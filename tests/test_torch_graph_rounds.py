"""A fit's leafwise rounds replayed from CUDA graphs on the card
(``growth.LeafwiseRounds``) against the same rounds run eagerly. The
tests need a card and skip without one. This file imports nothing of the
JAX package, which the card's machine lacks; there, run it without the
tests' conftest (which loads JAX)::

    python -m pytest tests/test_torch_graph_rounds.py -m card --noconftest -o addopts=""
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.models.gbdt import growth as TG


@pytest.mark.card
@pytest.mark.parametrize("quantized", [False, True])
def test_graphed_rounds_grow_the_eager_trees_on_the_card(quantized):
    """On the card a fit's rounds replay from CUDA graphs; the model, its
    text and the histogram launches are those of the eager rounds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the rounds replay from CUDA graphs")
    from mmlspark_tpu_torch.models.gbdt import booster as TB
    from mmlspark_tpu_torch.ops.histogram import node_histogram
    rng = np.random.default_rng(5)
    X = rng.normal(size=(60000, 12)).astype(np.float32)
    y = (X[:, 3] + X[:, 4] * X[:, 0] / 4 + rng.normal(size=60000)
         > 0).astype(np.float32)
    out = []
    for graphed in (True, False):
        real = TB.LeafwiseRounds
        if not graphed:
            TB.LeafwiseRounds = lambda: None
        try:
            before = node_histogram.launches + node_histogram.int8_launches
            text = TB.train_booster(
                X, y, objective="binary", num_iterations=6, max_bin=63,
                seed=3, device="cuda",
                cfg=TG.GrowConfig(quantized_grad=quantized)
            ).to_lightgbm_string()
            out.append((text, node_histogram.launches
                        + node_histogram.int8_launches - before))
        finally:
            TB.LeafwiseRounds = real
    assert out[0] == out[1]

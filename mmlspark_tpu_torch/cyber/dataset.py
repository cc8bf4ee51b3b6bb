"""Synthetic access-graph generator for anomaly-detection experiments.

The PyTorch port's own copy of ``mmlspark_tpu/cyber/dataset.py``
(host numpy, the same ``default_rng`` draws); the port imports
nothing of the JAX package.

Capability parity with the reference's cyber DataFactory
(src/main/python/mmlspark/cyber/dataset.py): three departments (hr, fin,
eng) whose users normally touch their own department's resources. The
factory emits

* ``training_edges`` — dense intra-department access (plus a shared
  "free-for-all" resource keeping the graph one component),
* ``intra_test_edges`` — NEW intra-department pairs (normal behavior the
  model should score low),
* ``inter_test_edges`` — cross-department pairs (anomalous behavior the
  model should score high).

Implementation is numpy/Dataset-native (vectorized pair sampling over the
user×resource grid) rather than rows built one by one in pandas.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core.dataset import Dataset

DEPARTMENTS = ("hr", "fin", "eng")

# per-department edge density for the test splits — one source of truth for
# both the intra (normal) and inter (anomalous) generators
TEST_RATIOS = {"hr": 0.025, "fin": 0.05, "eng": 0.035}


class DataFactory:
    """Deterministic clustered access-graph generator (seeded)."""

    def __init__(self, num_users: Optional[Dict[str, int]] = None,
                 num_resources: Optional[Dict[str, int]] = None,
                 single_component: bool = True, seed: int = 42):
        num_users = num_users or {"hr": 7, "fin": 5, "eng": 10}
        num_resources = num_resources or {"hr": 30, "fin": 25, "eng": 50}
        self.users = {d: [f"{d}_user_{i}" for i in range(num_users[d])]
                      for d in DEPARTMENTS}
        self.resources = {d: [f"{d}_res_{i}" for i in range(num_resources[d])]
                          for d in DEPARTMENTS}
        # one resource every user touches: keeps the access graph connected
        # so per-component normalization sees a single component
        self.join_resources = ["ffa"] if single_component else []
        self.rng = np.random.default_rng(seed)

    # -- core sampling -------------------------------------------------------

    def _pairs(self, users: Sequence[str], resources: Sequence[str],
               ratio: float,
               exclude: Optional[Set[Tuple[str, str]]] = None
               ) -> List[Tuple[str, str, float]]:
        """Sample ``ratio`` of the user×resource grid (each user keeps at
        least one edge), with access counts in the reference's 500-1000
        range; ``exclude`` drops pairs already seen in training."""
        if not users or not resources:
            return []
        nu, nr = len(users), len(resources)
        take = self.rng.random((nu, nr)) < ratio
        # every user gets at least one resource so nobody is cold (a user
        # with no training edges has no embedding and scores NaN later)
        take[np.arange(nu), self.rng.integers(0, nr, nu)] = True
        out = []
        for i, j in zip(*np.nonzero(take)):
            pair = (users[i], resources[j])
            if exclude and pair in exclude:
                continue
            out.append((*pair, float(self.rng.integers(500, 1001))))
        return out

    def _to_dataset(self, tups: List[Tuple[str, str, float]]) -> Dataset:
        return Dataset({
            "tenant": np.zeros(len(tups), np.int64),
            "user": [t[0] for t in tups],
            "res": [t[1] for t in tups],
            "likelihood": np.asarray([t[2] for t in tups], np.float64),
        })

    def _join_edges(self) -> List[Tuple[str, str, float]]:
        out = []
        for d in DEPARTMENTS:
            out += self._pairs(self.users[d], self.join_resources, 1.0)
        return out

    # -- public surface (reference parity) -----------------------------------

    def create_clustered_training_data(self, ratio: float = 0.25) -> Dataset:
        """Dense intra-department access edges (+ the join resource)."""
        tups = self._join_edges()
        for d in DEPARTMENTS:
            tups += self._pairs(self.users[d], self.resources[d],
                                max(ratio, 1e-9))
        self._train_pairs = {(u, r) for u, r, _ in tups}
        return self._to_dataset(tups)

    def create_clustered_intra_test_data(
            self, train: Optional[Dataset] = None) -> Dataset:
        """New same-department pairs — normal behavior unseen in training."""
        if train is not None:
            seen = set(zip(train["user"], train["res"]))
        else:
            seen = getattr(self, "_train_pairs", set())
        tups = self._join_edges()
        for d, r in TEST_RATIOS.items():
            tups += self._pairs(self.users[d], self.resources[d], r,
                                exclude=seen)
        return self._to_dataset(tups)

    def create_clustered_inter_test_data(self) -> Dataset:
        """Cross-department pairs — the anomalies."""
        tups = self._join_edges()
        for d in DEPARTMENTS:
            for other in DEPARTMENTS:
                if other != d:
                    tups += self._pairs(self.users[d], self.resources[other],
                                        TEST_RATIOS[d])
        return self._to_dataset(tups)

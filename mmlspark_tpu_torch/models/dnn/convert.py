"""Carry DNN params and models between the JAX package and the port.

The JAX package's param trees hold numpy (or JAX) arrays with convolution
weights as ``[kh, kw, in, out]``; the port's hold tensors with torch's
``[out, in, kh, kw]``. Dense weights are ``[in, out]`` in both, and every
other leaf is the same array. The model repository and saved stage
directories keep the JAX layout, so either package loads what the other
wrote. The rule both functions follow: a numpy leaf is in the JAX layout, a
tensor leaf in the port's; a leaf already in the target layout passes
through unchanged. Nothing of the JAX package is imported: its arrays are
read through ``np.asarray``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ...core.params import set_known_params
from ...device import DeviceLike, resolve_device


def params_from_jax(tree: Any) -> Any:
    """A JAX-layout param tree (numpy or JAX array leaves, in dicts, lists
    or tuples) as the port's: CPU tensors, 4-D weights permuted to
    ``[out, in, kh, kw]``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v) for v in tree)
    if tree is None or isinstance(tree, torch.Tensor):
        return tree
    a = np.asarray(tree)
    if a.ndim == 4:
        a = np.transpose(a, (3, 2, 0, 1))
    return torch.from_numpy(np.array(a, order="C"))  # a writable copy


def params_to_jax(tree: Any) -> Any:
    """The port's param tree in the JAX layout: numpy leaves, 4-D weights
    permuted to ``[kh, kw, in, out]`` (bfloat16 tensors as f32), dict keys
    sorted."""
    if isinstance(tree, dict):
        # keys sorted, as the JAX package's tree_map leaves them: payloads
        # flatten in the same order
        return {k: params_to_jax(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_jax(v) for v in tree)
    if not isinstance(tree, torch.Tensor):
        return tree
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    if t.dim() == 4:
        t = t.permute(2, 3, 1, 0)
    return np.ascontiguousarray(t.numpy())


def dnn_model_from_jax(jax_dnn_model, device: DeviceLike = None):
    """The port's :class:`~.scoring.DNNModel` for a JAX ``DNNModel``: its
    params converted, its ``apply_spec`` rebuilt on the port's ``cnn``, its
    Params copied, ``device`` the caller's. A JAX model without an
    ``apply_spec`` holds a JAX function, which the port cannot run: it
    raises."""
    from .scoring import DNNModel

    spec = getattr(jax_dnn_model, "apply_spec", None)
    if spec is None:
        raise ValueError(
            "this JAX DNNModel has no apply_spec: its apply_fn is a JAX "
            "function, which the port cannot run; build the port's model "
            "from DNNModel.from_downloader or an apply_spec")
    model = DNNModel(params_from_jax(jax_dnn_model.params), apply_spec=spec)
    # the set Params as they are: the JAX DNNModel's ``params`` attribute
    # shadows ``Params.params()``, so its ``extract_param_map`` raises
    return set_known_params(model, dict(jax_dnn_model._paramMap), device)


def transformer_params_from_jax(tree: Any, cfg, mesh=None,
                                device: DeviceLike = None) -> Any:
    """The JAX transformer's param tree (``init_params(cfg, key)``, numpy
    or JAX array leaves) as the port's: the same layout leaf for leaf, f32
    tensors on ``device``. With ``mesh``, this rank's ``model`` shards
    (:func:`.transformer.shard_params`); without, the full tree. Unlike
    :func:`params_from_jax`, no 4-D leaf is permuted: ``wqkv``'s
    ``[L, E, H, 3*Dh]`` is the same in both packages."""
    from . import transformer

    full = transformer.tree_map(
        lambda a: torch.from_numpy(np.array(a, dtype=np.float32)), tree)
    if mesh is not None:
        return transformer.shard_params(full, cfg, mesh, device=device)
    dev = resolve_device(device)
    return transformer.tree_map(lambda t: t.to(dev), full)


def transformer_params_to_jax(tree: Any, cfg, mesh=None) -> Any:
    """The port's transformer params as the JAX layout's numpy tree, keys
    sorted. With ``mesh``, ``tree`` is this rank's shards and the ``model``
    dims are gathered first (every rank of the axis must call it)."""
    from . import transformer

    if mesh is not None:
        tree = transformer.gather_params(tree, cfg, mesh)

    def to_numpy(t):
        if isinstance(t, dict):
            return {k: to_numpy(t[k]) for k in sorted(t)}
        return np.ascontiguousarray(t.detach().cpu().float().numpy())

    return to_numpy(tree)

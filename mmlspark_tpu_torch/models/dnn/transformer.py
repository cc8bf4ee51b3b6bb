"""SPMD transformer with data x seq x model parallelism over a rank mesh.

Counterpart of ``mmlspark_tpu/models/dnn/transformer.py``. One model spans
the ranks of a :class:`~...parallel.mesh.Mesh`:

  * ``data``  — batch sharding (DP)
  * ``model`` — Megatron-style tensor parallelism (TP): QKV/MLP column
    split, output projections row split with one ``psum`` per block
  * ``seq``   — sequence parallelism (SP): activations sharded over the
    sequence; exact attention by the ring (``ring``, ``ring_zigzag``) or
    by Ulysses' all-to-alls (``ulysses``)

The JAX package runs each rank's program inside one ``shard_map``; here
every rank runs :func:`forward_local` on its own shards and calls the
differentiable collectives of :mod:`...parallel.collectives`, whose
backward passes are JAX's transposes under ``check_vma=False``. Params are
f32, sharded on ``model`` (:func:`param_specs`) or replicated; activations
are ``cfg.dtype``. Every projection multiplies its ``cfg.dtype`` operands
exactly into f32 sums (JAX's ``preferred_element_type=f32``). The train
step copies the JAX one: gradients through the loss, a ``psum`` over
``model`` for the params replicated on it, a ``pmean`` over ``data`` and
``seq``, then AdamW.

Entry points (:func:`init_params`, :func:`shard_params`,
:func:`make_train_step`, :func:`make_forward`) take ``device``: ``cuda``
by default, raising without a GPU; ``device="cpu"`` runs on the CPU.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...device import DeviceLike, exact_f32, resolve_device
from ...parallel import placement
from ...parallel.collectives import all_gather, pmax, pmean, psum
from ...parallel.mesh import Mesh
from ...parallel.ring_attention import ring_attention, zigzag_ring_attention
from ...parallel.ulysses import ulysses_attention
from ...utils import prng

_ATTENTION = {"ring": ring_attention, "ring_zigzag": zigzag_ring_attention,
              "ulysses": ulysses_attention}


class TransformerConfig(NamedTuple):
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    d_head: int = 64
    n_layers: int = 4
    d_ff: int = 2048
    max_len: int = 2048
    dtype: Any = torch.bfloat16
    # sequence-parallel attention over the 'seq' axis: "ring" (neighbour
    # exchange, O(S_local) memory, no head constraint), "ring_zigzag" (the
    # ring over the causally balanced zig-zag layout; feed tokens and
    # targets through zigzag_permute) or "ulysses" (two all-to-alls reshard
    # heads <-> sequence; per-TP-rank heads divisible by the seq shards)
    seq_attention: str = "ring"
    # recompute each block's activations in the backward pass instead of
    # keeping them (torch.utils.checkpoint): activation memory O(S_local E)
    # instead of O(n_layers S_local E), at about a third more operations
    remat: bool = False


Tree = Dict[str, Any]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [tree]


def _unflatten(tree: Tree, leaves) -> Tree:
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def init_params(cfg: TransformerConfig, key: Union[int, Any] = 0,
                device: DeviceLike = None) -> Tree:
    """f32 parameters, layers stacked on a leading axis, drawn on
    ``device`` under ``key`` (a seed, or a PRNG key of ``utils/prng.py``).
    The draws are the JAX ``init_params(cfg, PRNGKey(seed))`` ones
    (``split(key, 4)``, ``split(k_layers, 6 L)`` as ``[L, 6]``, each
    normal at the JAX shape and scale), within a few f32 ulps
    (:func:`~mmlspark_tpu_torch.utils.prng.normal`), and the same bytes on
    every device."""
    dev = resolve_device(device)
    if isinstance(key, (int, np.integer)):
        key = prng.prng_key(int(key))
    E, H, Dh, Fd, L = (cfg.d_model, cfg.n_heads, cfg.d_head, cfg.d_ff,
                       cfg.n_layers)
    k_embed, k_pos, k_layers, k_head = prng.split(key, 4)
    ks = prng.split(k_layers, (L, 6))

    def norm(k, shape, scale):
        return prng.normal(k, shape, device=dev) * float(np.float32(scale))

    def stack(j, shape, scale):
        return torch.stack([norm(ks[i, j], shape, scale) for i in range(L)])

    def ones(*shape):
        return torch.ones(shape, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    layers = {
        "ln1_scale": ones(L, E), "ln1_bias": zeros(L, E),
        # [E, H, 3*Dh]: per-head q|k|v contiguous, so the head-axis TP shard
        # is the same layout at every tensor-parallel size
        "wqkv": stack(0, (E, H, 3 * Dh), E ** -0.5),
        "wo": stack(1, (H * Dh, E), (H * Dh) ** -0.5),
        "ln2_scale": ones(L, E), "ln2_bias": zeros(L, E),
        "w1": stack(2, (E, Fd), E ** -0.5),
        "b1": zeros(L, Fd),
        "w2": stack(3, (Fd, E), Fd ** -0.5),
        "b2": zeros(L, E),
    }
    return {"embed": norm(k_embed, (cfg.vocab_size, E), 1.0),
            "pos": norm(k_pos, (cfg.max_len, E), 0.02),
            "layers": layers,
            "lnf_scale": ones(E), "lnf_bias": zeros(E),
            "head": norm(k_head, (E, cfg.vocab_size), E ** -0.5)}


def param_specs(cfg: TransformerConfig) -> Tree:
    """Per-dimension mesh axis of each param (None: replicated on that
    dimension), mirroring :func:`init_params`: TP dims on ``model``."""
    return {
        "embed": (None, "model"),
        "pos": (None, "model"),
        "layers": {
            "ln1_scale": (None, None), "ln1_bias": (None, None),
            "wqkv": (None, None, "model", None),
            "wo": (None, "model", None),
            "ln2_scale": (None, None), "ln2_bias": (None, None),
            "w1": (None, None, "model"), "b1": (None, "model"),
            "w2": (None, "model", None), "b2": (None, None),
        },
        "lnf_scale": (None,), "lnf_bias": (None,),
        "head": (None, "model"),
    }


def _layer_norm(x, scale, bias):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + 1e-5) * scale + bias).to(x.dtype)


def _dot(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` with f32 sums of the exact products of the operands (the
    JAX package's ``preferred_element_type=jnp.float32``)."""
    return torch.einsum(spec, a.float(), b.float())


def _block(x, lp, cfg: TransformerConfig, mesh: Mesh, causal: bool):
    B, S = x.shape[:2]
    Hl = cfg.n_heads // mesh.axis_size("model")
    Dh, dt = cfg.d_head, cfg.dtype
    h = _layer_norm(x, lp["ln1_scale"], lp["ln1_bias"])
    qkv = _dot("bse,ehk->bshk", h, lp["wqkv"].to(dt))      # [B,S,Hl,3*Dh]
    qkv = qkv.reshape(B, S, Hl, 3, Dh).to(dt)
    q = qkv[:, :, :, 0].transpose(1, 2)                     # [B, Hl, S, Dh]
    k = qkv[:, :, :, 1].transpose(1, 2)
    v = qkv[:, :, :, 2].transpose(1, 2)
    att = _ATTENTION[cfg.seq_attention](q, k, v, mesh, "seq", causal=causal)
    att = att.transpose(1, 2).reshape(B, S, Hl * Dh)
    out = _dot("bsk,ke->bse", att, lp["wo"].to(dt))
    out = psum(out, mesh, "model").to(dt)
    x = x + out
    h = _layer_norm(x, lp["ln2_scale"], lp["ln2_bias"])
    m = _dot("bse,ef->bsf", h, lp["w1"].to(dt)) + lp["b1"]
    m = F.gelu(m.float(), approximate="tanh").to(dt)
    m = _dot("bsf,fe->bse", m, lp["w2"].to(dt))
    m = psum(m, mesh, "model").to(dt) + lp["b2"].to(dt)
    return x + m


def forward_local(params: Tree, tokens: torch.Tensor, cfg: TransformerConfig,
                  mesh: Mesh, causal: bool = True) -> torch.Tensor:
    """This rank's forward on its shards; returns vocab-sharded logits
    ``[B_local, S_local, V/tp]`` in f32.

    tokens: ``[B_local, S_local]`` integer ids, this rank's (data, seq)
    block (zig-zag ordered for ``ring_zigzag``)."""
    if cfg.seq_attention not in _ATTENTION:
        # all strategies are exact, so a typo would silently measure the
        # wrong one — fail loudly instead
        raise ValueError(
            f"unknown seq_attention {cfg.seq_attention!r}: "
            "use 'ring', 'ring_zigzag' or 'ulysses'")
    B, S = tokens.shape
    sp_idx, n_sp = mesh.axis_index("seq"), mesh.axis_size("seq")
    if S * n_sp > cfg.max_len:
        raise ValueError(f"sequence of {S * n_sp} tokens is longer than "
                         f"max_len {cfg.max_len}")
    pos = params["pos"]
    # embedding: the table is E-sharded; gather rows then all-gather E
    emb_local = params["embed"][tokens]                     # [B, S, E/tp]
    if cfg.seq_attention == "ring_zigzag":
        # this shard holds chunk me and chunk 2n-1-me of the global
        # sequence: slice the positional table accordingly
        C = S // 2
        hi = (2 * n_sp - 1 - sp_idx) * C
        pos_local = torch.cat([pos[sp_idx * C:sp_idx * C + C],
                               pos[hi:hi + C]])
    else:
        pos_local = pos[sp_idx * S:sp_idx * S + S]
    x_local = emb_local + pos_local[None]
    x = all_gather(x_local, mesh, "model", dim=2, tiled=True).to(cfg.dtype)

    layers = params["layers"]
    names = list(layers)
    for i in range(cfg.n_layers):
        lp = [layers[n][i] for n in names]
        if cfg.remat:
            x = checkpoint(
                lambda x, *w: _block(x, dict(zip(names, w)), cfg, mesh,
                                     causal),
                x, *lp, use_reentrant=False)
        else:
            x = _block(x, dict(zip(names, lp)), cfg, mesh, causal)
    x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"])
    return _dot("bse,ev->bsv", x, params["head"].to(cfg.dtype))


def sharded_xent(logits_local: torch.Tensor, targets: torch.Tensor,
                 cfg: TransformerConfig, mesh: Mesh) -> torch.Tensor:
    """Cross-entropy over vocab-sharded logits (stable log-sum-exp with
    ``pmax``/``psum`` over ``model``); the mean over every token by
    ``pmean`` over ``data`` and ``seq``."""
    v_local = cfg.vocab_size // mesh.axis_size("model")
    v0 = mesh.axis_index("model") * v_local
    # stability shift only — constant w.r.t. differentiation
    lmax = pmax(logits_local.detach().amax(-1), mesh, "model")
    z = torch.exp(logits_local - lmax[..., None])
    log_z = torch.log(psum(z.sum(-1), mesh, "model")) + lmax
    t_local = targets - v0
    in_range = (t_local >= 0) & (t_local < v_local)
    picked = torch.take_along_dim(
        logits_local, t_local.clamp(0, v_local - 1)[..., None], dim=-1)[..., 0]
    picked = psum(torch.where(in_range, picked, 0.0), mesh, "model")
    nll = log_z - picked
    return pmean(pmean(nll.mean(), mesh, "data"), mesh, "seq")


# ---------------------------------------------------------------------------
# hand-rolled AdamW (the state is sharded as the params are)
# ---------------------------------------------------------------------------


def adamw_init(params: Tree) -> Tree:
    dev = tree_leaves(params)[0].device
    return {"mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_update(grads: Tree, state: Tree, params: Tree, lr=1e-3, b1=0.9,
                 b2=0.999, eps=1e-8, weight_decay=0.01):
    c = state["count"] + 1
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["mu"], grads)
    nu = tree_map(lambda n, g: b2 * n + (1 - b2) * g * g, state["nu"], grads)
    cf = c.float()
    bc1 = 1 - b1 ** cf
    bc2 = 1 - b2 ** cf

    def upd(p, m, n):
        return p - lr * (m / bc1 / (torch.sqrt(n / bc2) + eps)
                         + weight_decay * p)

    new_params = tree_map(upd, params, mu, nu)
    return new_params, {"mu": mu, "nu": nu, "count": c}


# ---------------------------------------------------------------------------
# train / forward steps over a mesh
# ---------------------------------------------------------------------------


def local_block(tokens, mesh: Mesh, device: torch.device) -> torch.Tensor:
    """This rank's ``(data, seq)`` block of global ``[B, S]`` ids."""
    t = torch.as_tensor(np.asarray(tokens) if not isinstance(
        tokens, torch.Tensor) else tokens)
    nd, ns = mesh.axis_size("data"), mesh.axis_size("seq")
    B, S = t.shape
    if B % nd or S % ns:
        raise ValueError(f"tokens {tuple(t.shape)} do not split over "
                         f"data={nd} x seq={ns}")
    bl, sl = B // nd, S // ns
    di, si = mesh.axis_index("data"), mesh.axis_index("seq")
    return t[di * bl:(di + 1) * bl, si * sl:(si + 1) * sl].to(
        device=device, dtype=torch.long)


def loss_and_grads(params: Tree, tokens: torch.Tensor, targets: torch.Tensor,
                   cfg: TransformerConfig, mesh: Mesh):
    """This rank's loss and the train step's gradients of its shards
    (``tokens``/``targets``: its ``(data, seq)`` block).

    Params replicated on ``model`` get their partial gradients summed over
    it; then every gradient is averaged over ``data`` and ``seq``. As in
    the JAX package, the collectives' transposes make every gradient the
    true one times the ``model`` shard count (ROADMAP Queue 3)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        logits = forward_local(leaves, tokens, cfg, mesh)
        loss = sharded_xent(logits, targets, cfg, mesh)
        flat = torch.autograd.grad(loss, tree_leaves(leaves))
    with torch.no_grad():
        grads = tree_map(
            lambda g, s: g if "model" in s else psum(g, mesh, "model"),
            _unflatten(params, flat), param_specs(cfg))
        grads = tree_map(
            lambda g: pmean(pmean(g, mesh, "data"), mesh, "seq"), grads)
    return loss.detach(), grads


def make_train_step(cfg: TransformerConfig, mesh: Mesh, lr: float = 1e-3,
                    device: DeviceLike = None):
    """Returns ``step(params, opt_state, tokens, targets) -> (params,
    opt_state, loss)`` for this rank: ``params``/``opt_state`` its shards
    (:func:`shard_params`, :func:`shard_opt_state`), ``tokens``/``targets``
    the global ``[B, S]`` ids (every rank passes the same), ``loss`` the
    global mean (a 0-d f32 tensor, equal on every rank). The gradients are
    :func:`loss_and_grads`'; AdamW updates each shard. The f32 matmuls run
    in full f32 (``device.exact_f32``: no TF32), as the JAX package's do."""
    dev = resolve_device(device)

    def step(params, opt_state, tokens, targets):
        with exact_f32(dev):
            loss, grads = loss_and_grads(
                params, local_block(tokens, mesh, dev),
                local_block(targets, mesh, dev), cfg, mesh)
        with torch.no_grad():
            new_params, new_opt = adamw_update(grads, opt_state, params,
                                               lr=lr)
        return new_params, new_opt, loss

    return step


def make_forward(cfg: TransformerConfig, mesh: Mesh, causal: bool = True,
                 device: DeviceLike = None):
    """Returns ``forward(params, tokens [B, S]) -> logits [B, S, V]``: the
    full logits on every rank, gathered over ``model``, ``seq`` and
    ``data``."""
    dev = resolve_device(device)

    def forward(params, tokens):
        with torch.no_grad(), exact_f32(dev):
            tok = local_block(tokens, mesh, dev)
            out = forward_local(params, tok, cfg, mesh, causal=causal)
            out = all_gather(out, mesh, "model", dim=2, tiled=True)
            out = all_gather(out, mesh, "seq", dim=1, tiled=True)
            return all_gather(out, mesh, "data", dim=0, tiled=True)

    return forward


def _shard(t: torch.Tensor, spec, mesh: Mesh, dev) -> torch.Tensor:
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = mesh.axis_size(axis)
            if t.shape[dim] % n:
                raise ValueError(f"dimension {dim} of {tuple(t.shape)} does "
                                 f"not split over {axis}={n}")
            size = t.shape[dim] // n
            t = t.narrow(dim, mesh.axis_index(axis) * size, size)
    return t.to(dev).clone()


def shard_params(params: Tree, cfg: TransformerConfig, mesh: Mesh,
                 device: DeviceLike = None) -> Tree:
    """This rank's shards of the full ``params`` (:func:`param_specs`), on
    ``device``."""
    dev = resolve_device(device)
    placement.plan_for("transformer.fit", mesh=mesh, what="params_tp",
                       device=dev)
    return tree_map(lambda t, s: _shard(t, s, mesh, dev), params,
                    param_specs(cfg))


def shard_opt_state(opt_state: Tree, cfg: TransformerConfig, mesh: Mesh,
                    device: DeviceLike = None) -> Tree:
    dev = resolve_device(device)
    specs = param_specs(cfg)
    return {"mu": tree_map(lambda t, s: _shard(t, s, mesh, dev),
                           opt_state["mu"], specs),
            "nu": tree_map(lambda t, s: _shard(t, s, mesh, dev),
                           opt_state["nu"], specs),
            "count": opt_state["count"].to(dev).clone()}


def gather_params(params: Tree, cfg: TransformerConfig,
                  mesh: Mesh) -> Tree:
    """The full params from this rank's shards: each TP dim gathered over
    ``model`` (every rank of the axis must call it)."""
    def full(t, spec):
        for dim, axis in enumerate(spec):
            if axis is not None:
                t = all_gather(t, mesh, axis, dim=dim, tiled=True)
        return t

    with torch.no_grad():
        return tree_map(full, params, param_specs(cfg))


__all__ = ["TransformerConfig", "adamw_init", "adamw_update",
           "forward_local", "gather_params", "init_params", "local_block",
           "loss_and_grads",
           "make_forward", "make_train_step", "param_specs",
           "shard_opt_state", "shard_params", "sharded_xent"]

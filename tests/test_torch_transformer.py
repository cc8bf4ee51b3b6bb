"""The SPMD transformer of the PyTorch port against the JAX package.

The JAX params (``init_params(cfg, PRNGKey(0))``) are carried across with
``convert.transformer_params_from_jax``, and the same seeded tokens go
through both packages' ``make_train_step`` (lr 1e-2).

  * World size 1, ``dtype=float32``, each strategy (ring, zig-zag ring,
    Ulysses): the forward logits within 1e-5, three AdamW steps' losses
    within 1e-5 and the final params within 1e-4 of JAX on a 1-device mesh.
  * World size 4, ``{"data": 1, "seq": 2, "model": 2}`` (one ``run_ranks``
    call, four gloo processes): each strategy's losses within 1e-5 and its
    final params, gathered over ``model``, within 1e-4 of JAX on a mesh of
    the same shape; the params replicated on ``model`` bit-equal on every
    rank (JAX's ``test_tp_replicated_params_stay_identical``); ``remat``
    bit-equal to the plain step; the reference's gradients carry the
    ``model`` shard count as a factor (ROADMAP Queue 3), and so do the
    port's: its step's gradients at ``model=2`` are twice those of one
    rank on the same batch.
  * ``dtype=bfloat16`` at world size 1: losses within ``BF16_LOSS_ATOL``
    of JAX (see there for why).
  * ``init_params(cfg, 0)`` draws the JAX ``init_params(cfg,
    PRNGKey(0))`` (``mmlspark_tpu_torch/utils/prng.py``): every leaf
    within 4 f32 ulps, and a key given as words draws what its seed does.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from _torch_parity import f32_ulps
from _torch_ranks import run_ranks
from mmlspark_tpu.models.dnn import transformer as JT
from mmlspark_tpu.parallel.compat import shard_map
from mmlspark_tpu.parallel.mesh import make_mesh as jmake_mesh
from mmlspark_tpu.parallel.ring_attention import zigzag_permute
from mmlspark_tpu_torch.models.dnn import transformer as TT
from mmlspark_tpu_torch.models.dnn.convert import (
    transformer_params_from_jax, transformer_params_to_jax)
from mmlspark_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

SMALL = dict(vocab_size=64, d_model=32, n_heads=4, d_head=8, n_layers=2,
             d_ff=64, max_len=64)
STRATEGIES = ("ring", "ring_zigzag", "ulysses")
LR = 1e-2
STEPS = 3
LOSS_ATOL = 1e-5
PARAM_ATOL = 1e-4
#: bf16 rounds activations to 8 significant bits at the same points in
#: both packages, but their f32 sums (matmuls, layer norms, softmax
#: denominators) run in other orders, so now and then a value rounds to the
#: neighbouring bf16 number (one part in 256) on one side only. Over seeds
#: 0-2 this moved the three losses (2.8 to 4.5) by 5.5e-4 to 1.4e-3. The
#: bound is a quarter of a bf16 ulp at that magnitude (2^-6 / 4), 2.9x the
#: largest seen. It catches a wrong or missing term, not where a value is
#: rounded: rounding the matmuls' outputs or the layer norms' at other
#: points moved the loss no further (1.2e-3). The f32 tests (1e-5) hold
#: the arithmetic.
BF16_LOSS_ATOL = 2.0 ** -8
#: the leaves whose step gradients the world-size-4 test holds: sharded on
#: model (w1, head, wqkv) and replicated on it (ln1_scale, b2)
GRAD_KEYS = ("w1", "wqkv", "ln1_scale", "b2", "head")


def _tokens(B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, SMALL["vocab_size"], (B, S)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _jax_params(cfg):
    return jax.tree_util.tree_map(np.asarray,
                                  JT.init_params(cfg, jax.random.PRNGKey(0)))


def _jax_run(cfg, shape, toks, tgts, steps=STEPS):
    """(losses, final params as numpy) of JAX's train step."""
    mesh = jmake_mesh(shape, devices=jax.devices()[:int(np.prod(
        list(shape.values())))])
    params = JT.shard_params(JT.init_params(cfg, jax.random.PRNGKey(0)),
                             cfg, mesh)
    opt = JT.shard_opt_state(JT.adamw_init(params), cfg, mesh)
    step = JT.make_train_step(cfg, mesh, lr=LR)
    losses = []
    for _ in range(steps):
        params, opt, loss = step(params, opt, toks, tgts)
        losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, params)


def _port_run(cfg, params_np, toks, tgts, steps=STEPS):
    mesh = make_mesh({"data": 1, "seq": 1, "model": 1})
    params = transformer_params_from_jax(params_np, cfg, mesh=mesh,
                                         device="cpu")
    opt = TT.adamw_init(params)
    step = TT.make_train_step(cfg, mesh, lr=LR, device="cpu")
    losses = []
    for _ in range(steps):
        params, opt, loss = step(params, opt, toks, tgts)
        losses.append(float(loss))
    return losses, transformer_params_to_jax(params, cfg)


def _compare_trees(got, want, atol):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_g) == len(flat_w)
    for path, g in flat_g:
        np.testing.assert_allclose(np.asarray(g), flat_w[path], rtol=0,
                                   atol=atol, err_msg=str(path))


def _permuted(mode, n, *arrays):
    if mode != "ring_zigzag":
        return arrays
    return tuple(zigzag_permute(a, n, axis=1) for a in arrays)


@pytest.mark.parametrize("mode", STRATEGIES)
def test_world_size_one_f32_matches_jax(mode):
    jcfg = JT.TransformerConfig(dtype=jnp.float32, seq_attention=mode,
                                **SMALL)
    tcfg = TT.TransformerConfig(dtype=torch.float32, seq_attention=mode,
                                **SMALL)
    toks, tgts = _tokens()
    pnp = _jax_params(jcfg)
    jmesh = jmake_mesh({"data": 1, "seq": 1, "model": 1},
                       devices=jax.devices()[:1])
    want = np.asarray(JT.make_forward(jcfg, jmesh)(
        JT.shard_params(JT.init_params(jcfg, jax.random.PRNGKey(0)), jcfg,
                        jmesh), toks))
    tmesh = make_mesh({"data": 1, "seq": 1, "model": 1})
    got = TT.make_forward(tcfg, tmesh, device="cpu")(
        transformer_params_from_jax(pnp, tcfg, mesh=tmesh, device="cpu"),
        toks)
    assert got.shape == (2, 32, SMALL["vocab_size"])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)

    j_losses, j_params = _jax_run(jcfg, {"data": 1, "seq": 1, "model": 1},
                                  toks, tgts)
    t_losses, t_params = _port_run(tcfg, pnp, toks, tgts)
    np.testing.assert_allclose(t_losses, j_losses, rtol=0, atol=LOSS_ATOL)
    assert t_losses[-1] < t_losses[0]
    _compare_trees(t_params, j_params, PARAM_ATOL)


@pytest.mark.parametrize("seed", [0, 7])
def test_init_params_is_the_jax_init(seed):
    cfg = dict(SMALL, n_layers=3)
    want = jax.tree_util.tree_map(np.asarray, JT.init_params(
        JT.TransformerConfig(**cfg), jax.random.PRNGKey(seed)))
    tcfg = TT.TransformerConfig(**cfg)
    got = transformer_params_to_jax(TT.init_params(tcfg, seed,
                                                   device="cpu"), tcfg)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_w) == len(flat_g)
    for path, v in flat_w:
        assert flat_g[path].shape == v.shape, path
        assert f32_ulps(flat_g[path], v) <= 4, path
    again = transformer_params_to_jax(TT.init_params(
        tcfg, (0, seed), device="cpu"), tcfg)
    for path, v in jax.tree_util.tree_leaves_with_path(again):
        np.testing.assert_array_equal(v, flat_g[path])


def test_bf16_world_size_one_matches_jax():
    jcfg = JT.TransformerConfig(**SMALL)
    tcfg = TT.TransformerConfig(**SMALL)
    assert jcfg.dtype == jnp.bfloat16 and tcfg.dtype == torch.bfloat16
    toks, tgts = _tokens()
    j_losses, _ = _jax_run(jcfg, {"data": 1, "seq": 1, "model": 1}, toks,
                           tgts)
    t_losses, t_params = _port_run(tcfg, _jax_params(jcfg), toks, tgts)
    np.testing.assert_allclose(t_losses, j_losses, rtol=0,
                               atol=BF16_LOSS_ATOL)
    assert t_losses[-1] < t_losses[0]
    assert all(np.isfinite(a).all()
               for a in jax.tree_util.tree_leaves(t_params))


_BODY = """
from mmlspark_tpu_torch.models.dnn import transformer as T
from mmlspark_tpu_torch.models.dnn.convert import (
    transformer_params_from_jax, transformer_params_to_jax)
from mmlspark_tpu_torch.parallel.mesh import make_mesh
from mmlspark_tpu_torch.parallel.ring_attention import zigzag_permute
GRAD_KEYS = %(grad_keys)r
mesh = make_mesh({"data": 1, "seq": 2, "model": 2})
flat = np.load(%(params)r)
tree = {}
for key in flat.files:
    *outer, leaf = key.split("/")
    node = tree
    for k in outer:
        node = node.setdefault(k, {})
    node[leaf] = flat[key]
rng = np.random.default_rng(0)
toks = rng.integers(0, %(vocab)d, (2, 32)).astype(np.int32)
tgts = np.roll(toks, -1, axis=1)
result = {"seq": mesh.axis_index("seq"), "model": mesh.axis_index("model")}
for mode, remat in (("ring", False), ("ring_zigzag", False),
                    ("ulysses", False), ("ring", True)):
    cfg = T.TransformerConfig(dtype=torch.float32, seq_attention=mode,
                              remat=remat, **%(small)r)
    t_in, y_in = toks, tgts
    if mode == "ring_zigzag":
        t_in, y_in = (zigzag_permute(a, 2, axis=1) for a in (toks, tgts))
    params = transformer_params_from_jax(tree, cfg, mesh=mesh, device="cpu")
    opt = T.adamw_init(params)
    step = T.make_train_step(cfg, mesh, lr=%(lr)r, device="cpu")
    losses = []
    for _ in range(%(steps)d):
        params, opt, loss = step(params, opt, t_in, y_in)
        losses.append(float(loss))
    full = transformer_params_to_jax(params, cfg, mesh)
    tag = mode + ("_remat" if remat else "")
    result[tag] = {
        "losses": losses,
        "replicated": {k: params["layers"][k].tolist()
                       for k in ("ln1_scale", "ln2_scale", "b2")},
        "params": ({"/".join(k): v for k, v in [
            (("embed",), full["embed"]), (("head",), full["head"]),
            (("layers", "wqkv"), full["layers"]["wqkv"]),
            (("layers", "w2"), full["layers"]["w2"]),
            (("layers", "ln1_scale"), full["layers"]["ln1_scale"])]}
                   if rank == 0 else None)}
    if rank == 0:
        result[tag]["params"] = {k: v.tolist()
                                 for k, v in result[tag]["params"].items()}
# the step's gradients of one batch, gathered over model (every rank)
cfg = T.TransformerConfig(dtype=torch.float32, **%(small)r)
params = transformer_params_from_jax(tree, cfg, mesh=mesh, device="cpu")
_, grads = T.loss_and_grads(params, T.local_block(toks, mesh, "cpu"),
                            T.local_block(tgts, mesh, "cpu"), cfg, mesh)
grads = T.gather_params(grads, cfg, mesh)
if rank == 0:
    result["grads"] = {k: grads["layers"][k].tolist() if k != "head"
                       else grads[k].tolist() for k in GRAD_KEYS}
"""


def _jax_grads(cfg, shape, params_np, toks, tgts):
    """The gradients JAX's train step feeds AdamW (``transformer.py``'s
    ``step_local`` up to ``adamw_update``), gathered."""
    mesh = jmake_mesh(shape, devices=jax.devices()[:4])
    specs = JT.param_specs(cfg)

    def local(params, tokens, targets):
        grads = jax.grad(lambda p: JT.sharded_xent(
            JT.forward_local(p, tokens, cfg), targets, cfg))(params)
        grads = jax.tree_util.tree_map(
            lambda g, s: g if "model" in tuple(s) else lax.psum(g, "model"),
            grads, specs)
        return jax.tree_util.tree_map(
            lambda g: lax.pmean(lax.pmean(g, "data"), "seq"), grads)

    fn = jax.jit(shard_map(local, mesh=mesh,
                           in_specs=(specs, P("data", "seq"),
                                     P("data", "seq")),
                           out_specs=specs, check_vma=False))
    params = JT.shard_params(jax.tree_util.tree_map(jnp.asarray, params_np),
                             cfg, mesh)
    return jax.tree_util.tree_map(np.asarray, fn(params, toks, tgts))


def _flat_npz(tree, path):
    flat = {}
    for kp, leaf in jax.tree_util.tree_leaves_with_path(tree):
        flat["/".join(k.key for k in kp)] = leaf
    np.savez(path, **flat)


def test_world_size_four_matches_jax(tmp_path):
    jcfg = JT.TransformerConfig(dtype=jnp.float32, **SMALL)
    pnp = _jax_params(jcfg)
    ppath = os.path.join(str(tmp_path), "params.npz")
    _flat_npz(pnp, ppath)
    body = _BODY % dict(params=ppath, vocab=SMALL["vocab_size"], small=SMALL,
                        lr=LR, steps=STEPS, grad_keys=GRAD_KEYS)
    ranks = run_ranks(tmp_path, 4, body)
    assert [(r["seq"], r["model"]) for r in ranks] == [(0, 0), (0, 1),
                                                       (1, 0), (1, 1)]
    toks, tgts = _tokens()
    shape = {"data": 1, "seq": 2, "model": 2}
    for mode in STRATEGIES:
        cfg = jcfg._replace(seq_attention=mode)
        j_losses, j_params = _jax_run(cfg, shape,
                                      *_permuted(mode, 2, toks, tgts))
        for r in ranks:
            np.testing.assert_allclose(r[mode]["losses"], j_losses, rtol=0,
                                       atol=LOSS_ATOL)
            for k, v in r[mode]["replicated"].items():
                assert v == ranks[0][mode]["replicated"][k], (mode, k)
        for key, v in ranks[0][mode]["params"].items():
            node = j_params
            for k in key.split("/"):
                node = node[k]
            np.testing.assert_allclose(np.asarray(v), node, rtol=0,
                                       atol=PARAM_ATOL, err_msg=key)
    for r in ranks:
        assert r["ring_remat"]["losses"] == r["ring"]["losses"]
        assert r["ring_remat"]["replicated"] == r["ring"]["replicated"]

    # the factor: the step's gradients at model=2 equal JAX's, and twice
    # the true ones (the port's step on one rank)
    j_grads = _jax_grads(jcfg, shape, pnp, toks, tgts)
    tcfg = TT.TransformerConfig(dtype=torch.float32, **SMALL)
    one = make_mesh({"data": 1, "seq": 1, "model": 1})
    _, ref = TT.loss_and_grads(
        transformer_params_from_jax(pnp, tcfg, device="cpu"),
        torch.as_tensor(toks, dtype=torch.long),
        torch.as_tensor(tgts, dtype=torch.long), tcfg, one)
    for k in GRAD_KEYS:
        got = np.asarray(ranks[0]["grads"][k])
        want = j_grads[k] if k == "head" else j_grads["layers"][k]
        true = (ref[k] if k == "head" else ref["layers"][k]).numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale,
                                   err_msg=k)
        np.testing.assert_allclose(got, 2 * true, rtol=0, atol=1e-5 * scale,
                                   err_msg=k)

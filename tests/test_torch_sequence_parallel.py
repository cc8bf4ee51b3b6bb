"""Sequence parallelism of the PyTorch port against the JAX package.

  * ``blockwise_attention`` and ``local_attention`` on one rank, causal and
    not, with block sizes that do and do not divide S: outputs within 1e-5
    of JAX at f32 and ``torch.autograd`` gradients (of the output against
    a seeded cotangent) within 1e-4 of ``jax.grad``.
  * The zig-zag helpers equal JAX's exactly, errors included.
  * Two gloo ranks on a ``{"seq": 2}`` mesh (one ``run_ranks`` call): ring,
    zig-zag ring and Ulysses attention, causal and not, outputs (1e-5)
    and gradients (1e-4) per rank against JAX's ``shard_map`` on a
    2-device ``seq`` mesh; and each collective's backward against JAX's
    transpose under ``check_vma=False`` (the gradient inside
    ``shard_map`` of each rank's own loss): ``psum`` and ``all_gather``
    give 2 per element where the loss is a plain sum, as in JAX.
  * Ulysses refuses a head count the shard count does not divide, with the
    JAX message.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from _torch_ranks import run_ranks
from mmlspark_tpu.parallel import ring_attention as JR
from mmlspark_tpu.parallel import ulysses as JU
from mmlspark_tpu.parallel.compat import shard_map
from mmlspark_tpu.parallel.mesh import make_mesh as jmake_mesh
from mmlspark_tpu_torch.parallel import ring_attention as TR
from mmlspark_tpu_torch.parallel import ulysses as TU
from mmlspark_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

OUT_ATOL = 1e-5
GRAD_ATOL = 1e-4


def _qkvw(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]


def _torch_out_and_grads(fn, q, k, v, w):
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = fn(*ts)
    (out * torch.tensor(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_out_and_grads(fn, q, k, v, w):
    def both(q, k, v, w):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(w)

    out, grads = jax.jit(both)(q, k, v, w)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _close(got, want, atol):
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block_size", [8, 5, 7, 512])
def test_blockwise_attention_matches_jax(causal, block_size):
    q, k, v, w = _qkvw((2, 3, 24, 8), seed=block_size)
    got = _torch_out_and_grads(
        lambda q, k, v: TR.blockwise_attention(q, k, v, causal=causal,
                                               block_size=block_size),
        q, k, v, w)
    want = _jax_out_and_grads(
        lambda q, k, v: JR.blockwise_attention(q, k, v, causal=causal,
                                               block_size=block_size),
        q, k, v, w)
    _close(got[0], want[0], OUT_ATOL)
    for g, h in zip(got[1], want[1]):
        assert np.isfinite(g).all()
        _close(g, h, GRAD_ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_local_attention_matches_jax(causal):
    q, k, v, w = _qkvw((2, 2, 17, 8), seed=3)
    got = _torch_out_and_grads(
        lambda q, k, v: TR.local_attention(q, k, v, causal=causal),
        q, k, v, w)
    want = _jax_out_and_grads(
        lambda q, k, v: JR.local_attention(q, k, v, causal=causal),
        q, k, v, w)
    _close(got[0], want[0], OUT_ATOL)
    for g, h in zip(got[1], want[1]):
        assert np.isfinite(g).all()
        _close(g, h, GRAD_ATOL)


@pytest.mark.parametrize("n,S", [(1, 8), (2, 16), (3, 12), (4, 64)])
def test_zigzag_helpers_equal_jax(n, S):
    np.testing.assert_array_equal(TR.zigzag_global_positions(n, S),
                                  JR.zigzag_global_positions(n, S))
    x = np.arange(3 * S * 2).reshape(3, S, 2)
    p = TR.zigzag_permute(x, n, axis=1)
    np.testing.assert_array_equal(p, JR.zigzag_permute(x, n, axis=1))
    np.testing.assert_array_equal(TR.zigzag_unpermute(p, n, axis=1),
                                  JR.zigzag_unpermute(p, n, axis=1))
    np.testing.assert_array_equal(TR.zigzag_unpermute(p, n, axis=1), x)


def test_zigzag_helpers_refuse_what_jax_refuses():
    for mod in (TR, JR):
        with pytest.raises(ValueError, match="divisible by 2\\*n_shards"):
            mod.zigzag_permute(np.zeros((2, 10)), 3, axis=1)


def test_ulysses_refuses_indivisible_heads():
    # a stand-in seq axis of two ranks: the check runs before any exchange
    mesh = Mesh(axes={"seq": ((0, 1), None)})
    q = torch.zeros(1, 3, 4, 8)
    with pytest.raises(ValueError, match="heads \\(3\\) divisible by the "
                                         "'seq' shard count \\(2\\)"):
        TU.ulysses_attention(q, q, q, mesh, "seq")
    jmesh = jmake_mesh({"seq": 2}, devices=jax.devices()[:2])
    with pytest.raises(ValueError, match="heads \\(3\\) divisible by the "
                                         "'seq' shard count \\(2\\)"):
        shard_map(lambda q: JU.ulysses_attention(q, q, q, "seq"),
                  mesh=jmesh, in_specs=P(None, None, "seq", None),
                  out_specs=P(None, None, "seq", None),
                  check_vma=False)(jnp.zeros((1, 3, 8, 8)))


# ---------------------------------------------------------------------------
# two ranks on a seq mesh
# ---------------------------------------------------------------------------

ATT_SHAPE = (1, 4, 16, 8)      # B, H, S (global), D
ATT_SEED = 7
COLL_SEED = 9
#: (name, local input shape, local output shape)
COLLECTIVES = (
    ("psum", (2, 3), (2, 3)),
    ("pmean", (2, 3), (2, 3)),
    ("all_gather_tiled", (2, 3), (4, 3)),
    ("all_gather", (2, 3), (2, 2, 3)),
    ("ppermute", (2, 3), (2, 3)),
    ("all_to_all", (4, 3), (2, 6)),
)

_BODY = """
from mmlspark_tpu_torch.parallel import collectives as C
from mmlspark_tpu_torch.parallel import ring_attention as R
from mmlspark_tpu_torch.parallel import ulysses as U
from mmlspark_tpu_torch.parallel.mesh import make_mesh
mesh = make_mesh({"seq": 2})
B, H, S, D = %(shape)r
Sl = S // 2
rng = np.random.default_rng(%(att_seed)d)
q, k, v, w = (rng.normal(size=(B, H, S, D)).astype(np.float32)
              for _ in range(4))
result = {"index": mesh.axis_index("seq"), "size": mesh.axis_size("seq")}
fns = {"ring": R.ring_attention, "ring_zigzag": R.zigzag_ring_attention,
       "ulysses": U.ulysses_attention}
for name, fn in fns.items():
    arrs = [q, k, v, w]
    if name == "ring_zigzag":
        arrs = [R.zigzag_permute(a, 2, axis=2) for a in arrs]
    mine = [torch.tensor(a[:, :, rank * Sl:(rank + 1) * Sl])
            for a in arrs]
    for causal in (True, False):
        ts = [t.clone().requires_grad_() for t in mine[:3]]
        out = fn(*ts, mesh, "seq", causal=causal)
        (out * mine[3]).sum().backward()
        result[f"{name}_{causal}"] = [out.detach().tolist()] + [
            t.grad.tolist() for t in ts]
rng = np.random.default_rng(%(coll_seed)d)
coll = {
    "psum": lambda x: C.psum(x, mesh, "seq"),
    "pmean": lambda x: C.pmean(x, mesh, "seq"),
    "all_gather_tiled": lambda x: C.all_gather(x, mesh, "seq", 0, True),
    "all_gather": lambda x: C.all_gather(x, mesh, "seq", 0, False),
    "ppermute": lambda x: C.ppermute(x, mesh, "seq", 1),
    "all_to_all": lambda x: C.all_to_all(x, mesh, "seq", 0, 1),
}
for name, xs, ws in %(coll)r:
    x_all = rng.normal(size=(2,) + tuple(xs)).astype(np.float32)
    w_all = rng.normal(size=(2,) + tuple(ws)).astype(np.float32)
    x = torch.tensor(x_all[rank], requires_grad=True)
    (coll[name](x) * torch.tensor(w_all[rank])).sum().backward()
    result[name] = x.grad.tolist()
    x = torch.tensor(x_all[rank], requires_grad=True)
    coll[name](x).sum().backward()
    result[name + "_ones"] = x.grad.tolist()
x = torch.tensor([float(rank), 5.0 - 3 * rank])
result["pmax"] = C.pmax(x, mesh, "seq").tolist()
result["stats"] = C.stats()
"""

_JAX_COLLECTIVES = {
    "psum": lambda x: lax.psum(x, "seq"),
    "pmean": lambda x: lax.pmean(x, "seq"),
    "all_gather_tiled": lambda x: lax.all_gather(x, "seq", axis=0,
                                                 tiled=True),
    "all_gather": lambda x: lax.all_gather(x, "seq", axis=0),
    "ppermute": lambda x: lax.ppermute(x, "seq", [(0, 1), (1, 0)]),
    "all_to_all": lambda x: lax.all_to_all(x, "seq", 0, 1, tiled=True),
}


def _jax_rank_grads(fn, x_all, w_all, mesh):
    """Each device's gradient of its own ``sum(fn(x) * w)`` inside
    ``shard_map(check_vma=False)`` (the transformer step's semantics)."""
    def per(x, w):
        x, w = x[0], w[0]
        return jax.grad(lambda x: (fn(x) * w).sum())(x)[None]

    g = jax.jit(shard_map(per, mesh=mesh, in_specs=(P("seq"), P("seq")),
                          out_specs=P("seq"), check_vma=False))(x_all, w_all)
    return np.asarray(g)


def _jax_attention(name, causal, q, k, v, w, mesh):
    fn = {"ring": JR.ring_attention, "ring_zigzag": JR.zigzag_ring_attention,
          "ulysses": JU.ulysses_attention}[name]
    spec = P(None, None, "seq", None)
    sharded = shard_map(lambda q, k, v: fn(q, k, v, "seq", causal=causal),
                        mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                        check_vma=False)
    return _jax_out_and_grads(sharded, q, k, v, w)


def test_two_ranks_attention_and_collectives_match_jax(tmp_path):
    body = _BODY % dict(shape=ATT_SHAPE, att_seed=ATT_SEED,
                        coll_seed=COLL_SEED, coll=COLLECTIVES)
    ranks = run_ranks(tmp_path, 2, body)
    assert [(r["index"], r["size"]) for r in ranks] == [(0, 2), (1, 2)]
    mesh = jmake_mesh({"seq": 2}, devices=jax.devices()[:2])
    Sl = ATT_SHAPE[2] // 2
    rng = np.random.default_rng(ATT_SEED)
    q, k, v, w = (rng.normal(size=ATT_SHAPE).astype(np.float32)
                  for _ in range(4))
    for name in ("ring", "ring_zigzag", "ulysses"):
        arrs = [q, k, v, w]
        if name == "ring_zigzag":
            arrs = [JR.zigzag_permute(a, 2, axis=2) for a in arrs]
        for causal in (True, False):
            out, grads = _jax_attention(name, causal, *arrs, mesh)
            for r, res in enumerate(ranks):
                got = [np.asarray(a) for a in res[f"{name}_{causal}"]]
                sl = slice(r * Sl, (r + 1) * Sl)
                _close(got[0], out[:, :, sl], OUT_ATOL)
                for g, h in zip(got[1:], grads):
                    assert np.isfinite(g).all()
                    _close(g, h[:, :, sl], GRAD_ATOL)
    rng = np.random.default_rng(COLL_SEED)
    for name, xs, ws in COLLECTIVES:
        x_all = rng.normal(size=(2,) + xs).astype(np.float32)
        w_all = rng.normal(size=(2,) + ws).astype(np.float32)
        fn = _JAX_COLLECTIVES[name]
        want = _jax_rank_grads(fn, x_all, w_all, mesh)
        ones = _jax_rank_grads(fn, x_all, np.ones_like(w_all), mesh)
        for r, res in enumerate(ranks):
            _close(np.asarray(res[name]), want[r], 1e-6)
            np.testing.assert_array_equal(np.asarray(res[name + "_ones"]),
                                          ones[r])
    # the Motivation's two probes: 2 per element, not 1
    for r in ranks:
        assert np.all(np.asarray(r["psum_ones"]) == 2.0)
        assert np.all(np.asarray(r["all_gather_tiled_ones"]) == 2.0)
        assert r["pmax"] == [1.0, 5.0]
        # one exchange of K and V together per ring step: 2 strategies x
        # 2 masks, forward and backward, plus the ppermute probe's two
        assert r["stats"]["ppermute"]["calls"] == 2 * 2 * 2 + 2 * 2

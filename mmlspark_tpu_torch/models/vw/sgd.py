"""Hashed SGD on the device — the VW training loop as torch ops.

Counterpart of ``mmlspark_tpu/models/vw/sgd.py``. The reference drives VW's
C++ online SGD example by example over JNI (reference:
vw/VowpalWabbitBase.scala:235-266 ``trainRow``; multi-pass via native cache
files :336-341; distributed AllReduce of the weight vector over a
driver-hosted spanning tree :401-429). The JAX package scans minibatches of
padded sparse rows in one compiled program; here the same steps run as a
host loop over minibatches that stay on the device: gather the weights by
hashed index, compute the loss gradient, scatter-add the update into the
``2^numBits`` table. Each rank of the data group (``parallel/mesh.Mesh``)
trains its replica on its rows; the replicas are averaged by one
``all_reduce`` at every pass end (the JAX ``pmean``; the identity on one
rank).

Adaptive (AdaGrad) updates mirror VW's ``--adaptive``; ``adaptive=False``
decays the rate as ``1 / (t + 1) ** power_t``. L1 is VW's lazy truncated
gradient: each weight shrinks by ``lr * l1`` per elapsed step, applied at
touch time from a per-weight last-touch clock and caught up at pass ends.
``--bfgs`` switches to a full-batch L-BFGS (two-loop recursion, Armijo
backtracking) whose objective and gradient are one ``all_reduce`` per
evaluation; its line search reads one scalar back to the host per trial.

Scatter-adds go through :func:`scatter_add` (``index_put_`` with
``accumulate=True``): on CUDA it sorts the indices and sums each run of
equal ones in a fixed order, so equal inputs give equal bits on the card
(``index_add_`` sums duplicates with float atomics in no fixed order). Every
row carries VW's constant feature, so each batch adds ``batch_size`` times
into one cell. That keeps the JAX package's promises on the card: a
streamed fit equals the in-memory fit on one rank, and a resumed fit the
uninterrupted one on the same rank count, bit for bit.
"""

from __future__ import annotations

import threading
import zlib
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from ...parallel import mesh as meshlib
from ...parallel import placement
from ...utils.profiling import annotate


class SGDConfig(NamedTuple):
    num_bits: int = 18
    loss: str = "squared"  # squared | logistic | hinge | quantile
    learning_rate: float = 0.5
    power_t: float = 0.5          # lr decay exponent (VW default)
    initial_t: float = 0.0
    l1: float = 0.0
    l2: float = 0.0
    adaptive: bool = True
    num_passes: int = 1
    batch_size: int = 128
    quantile_tau: float = 0.5
    link: str = "identity"
    optimizer: str = "sgd"        # sgd | bfgs (VW --bfgs)


_EPS = 1e-6


def _loss_grad(loss: str, pred, y, tau: float):
    """d(loss)/d(prediction). Labels: classifier y in {0,1}; regressor real."""
    if loss == "squared":
        return pred - y
    if loss == "logistic":
        return torch.sigmoid(pred) - y
    if loss == "hinge":
        s = 2.0 * y - 1.0
        return torch.where(s * pred < 1.0, -s, torch.zeros_like(s))
    if loss == "quantile":
        d = pred - y
        return torch.where(d >= 0, torch.full_like(d, 1.0 - tau),
                           torch.full_like(d, -tau))
    raise ValueError(f"unknown loss {loss!r}")


def _loss_value(loss: str, pred, y, tau: float):
    """Pointwise loss values (L-BFGS needs objectives, not just gradients)."""
    if loss == "squared":
        return 0.5 * (pred - y) ** 2
    if loss == "logistic":
        s = 2.0 * y - 1.0
        return torch.nn.functional.softplus(-s * pred)
    if loss == "hinge":
        s = 2.0 * y - 1.0
        return torch.clamp(1.0 - s * pred, min=0.0)
    if loss == "quantile":
        d = pred - y
        return torch.where(d >= 0, (1.0 - tau) * d, -tau * d)
    raise ValueError(f"unknown loss {loss!r}")


def scatter_add(table: torch.Tensor, idx: torch.Tensor,
                upd: torch.Tensor) -> torch.Tensor:
    """``table[idx] += upd`` in place, duplicates summed in a fixed order
    (in index order on the CPU; sorted runs on CUDA)."""
    return table.index_put_((idx,), upd, accumulate=True)


def _margins(w: torch.Tensor, idx: torch.Tensor,
             val: torch.Tensor) -> torch.Tensor:
    """``sum_j w[idx[:, j]] * val[:, j]`` per row."""
    return (w.index_select(0, idx.reshape(-1)).view(idx.shape)
            * val).sum(dim=1)


class Prepped(NamedTuple):
    """A rank's padded rows on the device, reused across passes and calls."""
    idx: torch.Tensor   # [n_local, nnz] int64
    val: torch.Tensor   # [n_local, nnz] f32
    y: torch.Tensor     # [n_local] f32
    sw: torch.Tensor    # [n_local] f32 (0 on padded rows)


def _prep_sgd_data(indices: np.ndarray, values: np.ndarray,
                   labels: np.ndarray, sample_weight: Optional[np.ndarray],
                   cfg: SGDConfig, mesh: meshlib.Mesh,
                   device: torch.device) -> Prepped:
    """Pad rows to a whole number of batches per rank and move this rank's
    slice to the device once (the JAX ``_prep_sgd_data``'s layout: rank
    ``r`` of ``k`` holds padded rows ``[r n_pad / k, (r + 1) n_pad / k)``)."""
    n = indices.shape[0]
    sw = np.ones(n, np.float32) if sample_weight is None else np.asarray(
        sample_weight, np.float32)
    nshards = meshlib.num_shards(mesh)
    placement.plan_for("vw.fit", mesh=mesh, rows=n, device=device)
    mult = nshards * cfg.batch_size
    idx_p, _ = meshlib.pad_rows(np.asarray(indices).astype(np.int64), mult)
    val_p, _ = meshlib.pad_rows(np.asarray(values, np.float32), mult)
    y_p, _ = meshlib.pad_rows(np.asarray(labels, np.float32), mult)
    sw_p, _ = meshlib.pad_rows(sw, mult)
    sw_p = sw_p * meshlib.validity_mask(n, len(sw_p))  # pads learn nothing
    return Prepped(*(placement.shard_rows(a, mesh, device=device)[0]
                     for a in (idx_p, val_p, y_p, sw_p)))


def _pmean(t: torch.Tensor, mesh: meshlib.Mesh) -> torch.Tensor:
    if mesh.size == 1:
        return t
    return mesh.all_reduce(t) / mesh.size


def _shrink(wv, pending, cfg: SGDConfig):
    """Lazy L1: ``wv`` shrunk by ``lr * l1`` per pending step."""
    return torch.sign(wv) * torch.clamp(
        torch.abs(wv) - (cfg.learning_rate * cfg.l1) * pending, min=0.0)


def _batch_step(cfg: SGDConfig, w, g2, lt, t, bi, bv, by, bw) -> None:
    """One minibatch step (the JAX ``batch_step``), in place on ``w``,
    ``g2`` and ``lt``. ``t`` is the step clock: a host float (f32-valued)
    in the eager loop, a 0-d f32 tensor on the device in a captured
    graph."""
    lr = cfg.learning_rate
    flat_i = bi.reshape(-1)
    if cfg.l1 > 0:
        # lazy truncated gradient: catch the touched weights up on their
        # skipped steps BEFORE predicting/updating
        pending = torch.clamp(t - lt.index_select(0, flat_i), min=0.0)
        wv = _shrink(w.index_select(0, flat_i), pending, cfg)
        w.index_put_((flat_i,), wv)
        if isinstance(t, torch.Tensor):
            lt.index_put_((flat_i,), t.expand(flat_i.shape[0]))
        else:
            lt.index_fill_(0, flat_i, t)
        pred = (wv.view(bi.shape) * bv).sum(dim=1)
    else:
        pred = _margins(w, bi, bv)
    gp = _loss_grad(cfg.loss, pred, by, cfg.quantile_tau) * bw
    flat_g = (gp[:, None] * bv).reshape(-1)
    if cfg.adaptive:
        scatter_add(g2, flat_i, flat_g * flat_g)
        scale = torch.rsqrt(g2.index_select(0, flat_i) + _EPS)
    elif isinstance(t, torch.Tensor):
        scale = 1.0 / torch.pow(t + 1.0, cfg.power_t)
    else:
        # f32 arithmetic, as the JAX scan's f32 clock
        scale = float(np.float32(1.0) / np.power(
            np.float32(t + 1.0), np.float32(cfg.power_t)))
    if cfg.l2 > 0:
        w.mul_(1.0 - lr * cfg.l2)
    scatter_add(w, flat_i, flat_g * -lr * scale)


# two threads may not capture at once (a capture registers the generator's
# state); fit_multiple's threads take turns here
_CAPTURE_LOCK = threading.Lock()


def capture_graph(body, state: Sequence[torch.Tensor],
                  device: torch.device) -> "torch.cuda.CUDAGraph":
    """``body`` captured as a CUDA graph. It runs once eagerly on a side
    stream first (lazy initialisation stays out of the capture); ``state``,
    every tensor ``body`` updates in place, is then put back, so the
    capture starts from the state the caller passed."""
    with _CAPTURE_LOCK:
        saved = [a.clone() for a in state]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream(device).wait_stream(side)
        for a, v in zip(state, saved):
            a.copy_(v)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            body()
    return graph


class _StepGraph:
    """One minibatch step captured as a CUDA graph over a rank's
    device-resident batches: a device counter picks the batch and the
    device clock ``t`` advances inside the graph, so a pass is ``nb``
    replays of one graph (one launch each) instead of some 45 kernel
    launches a step from the host. The state tensors are the graph's
    static inputs and are updated in place."""

    def __init__(self, prepped: Prepped, cfg: SGDConfig, w, g2, lt,
                 t: float):
        idx, val, y, sw = prepped
        bs, nnz = cfg.batch_size, idx.shape[1]
        self.nb = idx.shape[0] // bs
        batches = (idx.view(self.nb, bs, nnz), val.view(self.nb, bs, nnz),
                   y.view(self.nb, bs), sw.view(self.nb, bs))
        dev = w.device
        self.b = torch.zeros(1, dtype=torch.int64, device=dev)
        self.t = torch.tensor(t, dtype=torch.float32, device=dev)

        def body():
            bi, bv, by, bw = (a.index_select(0, self.b)[0] for a in batches)
            _batch_step(cfg, w, g2, lt, self.t, bi, bv, by, bw)
            self.t.add_(1.0)
            self.b.add_(1)

        self.graph = capture_graph(body, (w, g2, lt, self.t, self.b), dev)

    def run_pass(self) -> None:
        self.b.zero_()
        for _ in range(self.nb):
            self.graph.replay()


def _sgd_passes(prepped: Prepped, cfg: SGDConfig, mesh: meshlib.Mesh,
                w: torch.Tensor, g2: torch.Tensor, t: float,
                lt: torch.Tensor, graph: Optional[bool] = None):
    """``cfg.num_passes`` passes of minibatch steps over a rank's rows
    (the JAX ``local_train``); returns ``(w, g2, t, lt)``. On CUDA the
    step runs as one captured graph (:class:`_StepGraph`; ``graph=False``
    keeps the eager loop), on the CPU eagerly."""
    idx, val, y, sw = prepped
    bs = cfg.batch_size
    nb = idx.shape[0] // bs
    if graph is None:
        graph = w.is_cuda
    step = None
    for _ in range(cfg.num_passes):
        t = float(np.float32(t))
        if graph and nb:
            if step is None:
                step = _StepGraph(prepped, cfg, w, g2, lt, t)
            step.run_pass()
            t = float(np.float32(t + nb))
        else:
            for b in range(nb):
                rows = slice(b * bs, (b + 1) * bs)
                _batch_step(cfg, w, g2, lt, t, idx[rows], val[rows], y[rows],
                            sw[rows])
                t = float(np.float32(t + 1.0))
        if cfg.l1 > 0:
            # pass-end catch-up so the averaged replicas agree exactly
            w.copy_(_shrink(w, torch.clamp(t - lt, min=0.0), cfg))
            lt.fill_(t)
        if mesh.size > 1:
            w.copy_(_pmean(w, mesh))
            g2.copy_(_pmean(g2, mesh))
    return w, g2, t, lt


def _as_f32(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32).clone()
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def train_sgd(indices: np.ndarray, values: np.ndarray, labels: np.ndarray,
              sample_weight: Optional[np.ndarray], cfg: SGDConfig,
              mesh: Optional[meshlib.Mesh] = None,
              initial_weights: Optional[np.ndarray] = None,
              initial_state: Optional[tuple] = None,
              return_state: bool = False,
              prepped: Optional[Prepped] = None,
              device: DeviceLike = None):
    """Train a hashed linear model; returns the weight vector
    ``[2^num_bits]`` (numpy).

    ``initial_state``/``return_state`` carry the optimizer state
    ``(weights, adagrad accumulators, step counter, lazy-L1 clock)`` across
    calls, as numpy, so pass-level checkpoint/resume and streamed chunks
    reproduce an uninterrupted run exactly. ``prepped`` (from
    :func:`_prep_sgd_data`) skips the per-call pad and upload."""
    dev = resolve_device(device)
    mesh = mesh or meshlib.get_default_mesh()
    D = 1 << cfg.num_bits
    if prepped is None:
        prepped = _prep_sgd_data(indices, values, labels, sample_weight,
                                 cfg, mesh, dev)
    # the lazy-L1 clock is read only when l1 > 0: a 1-element dummy
    # otherwise (the JAX package's checkpoint layout)
    D_lt = D if cfg.l1 > 0 else 1
    if initial_state is not None:
        if len(initial_state) == 3:     # pre-lazy-L1 checkpoint format
            w_raw, g2_0, t_0 = initial_state
            lt_0 = None
        else:
            w_raw, g2_0, t_0, lt_0 = initial_state
            if lt_0 is not None and np.shape(lt_0)[0] != D_lt:
                # saved under another l1 setting: weights are caught up at
                # every pass end, so "last touched now" is exact
                lt_0 = None
        t = float(np.float32(t_0))
        w = _as_f32(w_raw, dev)
        g2 = _as_f32(g2_0, dev)
        lt = (torch.full((D_lt,), t, dtype=torch.float32, device=dev)
              if lt_0 is None else _as_f32(lt_0, dev))
    else:
        w = (torch.zeros(D, dtype=torch.float32, device=dev)
             if initial_weights is None else _as_f32(initial_weights, dev))
        g2 = torch.zeros(D, dtype=torch.float32, device=dev)
        t = float(np.float32(cfg.initial_t))
        lt = torch.full((D_lt,), t, dtype=torch.float32, device=dev)
    with annotate(f"vw_sgd_train:{cfg.num_passes}pass"):
        w, g2, t, lt = _sgd_passes(prepped, cfg, mesh, w, g2, t, lt)
    w_np = w.cpu().numpy()
    if return_state:
        return w_np, (w_np, g2.cpu().numpy(), t, lt.cpu().numpy())
    return w_np


def train_bfgs(indices: np.ndarray, values: np.ndarray, labels: np.ndarray,
               sample_weight: Optional[np.ndarray], cfg: SGDConfig,
               mesh: Optional[meshlib.Mesh] = None,
               initial_weights: Optional[np.ndarray] = None,
               history: int = 10, device: DeviceLike = None,
               trace: Optional[dict] = None) -> np.ndarray:
    """VW ``--bfgs`` parity: full-batch L-BFGS over the hashed linear model.

    ``num_passes`` iterations; each evaluates the global objective and
    gradient with one ``all_reduce`` each over the data group, updates the
    ``[m, D]`` curvature history and line-searches with Armijo
    backtracking (at most 20 halvings). The search's condition and the
    curvature check are read back to the host: one read per trial plus one
    per iteration. L2 regularizes the objective; L1 truncates once after
    the last iteration. ``trace``, when given, receives ``objective`` (per
    iteration, starting with the initial one) and ``readbacks`` (per
    iteration)."""
    dev = resolve_device(device)
    mesh = mesh or meshlib.get_default_mesh()
    D = 1 << cfg.num_bits
    idx, val, y, sw = _prep_sgd_data(indices, values, labels, sample_weight,
                                     cfg, mesh, dev)
    flat_i = idx.reshape(-1)
    m = int(history)
    iters = max(int(cfg.num_passes), 1)
    w = (torch.zeros(D, dtype=torch.float32, device=dev)
         if initial_weights is None else _as_f32(initial_weights, dev))
    wsum = mesh.all_reduce(sw.sum())

    def obj_grad(w):
        pred = _margins(w, idx, val)
        lv = _loss_value(cfg.loss, pred, y, cfg.quantile_tau)
        gp = _loss_grad(cfg.loss, pred, y, cfg.quantile_tau) * sw
        loss = mesh.all_reduce((lv * sw).sum()) / wsum
        grad = scatter_add(torch.zeros(D, dtype=torch.float32, device=dev),
                           flat_i, (gp[:, None] * val).reshape(-1))
        grad = mesh.all_reduce(grad) / wsum
        if cfg.l2 > 0:
            loss = loss + 0.5 * cfg.l2 * torch.sum(w * w)
            grad = grad + cfg.l2 * w
        return loss, grad

    S = torch.zeros((m, D), dtype=torch.float32, device=dev)
    Y = torch.zeros((m, D), dtype=torch.float32, device=dev)
    rho = torch.zeros(m, dtype=torch.float32, device=dev)
    k = 0

    def two_loop(grad):
        """L-BFGS direction from the curvature history (ring buffer)."""
        q = grad
        alphas = torch.zeros(m, dtype=torch.float32, device=dev)
        live = min(k, m)
        for i in range(live):
            j = (k - 1 - i) % m
            a = rho[j] * torch.dot(S[j], q)
            q = q - a * Y[j]
            alphas[j] = a
        r = q
        if k > 0:
            j_last = (k - 1) % m
            sy = torch.dot(S[j_last], Y[j_last])
            yy = torch.dot(Y[j_last], Y[j_last])
            gamma = torch.where(yy > 0, sy / (yy + 1e-12),
                                torch.ones_like(yy))
            r = gamma * q
        for i in range(live):
            j = (k - live + i) % m
            b = rho[j] * torch.dot(Y[j], r)
            r = r + (alphas[j] - b) * S[j]
        return r

    f, g = obj_grad(w)
    objective = [float(f)] if trace is not None else None
    readbacks = []
    for _ in range(iters):
        d = -two_loop(g)
        gtd = torch.dot(g, d)
        # fall back to steepest descent if the direction lost descent
        use_sd = gtd >= 0
        d = torch.where(use_sd, -g, d)
        gtd = torch.where(use_sd, -torch.dot(g, g), gtd)
        step, tries, reads = 1.0, 0, 0
        wnew = w + d
        fnew, gnew = obj_grad(wnew)
        while True:
            # NOT(sufficient decrease): a NaN/inf trial keeps backtracking
            reads += 1
            if bool(fnew <= f + 1e-4 * step * gtd) or tries >= 20:
                break
            step *= 0.5
            wnew = w + step * d
            fnew, gnew = obj_grad(wnew)
            tries += 1
        s_vec = wnew - w
        y_vec = gnew - g
        sy = torch.dot(s_vec, y_vec)
        reads += 1
        if bool(sy > 1e-10):                  # curvature condition
            j = k % m
            S[j] = s_vec
            Y[j] = y_vec
            rho[j] = 1.0 / (sy + 1e-12)
            k += 1
        w, f, g = wnew, fnew, gnew
        if trace is not None:
            objective.append(float(f))
        readbacks.append(reads)
    if cfg.l1 > 0:
        w = torch.sign(w) * torch.clamp(torch.abs(w) - cfg.l1, min=0.0)
    if trace is not None:
        trace["objective"] = objective
        trace["readbacks"] = readbacks
    return w.cpu().numpy()


def train_sgd_checkpointed(indices: np.ndarray, values: np.ndarray,
                           labels: np.ndarray,
                           sample_weight: Optional[np.ndarray],
                           cfg: SGDConfig, checkpoint_dir: str,
                           mesh: Optional[meshlib.Mesh] = None,
                           initial_weights: Optional[np.ndarray] = None,
                           device: DeviceLike = None) -> np.ndarray:
    """Multi-pass SGD with pass-level checkpoint/resume.

    Each pass runs as one call whose full optimizer state (weights, adagrad
    accumulators, step counter, lazy-L1 clock) is checkpointed; resuming
    reproduces the uninterrupted run exactly.

    Over a data group the whole state is a replica after every pass: the
    weights and accumulators are averaged over the group, every rank takes
    the same number of steps (rows pad to whole batches per rank), so the
    step clock agrees, and the lazy-L1 clock is filled with it at the pass
    end (``l1 > 0``) or is a one-element slot nothing reads (``l1 == 0``).
    Rank 0 alone writes it, once, after the ranks have checked that their
    copies agree, and hands it to the group on resume
    (:class:`...utils.checkpoint.GroupCheckpoints`). A resume on another
    rank count loads it, as the JAX package's does."""
    from ...utils.checkpoint import GroupCheckpoints, data_fingerprint

    dev = resolve_device(device)
    mesh = mesh or meshlib.get_default_mesh()
    fingerprint = data_fingerprint(
        indices, values, labels,
        None if sample_weight is None else np.asarray(sample_weight),
        None if initial_weights is None else np.asarray(initial_weights),
        config=cfg._replace(num_passes=0))    # pass count may legally change
    ckpts = GroupCheckpoints(checkpoint_dir, fingerprint, mesh)
    latest = ckpts.latest()
    start_pass, state = 0, None
    if latest is not None:
        _, payload = latest
        start_pass = payload["pass"] + 1
        state = payload["state"]
        if start_pass >= cfg.num_passes:
            raise ValueError(
                f"checkpoint in {checkpoint_dir} already covers "
                f"{start_pass} passes but only {cfg.num_passes} were "
                "requested; clear the directory or raise numPasses")
    one = cfg._replace(num_passes=1)
    prepped = None
    w = initial_weights
    for p in range(start_pass, cfg.num_passes):
        if prepped is None:
            prepped = _prep_sgd_data(indices, values, labels, sample_weight,
                                     one, mesh, dev)
        w, state = train_sgd(indices, values, labels, sample_weight, one,
                             mesh=mesh, initial_weights=w,
                             initial_state=state, return_state=True,
                             prepped=prepped, device=dev)
        if p != cfg.num_passes - 1:
            mesh.check_same(_state_digest(state), "the VW optimizer state")
            ckpts.save(p, {"pass": p, "state": state,
                           "fingerprint": fingerprint})
    return w


def _state_digest(state: tuple) -> tuple:
    """A cheap digest of ``(w, g2, t, lt)``: crc32 of each array's bytes
    and the clock."""
    w, g2, t, lt = state
    return (zlib.crc32(w), zlib.crc32(g2), float(t), zlib.crc32(lt))


DEFAULT_STREAM_CHUNK_ROWS = 262_144


def train_sgd_streamed(index_path, value_path, label_path,
                       weight_path=None, *, cfg: SGDConfig,
                       mesh: Optional[meshlib.Mesh] = None,
                       initial_weights: Optional[np.ndarray] = None,
                       chunk_rows: Optional[int] = None,
                       return_state: bool = False,
                       device: DeviceLike = None):
    """Multi-pass hashed SGD over ``.npy`` shards — larger-than-RAM
    training.

    Each pass replays the shards in order in bounded host chunks, and the
    optimizer state carries across chunk calls through :func:`train_sgd`'s
    ``initial_state``/``return_state``, so a streamed pass IS the in-memory
    pass over the same batches. Paths: each of index/value/label (and
    optional weight) is a ``.npy`` file, a directory of shards, or a list
    (:class:`~..gbdt.ingest.ShardedMatrixSource`). Indices are masked by
    ``2^num_bits`` here, so shards may carry raw 32-bit hashes as int64.

    ``chunk_rows`` is rounded down to a whole number of batch groups
    (``ranks * batch_size``; up to one group if smaller), so every chunk but
    the tail is pad-free and the tail pads where the in-memory path pads.
    On one rank the streamed run is bit-identical to :func:`train_sgd` on
    the concatenated arrays (lazy L1 to float rounding: its catch-up
    composes exactly only in real arithmetic). Over several ranks the
    pass-end average becomes a chunk-end average."""
    from ..gbdt.ingest import ShardedMatrixSource

    dev = resolve_device(device)
    coerce = ShardedMatrixSource.coerce
    idx_src, val_src, y_src = (coerce(index_path), coerce(value_path),
                               coerce(label_path))
    sw_src = None if weight_path is None else coerce(weight_path)
    n = idx_src.n
    lens = {"index": n, "value": val_src.n, "label": y_src.n}
    if sw_src is not None:
        lens["weight"] = sw_src.n
    if len(set(lens.values())) != 1:
        raise ValueError(f"source row counts disagree: {lens}")
    if idx_src.ndim != 2 or val_src.ndim != 2:
        raise ValueError(
            "index/value shards must be 2-D [n, nnz] (got "
            f"{idx_src.ndim}-D / {val_src.ndim}-D); reshape single-feature "
            "data to [n, 1]")
    if idx_src.num_features != val_src.num_features:
        raise ValueError(
            f"index nnz {idx_src.num_features} != value nnz "
            f"{val_src.num_features}")
    if chunk_rows is None:
        chunk_rows = DEFAULT_STREAM_CHUNK_ROWS
    if chunk_rows <= 0:
        raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
    if n == 0:
        raise ValueError("sources contain no rows")
    mesh = mesh or meshlib.get_default_mesh()
    mult = meshlib.num_shards(mesh) * cfg.batch_size
    chunk_rows = max(mult, (chunk_rows // mult) * mult)
    mask = (1 << cfg.num_bits) - 1
    one = cfg._replace(num_passes=1)
    w = (np.zeros(1 << cfg.num_bits, np.float32)
         if initial_weights is None else initial_weights)
    state = None
    for _ in range(cfg.num_passes):
        for start in range(0, n, chunk_rows):
            stop = min(start + chunk_rows, n)
            idx = (idx_src.read(start, stop, dtype=None)
                   .astype(np.int64) & mask)
            val = val_src.read(start, stop)
            y = y_src.read(start, stop)
            sw = None if sw_src is None else sw_src.read(start, stop)
            w, state = train_sgd(idx, val, y, sw, one, mesh=mesh,
                                 initial_weights=w, initial_state=state,
                                 return_state=True, device=dev)
    if return_state:
        return w, state
    return w


def predict_sgd(indices: np.ndarray, values: np.ndarray, weights,
                loss: str = "squared", device: DeviceLike = None
                ) -> np.ndarray:
    """Margin predictions for padded sparse rows (numpy ``[n]`` f32).
    ``weights`` may be a tensor already on the device: a caller scoring
    chunk after chunk keeps the table resident and skips its upload."""
    del loss
    dev = resolve_device(device)
    w = (weights.to(dev) if isinstance(weights, torch.Tensor)
         else torch.from_numpy(np.array(weights, np.float32)).to(dev))
    idx = torch.from_numpy(np.asarray(indices).astype(np.int64)).to(dev)
    val = torch.from_numpy(np.asarray(values, np.float32)).to(dev)
    return _margins(w, idx, val).cpu().numpy()

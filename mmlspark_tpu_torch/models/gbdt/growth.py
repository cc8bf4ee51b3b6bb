"""Tree growth in eager PyTorch: leafwise and depthwise, on one device or
row-sharded over a data group.

Counterpart of ``mmlspark_tpu/models/gbdt/growth.py`` (LightGBM's tree
learner; reference: lightgbm/TrainUtils.scala:246). Trees keep the JAX
package's fixed slot layout, so they pack, save and predict identically:

  * a tree is ``M = 2*num_leaves - 1`` node slots, slot 0 the root;
  * each row carries its current node id (``row_node``), updated by masked
    ``where`` — no repartitioning;
  * :func:`grow_tree` (leafwise, best-first) splits the top ``leaf_batch``
    pending leaves per round by cached gain and builds their children's
    histograms in one pass of the node-histogram kernel;
    :func:`grow_tree_depthwise` splits a whole level per pass, best gains
    first within the ``num_leaves`` budget.

Both take ``quantized_grad`` (LightGBM use_quantized_grad): the stats are
quantized to int8 per tree and every histogram pass runs the int8 kernel,
with exact int32 sums. Both take ``is_cat`` ([F] bool): categorical
features split by LightGBM's sorted-subset search, and the chosen left
subset is kept as a bitset of bins (``Tree.cat_bitset``).

Where the JAX package compiles one program (``fori_loop`` over rounds,
``lax.cond`` to skip finished ones, ``vmap`` over candidates), the port runs
an eager Python loop that stops once no split is left, with the candidate
axis written out as a batch dimension. Every tensor stays on the device of
``binned_t``; the loop reads one boolean per round or level back to the
host, through :func:`host_read`, which counts every such wait in
``host_syncs``. The leafwise loop reads a round's predicate as soon as it
is computed (:class:`_Later`), so the host queues the next round while
the card runs the rest of this one; on one card a fit's leafwise rounds
replay from CUDA graphs (:class:`LeafwiseRounds`).

Per-node state tensors carry one spare slot at index ``M``: writes for
candidates that do not split go there (the JAX package's ``mode="drop"``)
and the slot is cut off when the tree is returned.

With ``group`` (a :class:`...parallel.mesh.Mesh`; the JAX package's
``axis_name``) each rank holds a slice of the rows and the trees are grown
on the collective path, as the JAX package's ``shard_map`` program does:

  * data_parallel: histograms and stat totals are summed over the group
    (``all_reduce``), so every rank takes the same split decisions;
  * ``GrowConfig.hist_blocks`` (the deterministic blocked reduction):
    every row reduction — histograms, totals, leaf renewal — is computed
    per fixed row block, gathered in rank order and folded left to right,
    and quantization derives from global amax and row indices, so every
    world size dividing the block count grows bit-identical trees;
  * ``GrowConfig.voting`` (voting_parallel): ranks vote their ``top_k``
    features and only the top ``2 * top_k`` features' histograms are
    summed; on one rank too, it restricts the split search.

The collective path turns off histogram subtraction (a rank's share of the
globally smaller children has no bound).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ...observability import spans as _spans
from ...ops.histogram import (_INT32_CELL, QUANT_NEAREST, QUANT_POSITIONAL,
                              QUANT_THREEFRY, node_histogram,
                              positional_uniform, quant_q_max,
                              quantize_stats, quantize_stats_cuda,
                              stats_amax_cuda)
from ...utils import prng
from ...ops.histogram_scatter import (NONFINITE_SHIFT, fixed_point_shifts,
                                      pow2)

NEG_INF = float("-inf")
# rows of int8 stats a histogram cell may sum with no range check
_INT8_SAFE_ROWS = _INT32_CELL // 128

# device-to-host reads made through host_read since the process started:
# each one waits for the device to finish the work queued before it
host_syncs = 0


def host_read(read: Callable[[torch.Tensor], Any], t: torch.Tensor) -> Any:
    """``read(t)``, counted in ``host_syncs``: the one way growth and the
    boosting loop read a tensor's value on the host (``bool``, ``int``,
    ``float``, ``torch.Tensor.item``, ``.cpu``, ``.tolist``), each of which
    waits for the device. Counted on every device, so a fit on the CPU
    counts the reads its run on the card would wait on."""
    global host_syncs
    host_syncs += 1
    return read(t)


class _Later:
    """A small device tensor on its way to the host. On the card it is
    copied without blocking into pinned memory behind an event, so that
    :meth:`tolist` waits only for the work queued before the copy and not
    for what the host has queued since; elsewhere it is read at once."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        self._t = t
        if t.is_cuda:
            self._t = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._t.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()

    def tolist(self):
        if self._event is not None:
            self._event.synchronize()
        return self._t.tolist()


class GrowConfig(NamedTuple):
    num_leaves: int = 31
    max_depth: int = -1  # <0: unlimited (bounded by num_leaves chain)
    num_bins: int = 255
    learning_rate: float = 0.1
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    # split the top ``leaf_batch`` pending leaves per histogram pass (see the
    # JAX package's GrowConfig.leaf_batch: batching only reorders splits near
    # num_leaves exhaustion; 1 is strict sequential best-first)
    leaf_batch: int = 8
    # clamp each leaf's raw output (pre-shrinkage) to +-this; 0 disables
    max_delta_step: float = 0.0
    # histogram subtraction: stream only each split's smaller child and
    # derive the larger sibling as parent minus smaller, with the
    # smaller children's rows compacted to the front of a half-width
    # buffer. True | False | "auto" ("auto" resolves through
    # resolve_growth_backend before growth)
    hist_subtraction: "bool | str" = "auto"
    # the compaction's row selector: "searchsorted" (cumsum + binary
    # search), "argsort" (one stable sort of the not-selected key) or
    # "auto" ("searchsorted": the JAX package picks argsort on the TPU
    # only). Both give the same rows in the same order
    compact_selector: str = "auto"
    # "leafwise" (best-first, grow_tree) or "depthwise" (one histogram pass
    # per level, grow_tree_depthwise); train_booster dispatches on it
    growth_policy: str = "leafwise"
    # quantized-gradient histograms (LightGBM use_quantized_grad): grad/hess
    # quantize to int8 per tree, stochastically rounded with the JAX
    # package's uniforms (_quantize_for), and every histogram pass sums
    # them exactly in int32
    quantized_grad: bool = False
    # with quantized_grad: recompute the leaves' grad/hess/count from the
    # f32 stats after growth, so leaf values carry no quantization error
    # (LightGBM quant_train_renew_leaf)
    quant_renew_leaf: bool = True
    # with quantized_grad: boosting iterations below this grow at full
    # precision (train_booster applies it)
    quant_warmup_iters: int = 2
    # voting_parallel (reference: lightgbm/LightGBMParams.scala:13-27):
    # ranks vote their locally best top_k features; only the top 2*top_k
    # features' histograms are summed and searched
    voting: bool = False
    top_k: int = 20
    # the deterministic blocked reduction (topology-independent training):
    # 0 = plain all-reduce; k >= 2 computes every row reduction per fixed
    # row block, folded in block order, so world sizes dividing k grow
    # bit-identical trees; "auto" resolves through
    # parallel.placement.resolve_hist_blocks (MMLSPARK_TPU_HIST_BLOCKS)
    # before training, and reaching growth unresolved it is 0
    hist_blocks: "int | str" = "auto"
    # categorical splits (LightGBM cat_smooth / max_cat_threshold): category
    # bins are ordered by the smoothed ratio g / (h + cat_smooth) and their
    # prefixes, up to max_cat_threshold bins long, scanned as left subsets
    cat_smooth: float = 10.0
    max_cat_threshold: int = 32


def resolve_growth_backend(cfg: GrowConfig) -> GrowConfig:
    """Resolve ``hist_subtraction`` and ``compact_selector`` ``"auto"`` to
    concrete values.

    A GPU takes the JAX package's non-TPU rule: ``hist_subtraction``
    ``"auto"`` -> True, ``compact_selector`` ``"auto"`` -> "searchsorted".
    Idempotent; validates the fields."""
    hs, cs = cfg.hist_subtraction, cfg.compact_selector
    if cs not in ("auto", "argsort", "searchsorted"):
        raise ValueError(
            f"compact_selector must be 'auto', 'argsort' or 'searchsorted',"
            f" got {cs!r}")
    if hs != "auto" and not isinstance(hs, bool):
        raise ValueError(
            f"hist_subtraction must be True, False or 'auto', got {hs!r}")
    if cfg.growth_policy not in ("leafwise", "depthwise"):
        raise ValueError(f"growth_policy must be 'leafwise' or 'depthwise', "
                         f"got {cfg.growth_policy!r}")
    return cfg._replace(hist_subtraction=True if hs == "auto" else hs,
                        compact_selector=("searchsorted" if cs == "auto"
                                          else cs))


def _blocked(cfg: GrowConfig) -> bool:
    hb = cfg.hist_blocks
    return isinstance(hb, int) and not isinstance(hb, bool) and hb > 1


def _hist_block_geometry(cfg: GrowConfig, group, n: int):
    """(blocks_local, rows_per_block) for the blocked reduction; (0, n) on
    the plain path. Raises when a pinned block count cannot tile this
    rank's rows (train_booster resolves these cases up front via
    placement.resolve_hist_blocks; direct growth callers fail loudly)."""
    if not _blocked(cfg):
        return 0, n
    hb = cfg.hist_blocks
    if cfg.voting:
        raise ValueError(
            "hist_blocks does not compose with voting_parallel (the "
            "shard-local ballot is inherently topology-dependent)")
    size = 1 if group is None else group.size
    if hb % size:
        raise ValueError(
            f"hist_blocks={hb} is not a multiple of the {size}-shard data "
            "axis")
    bl = hb // size
    if n % bl:
        raise ValueError(
            f"shard row count {n} does not tile into {bl} blocks "
            f"(hist_blocks={hb} over {size} shards)")
    return bl, n // bl


def _blocked_fold(parts: torch.Tensor, group) -> torch.Tensor:
    """Gather the ranks' block partials (``[blocks_local, ...]``) into
    canonical block order and fold them left to right: ``acc = p[0]``,
    then ``acc = acc + p[j]``, an explicit order no reduction kernel
    chooses."""
    if group is not None:
        parts = group.all_gather(parts)
    acc = parts[0]
    for j in range(1, parts.shape[0]):
        acc = acc + parts[j]
    return acc


def _exact_block_sums(x: torch.Tensor, blocks: int,
                      seg: Optional[torch.Tensor] = None,
                      segments: int = 1) -> torch.Tensor:
    """``[blocks, C, segments]`` f32: the sums of ``x`` ([C, n] f32) over
    each of ``blocks`` consecutive row blocks (and, with ``seg`` [n] in
    [0, segments), over each segment id in it), each the exact sum rounded
    once to f32 — bits that no summation order, device or layout moves.

    The blocked reduction needs that: a float ``sum`` or ``index_add_``
    on a GPU adds in an order that depends on the launch (and on the
    slice's alignment), which would make a fit's leaves differ between
    runs and world sizes. Each (channel, block) is summed as int64 fixed
    point at the deterministic mode's shifts (:func:`fixed_point_shifts`),
    exactly. A block whose values are not all finite sums to NaN."""
    C, n = x.shape
    rpb = n // blocks
    xb = x.reshape(C, blocks, rpb).to(torch.float64)
    shift = fixed_point_shifts(xb.abs().amax(dim=2), rpb)      # [C, blocks]
    finite = shift != NONFINITE_SHIFT
    shift = torch.where(finite, shift, 0)
    q = torch.round(xb * pow2(shift)[:, :, None]).to(torch.int64)
    if seg is None:
        acc = q.sum(dim=2, keepdim=True)
    else:
        ids = (seg.reshape(blocks, rpb)
               + torch.arange(blocks, device=seg.device)[:, None] * segments)
        acc = torch.zeros((C, blocks * segments), dtype=torch.int64,
                          device=x.device)
        acc.index_add_(1, ids.reshape(-1), q.reshape(C, n))
        acc = acc.reshape(C, blocks, segments)
    inv = torch.where(finite, pow2(-shift), float("nan"))
    out = acc.to(torch.float64) * inv[..., None]
    return out.to(torch.float32).permute(1, 0, 2).contiguous()


class Tree(NamedTuple):
    """Fixed-shape tree: node slot 0 is the root; unused slots are inert
    leaves. Same fields, in the same order, as the JAX package's ``Tree``.
    ``cat_bitset`` holds the uint32 words of the JAX layout in int64 (CUDA
    has few uint32 ops); the Booster stores them as uint32."""
    feat: torch.Tensor        # [M] int32 split feature (internal nodes)
    thr_bin: torch.Tensor     # [M] int32 split bin ("go left if bin <= thr")
    left: torch.Tensor        # [M] int32 child ids
    right: torch.Tensor       # [M] int32
    is_leaf: torch.Tensor     # [M] bool
    leaf_value: torch.Tensor  # [M] f32 (shrinkage already applied)
    node_count: torch.Tensor  # [] int32 — nodes actually allocated
    node_grad: torch.Tensor   # [M] f32 sum of gradients in node
    node_hess: torch.Tensor   # [M] f32
    node_cnt: torch.Tensor    # [M] f32
    split_gain: torch.Tensor  # [M] f32 gain of the split at internal nodes
    node_value: torch.Tensor  # [M] f32 expected value at every node
    cat_bitset: torch.Tensor  # [M, BW] int64 left-subset bitset of bins
    #                           (categorical splits; all-zero: numeric split)


def _soft_threshold(g, l1):
    return torch.sign(g) * torch.clamp(torch.abs(g) - l1, min=0.0)


def _leaf_objective(g, h, cfg):
    sg = _soft_threshold(g, cfg.lambda_l1)
    return sg * sg / (h + cfg.lambda_l2 + 1e-38)


def _feature_best_gains(hist: torch.Tensor, fm: torch.Tensor,
                        cfg: GrowConfig) -> torch.Tensor:
    """[K, F] best local split gain per node and feature from local
    ``[K, F, 3, B]`` histograms, node totals taken from the histograms
    themselves — a rank's vote under voting_parallel."""
    B = hist.shape[-1]
    gl = torch.cumsum(hist[:, :, 0, :], dim=-1)
    hl = torch.cumsum(hist[:, :, 1, :], dim=-1)
    cl = torch.cumsum(hist[:, :, 2, :], dim=-1)
    tg, th, tc = gl[..., -1:], hl[..., -1:], cl[..., -1:]
    gr, hr, cr = tg - gl, th - hl, tc - cl
    gain = (_leaf_objective(gl, hl, cfg) + _leaf_objective(gr, hr, cfg)
            - _leaf_objective(tg, th, cfg))
    ok = ((cl >= cfg.min_data_in_leaf) & (cr >= cfg.min_data_in_leaf)
          & (hl >= cfg.min_sum_hessian_in_leaf)
          & (hr >= cfg.min_sum_hessian_in_leaf) & fm[None, :, None])
    ok[..., B - 1] = False
    return torch.where(ok, gain, torch.full_like(gain, NEG_INF)).amax(dim=-1)


def _voting_select(h: torch.Tensor, feat_mask: torch.Tensor,
                   cfg: GrowConfig, group, W: int):
    """voting_parallel feature selection (LightGBMParams.scala:13-27): each
    rank votes its ``top_k`` features by best local gain (max over the
    ``W`` frontier nodes), the votes are summed, and only the global top
    ``2 * top_k`` features' histograms are summed — scattered back into a
    zeroed ``[F, 3W, B]`` array. Ties go to the lower feature index, as
    ``lax.top_k``'s do. Returns (h_global, selected [F] bool)."""
    F, _, B = h.shape
    hw = h.reshape(F, W, 3, B).permute(1, 0, 2, 3)
    g = _feature_best_gains(hw, feat_mask, cfg).amax(dim=0)         # [F]
    k = min(int(cfg.top_k), F)
    top_g, local_top = torch.sort(g, descending=True, stable=True)
    top_g, local_top = top_g[:k], local_top[:k]
    # a rank with no feasible split (all -inf: small nodes at deep
    # levels) casts no votes for the arbitrary indices the sort returns
    ballots = (top_g > NEG_INF).to(torch.float32)
    votes = torch.zeros(F, dtype=torch.float32, device=h.device)
    votes.index_add_(0, local_top, ballots)
    if group is not None:
        votes = group.all_reduce(votes)
    sel = torch.sort(torch.sort(votes, descending=True, stable=True)
                     .indices[:min(2 * k, F)]).values
    hsel = h[sel]
    if group is not None:
        hsel = group.all_reduce(hsel)
    hfull = torch.zeros_like(h)
    hfull[sel] = hsel
    mask = torch.zeros(F, dtype=torch.bool, device=h.device)
    mask[sel] = True
    return hfull, mask


def bitset_words(num_bins: int) -> int:
    """Words of a bitset over ``num_bins`` bins: ceil(num_bins / 32)."""
    return -(-int(num_bins) // 32)


def _pack_bits(member: torch.Tensor) -> torch.Tensor:
    """[..., B] bool -> [..., ceil(B/32)] int64 words (bit ``b % 32`` of word
    ``b // 32`` is bin ``b``; each word's value is the JAX layout's uint32)."""
    B = member.shape[-1]
    BW = bitset_words(B)
    m = torch.nn.functional.pad(member.to(torch.int64), (0, BW * 32 - B))
    m = m.reshape(*member.shape[:-1], BW, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=member.device)
    return (m << shifts).sum(dim=-1)


def _word_bit(word: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Bit ``idx % 32`` of each int64 ``word``, as bool."""
    return ((word >> (idx & 31)) & 1).to(torch.bool)


def bit_test(bits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """bits: [..., BW] int64 words; idx: [...] integer bin ids (< 32*BW):
    membership, broadcast over the leading dims."""
    idx = idx.long()
    word = bits.gather(-1, (idx >> 5)[..., None])[..., 0]
    return _word_bit(word, idx)


def _best_split(hist, tot_g, tot_h, tot_c, cfg: GrowConfig, feat_mask, allow,
                is_cat=None):
    """Best split of K nodes from their histograms, numeric or categorical.

    hist: [K, F, 3, B] (grad, hess, count per bin); tot_*: [K] node totals;
    feat_mask: [F] bool; allow: [K] bool. Numeric features split "bin <= b"
    for b in [0, B-2]. Categorical features (``is_cat`` [F] bool) take
    LightGBM's sorted-subset search: bins ordered by the smoothed ratio
    g / (h + cat_smooth) (empty bins last, as +inf; ties in bin order, as
    the stable ``jnp.argsort``), prefixes of at most ``max_cat_threshold``
    bins scanned as left subsets. Returns [K]-shaped (gain, feat, bin,
    left_g, left_h, left_c) and the winner's [K, BW] int64 bitset (zero for
    a numeric winner); gain is -inf where no split is allowed. Ties go to
    the lowest flat (feature, bin) index, as ``jnp.argmax`` does.
    """
    K, F, _, B = hist.shape
    g, h, c = hist[:, :, 0, :], hist[:, :, 1, :], hist[:, :, 2, :]
    gl = torch.cumsum(g, dim=-1)                                # [K, F, B]
    hl = torch.cumsum(h, dim=-1)
    cl = torch.cumsum(c, dim=-1)
    ok_extra = feat_mask[None, :, None] & allow[:, None, None]
    if is_cat is not None:
        ratio = torch.where(c > 0, g / (h + cfg.cat_smooth),
                            torch.full_like(g, float("inf")))
        order = torch.argsort(ratio, dim=-1, stable=True)       # [K, F, B]
        ar = torch.arange(B, device=hist.device)
        rank = torch.empty_like(order).scatter_(
            -1, order, ar.expand(K, F, B).contiguous())
        icat = is_cat[None, :, None]
        gl = torch.where(icat, torch.cumsum(g.gather(-1, order), dim=-1), gl)
        hl = torch.where(icat, torch.cumsum(h.gather(-1, order), dim=-1), hl)
        cl = torch.where(icat, torch.cumsum(c.gather(-1, order), dim=-1), cl)
        ok_extra = ok_extra & (~icat | (ar < int(cfg.max_cat_threshold)))
    tg, th, tc = (t.reshape(K, 1, 1) for t in (tot_g, tot_h, tot_c))
    gr, hr, cr = tg - gl, th - hl, tc - cl
    gain = (_leaf_objective(gl, hl, cfg) + _leaf_objective(gr, hr, cfg)
            - _leaf_objective(tg, th, cfg))
    ok = ((cl >= cfg.min_data_in_leaf) & (cr >= cfg.min_data_in_leaf)
          & (hl >= cfg.min_sum_hessian_in_leaf)
          & (hr >= cfg.min_sum_hessian_in_leaf) & ok_extra)
    ok[:, :, B - 1] = False                   # last bin: empty right side
    gain = torch.where(ok, gain, torch.full_like(gain, NEG_INF))
    flat = torch.argmax(gain.reshape(K, F * B), dim=1)        # [K]
    f, b = flat // B, flat % B

    def pick(a):
        return a.reshape(K, F * B).gather(1, flat[:, None])[:, 0]

    if is_cat is None:
        bits = torch.zeros((K, bitset_words(B)), dtype=torch.int64,
                           device=hist.device)
    else:
        rank_f = rank.gather(1, f[:, None, None].expand(K, 1, B))[:, 0]
        bits = _pack_bits(is_cat[f][:, None] & (rank_f <= b[:, None]))
    return (pick(gain), f.to(torch.int32), b.to(torch.int32), pick(gl),
            pick(hl), pick(cl), bits)


def _route_rows_to_children(binned_t, row_node, slots, do, feats, bins_,
                            bits_k, lid, is_cat=None):
    """[K, n] row routing for one batched round or level: rows whose node
    is a splitting candidate move to its left/right child slot (``lid``/
    ``lid + 1``); a categorical candidate (``is_cat[feat]``) sends a row
    left when its bin is in the candidate's bitset (``bits_k`` [K, BW]).
    Returns (new_row_node, move [K, n], goleft_k [K, n])."""
    move = (row_node[None, :] == slots[:, None]) & do[:, None]
    # widen narrow bin storage once into a [K, n] transient (K is small)
    rows = binned_t.index_select(0, feats.long()).to(torch.int32)
    goleft_k = rows <= bins_[:, None]
    if is_cat is not None:
        rows_l = rows.long()
        member = _word_bit(bits_k.gather(1, rows_l >> 5), rows_l)
        goleft_k = torch.where(is_cat[feats.long()][:, None], member,
                               goleft_k)
    in_any = move.any(dim=0)
    go_left_row = (move & goleft_k).any(dim=0)
    lid_row = torch.where(move, lid[:, None], 0).sum(dim=0,
                                                     dtype=torch.int32)
    new_row_node = torch.where(
        in_any, torch.where(go_left_row, lid_row, lid_row + 1), row_node)
    return new_row_node, move, goleft_k


def _use_subtraction(cfg: GrowConfig, n: int, group=None) -> bool:
    """Histogram subtraction engages on a resolved ``True`` at real row
    counts only (the JAX package's threshold, ``n >= 8192``), for both
    growth policies, and never on the collective path (a group, voting or
    the blocked reduction: the compacted smaller-child pass has neither a
    bound per rank nor a canonical block tiling)."""
    if cfg.hist_subtraction == "auto":
        raise ValueError(
            "hist_subtraction='auto' reached tree growth unresolved — "
            "callers must apply resolve_growth_backend(cfg) first")
    return (bool(cfg.hist_subtraction) and group is None
            and not _blocked(cfg) and not cfg.voting and n >= 8192)


def _quantize_for(base_t: torch.Tensor, qkey: Optional[Tuple[int, int]],
                  group=None, blocks_local: int = 0,
                  rows_per_block: int = 0, n_rows: Optional[int] = None):
    """int8 quantization of one tree's ``[3, n]`` stats (the JAX package's
    ``_quantize_for``), stochastically rounded under the key words
    ``qkey`` with the JAX package's draws, round-to-nearest when it is
    None. The plain path draws ``jax.random.uniform(qkey, [3, n_rows])``
    (``utils/prng.py``): the one-device draw over ``n_rows`` rows (default
    ``n`` times the group's size), of which a rank draws its own rows at
    their global index, so every world size rounds as one device does.
    The blocked mode draws :func:`positional_uniform` over global row
    indices, takes the scales from the global amax (``all_reduce(MAX)`` is
    exact) and bounds the int32 accumulator by the rows per block. Returns
    (int8 stats, f32 scales [3])."""
    S, n = base_t.shape
    start, stride, q_max = _rounding(n, group, blocks_local, rows_per_block,
                                     n_rows)
    if not blocks_local:
        u = None if qkey is None else prng.uniform(
            qkey, (S, n), start=start, device=base_t.device, stride=stride)
        return quantize_stats(base_t, q_max=q_max, u=u)
    u = None if qkey is None else positional_uniform(
        qkey, S, n, base_t.device, start=start)
    amax = base_t.abs().amax(dim=1)
    if group is not None:
        amax = group.all_reduce(amax, op="max")
    return quantize_stats(base_t, amax=amax, q_max=q_max, u=u)


def _rounding(n: int, group, blocks_local: int, rows_per_block: int,
              n_rows: Optional[int]) -> Tuple[int, int, float]:
    """Where this rank's ``n`` rows sit in a tree's rounding draw, and the
    int8 bound: ``(start, stride, q_max)``. Ranks hold equal consecutive
    slices, so ``start`` is this rank's first global row; ``stride`` is the
    plain path's counter distance between channels (the one-device draw's
    rows, :func:`_quantize_for`; the blocked mode's positional draws take
    none)."""
    start = 0 if group is None else group.rank * n
    stride = n_rows or n * (1 if group is None else group.size)
    return start, stride, quant_q_max(rows_per_block if blocks_local else n)


def _quantize_fused(grad, hess, vm, qkey: Optional[Tuple[int, int]],
                    group=None, blocks_local: int = 0,
                    rows_per_block: int = 0, n_rows: Optional[int] = None):
    """:func:`_quantize_for` of the stack ``(grad * vm, hess * vm, vm)`` on
    the card, without the stack: the per-channel amax in one launch (over
    the group in the blocked mode), then the masking, the draw and the int8
    pack in one more (``ops/histogram.py:quantize_stats_cuda``), the same
    bits as the eager chain. Returns (int8 stats [3, n], f32 scales
    [3])."""
    start, stride, q_max = _rounding(grad.shape[0], group, blocks_local,
                                     rows_per_block, n_rows)
    mode = (QUANT_NEAREST if qkey is None
            else QUANT_POSITIONAL if blocks_local else QUANT_THREEFRY)
    amax = stats_amax_cuda(grad, hess, vm)
    if blocks_local and group is not None:
        amax = group.all_reduce(amax, op="max")
    return quantize_stats_cuda(grad, hess, vm, amax, q_max=q_max, mode=mode,
                               qkey=qkey, start=start, stride=stride)


def _stat_totals(base_t: torch.Tensor, qscales: Optional[torch.Tensor],
                 group=None, blocks_local: int = 0,
                 rows_per_block: int = 0):
    """[3] grad/hess/count totals of a node's rows, over the group.
    Quantized stats are summed exactly in int32 (quant_q_max bounds the sum
    below 2^31) and then scaled, so the totals agree with the dequantized
    histograms. The blocked mode folds per-block sums in block order; a
    quantized block sum widens to f32 before the fold (folding raw int32
    over every block would wrap once q_max * rows crosses 2^31)."""
    if blocks_local:
        if qscales is not None:
            parts = base_t.reshape(3, blocks_local, rows_per_block).sum(
                dim=2, dtype=torch.int32).to(torch.float32).t()
        else:
            parts = _exact_block_sums(base_t, blocks_local)[:, :, 0]
        tot = _blocked_fold(parts.contiguous(), group)
        return tot * qscales if qscales is not None else tot
    if qscales is not None:
        tot = base_t.sum(dim=1, dtype=torch.int32) * qscales
    else:
        tot = base_t.sum(dim=1)
    return tot if group is None else group.all_reduce(tot)


def _renew_leaf_stats(ng, nh, nc, is_leaf, row_node, grad, hess, vm,
                      group=None, blocks_local: int = 0,
                      rows_per_block: int = 0):
    """Full-precision leaf stats for quantized training (LightGBM
    quant_train_renew_leaf): each leaf's grad/hess/count recomputed from
    the f32 stats by one segment-sum over the final row->leaf map, so leaf
    values carry no int8 error. Internal nodes keep their recorded stats.
    The arrays are ``[M + 1]`` with the spare slot. The segment sums are
    exact (:func:`_exact_block_sums`; the JAX package adds in f32), so a
    fit's leaves are the same bits on every run and device, where a float
    ``index_add_`` on the card adds in launch order. Over a group the sums
    are all-reduced, or (blocked mode) taken per block and folded in block
    order. Non-finite stats give NaN leaves (their int8 histograms are
    undefined in both packages)."""
    stats = torch.stack([grad * vm, hess * vm, vm])              # [3, n]
    seg = row_node.long()
    if blocks_local:
        renew = _blocked_fold(_exact_block_sums(
            stats, blocks_local, seg, ng.shape[0]), group)
    else:
        renew = _exact_block_sums(stats, 1, seg, ng.shape[0])[0]
        if group is not None:
            renew = group.all_reduce(renew)
    return tuple(torch.where(is_leaf, renew[i], v)
                 for i, v in enumerate((ng, nh, nc)))


def _compact_select(sel: torch.Tensor, h_buf: int,
                    mode: str = "searchsorted"):
    """Indices of the selected rows, compacted to the front of an ``h_buf``
    buffer (stable order). Returns (src [h_buf] int64, n_sel 0-d int64
    tensor); entries past ``n_sel`` point at unselected rows and are
    masked by the caller.

    ``mode`` (``GrowConfig.compact_selector``): "searchsorted" finds the
    k-th selected row by cumsum + binary search; "argsort" takes a stable
    argsort of the not-selected key (one ``[n]`` sort). Both give the same
    entries below ``n_sel``."""
    n = sel.shape[0]
    if mode == "argsort":
        key = (~sel).to(torch.int8)
        src = torch.argsort(key, stable=True)[:h_buf]
        return src, sel.sum(dtype=torch.int64)
    if mode != "searchsorted":
        raise ValueError(f"compact_selector must be 'argsort' or "
                         f"'searchsorted', got {mode!r}")
    c = torch.cumsum(sel.to(torch.int32), dim=0, dtype=torch.int32)
    want = torch.arange(1, h_buf + 1, dtype=torch.int32, device=sel.device)
    src = torch.searchsorted(c, want, side="left").clamp_(max=n - 1)
    return src, c[-1].long()


def _subtracted_pair_hists(binned_t, base_t, qscales, row_small,
                           small_is_left, parent_hists, K: int, B: int,
                           h_buf: int, selector: str):
    """Smaller-child compaction + subtraction for K sibling pairs, shared by
    both growth policies.

    row_small: [n] in [-1, K) — each row's pair index if it lies in that
    pair's smaller child, else -1. small_is_left: [K] bool. parent_hists:
    [K, F, 3, B] f32. Gathers the selected rows (at most n//2 of them: pair
    row sets are disjoint and min(l, r) <= total/2) into the half-width
    buffer, builds the K smaller-child histograms in one kernel pass
    (dequantized when ``qscales`` is set), derives each larger sibling as
    parent minus smaller in f32, and returns [2K, F, 3, B] interleaved as
    [l0, r0, l1, r1, ...]. ``selector`` is the compaction's mode
    (:func:`_compact_select`)."""
    F = binned_t.shape[0]
    src, n_sel = _compact_select(row_small >= 0, h_buf, selector)
    keep = torch.arange(h_buf, device=src.device) < n_sel
    pos_h = torch.where(keep, row_small[src], -1).to(torch.int32)
    h_small = node_histogram(binned_t.index_select(1, src).contiguous(),
                             pos_h,
                             base_t.index_select(1, src).contiguous(), K, B,
                             scales=qscales)
    h_small = h_small.reshape(F, K, 3, B).permute(1, 0, 2, 3)
    h_large = parent_hists - h_small
    sl = small_is_left[:, None, None, None]
    left_h = torch.where(sl, h_small, h_large)
    right_h = torch.where(sl, h_large, h_small)
    return torch.stack([left_h, right_h], dim=1).reshape(2 * K, F, 3, B)


class _Stats(NamedTuple):
    """The masked ``[3, n]`` stats a tree is grown from, and how its row
    reductions run: ``group`` (None on one device), the blocked geometry
    (``blocks``, ``rpb``; 0 and n on the plain path)."""
    vm: torch.Tensor
    base_t: torch.Tensor
    qscales: Optional[torch.Tensor]
    group: object
    blocks: int
    rpb: int

    def hist(self, binned_t, row_pos, W: int, B: int, feat_mask, cfg):
        """The frontier's global ``[F, 3W, B]`` histograms and the [F]
        mask of features the split search may use: one pass summed over
        the group (data_parallel), the blocked fold, or the voting
        selection."""
        ones = torch.ones_like(feat_mask)
        if self.blocks:
            parts = node_histogram(binned_t, row_pos, self.base_t, W, B,
                                   scales=self.qscales, blocks=self.blocks)
            return _blocked_fold(parts, self.group), ones
        h = node_histogram(binned_t, row_pos, self.base_t, W, B,
                           scales=self.qscales)
        if self.group is None:
            return h, ones
        if not cfg.voting:
            return self.group.all_reduce(h), ones
        return _voting_select(h, feat_mask, cfg, self.group, W)

    def totals(self):
        return _stat_totals(self.base_t, self.qscales, self.group,
                            self.blocks, self.rpb)


def _prepare_stats(grad, hess, valid, cfg: GrowConfig, qkey,
                   group=None, n_rows: Optional[int] = None) -> _Stats:
    """The masked ``[3, n]`` stats a tree is grown from, quantized when
    ``cfg.quantized_grad``, with the blocked geometry of this rank's
    rows. Quantized stats on the card come from the fused kernel
    (:func:`_quantize_fused`), on the CPU from the eager chain
    (:func:`_quantize_for`)."""
    n = grad.shape[0]
    bl, rpb = _hist_block_geometry(cfg, group, n)
    with _spans.span("gbdt.grow.stats", device=grad.device, publish=False):
        vm = valid.to(torch.float32)
        if cfg.quantized_grad and grad.is_cuda:
            base_t, qscales = _quantize_fused(grad, hess, vm, qkey, group,
                                              bl, rpb, n_rows)
            return _Stats(vm, base_t, qscales, group, bl, rpb)
        base_t = torch.stack([grad * vm, hess * vm, vm], dim=0).contiguous()
        qscales = None
        if cfg.quantized_grad:
            base_t, qscales = _quantize_for(base_t, qkey, group, bl, rpb,
                                            n_rows)
            base_t = base_t.contiguous()
    return _Stats(vm, base_t, qscales, group, bl, rpb)


def _finish_tree(cfg: GrowConfig, M: int, feat, thr, left, right, is_leaf,
                 ng, nh, nc, gain, bits, num_nodes, row_node, grad, hess,
                 st: _Stats):
    """Leaf values from the node totals (renewed from the f32 stats first
    when quantized), and the ``[M]`` tree without the spare slot."""
    if cfg.quantized_grad and cfg.quant_renew_leaf:
        with _spans.span("gbdt.grow.renew", device=grad.device,
                         publish=False):
            ng, nh, nc = _renew_leaf_stats(ng, nh, nc, is_leaf, row_node,
                                           grad, hess, st.vm, st.group,
                                           st.blocks, st.rpb)
    ng, nh, nc = ng[:M], nh[:M], nc[:M]
    is_leaf = is_leaf[:M].clone()
    raw_val = -_soft_threshold(ng, cfg.lambda_l1) / (nh + cfg.lambda_l2
                                                     + 1e-38)
    if cfg.max_delta_step > 0:
        raw_val = raw_val.clamp(-cfg.max_delta_step, cfg.max_delta_step)
    lr = float(cfg.learning_rate)
    zero = torch.zeros_like(raw_val)
    leaf_value = torch.where(is_leaf & (nc > 0), raw_val * lr, zero)
    node_value = torch.where(nc > 0, raw_val * lr, zero)
    # copies: a fit's leafwise rounds keep their state from tree to tree
    return Tree(feat=feat[:M].clone(), thr_bin=thr[:M].clone(),
                left=left[:M].clone(), right=right[:M].clone(),
                is_leaf=is_leaf, leaf_value=leaf_value,
                node_count=num_nodes.clone(), node_grad=ng.clone(),
                node_hess=nh.clone(), node_cnt=nc.clone(),
                split_gain=gain[:M].clone(), node_value=node_value,
                cat_bitset=bits[:M].clone())


class LeafwiseRounds:
    """One fit's leafwise trees on the card, replayed from CUDA graphs.

    The boosting loop makes one and hands it to every :func:`grow_tree` of
    the fit. A tree's shapes are fixed by the rows, the features and the
    configuration, so its state lives in buffers kept from tree to tree
    (:class:`_RoundState`) and its three bodies are captured once each:
    the root with the first round's head, a round's head, and a round's
    body. Each runs eagerly the first time (lazy loads and caches stay out
    of the capture), is captured the second, and is one replay after that
    instead of some 150 launches queued from the host. A replay counts the
    histogram launches its capture made. Single device only: the
    collective paths grow their trees eagerly."""

    # node_histogram's counters, which a replay adds to as its body would
    _COUNTERS = ("launches", "int8_launches", "det_launches", "rows")

    def __init__(self):
        self._entries: dict = {}

    def state(self, key, make: Callable[[], "_RoundState"]) -> "_RoundState":
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = {"state": make(), "bodies": {}}
        return entry["state"]

    def run(self, key, name: str, body: Callable[[], None]) -> None:
        bodies = self._entries[key]["bodies"]
        entry = bodies.setdefault(name, {"runs": 0, "graph": None})
        entry["runs"] += 1
        if entry["runs"] == 1:
            body()
            return
        if entry["graph"] is None:
            before = [getattr(node_histogram, c) for c in self._COUNTERS]
            graph = torch.cuda.CUDAGraph()
            with _CAPTURE_LOCK, torch.cuda.graph(
                    graph, capture_error_mode="thread_local"):
                body()
            entry["delta"] = [getattr(node_histogram, c) - b
                              for c, b in zip(self._COUNTERS, before)]
            for c, b in zip(self._COUNTERS, before):
                setattr(node_histogram, c, b)
            entry["graph"] = graph
        entry["graph"].replay()
        for c, d in zip(self._COUNTERS, entry["delta"]):
            setattr(node_histogram, c, getattr(node_histogram, c) + d)


# two threads may not capture at once (the predict graphs take it too)
_CAPTURE_LOCK = threading.Lock()


class _RoundState(NamedTuple):
    """What a leafwise round reads and writes, updated in place: the rows'
    nodes, the ``[M + 1]`` per-slot arrays (slot ``M`` the spare), the
    cached candidates, the node histograms under subtraction, the node
    count, the round's ``head`` (live, nodes before it, its splits) and
    its candidates (``top_g``, ``slots``, ``do``), and the tree's inputs
    (its statistics, their scales, the feature mask)."""
    row_node: torch.Tensor
    feat: torch.Tensor
    thr: torch.Tensor
    left: torch.Tensor
    right: torch.Tensor
    depth: torch.Tensor
    is_leaf: torch.Tensor
    ng: torch.Tensor
    nh: torch.Tensor
    nc: torch.Tensor
    gain: torch.Tensor
    cg: torch.Tensor
    cf: torch.Tensor
    cb: torch.Tensor
    clg: torch.Tensor
    clh: torch.Tensor
    clc: torch.Tensor
    cbits: torch.Tensor
    tbits: torch.Tensor
    num_nodes: torch.Tensor
    nhist: Optional[torch.Tensor]
    head: torch.Tensor
    top_g: torch.Tensor
    slots: torch.Tensor
    do: torch.Tensor
    arange_kb: torch.Tensor
    slot_m: torch.Tensor
    root_allow: torch.Tensor
    base_t: torch.Tensor
    qscales: Optional[torch.Tensor]
    feat_mask: torch.Tensor

    # the fields a tree starts from zero, row_node through head (the rest
    # are the round's candidates, constants or inputs)
    PER_TREE = 22

    @staticmethod
    def make(n: int, F: int, M: int, B: int, BW: int, KB: int,
             use_sub: bool, root_allow: bool, base_t: torch.Tensor,
             qscales: Optional[torch.Tensor], feat_mask: torch.Tensor,
             copies: bool) -> "_RoundState":
        """Zeroed state; with ``copies`` the tree's inputs are buffers to
        copy them into, else the inputs themselves."""
        dev = base_t.device

        def slots(dtype):                  # M slots + the spare slot M
            return torch.zeros(M + 1, dtype=dtype, device=dev)

        i32, f32 = torch.int32, torch.float32
        return _RoundState(
            row_node=torch.zeros(n, dtype=i32, device=dev),
            feat=slots(i32), thr=slots(i32), left=slots(i32),
            right=slots(i32), depth=slots(i32),
            is_leaf=slots(torch.bool), ng=slots(f32), nh=slots(f32),
            nc=slots(f32), gain=slots(f32), cg=slots(f32), cf=slots(i32),
            cb=slots(i32), clg=slots(f32), clh=slots(f32), clc=slots(f32),
            cbits=torch.zeros((M + 1, BW), dtype=torch.int64, device=dev),
            tbits=torch.zeros((M + 1, BW), dtype=torch.int64, device=dev),
            num_nodes=torch.zeros((), dtype=i32, device=dev),
            # per-node histogram cache [M+1, F, 3, B] f32 (dequantized when
            # quantized): the subtraction parent of every future candidate
            # (~5 MB at 31 leaves x 28 features x 255 bins, linear in F)
            nhist=(torch.zeros((M + 1, F, 3, B), dtype=f32, device=dev)
                   if use_sub else None),
            head=torch.zeros(3, dtype=i32, device=dev),
            top_g=torch.zeros(KB, dtype=f32, device=dev),
            slots=torch.zeros(KB, dtype=i32, device=dev),
            do=torch.zeros(KB, dtype=torch.bool, device=dev),
            arange_kb=torch.arange(KB, dtype=i32, device=dev),
            slot_m=torch.full((KB,), M, dtype=i32, device=dev),
            root_allow=torch.tensor([root_allow], device=dev),
            base_t=torch.empty_like(base_t) if copies else base_t,
            qscales=(torch.empty_like(qscales)
                     if copies and qscales is not None else qscales),
            feat_mask=torch.empty_like(feat_mask) if copies else feat_mask)


def grow_tree(binned_t: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              valid: torch.Tensor, feat_mask: torch.Tensor, cfg: GrowConfig,
              is_cat: Optional[torch.Tensor] = None,
              qkey: Optional[Tuple[int, int]] = None, group=None,
              n_rows: Optional[int] = None,
              rounds: Optional[LeafwiseRounds] = None):
    """Grow one leafwise tree on one device, or on this rank's rows of
    ``group`` (the collective path: every rank takes the same splits).

    binned_t: [F, n] int32/int16/uint8 (column-major); grad/hess: [n] f32;
    valid: [n] f32 row mask (0 for rows that must not count); feat_mask:
    [F] bool (feature_fraction); is_cat: [F] bool categorical features, or
    None for none. ``cfg`` must be resolved
    (:func:`resolve_growth_backend`). With ``cfg.quantized_grad``, ``qkey``
    (two uint32 words, :func:`...ops.histogram.quant_key`) seeds the
    stochastic rounding; None rounds to nearest. ``n_rows``: the rows of
    the one-device fit whose rounding draw this rank's rows slice (the
    data's real rows, when the group pads them; :func:`_quantize_for`).
    ``rounds``: the fit's :class:`LeafwiseRounds`, which replays the rounds
    on one card from a CUDA graph (ignored elsewhere; the trees are the
    same bits either way). Returns (Tree, row_node
    [n] int32): ``row_node`` is each row's final leaf, so
    ``leaf_value[row_node]`` is the tree's prediction for the training rows.
    """
    F, n = binned_t.shape
    dev = binned_t.device
    L = int(cfg.num_leaves)
    M = 2 * L - 1
    B = int(cfg.num_bins)
    BW = bitset_words(B)

    st = _prepare_stats(grad, hess, valid, cfg, qkey, group, n_rows)
    use_sub = _use_subtraction(cfg, n, group)
    h_buf = max(n // 2, 1)
    KB = max(1, min(int(cfg.leaf_batch), L - 1))
    W2 = 2 * KB
    # a round reads nothing back while it is captured: kernel 2's range
    # check reads the stats only past _INT8_SAFE_ROWS rows
    graphed = (rounds is not None and dev.type == "cuda" and group is None
               and not st.blocks
               and (st.qscales is None or n <= _INT8_SAFE_ROWS))

    def make(copies: bool):
        return _RoundState.make(
            n, F, M, B, BW, KB, use_sub,
            cfg.max_depth < 0 or cfg.max_depth >= 1, st.base_t, st.qscales,
            feat_mask, copies)

    key = None
    if graphed:
        key = (binned_t.data_ptr(), tuple(binned_t.shape), binned_t.dtype,
               cfg, None if is_cat is None else is_cat.data_ptr(),
               st.base_t.dtype, st.qscales is None)
        s = rounds.state(key, lambda: make(True))
        s.base_t.copy_(st.base_t)
        if s.qscales is not None:
            s.qscales.copy_(st.qscales)
        s.feat_mask.copy_(feat_mask)
    else:
        s = make(False)
    st = st._replace(base_t=s.base_t, qscales=s.qscales)

    def root():
        """The root's histograms, totals and best split, and the state a
        tree starts from."""
        if graphed:
            for t in s[:_RoundState.PER_TREE]:
                if t is not None:
                    t.zero_()
        # every row at the root: row_node is all zeros here
        root_hist, sel0 = st.hist(binned_t, s.row_node, 1, B, s.feat_mask,
                                  cfg)                            # [F, 3, B]
        # totals from the stats (under voting an unselected feature's rows
        # are zeroed in the histograms)
        tot = st.totals()
        g0, f0, b0, lg0, lh0, lc0, bits0 = _best_split(
            root_hist.reshape(1, F, 3, B), tot[0:1], tot[1:2], tot[2:3], cfg,
            s.feat_mask & sel0, s.root_allow, is_cat)
        s.is_leaf.fill_(True)
        s.cg.fill_(NEG_INF)                            # cached best gain
        s.num_nodes.fill_(1)
        s.ng[0], s.nh[0], s.nc[0] = tot[0], tot[1], tot[2]
        s.cg[0], s.cf[0], s.cb[0] = g0[0], f0[0], b0[0]
        s.clg[0], s.clh[0], s.clc[0] = lg0[0], lh0[0], lc0[0]
        # the candidate's bitset (cbits) and each split node's (tbits)
        s.cbits[0] = bits0[0]
        if use_sub:
            s.nhist[0] = root_hist.reshape(F, 3, B)

    arange_kb, slot_m = s.arange_kb, s.slot_m

    def twice(x):                          # [KB] -> [2 KB], each one twice
        return x[:, None].expand(KB, 2).reshape(-1)

    def round_head():
        # the JAX package's round predicate; once false it stays false
        live = (s.num_nodes < M) & (s.cg[:M].max() > cfg.min_gain_to_split)
        # top-KB cached gains, ties to the lower slot (lax.top_k order)
        top_g, slots = torch.sort(s.cg[:M], descending=True, stable=True)
        s.top_g.copy_(top_g[:KB])
        s.slots.copy_(slots[:KB])
        budget = L - (s.num_nodes + 1) // 2
        s.do.copy_(live & (s.top_g > cfg.min_gain_to_split)
                   & (arange_kb < budget))
        s.head.copy_(torch.stack([live.to(torch.int32), s.num_nodes,
                                  s.do.sum(dtype=torch.int32)]))

    def round_body():
        top_g, slots, do, n_split = s.top_g, s.slots, s.do, s.head[2]
        offset = torch.cumsum(do.to(torch.int32), 0, dtype=torch.int32) - 1
        lid = s.num_nodes + 2 * offset                 # [KB] child slots
        rid = lid + 1
        sl_long = slots.long()
        feats, bins_ = s.cf[sl_long], s.cb[sl_long]
        bits_k = s.cbits[sl_long]                                  # [KB, BW]

        row_node, move, goleft_k = _route_rows_to_children(
            binned_t, s.row_node, slots, do, feats, bins_, bits_k, lid,
            is_cat)
        s.row_node.copy_(row_node)
        if use_sub:
            # stream only each candidate's smaller child (by raw routed row
            # count, which bounds the n//2 buffer); the larger sibling
            # derives from the cached candidate histogram
            rawL = (move & goleft_k).sum(dim=1)
            rawA = move.sum(dim=1)
            small_is_left = rawL <= rawA - rawL                # ties -> left
            in_small = (move & (goleft_k == small_is_left[:, None])).any(0)
            spos = torch.where(move, arange_kb[:, None], 0).sum(
                dim=0, dtype=torch.int32)
            row_small = torch.where(in_small, spos, -1).to(torch.int32)
            parents = s.nhist[torch.where(do, slots, 0).long()]
            hw = _subtracted_pair_hists(binned_t, s.base_t, s.qscales,
                                        row_small, small_is_left, parents,
                                        KB, B, h_buf, cfg.compact_selector)
            sel = torch.ones_like(s.feat_mask)
        else:
            # child position in [0, 2*KB): 2i = left child of candidate i
            cpos = torch.where(goleft_k, 2 * arange_kb[:, None],
                               2 * arange_kb[:, None] + 1)
            child_pos = torch.where(
                move.any(dim=0),
                torch.where(move, cpos, 0).sum(dim=0, dtype=torch.int32),
                -1).to(torch.int32)
            h, sel = st.hist(binned_t, child_pos, W2, B, s.feat_mask, cfg)
            hw = h.reshape(F, W2, 3, B).permute(1, 0, 2, 3)  # [W2, F, 3, B]

        # child totals: left from the candidate cache, right = parent - left
        lg, lh, lc = s.clg[sl_long], s.clh[sl_long], s.clc[sl_long]
        tg = torch.stack([lg, s.ng[sl_long] - lg], 1).reshape(-1)  # [W2]
        th = torch.stack([lh, s.nh[sl_long] - lh], 1).reshape(-1)
        tc = torch.stack([lc, s.nc[sl_long] - lc], 1).reshape(-1)
        child_depth = s.depth[sl_long] + 1                         # [KB]
        can_split = (torch.ones_like(do) if cfg.max_depth < 0
                     else child_depth + 1 <= cfg.max_depth)
        allow2 = twice(can_split & do)
        g2, f2, b2, lg2, lh2, lc2, bits2 = _best_split(
            hw, tg, th, tc, cfg, s.feat_mask & sel, allow2, is_cat)

        # record splits; slot M is the spare slot for non-splits
        pslot = torch.where(do, slots, slot_m).long()
        cslot = torch.where(twice(do), torch.stack([lid, rid], 1).reshape(-1),
                            twice(slot_m)).long()
        s.feat[pslot] = feats
        s.thr[pslot] = bins_
        s.left[pslot] = lid
        s.right[pslot] = rid
        # values on the device: a round captured in a graph copies nothing
        # from the host
        s.is_leaf[pslot] = torch.zeros_like(do)
        s.gain[pslot] = top_g
        s.tbits[pslot] = bits_k
        s.depth[cslot] = twice(child_depth)
        s.ng[cslot], s.nh[cslot], s.nc[cslot] = tg, th, tc
        s.cg[pslot] = torch.full_like(top_g, NEG_INF)
        s.cg[cslot] = g2
        s.cf[cslot], s.cb[cslot] = f2, b2
        s.clg[cslot], s.clh[cslot], s.clc[cslot] = lg2, lh2, lc2
        s.cbits[cslot] = bits2
        s.num_nodes.add_(2 * n_split)
        if use_sub:
            # the children's histograms are the subtraction parents of
            # every round that later splits them (cslot order [l0, r0, ...]
            # matches hw's)
            s.nhist[cslot] = hw
        s.is_leaf[M:].fill_(True)          # the spare slot stays inert

    # A round is its head (the predicate and the candidates) and its body.
    # The host reads each head (live, the nodes before the round, its
    # splits) as soon as the card has it and queues the next round while
    # the body runs. A round that is not live splits nothing and writes
    # only the spare slot, so the one extra round a tree stopped by its
    # gains runs changes nothing; a tree stopped by its leaf budget runs
    # none, since the host counts the nodes each round leaves. The root
    # runs with the first head.
    def first():
        root()
        if L > 1:
            round_head()

    def run(name, body):
        if graphed:
            rounds.run(key, name, body)
        else:
            body()

    run("first", first)
    for r in range(L - 1):
        if r:
            was_live, nodes, split = host_read(_Later.tolist, pending)
            if not was_live or nodes + 2 * split >= M:
                break
            run("head", round_head)
        pending = _Later(s.head)
        run("body", round_body)

    tree = _finish_tree(cfg, M, s.feat, s.thr, s.left, s.right, s.is_leaf,
                        s.ng, s.nh, s.nc, s.gain, s.tbits, s.num_nodes,
                        s.row_node, grad, hess, st)
    return tree, s.row_node.clone()


def grow_tree_depthwise(binned_t: torch.Tensor, grad: torch.Tensor,
                        hess: torch.Tensor, valid: torch.Tensor,
                        feat_mask: torch.Tensor, cfg: GrowConfig,
                        is_cat: Optional[torch.Tensor] = None,
                        qkey: Optional[Tuple[int, int]] = None, group=None,
                        n_rows: Optional[int] = None):
    """Grow one tree level by level: one histogram pass per level.

    Counterpart of the JAX package's ``grow_tree_depthwise``. Every node
    of the level's frontier takes 3 stat channels of one node-histogram
    pass; the level's candidate splits are ranked by gain so the
    ``num_leaves`` budget goes to the best first (ties to the lower
    frontier position: stable sorts, as ``jnp.argsort``); children take
    slots in frontier order. From level 1 on, with histogram subtraction
    (``n >= 8192``), only each sibling pair's smaller child is streamed and
    the larger one is its parent's histogram minus it. Without an explicit
    ``max_depth`` the depth is capped at the balanced depth plus two. Under
    voting, the ranks vote once per level over the whole frontier.
    Arguments and return value as :func:`grow_tree`.
    """
    F, n = binned_t.shape
    dev = binned_t.device
    L = int(cfg.num_leaves)
    M = 2 * L - 1
    B = int(cfg.num_bins)
    depth_cap = (cfg.max_depth if cfg.max_depth > 0
                 else min(L - 1, (L - 1).bit_length() + 2))

    st = _prepare_stats(grad, hess, valid, cfg, qkey, group, n_rows)
    base_t, qscales = st.base_t, st.qscales
    use_sub = _use_subtraction(cfg, n, group)
    h_buf = max(n // 2, 1)

    def zeros(dtype):                      # M slots + the spare slot M
        return torch.zeros(M + 1, dtype=dtype, device=dev)

    feat, thr, left, right = (zeros(torch.int32) for _ in range(4))
    is_leaf = torch.ones(M + 1, dtype=torch.bool, device=dev)
    ng, nh, nc, gain = (zeros(torch.float32) for _ in range(4))
    bits = torch.zeros((M + 1, bitset_words(B)), dtype=torch.int64,
                       device=dev)
    tot0 = st.totals()
    ng[0], nh[0], nc[0] = tot0[0], tot0[1], tot0[2]

    row_node = torch.zeros(n, dtype=torch.int32, device=dev)
    num_nodes = torch.ones((), dtype=torch.int32, device=dev)
    leaves = torch.ones((), dtype=torch.int32, device=dev)
    # the level's frontier: node slot ids, -1 = inactive position
    frontier = torch.full((L,), -1, dtype=torch.int32, device=dev)
    frontier[0] = 0
    # with subtraction: (the previous level's [W, F, 3, B] histograms, each
    # sibling pair's parent position in the previous frontier [W//2], each
    # child's raw row count [W]) — the parents of the next level
    aux = None

    for depth in range(depth_cap):
        W = min(2 ** depth, L)
        # once the budget is spent or the frontier is empty, stop
        if not host_read(bool, (leaves < L) & (frontier >= 0).any()):
            break
        fr = frontier[:W]
        active = fr >= 0
        fr_l = fr.clamp(min=0).long()

        fm_level = feat_mask
        if use_sub and depth >= 1:
            h = _sub_level_hist(binned_t, base_t, qscales, aux, frontier,
                                row_node, W, M, B, h_buf,
                                cfg.compact_selector)
        else:
            # each row's frontier position (-1: the row is at a finished
            # leaf); inactive positions write to the spare slot M
            slot_to_pos = torch.full((M + 1,), -1, dtype=torch.int32,
                                     device=dev)
            slot_to_pos[torch.where(active, fr, M).long()] = torch.arange(
                W, dtype=torch.int32, device=dev)
            row_pos = slot_to_pos[row_node.long()]
            h, sel = st.hist(binned_t, row_pos, W, B, feat_mask, cfg)
            fm_level = feat_mask & sel
            h = h.reshape(F, W, 3, B).permute(1, 0, 2, 3)      # [W, F, 3, B]

        pg, ph, pc = ng[fr_l], nh[fr_l], nc[fr_l]
        allow = active & (cfg.max_depth < 0 or depth + 1 <= cfg.max_depth)
        gains, feats, bins_, lgs, lhs, lcs, bits_w = _best_split(
            h, pg, ph, pc, cfg, fm_level, allow, is_cat)
        gains = torch.where(active, gains, torch.full_like(gains, NEG_INF))

        # budget: leaves + splits <= num_leaves, best gains first
        order = torch.argsort(-gains, stable=True)
        rank = torch.empty(W, dtype=torch.int32, device=dev)
        rank[order] = torch.arange(W, dtype=torch.int32, device=dev)
        do = (gains > cfg.min_gain_to_split) & (rank < L - leaves) & active

        # child slots in frontier order among the splitting nodes
        offset = torch.cumsum(do.to(torch.int32), 0, dtype=torch.int32) - 1
        lid = num_nodes + 2 * offset
        rid = lid + 1
        n_split = do.sum(dtype=torch.int32)

        row_node, move, goleft_k = _route_rows_to_children(
            binned_t, row_node, torch.where(active, fr, -1), do, feats,
            bins_, bits_w, lid, is_cat)

        # record splits and children's totals; slot M takes non-splits
        slot = torch.where(do, fr, M).long()
        feat[slot] = feats
        thr[slot] = bins_
        left[slot] = lid
        right[slot] = rid
        is_leaf[slot] = False
        gain[slot] = gains
        bits[slot] = bits_w
        lslot = torch.where(do, lid, M).long()
        rslot = torch.where(do, rid, M).long()
        ng[lslot], nh[lslot], nc[lslot] = lgs, lhs, lcs
        ng[rslot], nh[rslot], nc[rslot] = pg - lgs, ph - lhs, pc - lcs
        is_leaf[M] = True                  # the spare slot stays inert

        # next frontier: the children, compacted to the front (stable)
        W_next = min(2 * W, L)
        child_slots = torch.stack([torch.where(do, lid, -1),
                                   torch.where(do, rid, -1)],
                                  dim=1).reshape(-1)
        perm = torch.argsort((child_slots < 0).to(torch.int32), stable=True)
        frontier = torch.full((L,), -1, dtype=torch.int32, device=dev)
        frontier[:W_next] = child_slots[perm][:W_next]

        if use_sub:
            # packed with the same perm as the child slots, so sibling
            # pairs stay adjacent: raw per-child row counts (from the
            # routing masks, invalid rows included — they bound the
            # compaction buffer) and each pair's parent position here
            rawL = (move & goleft_k).sum(dim=1, dtype=torch.int32)
            rawA = move.sum(dim=1, dtype=torch.int32)
            raw2 = torch.stack([rawL, rawA - rawL], dim=1).reshape(-1)
            pp2 = torch.repeat_interleave(
                torch.where(do, torch.arange(W, dtype=torch.int32,
                                             device=dev), -1), 2)
            aux = (h, pp2[perm][:2 * (W_next // 2)][0::2],
                   raw2[perm][:W_next])
        num_nodes = num_nodes + 2 * n_split
        leaves = leaves + n_split

    tree = _finish_tree(cfg, M, feat, thr, left, right, is_leaf, ng, nh, nc,
                        gain, bits, num_nodes, row_node, grad, hess, st)
    return tree, row_node


def _sub_level_hist(binned_t, base_t, qscales, aux, frontier, row_node,
                    W: int, M: int, B: int, h_buf: int, selector: str):
    """[W, F, 3, B] level histograms by smaller-child compaction: the rows
    of each sibling pair's smaller child (by raw count; at most n//2 in all,
    since the pairs' row sets are disjoint) are gathered into the
    half-width buffer, only those W//2 histograms are built, and each
    larger sibling is its parent's histogram minus the smaller one. An odd
    ``W`` (the frontier capped at ``num_leaves``) leaves the last position
    without a sibling; children arrive in pairs, so it never holds one and
    its histogram is zero padding."""
    h_prev, pair_parent, child_raw = aux
    Wh = W // 2
    dev = row_node.device
    pair_active = pair_parent >= 0
    left_raw = child_raw[0::2][:Wh]
    right_raw = child_raw[1::2][:Wh]
    small_off = (right_raw < left_raw).to(torch.int32)    # ties -> left
    small_pos = 2 * torch.arange(Wh, dtype=torch.int32, device=dev) + small_off
    small_slot = frontier[small_pos.long()]
    slot_to_small = torch.full((M + 1,), -1, dtype=torch.int32, device=dev)
    slot_to_small[torch.where(pair_active & (small_slot >= 0), small_slot,
                              M).long()] = torch.arange(
        Wh, dtype=torch.int32, device=dev)
    row_small = slot_to_small[row_node.long()]            # [n] in [-1, Wh)
    hw = _subtracted_pair_hists(
        binned_t, base_t, qscales, row_small, small_off == 0,
        h_prev[pair_parent.clamp(min=0).long()], Wh, B, h_buf, selector)
    if 2 * Wh != W:
        hw = torch.cat([hw, hw.new_zeros((W - 2 * Wh,) + hw.shape[1:])])
    return hw


def leaf_nodes_binned(tree: Tree, binned: torch.Tensor, depth_cap: int,
                      is_cat: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The leaf slot each binned row reaches in one tree: [n, F] -> [n]
    int64. A categorical split (``is_cat[feat]``) sends a row left when its
    bin is in the node's bitset; its one word is gathered from the
    flattened ``[M * BW]`` bitsets."""
    n = binned.shape[0]
    node = torch.zeros(n, dtype=torch.long, device=binned.device)
    feat, thr = tree.feat.long(), tree.thr_bin
    left, right = tree.left.long(), tree.right.long()
    BW = tree.cat_bitset.shape[-1]
    bits = tree.cat_bitset.reshape(-1)
    for _ in range(depth_cap):
        f = feat[node]
        x = binned.gather(1, f[:, None])[:, 0]
        go_left = x <= thr[node]
        if is_cat is not None:
            xl = x.long()
            member = _word_bit(bits[node * BW + (xl >> 5)], xl)
            go_left = torch.where(is_cat[f], member, go_left)
        nxt = torch.where(go_left, left[node], right[node])
        node = torch.where(tree.is_leaf[node], node, nxt)
    return node


def predict_tree_binned(tree: Tree, binned: torch.Tensor, depth_cap: int,
                        is_cat: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Evaluate one tree on binned rows: [n, F] -> [n] leaf values."""
    return tree.leaf_value[leaf_nodes_binned(tree, binned, depth_cap,
                                             is_cat)]


def raw_to_cat_bin(x: torch.Tensor, max_bin_idx: int) -> torch.Tensor:
    """Raw categorical value -> bin id (int64): rounded to nearest
    (``floor(x + 0.5)``), NaN and negatives -> 0, ids past ``max_bin_idx``
    clipped into it (the binner's 0.5-boundary categorical bins)."""
    b = torch.where(torch.isnan(x), torch.zeros_like(x), torch.floor(x + 0.5))
    return b.clamp(0, max_bin_idx).long()


def cat_member(bits: torch.Tensor, word0: torch.Tensor, x: torch.Tensor,
               max_bin_idx: int, strict: bool) -> torch.Tensor:
    """Categorical membership of raw values ``x`` in bitsets.

    ``bits`` [T, M * BW] holds every node's words flattened; ``word0``
    ([T, n] int64) is the index of each row's node's first word, so only
    one word per row and tree is gathered. ``strict=False`` (models
    trained here): ids bin exactly as training did, NaN and negatives to
    bin 0 and ids past the last bin into it (the catch-all).
    ``strict=True`` (models imported from LightGBM, which has no
    catch-all): ``FindInBitset`` semantics, NaN or any id outside the
    bitset routes right (not a member).
    """
    if not strict:
        cbin = raw_to_cat_bin(x, max_bin_idx)
        return _word_bit(bits.gather(1, word0 + (cbin >> 5)), cbin)
    b = torch.where(torch.isnan(x), torch.full_like(x, -1.0),
                    torch.floor(x + 0.5))
    in_range = (b >= 0) & (b <= max_bin_idx)
    cbin = b.clamp(0, max_bin_idx).long()
    return _word_bit(bits.gather(1, word0 + (cbin >> 5)), cbin) & in_range


def forest_leaf_nodes(feat, thr_raw, left, right, is_leaf,
                      features: torch.Tensor, depth_cap: int, *,
                      cat_bitset: Optional[torch.Tensor] = None,
                      is_cat: Optional[torch.Tensor] = None,
                      cat_max_bin: int = 0,
                      missing_dec: Optional[torch.Tensor] = None,
                      start: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The leaf slot every row reaches in every tree of a stacked forest,
    on raw float features: [T, n] int64.

    feat/left/right: [T, M] integer; is_leaf: [T, M] bool; thr_raw: [T, M]
    f32 ("go left if x <= thr"; NaN compares false, so it goes left — the
    binning convention of NaN -> bin 0). features: [n, F] f32. The depth
    loop runs ``depth_cap`` steps, as the JAX package's does; rows that
    reached a leaf stay there.

    ``is_cat`` ([F] bool) routes categorical features by bitset membership
    of the rounded category id (``cat_bitset`` [T, M, BW] int64 words):
    with ``cat_max_bin`` > 0 (the binner's ``max_bin``, models trained
    here) ids clip into the last bin; with 0 (imported models) they route
    by ``FindInBitset``. ``missing_dec`` ([T, M] integer LightGBM
    decision_type bytes) switches numeric routing to LightGBM's
    NumericalDecision: NaN maps to 0.0 unless the node's missing type is
    NaN; zero-as-missing (``|x| <= 1e-35``) and NaN-missing take the
    default side, bit 1 of the byte (1 = left); every other value compares
    ``x <= thr``.

    The predict lanes (:mod:`.quantize`) pass bf16 features with bf16
    thresholds, or uint8 bin ids with uint8 threshold ids; categorical
    membership then reads a bin id as its category id (widened to f32:
    the binner's identity bins). ``start`` ([T, n] int64) walks from those
    nodes instead of the roots.
    """
    T = feat.shape[0]
    n = features.shape[0]
    feat, left, right = feat.long(), left.long(), right.long()
    node = (torch.zeros((T, n), dtype=torch.long, device=features.device)
            if start is None else start)
    if is_cat is not None:
        BW = cat_bitset.shape[-1]
        bits = cat_bitset.reshape(T, -1)
        strict = cat_max_bin <= 0
        max_bin_idx = cat_max_bin - 1 if not strict else BW * 32 - 1
    if missing_dec is not None:
        missing_dec = missing_dec.long()
    for _ in range(depth_cap):
        f = feat.gather(1, node)                              # [T, n]
        x = features.gather(1, f.t()).t()                     # [T, n]
        t = thr_raw.gather(1, node)
        if missing_dec is None:
            go_left = ~(x > t)
        else:
            md = missing_dec.gather(1, node)
            mt = (md >> 2) & 3                # 0 none, 1 zero, 2 NaN
            x_nan = torch.isnan(x)
            xv = torch.where(x_nan & (mt != 2), torch.zeros_like(x), x)
            use_default = (((mt == 1) & (xv.abs() <= 1e-35))
                           | ((mt == 2) & x_nan))
            go_left = torch.where(use_default, (md & 2) != 0, ~(xv > t))
        if is_cat is not None:
            xc = x if x.is_floating_point() else x.to(torch.float32)
            member = cat_member(bits, node * BW, xc, max_bin_idx, strict)
            go_left = torch.where(is_cat[f], member, go_left)
        nxt = torch.where(go_left, left.gather(1, node),
                          right.gather(1, node))
        node = torch.where(is_leaf.gather(1, node), node, nxt)
    return node


def predict_forest_raw(feat, thr_raw, left, right, is_leaf, leaf_value,
                       features: torch.Tensor, depth_cap: int,
                       **routing) -> torch.Tensor:
    """Evaluate a stacked forest on raw float features: [T, n] leaf values
    (``leaf_value`` [T, M] f32; the routing and its keyword options as
    :func:`forest_leaf_nodes`)."""
    node = forest_leaf_nodes(feat, thr_raw, left, right, is_leaf, features,
                             depth_cap, **routing)
    return leaf_value.gather(1, node)

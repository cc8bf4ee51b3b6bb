"""A/B of the port's histogram kernels on one NVIDIA GPU: an earlier
version's sources against the ones in the tree, in turns.

    mkdir -p build/ab_old && \\
        git archive <commit> mmlspark_tpu_torch/csrc | tar -x -C build/ab_old
    python3 tools/ab_node_hist.py \\
        --old-src build/ab_old/mmlspark_tpu_torch/csrc [--out FILE] \\
        [--det-ablation] [--node-ablation] [--cols-ablation]

``--old-src`` holds the earlier ``node_hist.cu``, ``node_hist_int8.cu``,
``hist_bf16.cu`` and ``node_hist_det.cu`` (and the headers they include),
with the C interfaces of commit 37446c1: kernels 1-3 take the geometry as
the tree's do (``mm_node_hist_{bf16,int8}(binned, bin_bytes, pos, base,
out, n, F, W, B, group, node_tile, cluster, row_blocks, threads,
stream)``, ``mm_hist_bf16(binned, bin_bytes, stats, out, n, F, S, B,
to_bf16, group, reps, cluster, row_blocks, threads, stream)``), and the
deterministic mode is that commit's first version, ``mm_node_hist_det(
binned, bin_bytes, pos, base, shift, acc, out, n, blocks, F, W, B, group,
tile, row_blocks, threads, stream)``, run with that commit's geometry
(:func:`det_geometry_37446c1`). They are built with the same ``nvcc``
flags as the tree's kernels (``ops/_build.py``) into
``build/ab_old_libs/``; both builds' ``-Xptxas -v`` registers and spills
are compared kernel by kernel.

Kernels 1 and 2 run at the main path's rows (F=28, int32 bins, B=255: the
root pass n=1,000,000 W=1 and the half pass n=500,000 W=8), both versions
with the tree's geometry; kernel 3 at every row of ``chip_smoke.py``'s
phase 3c (``COLS_ROWS``), both with the tree's geometry; the
deterministic mode at phase 14a's passes (n=1,000,000 in 8 blocks, W=1
and W=16). At each row both versions run on the same inputs, are checked
against each other (kernel 2 and the deterministic mode bit-equal;
kernels 1 and 3 count channels bit-equal, the other channels within 1e-4
of their magnitude), and are timed in turns old, new, new, old: warm
(mean of 20 back-to-back launches) and with L2 cold (a 256 MB write
before each launch, each launch timed alone). Each time is the wrapper's:
the output's allocation and zero-fill, the launch (the deterministic
mode: its shifts and int64 partials too).

``--det-ablation``: the deterministic mode's redesign part by part at
both passes, each step bit-equal to the first: 37446c1's kernel; the
histogram body's fixed-point mode with one 64-bit atomicAdd per value (the
tree's ``node_hist_det.cu`` built again with ``-DMM_HIST_DET_CAS_CELLS``)
and 37446c1's geometry, int64 partials and a finish launch (part 1); (lo, hi)
cells (part 2); row blocks and clusters sized for one wave (part 3);
clusters that own their items, no int64 partials (part 4, the chosen
geometry); then the chosen geometry with 64-bit cells, other cluster
sizes, row blocks, feature groups, and the clusters the card holds.
``--node-ablation``: the earlier ablation of kernels 1 and 2 at their
main-path rows and at n=500,000 W=1, with a cluster sweep, row blocks
halved and quartered, a feature-group sweep and an empty pass (every row
at pos -1). ``--cols-ablation``: kernel 3's at four rows (n=1,000,000,
int32 bins: S=2 and S=3 at B=255, S=2 at B=63 and at B=4096), by geometry
alone: one feature per block with one copy of each cell and no clusters,
then the chosen feature groups, the pair flush, the chosen copies of each
cell; the chosen geometry on misaligned inputs (scalar loads); the other
copy counts (set through the module constant ``_cols_reps`` reads);
single blocks and clusters of 4 and 8; feature groups of 2, 4, 7, 14 and
28.

Needs a CUDA GPU; prints a report (and writes it to ``--out`` if given).
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
import json
import os
import re
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import (COLS_F, COLS_MAIN, COLS_ROWS,  # noqa: E402
                        STATS_DTYPES, card_line, check_cols, check_hist,
                        cols_bound_ms, cols_inputs, cols_key, det_bound_ms,
                        hist_inputs, misaligned, node_bound_ms, time_cold_ms,
                        time_ms)
from mmlspark_tpu_torch.ops import _build  # noqa: E402
from mmlspark_tpu_torch.ops import histogram as hist_ops  # noqa: E402
from mmlspark_tpu_torch.ops.histogram_scatter import _det_shifts  # noqa: E402

F, B = 28, 255
OLD_LIBS = os.path.join(os.path.dirname(_build.BUILD_DIR), "ab_old_libs")
KINDS = {"bf16": ("node_hist", "mm_node_hist_bf16", torch.float32,
                  hist_ops._node_hist_cuda),
         "int8": ("node_hist_int8", "mm_node_hist_int8", torch.int32,
                  hist_ops._node_hist_int8_cuda)}
NODE_ROWS = ((1_000_000, 1), (500_000, 8))
# the deterministic mode's rows: phase 14a's passes, n rows in 8 blocks
DET_BLOCKS = 8
DET_ROWS = ((1_000_000, 1), (1_000_000, 16))
ABLATION_ROWS = (COLS_MAIN, (1_000_000, 3, B, "int32", "bf16", "aligned"),
                 (1_000_000, 2, 63, "int32", "bf16", "aligned"),
                 (1_000_000, 2, 4096, "int32", "bf16", "aligned"))


def build_old(src_dir: str, say, det_cas: bool = False) -> tuple:
    """Compile the earlier sources with the tree's flags and ``-Xptxas
    -v``, one ``nvcc`` each, all at once; with ``det_cas`` also the tree's
    ``node_hist_det.cu`` with ``-DMM_HIST_DET_CAS_CELLS`` (one 64-bit
    atomicAdd per shared cell, the ablation's baseline) as
    ``node_hist_det-cas``. Returns (the loaded libraries by name, nvcc's
    output by name)."""
    os.makedirs(OLD_LIBS, exist_ok=True)
    jobs = {name: (os.path.join(src_dir, f"{name}.cu"), [])
            for name in hist_ops.HIST_KERNELS}
    if det_cas:
        jobs["node_hist_det-cas"] = (_build.source_path("node_hist_det"),
                                     ["-DMM_HIST_DET_CAS_CELLS"])
    procs = {}
    for name, (src, extra) in jobs.items():
        out = os.path.join(OLD_LIBS, f"lib{name}-old.so")
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, *extra, "-Xptxas",
               "-v", "-o", out, src]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    libs, logs = {}, {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the old {name}:\n{log}")
        say(f"old {name}: nvcc -Xptxas -v\n{log.rstrip()}")
        libs[name], logs[name] = ctypes.CDLL(out), log
    return libs, logs


def ptxas_table(log: str) -> dict:
    """``{kernel template instance: (registers, spill stores, spill loads)}``
    from ``-Xptxas -v`` output, keyed by the mangled name up to its
    parameter list (a kernel that gained a parameter keeps its key)."""
    table, name, spills = {}, None, (None, None)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = re.sub(r"EEEv.*", "", m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            table[name] = (int(m.group(1)), *spills)
    return table


def compare_registers(old_logs: dict, new_logs: dict, say) -> dict:
    """Kernels 1-3's registers and spills, old against new, instance by
    instance."""
    out = {}
    for name in ("node_hist", "node_hist_int8", "hist_bf16"):
        old, new = ptxas_table(old_logs[name]), ptxas_table(new_logs[name])
        same = bool(old) and old == new
        out[name] = dict(same=same, old=old, new=new)
        say(f"{name}: -Xptxas -v registers and spills of {len(old)} kernel "
            f"instances {'identical' if same else 'DIFFER'} old against "
            f"new" + ("" if same else f": old {old}, new {new}"))
    return out


def call_c(lib, entry, args):
    """``entry(*args, stream)`` on the current stream; ``args`` are
    (ctypes type, value) pairs."""
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [t for t, _ in args] + [ctypes.c_void_p]
    code = fn(*(v for _, v in args), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, f"{entry} of {os.path.basename(lib._name)}")


def old_node_call(lib, name, entry, out_dtype, binned, pos, base, W, geo):
    """The earlier node wrapper: zero-filled output, one launch with the
    tree's geometry."""
    out = torch.zeros((F, 3 * W, B), dtype=out_dtype, device="cuda")
    call_c(lib, entry, hist_ops._node_args(name, binned, pos, base, out, W,
                                           B, geo))
    return out


def old_cols_call(lib, binned, stats, nb, stats_dtype):
    """The earlier kernel-3 wrapper: zero-filled output, one launch with
    the tree's geometry."""
    S, n = stats.shape
    out = torch.zeros((binned.shape[0], S, nb), dtype=torch.float32,
                      device="cuda")
    call_c(lib, "mm_hist_bf16", hist_ops._cols_args(
        binned, stats, out, nb, stats_dtype == torch.bfloat16, None))
    return out


def det_geometry_37446c1(rows, F, W, B, blocks):
    """The deterministic mode's geometry at commit 37446c1 (its first
    version: one row per thread per sweep, no clusters), as a
    ``NodeGeometry`` (cluster 1)."""
    item_bytes = 24 * B
    tile, tiles, budget = hist_ops._tiling(W, item_bytes, W)
    groups = -(-F // max(1, min(F, budget // (tile * item_bytes))))
    group = -(-F // groups)
    smem = group * tile * item_bytes
    wave = hist_ops._DET_SMS * max(1, min(
        hist_ops._NODE_BLOCKS_PER_SM,
        hist_ops._SM_SMEM // (smem + hist_ops._BLOCK_RESERVE)))
    items = blocks * groups * tiles
    row_blocks = max(1, min(wave // items,
                            -(-rows // (2 * hist_ops._NODE_THREADS))))
    return hist_ops.NodeGeometry(group, tile, 1, row_blocks,
                                 hist_ops._balanced_threads(rows,
                                                            row_blocks),
                                 smem, groups, tiles)


def old_det_call(lib, binned, pos, base, W, blocks):
    """Commit 37446c1's wrapper of the deterministic mode: its shifts, the
    zeroed int64 partials, its geometry; scatter and finish."""
    F, n = binned.shape
    g = det_geometry_37446c1(n // blocks, F, W, B, blocks)
    shift = _det_shifts(base, blocks)
    acc = torch.zeros((blocks, F, 3 * W, B), dtype=torch.int64,
                      device="cuda")
    out = torch.empty((blocks, F, 3 * W, B), dtype=torch.float32,
                      device="cuda")
    c = ctypes
    call_c(lib, "mm_node_hist_det", [
        (c.c_void_p, binned.data_ptr()), (c.c_int, 4),
        (c.c_void_p, pos.data_ptr()), (c.c_void_p, base.data_ptr()),
        (c.c_void_p, shift.data_ptr()), (c.c_void_p, acc.data_ptr()),
        (c.c_void_p, out.data_ptr()), (c.c_longlong, n), (c.c_int, blocks),
        (c.c_int, F), (c.c_int, W), (c.c_int, B), (c.c_int, g.group),
        (c.c_int, g.node_tile), (c.c_int, g.row_blocks),
        (c.c_int, g.threads)])
    return out


def det_call(lib, binned, pos, base, W, blocks, geo, staged):
    """``hist_ops._node_hist_det_cuda`` through ``lib`` (the tree's
    library or its 64-bit-cell build) at geometry ``geo``, with int64
    partials and a finish launch where ``staged`` (also where the clusters
    own their items: the ablation's part 3)."""
    F, n = binned.shape
    amax = torch.empty((blocks, 3), dtype=torch.int32, device="cuda")
    acc = (torch.zeros((blocks, F, 3 * W, B), dtype=torch.int64,
                       device="cuda") if staged else None)
    out = torch.empty((blocks, F, 3 * W, B), dtype=torch.float32,
                      device="cuda")
    call_c(lib, "mm_node_hist_det", hist_ops._det_args(
        binned, pos, base, amax, acc, out, W, B, blocks, geo))
    return out


def node_inputs(kind, n, W, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    binned, pos, base = hist_inputs(gen, n, F, W, B)
    if kind == "int8":
        base, _ = hist_ops.quantize_stats(base)
    return binned, pos, base.contiguous()


def same(kind, got, want, what):
    if kind == "int8":
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: int8 histograms differ")
    else:
        check_hist(got, want)


def turns(old, new):
    """Warm and cold ms of ``old`` and ``new`` in turns old, new, new, old;
    each the mean of its two turns."""
    times = {"old": [], "new": []}
    for who in ("old", "new", "new", "old"):
        fn = old if who == "old" else new
        times[who].append((time_ms(fn, reps=20), time_cold_ms(fn)))
    row = {"turns": times}
    for who in ("old", "new"):
        row[f"{who}_ms"] = sum(t[0] for t in times[who]) / 2
        row[f"{who}_ms_cold"] = sum(t[1] for t in times[who]) / 2
    return row


def ab_line(label, row, bound, by):
    return (f"{label}: old {row['old_ms']:.4f} | {row['old_ms_cold']:.4f}  "
            f"new {row['new_ms']:.4f} | {row['new_ms_cold']:.4f}  "
            f"(x{row['old_ms'] / row['new_ms']:.2f} warm, "
            f"x{row['old_ms_cold'] / row['new_ms_cold']:.2f} cold)  bound "
            f"{bound:.4f} ({by}); new at {100 * bound / row['new_ms']:.1f}% "
            f"of bound; turns " + json.dumps(row["turns"]))


def with_rows(geo, n, row_blocks, bin_bytes=4):
    """``geo`` with ``row_blocks`` row blocks, its threads balanced for
    them (``_balanced_threads``)."""
    vectors = n // hist_ops._node_rows(bin_bytes)
    return geo._replace(row_blocks=row_blocks, threads=(
        hist_ops._balanced_threads(vectors, row_blocks)))


def with_group(geo, n, group, held):
    """``geo`` with ``group`` features per block, its grid again one wave
    of whole clusters of the size it had."""
    smem = geo.smem // geo.group * group
    groups = -(-F // group)
    c = geo.cluster
    rb = held(smem, c) * c // (groups * geo.tiles) // c * c
    return with_rows(geo._replace(group=group, groups=groups, smem=smem), n,
                     max(rb, c))


@contextlib.contextmanager
def cell_copies(reps, nb):
    """``_cols_geometry`` with ``reps`` copies of each cell of ``nb`` bins
    (1, or 4 to 32): sets the bytes of copies ``_cols_reps`` fills."""
    saved = hist_ops._COLS_REP_BYTES
    hist_ops._COLS_REP_BYTES = 4 * nb * reps if reps > 1 else 0
    try:
        yield
    finally:
        hist_ops._COLS_REP_BYTES = saved


def ablate_cols(dev, sms, say, record):
    say("== ablation of the new kernel 3 (ms; warm | L2 cold)")
    for row in ABLATION_ROWS:
        n, S, nb, _, sd, _ = row
        stats_dtype = STATS_DTYPES[sd]
        to_bf16 = int(stats_dtype == torch.bfloat16)
        gen = torch.Generator(device="cuda").manual_seed(n + S + 1)
        binned, stats = cols_inputs(gen, row)

        def held(smem, c):
            return hist_ops._clusters_held("hist_bf16", dev, 4, smem, c,
                                           to_bf16)

        def geometry(Fg=COLS_F, reps=None, cluster=None):
            with (cell_copies(reps, nb) if reps else contextlib.nullcontext()):
                return hist_ops._cols_geometry(n, Fg, S, nb, 4, sms, held,
                                               cluster)

        chosen = hist_ops._cols_geometry_on(dev, n, COLS_F, S, nb, 4,
                                            bool(to_bf16))
        one = geometry(1, reps=1, cluster=1)
        per_feature = with_rows(one._replace(groups=COLS_F), n, max(
            1, held(one.smem, 1) // (COLS_F * one.tiles)))
        want = hist_ops._hist_cuda(binned, stats, nb, stats_dtype)
        skewed = (misaligned(binned), misaligned(stats))
        plain = (binned, stats)
        steps = [("one feature per block, one copy, no clusters",
                  per_feature, plain),
                 ("+ feature groups", geometry(reps=1, cluster=1), plain),
                 ("+ pair flush", geometry(reps=1), plain),
                 (f"+ {chosen.reps} copies of each cell (the chosen "
                  "geometry)" if chosen.reps > 1 else
                  "the chosen geometry (one copy of each cell)", chosen,
                  plain),
                 ("chosen geometry, misaligned rows (scalar loads)", chosen,
                  skewed)]
        for R in (1, 4, 8, 16, 32):
            if R != chosen.reps and 4 * nb * R <= hist_ops._SMEM_MAX and (
                    R > 1 or chosen.reps > 1):
                steps.append((f"{R} copies", geometry(reps=R), plain))
        for c in (1, 4, 8):
            try:
                if c != chosen.cluster:
                    steps.append((f"cluster {c}", geometry(cluster=c), plain))
            except ValueError as e:   # too few row blocks for one cluster
                say(f"hist_bf16 {cols_key(row)} cluster {c}: not run ({e})")
        for g in (2, 4, 7, 14, 28):
            if g != chosen.group and g * chosen.smem // chosen.group <= (
                    hist_ops._SMEM_MAX):
                steps.append((f"group {g}", with_group(chosen, n, g, held),
                              plain))
        for label, geo, (b_, s_) in steps:
            def call(geo=geo, b_=b_, s_=s_):
                return hist_ops._hist_cuda(b_, s_, nb, stats_dtype,
                                           geometry=geo)
            check_cols(call(), want, f"hist_bf16 {label}")
            ms, cold = time_ms(call, reps=20), time_cold_ms(call)
            n_held = held(geo.smem, geo.cluster)
            record["ablation"].append(dict(
                kernel="hist_bf16", row=cols_key(row), step=label,
                geometry=geo._asdict(), ms=ms, ms_cold=cold,
                clusters_held=n_held))
            say(f"hist_bf16 {cols_key(row)} {label}: {ms:.4f} | {cold:.4f}  "
                f"[group {geo.group}, copies {geo.reps}, cluster {geo.cluster}, "
                f"{geo.row_blocks * geo.groups * geo.tiles} blocks; card "
                f"holds {n_held} clusters]")
        del binned, stats, skewed, want


def ablate_nodes(dev, sms, say, record):
    say("== ablation of the new kernels 1 and 2 (ms; warm | L2 cold)")
    for kind, (name, _, _, new_fn) in KINDS.items():
        for n, W in NODE_ROWS + ((500_000, 1),):
            binned, pos, base = node_inputs(kind, n, W, seed=n + W + 1)

            def held(smem, c, name=name):
                return hist_ops._clusters_held(name, dev, 4, smem, c)

            def forced(c):
                return hist_ops._node_geometry(n, F, W, B, 4, sms, held,
                                               cluster=c)
            chosen = hist_ops._geometry_on(name, dev, n, F, W, B, 4)
            one = hist_ops._node_geometry(n, 1, W, B, 4, sms, held,
                                          cluster=1)
            per_feature = with_rows(one._replace(groups=F), n, max(
                1, held(one.smem, 1) // (F * one.tiles)))
            want = new_fn(binned, pos, base, W, B)
            skewed = [misaligned(t) for t in (binned, pos, base)]
            steps = [("one feature per block, no clusters", per_feature,
                      (binned, pos, base)),
                     ("+ feature groups", forced(1), (binned, pos, base)),
                     ("+ cluster flush (the chosen geometry)", chosen,
                      (binned, pos, base)),
                     ("chosen geometry, misaligned rows (scalar loads)",
                      chosen, skewed)]
            for c in (1, 2, 4, 8):
                if c != chosen.cluster:
                    steps.append((f"cluster {c}", forced(c),
                                  (binned, pos, base)))
            for k in (2, 4):
                rb = chosen.row_blocks // k // chosen.cluster * chosen.cluster
                if rb >= chosen.cluster:
                    steps.append((f"row blocks / {k}",
                                  with_rows(chosen, n, rb),
                                  (binned, pos, base)))
            for g in (1, 2, 4, 7, 14, 28):
                if g != chosen.group and g * chosen.smem // chosen.group <= (
                        hist_ops._SMEM_MAX):
                    steps.append((f"group {g}",
                                  with_group(chosen, n, g, held),
                                  (binned, pos, base)))
            steps.append(("empty pass (every row at pos -1)", chosen,
                          (binned, torch.full_like(pos, -1), base)))
            for label, geo, (b_, p_, s_) in steps:
                def call(geo=geo, b_=b_, p_=p_, s_=s_):
                    return new_fn(b_, p_, s_, W, B, geometry=geo)
                if p_ is pos or p_ is skewed[1]:
                    same(kind, call(), want, f"{name} {label}")
                elif call().any():
                    raise AssertionError(f"{name} {label}: not all zero")
                ms, cold = time_ms(call, reps=20), time_cold_ms(call)
                record["ablation"].append(dict(
                    kernel=name, n=n, W=W, step=label,
                    geometry=geo._asdict(), ms=ms, ms_cold=cold,
                    clusters_held=held(geo.smem, geo.cluster)))
                say(f"{name} n={n} W={W} {label}: {ms:.4f} | {cold:.4f}  "
                    f"[group {geo.group}, cluster {geo.cluster}, "
                    f"{geo.row_blocks * geo.groups * geo.tiles} blocks; "
                    f"card holds {held(geo.smem, geo.cluster)} clusters]")
            del binned, pos, base, skewed, want


def det_inputs(n, W, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return hist_inputs(gen, n, F, W, B)


def same_det(got, want, what):
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"{what}: {bad} cells differ")


def ab_det(old_lib, say, record):
    """The deterministic mode, 37446c1's kernel against the tree's, at
    phase 14a's passes; kernel 1 at the same shape beside them."""
    for n, W in DET_ROWS:
        binned, pos, base = det_inputs(n, W, seed=n + W)

        def old():
            return old_det_call(old_lib, binned, pos, base, W, DET_BLOCKS)

        def new():
            return hist_ops._node_hist_det_cuda(binned, pos, base, W, B,
                                                DET_BLOCKS)

        same_det(new(), old(), f"node_hist_det n={n} W={W}")
        row = turns(old, new)
        bound, by = det_bound_ms(binned, pos, base, W, B, DET_BLOCKS)
        k1 = lambda: hist_ops._node_hist_cuda(binned, pos, base, W, B)
        row.update(kernel="node_hist_det", n=n, W=W, blocks=DET_BLOCKS,
                   geometry=hist_ops._det_geometry(
                       n // DET_BLOCKS, F, W, B, DET_BLOCKS)._asdict(),
                   old_geometry=det_geometry_37446c1(
                       n // DET_BLOCKS, F, W, B, DET_BLOCKS)._asdict(),
                   bound_ms=bound, bound_by=by,
                   kernel1_ms=time_ms(k1, reps=20),
                   kernel1_ms_cold=time_cold_ms(k1))
        record["ab"].append(row)
        say(ab_line(f"node_hist_det n={n} in {DET_BLOCKS} blocks W={W}",
                    row, bound, by) + f"; bit-equal; kernel 1 at this "
            f"shape {row['kernel1_ms']:.4f} | {row['kernel1_ms_cold']:.4f}")
        del binned, pos, base


def ablate_det(dev, old_lib, cas_lib, say, record):
    """The deterministic mode's redesign part by part (module docstring),
    every step bit-equal to 37446c1's kernel on the same inputs; ``cas_lib``
    is the tree's mode built with 64-bit cells."""
    say("== ablation of the deterministic mode (ms; warm | L2 cold)")
    libs = {True: _build.load("node_hist_det"), False: cas_lib}

    def held(smem, c):
        return hist_ops._clusters_held("node_hist_det", dev, 4, smem, c)

    for smem in (42_840, 97_920, 150_000):
        say(f"node_hist_det clusters held at {smem} B of shared memory: " +
            ", ".join(f"{c}: {held(smem, c)}" for c in (1, 2, 4, 8)))
        record["det_clusters_held"][smem] = {c: held(smem, c)
                                             for c in (1, 2, 4, 8)}
    for n, W in DET_ROWS:
        rows = n // DET_BLOCKS
        binned, pos, base = det_inputs(n, W, seed=n + W + 1)
        want = old_det_call(old_lib, binned, pos, base, W, DET_BLOCKS)
        old_geo = det_geometry_37446c1(rows, F, W, B, DET_BLOCKS)
        chosen = hist_ops._det_geometry(rows, F, W, B, DET_BLOCKS)
        nv = rows // hist_ops._DET_ROWS
        base_geo = old_geo._replace(threads=hist_ops._balanced_threads(
            nv, old_geo.row_blocks))
        items = DET_BLOCKS * chosen.groups * chosen.tiles

        def geo_with(geo, cluster, row_blocks):
            return geo._replace(cluster=cluster, row_blocks=row_blocks,
                                threads=hist_ops._balanced_threads(
                                    nv, row_blocks))

        steps = [("37446c1's kernel", None, None, None),
                 ("part 1: the body's fixed-point mode, 64-bit cells, "
                  "37446c1's geometry, int64 partials", base_geo, True,
                  False),
                 ("+ part 2: (lo, hi) cells", base_geo, True, True),
                 ("+ part 3: row blocks and clusters for one wave",
                  chosen, True, True)]
        if not hist_ops._det_staged(chosen):
            steps.append(("+ part 4: clusters own their items (the chosen "
                          "geometry)", chosen, False, True))
        steps.append(("chosen geometry, 64-bit cells", chosen, None, False))
        for c in (1, 2, 4, 8):
            per_item = held(chosen.smem, c) // items
            for k in sorted({1, per_item} - {0}):
                rb = c * k
                if (c, rb) != (chosen.cluster, chosen.row_blocks) and \
                        rb * items <= 4 * hist_ops._DET_SMS * 2:
                    g = geo_with(chosen, c, rb)
                    steps.append((f"cluster {c}, {rb} row blocks", g, None,
                                  True))
        for k in (2, 4):
            rb = chosen.row_blocks * k
            steps.append((f"row blocks x{k} (cluster {chosen.cluster})",
                          geo_with(chosen, chosen.cluster, rb), None, True))
            if chosen.cluster * k <= 8:
                steps.append((f"row blocks x{k}, clusters own their items",
                              geo_with(chosen, chosen.cluster * k, rb),
                              None, True))
        for t in (4, 8):
            if t < chosen.node_tile:
                grp = max(1, min(F, (hist_ops._SM_SMEM // 2 -
                                     hist_ops._BLOCK_RESERVE) // (
                                         t * 24 * B)))
                g = chosen._replace(node_tile=t, tiles=-(-W // t), group=grp,
                                    groups=-(-F // grp),
                                    smem=grp * t * 24 * B)
                per_item = held(g.smem, 1) // (DET_BLOCKS * g.groups *
                                               g.tiles)
                for c in sorted({1, min(8, per_item)} - {0}):
                    steps.append((f"tile {t}, group {grp}, cluster {c}",
                                  geo_with(g, c, c), None, True))
        for grp in (1, 2, 4, 7, 14):
            if grp != chosen.group and grp * chosen.node_tile * 24 * B <= \
                    hist_ops._SMEM_MAX:
                groups = -(-F // grp)
                g = chosen._replace(group=grp, groups=groups,
                                    smem=grp * chosen.node_tile * 24 * B)
                c = chosen.cluster
                rb = max(c, held(g.smem, c) // (DET_BLOCKS * groups *
                                                g.tiles) * c)
                steps.append((f"group {grp}", geo_with(g, c, rb), None,
                              True))
        # what the scatter's adds cost: the chosen geometry with no row in
        # a node (pos and the test that skips a vector), and with zero
        # stats (every load and conversion, no add)
        inputs = {"": (binned, pos, base),
                  "empty": (binned, torch.full_like(pos, -1), base),
                  "zero": (binned, pos, torch.zeros_like(base))}
        steps += [("empty pass (every row at pos -1)", chosen, None, True,
                   "empty"),
                  ("zero stats (loads and conversions, no add)", chosen,
                   None, True, "zero")]
        for label, geo, staged, pair, *which in steps:
            b_, p_, s_ = inputs[which[0] if which else ""]
            if geo is None:
                def call():
                    return old_det_call(old_lib, b_, p_, s_, W, DET_BLOCKS)
            else:
                if staged is None:
                    staged = hist_ops._det_staged(geo)

                def call(geo=geo, staged=staged, pair=pair, b_=b_, p_=p_,
                         s_=s_):
                    return det_call(libs[pair], b_, p_, s_, W, DET_BLOCKS,
                                    geo, staged)
            if which:
                same_det(call(), old_det_call(old_lib, b_, p_, s_, W,
                                              DET_BLOCKS),
                         f"node_hist_det W={W} {label}")
            else:
                same_det(call(), want, f"node_hist_det W={W} {label}")
            ms, cold = time_ms(call, reps=20), time_cold_ms(call)
            info = {} if geo is None else dict(
                geometry=geo._asdict(), clusters_held=held(geo.smem,
                                                           geo.cluster),
                staged=staged, pair_cells=pair)
            record["ablation"].append(dict(kernel="node_hist_det", n=n, W=W,
                                           step=label, ms=ms, ms_cold=cold,
                                           **info))
            g = geo or old_geo
            say(f"node_hist_det W={W} {label}: {ms:.4f} | {cold:.4f}  "
                f"[group {g.group}, tile {g.node_tile}, cluster {g.cluster}, "
                f"{g.row_blocks} row blocks, {g.threads} threads, "
                f"{g.row_blocks * g.groups * g.tiles * DET_BLOCKS} blocks"
                + ("" if geo is None else
                   f"; {'int64 partials' if info['staged'] else 'owned'}, "
                   f"{'(lo, hi)' if pair else '64-bit'} cells; card holds "
                   f"{info['clusters_held']} clusters") + "]")
        del binned, pos, base, want


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-src", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--det-ablation", action="store_true")
    ap.add_argument("--node-ablation", action="store_true")
    ap.add_argument("--cols-ablation", action="store_true")
    ap.add_argument("--det-only", action="store_true",
                    help="no rows of kernels 1-3 in the A/B")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_node_hist: no CUDA GPU is available")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        open(args.out, "w").close()

    def say(msg):
        print(msg, flush=True)
        if args.out:   # as it goes: a run cut short keeps its lines
            with open(args.out, "a") as f:
                f.write(msg + "\n")

    card = card_line()
    say(card)
    old_libs, old_logs = build_old(args.old_src, say,
                                   det_cas=args.det_ablation)
    new_logs = {}
    for name in hist_ops.HIST_KERNELS:
        if os.path.isfile(_build.library_path(name)):
            raise SystemExit(f"ab_node_hist: {name} is built already; "
                             "remove build/mmlspark_tpu_torch to read its "
                             "-Xptxas -v")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        for name in hist_ops.HIST_KERNELS:   # one at a time: one log each
            _build.build(name, verbose=True)
            new_logs[name] = buf.getvalue()
            buf.seek(0)
            buf.truncate()
    for name in hist_ops.HIST_KERNELS:
        say(f"new {name}: nvcc -Xptxas -v\n{new_logs[name].rstrip()}")
    dev = torch.cuda.current_device()
    sms = hist_ops._num_sms_of(dev)
    record = {"card": card, "ab": [], "ablation": [],
              "det_clusters_held": {},
              "registers": compare_registers(old_logs, new_logs, say)}

    say("== A/B in turns old, new, new, old (ms; warm | L2 cold)")
    for kind, (name, entry, out_dtype, new_fn) in (
            () if args.det_only else KINDS.items()):
        for n, W in NODE_ROWS:
            binned, pos, base = node_inputs(kind, n, W, seed=n + W)
            geo = hist_ops._geometry_on(name, dev, n, F, W, B, 4)

            def old():
                return old_node_call(old_libs[name], name, entry, out_dtype,
                                     binned, pos, base, W, geo)

            def new():
                return new_fn(binned, pos, base, W, B)

            same(kind, new(), old(), f"{name} n={n} W={W}")
            row = turns(old, new)
            bound, by = node_bound_ms(binned, pos, base, W, B)
            row.update(kernel=name, n=n, W=W, geometry=geo._asdict(),
                       bound_ms=bound, bound_by=by)
            record["ab"].append(row)
            say(ab_line(f"{name} n={n} W={W}", row, bound, by))
            del binned, pos, base

    ab_det(old_libs["node_hist_det"], say, record)

    for row_key in (() if args.det_only else COLS_ROWS):
        n, S, nb, _, sd, _ = row_key
        stats_dtype = STATS_DTYPES[sd]
        gen = torch.Generator(device="cuda").manual_seed(n + S + nb)
        binned, stats = cols_inputs(gen, row_key)

        def old():
            return old_cols_call(old_libs["hist_bf16"], binned, stats, nb,
                                 stats_dtype)

        def new():
            return hist_ops.histogram_cols(binned, stats, nb, stats_dtype)

        check_cols(new(), old(), f"hist_bf16 {cols_key(row_key)}")
        row = turns(old, new)
        bound, by = cols_bound_ms(binned, stats, nb)
        geo = hist_ops._cols_geometry_on(dev, n, COLS_F, S, nb,
                                         binned.element_size(),
                                         stats_dtype == torch.bfloat16)
        row.update(kernel="hist_bf16", row=cols_key(row_key),
                   geometry=geo._asdict(), bound_ms=bound, bound_by=by)
        record["ab"].append(row)
        say(ab_line(f"hist_bf16 {cols_key(row_key)}", row, bound, by))
        del binned, stats

    if args.det_ablation:
        ablate_det(dev, old_libs["node_hist_det"],
                   old_libs["node_hist_det-cas"], say, record)
    if args.cols_ablation:
        ablate_cols(dev, sms, say, record)
    if args.node_ablation:
        ablate_nodes(dev, sms, say, record)

    say("ab: " + json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())

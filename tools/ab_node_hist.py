"""A/B of the port's histogram kernels on one NVIDIA GPU: an earlier
version's sources against the ones in the tree, in turns.

    mkdir -p build/ab_old && \\
        git archive <commit> mmlspark_tpu_torch/csrc | tar -x -C build/ab_old
    python3 tools/ab_node_hist.py \\
        --old-src build/ab_old/mmlspark_tpu_torch/csrc [--out FILE] \\
        [--node-ablation]

``--old-src`` holds the earlier ``node_hist.cu``, ``node_hist_int8.cu`` and
``hist_bf16.cu`` (and the headers they include), with the C interfaces of
commit 15ded84: the node kernels take the geometry as the tree's do,
``mm_node_hist_{bf16,int8}(binned, bin_bytes, pos, base, out, n, F, W, B,
group, node_tile, cluster, row_blocks, threads, stream)``, and kernel 3
takes none, ``mm_hist_bf16(binned, bin_bytes, stats, out, n, F, S, B,
to_bf16, stream)``. They are built with the same ``nvcc`` flags as the
tree's kernels (``ops/_build.py``) into ``build/ab_old_libs/``.

Kernels 1 and 2 run at the main path's rows (F=28, int32 bins, B=255: the
root pass n=1,000,000 W=1 and the half pass n=500,000 W=8), both versions
with the tree's geometry; kernel 3 at every row of ``chip_smoke.py``'s
phase 3c (``COLS_ROWS``). At each row both versions run on the same
inputs, are checked against each other (kernel 2 bit-equal; kernels 1 and
3 count channels bit-equal, the other channels within 1e-4 of their
magnitude), and are timed in turns old, new, new, old: warm (mean of 20
back-to-back launches) and with L2 cold (a 256 MB write before each
launch, each launch timed alone). Each time is the wrapper's: the output's
zero-fill and the launch.

An ablation of the tree's kernel 3 follows at four rows (n=1,000,000,
int32 bins: S=2 and S=3 at B=255, S=2 at B=63 and at B=4096), by geometry
alone: one feature per block with one copy of each cell and no clusters
(16-byte loads, grid sized to the card), then the chosen feature groups,
then the pair flush, then the chosen copies of each cell (the chosen
geometry); the chosen geometry on misaligned inputs (scalar loads); the
other copy counts (1 and 4 to 32, as many as fit, set through the module
constant ``_cols_reps`` reads); single blocks and clusters of 4 and 8;
feature groups of 2, 4, 7, 14 and 28. With ``--node-ablation``, the
same for kernels 1 and 2 at their main-path rows and at n=500,000 W=1,
with a cluster sweep, row blocks halved and quartered, a feature-group
sweep and an empty pass (every row at pos -1).

Needs a CUDA GPU; prints a report (and writes it to ``--out`` if given).
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import (COLS_F, COLS_MAIN, COLS_ROWS,  # noqa: E402
                        STATS_DTYPES, card_line, check_cols, check_hist,
                        cols_bound_ms, cols_inputs, cols_key, hist_inputs,
                        misaligned, node_bound_ms, time_cold_ms, time_ms)
from mmlspark_tpu_torch.ops import _build  # noqa: E402
from mmlspark_tpu_torch.ops import histogram as hist_ops  # noqa: E402

F, B = 28, 255
OLD_LIBS = os.path.join(os.path.dirname(_build.BUILD_DIR), "ab_old_libs")
KINDS = {"bf16": ("node_hist", "mm_node_hist_bf16", torch.float32,
                  hist_ops._node_hist_cuda),
         "int8": ("node_hist_int8", "mm_node_hist_int8", torch.int32,
                  hist_ops._node_hist_int8_cuda)}
NODE_ROWS = ((1_000_000, 1), (500_000, 8))
ABLATION_ROWS = (COLS_MAIN, (1_000_000, 3, B, "int32", "bf16", "aligned"),
                 (1_000_000, 2, 63, "int32", "bf16", "aligned"),
                 (1_000_000, 2, 4096, "int32", "bf16", "aligned"))


def build_old(src_dir: str, say) -> dict:
    """Compile the earlier sources with the tree's flags (and ``-Xptxas
    -v``, whose registers and spills are reported); returns the loaded
    libraries by kernel name."""
    os.makedirs(OLD_LIBS, exist_ok=True)
    procs = {}
    for name in hist_ops.KERNELS:
        out = os.path.join(OLD_LIBS, f"lib{name}-old.so")
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-o", out,
               os.path.join(src_dir, f"{name}.cu")]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the old {name}:\n{log}")
        say(f"old {name}: nvcc -Xptxas -v\n{log.rstrip()}")
        libs[name] = ctypes.CDLL(out)
    return libs


def call_c(lib, entry, args):
    """``entry(*args, stream)`` on the current stream; ``args`` are
    (ctypes type, value) pairs."""
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [t for t, _ in args] + [ctypes.c_void_p]
    code = fn(*(v for _, v in args), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, f"old {entry}")


def old_node_call(lib, name, entry, out_dtype, binned, pos, base, W, geo):
    """The earlier node wrapper: zero-filled output, one launch with the
    tree's geometry."""
    out = torch.zeros((F, 3 * W, B), dtype=out_dtype, device="cuda")
    call_c(lib, entry, hist_ops._node_args(name, binned, pos, base, out, W,
                                           B, geo))
    return out


def old_cols_call(lib, binned, stats, nb, stats_dtype):
    """The earlier kernel-3 wrapper: zero-filled output, one launch that
    chooses its own grid."""
    S, n = stats.shape
    out = torch.zeros((binned.shape[0], S, nb), dtype=torch.float32,
                      device="cuda")
    c = ctypes
    call_c(lib, "mm_hist_bf16", [
        (c.c_void_p, binned.data_ptr()), (c.c_int, binned.element_size()),
        (c.c_void_p, stats.data_ptr()), (c.c_void_p, out.data_ptr()),
        (c.c_longlong, n), (c.c_int, binned.shape[0]), (c.c_int, S),
        (c.c_int, nb), (c.c_int, int(stats_dtype == torch.bfloat16))])
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-src", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--node-ablation", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_node_hist: no CUDA GPU is available")
    lines = [card_line()]

    def say(msg):
        print(msg, flush=True)
        lines.append(msg)

    say(lines[0])
    old_libs = build_old(args.old_src, say)
    say("new kernels: nvcc -Xptxas -v (below, unless already built)")
    _build.build_all(hist_ops.KERNELS, verbose=True)
    dev = torch.cuda.current_device()
    sms = hist_ops._num_sms_of(dev)
    record = {"card": lines[0], "ab": [], "ablation": []}

    say("== A/B in turns old, new, new, old (ms; warm | L2 cold)")
    for kind, (name, entry, out_dtype, new_fn) in KINDS.items():
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

    for row_key in COLS_ROWS:
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

    ablate_cols(dev, sms, say, record)
    if args.node_ablation:
        ablate_nodes(dev, sms, say, record)

    say("ab: " + json.dumps(record))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

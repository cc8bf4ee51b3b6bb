"""A/B of the node-histogram kernels (kernels 1 and 2) on one NVIDIA GPU:
an earlier version's sources against the ones in the tree, in turns.

    mkdir -p build/ab_old && \\
        git archive <commit> mmlspark_tpu_torch/csrc | tar -x -C build/ab_old
    python3 tools/ab_node_hist.py \\
        --old-src build/ab_old/mmlspark_tpu_torch/csrc [--out FILE]

``--old-src`` holds the earlier ``node_hist.cu`` and ``node_hist_int8.cu``
(and the headers they include), whose C entry points take no geometry:
``mm_node_hist_{bf16,int8}(binned, bin_bytes, pos, base, out, n, F, W, B,
stream)``. They are built with the same ``nvcc`` flags as the tree's
kernels (``ops/_build.py``) into ``build/ab_old_libs/``.

At each shape (F=28, int32 bins, B=255: the root pass n=1,000,000 W=1, the
half pass n=500,000 at W=8, at W=16 for kernel 1 and W=15 for kernel 2,
and at the narrow frontiers of a fit's early rounds, W in {1, 2, 4}) both
versions run on the same inputs, are checked against each
other (kernel 2 bit-equal; kernel 1's count channel bit-equal, grad/hess
within 1e-4 of the channel's magnitude), and are timed in turns old, new,
new, old: warm (mean of 20 back-to-back launches) and with L2 cold (a
256 MB write before each launch, each launch timed alone). Each time is
the wrapper's: the output's zero-fill and the launch.

An ablation of the tree's kernel follows, at the four main-path rows and
at n=500,000 W=1, by geometry alone: one feature per block without
clusters (16-byte loads, grid sized to the card), then the chosen feature
groups without clusters, then the chosen geometry; and the chosen
geometry on inputs offset by one element, so every array row is
misaligned and takes scalar loads. Then a cluster-size sweep at the chosen
groups (``cudaOccupancyMaxActiveClusters`` beside each size), the chosen
geometry with a half and a quarter of its row blocks, a feature-group
sweep at the chosen cluster size, and an empty pass
(every row at pos -1: zero-fill, launch, shared-memory clear, cluster
syncs and a flush with nothing to add).

Needs a CUDA GPU; prints a report (and writes it to ``--out`` if given).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import (card_line, check_hist, hist_inputs,  # noqa: E402
                        node_bound_ms, time_cold_ms, time_ms)
from mmlspark_tpu_torch.ops import _build  # noqa: E402
from mmlspark_tpu_torch.ops import histogram as hist_ops  # noqa: E402

F, B = 28, 255
OLD_LIBS = os.path.join(os.path.dirname(_build.BUILD_DIR), "ab_old_libs")
KINDS = {"bf16": ("node_hist", "mm_node_hist_bf16", torch.float32,
                  hist_ops._node_hist_cuda),
         "int8": ("node_hist_int8", "mm_node_hist_int8", torch.int32,
                  hist_ops._node_hist_int8_cuda)}


def build_old(src_dir: str) -> dict:
    """Compile the earlier sources with the tree's flags; returns the
    loaded libraries by kernel name."""
    os.makedirs(OLD_LIBS, exist_ok=True)
    procs = {}
    for name, _, _, _ in KINDS.values():
        out = os.path.join(OLD_LIBS, f"lib{name}-old.so")
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", out,
               os.path.join(src_dir, f"{name}.cu")]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the old {name}:\n{log}")
        libs[name] = ctypes.CDLL(out)
    return libs


def old_call(lib, entry, out_dtype, binned, pos, base, W):
    """The earlier wrapper: zero-filled output, one launch on the current
    stream."""
    n = binned.shape[1]
    out = torch.zeros((F, 3 * W, B), dtype=out_dtype, device="cuda")
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    c = ctypes
    fn.argtypes = [c.c_void_p, c.c_int, c.c_void_p, c.c_void_p, c.c_void_p,
                   c.c_longlong, c.c_int, c.c_int, c.c_int, c.c_void_p]
    code = fn(binned.data_ptr(), 4, pos.data_ptr(), base.data_ptr(),
              out.data_ptr(), n, F, W, B,
              torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, f"old {entry}")
    return out


def inputs(kind, n, W, seed):
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


def with_rows(geo, n, row_blocks):
    """``geo`` with ``row_blocks`` row blocks, its threads balanced for
    them (``_balanced_threads``)."""
    vectors = n // hist_ops._node_rows(4)
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


def misaligned(t):
    """A contiguous copy of ``t`` whose data starts one element past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-src", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_node_hist: no CUDA GPU is available")
    lines = [card_line()]

    def say(msg):
        print(msg, flush=True)
        lines.append(msg)

    say(lines[0])
    old_libs = build_old(args.old_src)
    _build.build_all([k[0] for k in KINDS.values()])
    dev = torch.cuda.current_device()
    sms = hist_ops._num_sms_of(dev)
    record = {"card": lines[0], "ab": [], "ablation": []}

    shapes = {"bf16": ((1_000_000, 1), (500_000, 8), (500_000, 16),
                       (500_000, 1), (500_000, 2), (500_000, 4)),
              "int8": ((1_000_000, 1), (500_000, 8), (500_000, 15),
                       (500_000, 1), (500_000, 2), (500_000, 4))}
    say("== A/B in turns old, new, new, old (ms; warm | L2 cold)")
    for kind, (name, entry, out_dtype, new_fn) in KINDS.items():
        for n, W in shapes[kind]:
            binned, pos, base = inputs(kind, n, W, seed=n + W)
            geo = hist_ops._geometry_on(name, dev, n, F, W, B, 4)

            def old():
                return old_call(old_libs[name], entry, out_dtype, binned,
                                pos, base, W)

            def new():
                return new_fn(binned, pos, base, W, B)

            same(kind, new(), old(), f"{name} n={n} W={W}")
            times = {"old": [], "new": []}
            for who in ("old", "new", "new", "old"):
                fn = old if who == "old" else new
                times[who].append((time_ms(fn, reps=20), time_cold_ms(fn)))
            bound, by = node_bound_ms(binned, pos, base, W, B)
            row = dict(kernel=name, n=n, W=W, geometry=geo._asdict(),
                       bound_ms=bound, bound_by=by, turns=times)
            for who in ("old", "new"):
                row[f"{who}_ms"] = sum(t[0] for t in times[who]) / 2
                row[f"{who}_ms_cold"] = sum(t[1] for t in times[who]) / 2
            record["ab"].append(row)
            say(f"{name} n={n} W={W}: old {row['old_ms']:.4f} | "
                f"{row['old_ms_cold']:.4f}  new {row['new_ms']:.4f} | "
                f"{row['new_ms_cold']:.4f}  (x{row['old_ms'] / row['new_ms']:.2f}"
                f" warm, x{row['old_ms_cold'] / row['new_ms_cold']:.2f} cold)"
                f"  bound {bound:.4f} ({by}); new at "
                f"{100 * bound / row['new_ms']:.1f}% of bound; turns "
                + json.dumps(times))
            del binned, pos, base

    say("== ablation of the new kernel at the main-path rows (ms; warm | "
        "L2 cold)")
    for kind, (name, _, _, new_fn) in KINDS.items():
        for n, W in shapes[kind][:2] + shapes[kind][3:4]:
            binned, pos, base = inputs(kind, n, W, seed=n + W + 1)
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

    say("ab: " + json.dumps(record))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Rehearse phases of ``chip_smoke.py`` on the CPU, at a small size.

    python tools/rehearse_chip_smoke.py p6 p8 p8b p9 [--rows 40000]
    python tools/rehearse_chip_smoke.py p10 p10b [--higgs-rows 200000]
    python tools/rehearse_chip_smoke.py p11 [--rows 40000 --higgs-rows 200000]
    python tools/rehearse_chip_smoke.py p12 [--rows 40000 --higgs-rows 20000]
    python tools/rehearse_chip_smoke.py p13 [--rows 40000 --higgs-rows 20000]
    python tools/rehearse_chip_smoke.py p14 [--rows 40000 --higgs-rows 40000]
    python tools/rehearse_chip_smoke.py p15 [--vw-rows 200000 --events 2000]
    python tools/rehearse_chip_smoke.py p16 [--higgs-rows 200000
        --sift-base 100000 --aa-scale 0.25]
    python tools/rehearse_chip_smoke.py p17 [--dnn-images 256
        --feat-rows 1024 --lime-images 1]
    python tools/rehearse_chip_smoke.py p18 [--higgs-rows 100000
        --http-rows 2000]
    python tools/rehearse_chip_smoke.py p19 [--tf-width 64 --tf-seq 256]
    python tools/rehearse_chip_smoke.py p20 [--higgs-rows 40000
        --vw-rows 50000]
    python tools/rehearse_chip_smoke.py p21 [--higgs-rows 40000]
    python tools/rehearse_chip_smoke.py p7 p22

Runs the named phases of a copy of ``chip_smoke.py`` with every ``cuda``
device replaced by ``cpu`` (and the profiler's device activity by its
host activity): the kernels' wrappers then take their plain
versions (counted as launches here), the card's timers and memory calls
are stubbed, the Covertype-shaped phases use ``--rows`` training rows
(a quarter of that held out) and the HIGGS-shaped ones ``--higgs-rows``
(a fifth of that held out). It finds Python-level faults before a chip
run and gives the quality a phase reaches at a small size, from which its
floors are set. Times it prints are CPU times, not device times.

Phases: ``p6`` (multiclass on one-hot columns), ``p8`` (categorical
multiclass), ``p8b`` (small categorical fits, which compare the CPU with
itself here), ``p9`` (the LightGBM text corpus and a CSR fit), ``p10``
(phase 4's default fit, then every training option warm-started from it
or beside it), ``p10b`` (the small fits of the training options), ``p11``
(phases 4, 4b, 6 and 8 for their models, then phase 11: the predict lanes,
contributions through the device TreeSHAP engine, which
``MMLSPARK_TPU_SHAP_DEVICE=1`` selects on the CPU, and the out-of-core
ingest with streamed scoring), ``p12`` (phases 4b and 6 for their models,
then phase 12's serving on the CPU; ``/healthz`` is told it runs on a
card, which it cannot see here), ``p13`` (phases 4, 4b and 6 for their
models, then phase 13 on the CPU: the plan route against the eager body,
the batch costs, a bundle, bundled ``serving_main`` workers behind a
gateway in subprocesses on the CPU, the checkpoint modes; the holds that
need a graph — one graph launch per call, a graph per bucketed key — wait
for the card), ``p14`` (phases 4, 4b and 6 for their models, then phase
14: the deterministic mode and its bit-exact plain version
``node_hist_det_plain`` both stood in for by ``node_hist_blocked_plain``,
as the CPU ranks' blocked route takes it, the blocked fits, the world-size-2 fit as two gloo processes on the CPU,
voting, telemetry, the pickled boosters), ``p15`` (phase 15: the VW fit
on ``--vw-rows`` Criteo-shaped rows, a fifth of that held out, its step
costs and scatter-add; the small VW fits, streamed and resumed; L-BFGS on
at most 200,000 of the rows; the bandit on ``--events`` events;
TrainClassifier on the Adult-shaped rows and the text chain — every
"cuda against cpu" check compares the CPU with itself here), ``p16``
(phase 16: the isolation forest on ``--higgs-rows`` rows, KNN on
``--sift-base`` sift-shaped rows and a hundredth of that as queries
(at least 100), SAR at MovieLens-1M's full size, AccessAnomaly on
departments scaled by ``--aa-scale``; the cuda-against-cpu checks again
compare the CPU with itself), ``p17`` (phase 17: ResNet-50 over
``--dnn-images`` preprocessed images per lane, the catalog, the
featurizer over ``--feat-rows`` pictures, three quarters of them training
the GBDT head, kernel 1's rows at that head's width, streamed scoring over
a quarter of the images and 64 JPEG files, ImageLIME at its defaults on
``--lime-images`` pictures, the DigitsConvNet fixture; the f32 lane's
spread holds compare the CPU with itself), ``p18`` (phases 4 and 4b for
their models, then phase 18: the tuning's two routes on ``--higgs-rows``
rows, the small tuning and ``FindBestModel``, the HTTP stages over
``--http-rows`` rows against a ``serving_main`` worker subprocess on the
CPU, the model fetched by ``http://``; "cuda against cpu" compares the CPU
with itself), ``p19`` (phase 19: the transformer's three strategies at
``d_model=--tf-width`` over 2 x ``--tf-seq`` tokens, the narrow config
"cuda against cpu", and 19b's four gloo ranks as CPU processes), ``p20``
(phase 20 on ``--higgs-rows`` rows and ``--vw-rows`` Criteo-shaped rows:
its three stages of two gloo ranks as CPU processes; the ranks' launch
holds wait for the card, since their plain versions count nothing), ``p21``
(phase 21 on ``--higgs-rows`` rows: the draws' cpu-against-cpu and golden
holds at their full 1,000,000 and ``[3, 1,000,000]`` shapes, 21c's cases
with ``--higgs-rows`` standing for its 10,500,000 rows and twice that for
its 20,000,000, the eager chain standing in for the fused route, then the
sampled, quantized and blocked fits and their twins), ``p7`` (the ranker
on ``MSLR_QUERIES`` a tenth of the card's), ``p22`` (the LambdaRank kernel's
cases at Yahoo LTR's full 473,134 rows, its long query cut to 1,500 rows,
still past the kernel's shared-memory rows; the plain version stands in
for the kernel and is compared with itself). The
plain versions are counted
as the kernel each stands in for, so a phase's launch checks hold here
as on the card.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import types

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mmlspark_tpu_torch.ops.histogram_scatter import (  # noqa: E402
    node_hist_blocked_plain, node_hist_plain)


class _Event:
    """Host-clock stand-in for ``torch.cuda.Event``."""

    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def load_on_cpu(rows: int, higgs_rows: int) -> types.ModuleType:
    """``chip_smoke.py`` executed as a module whose devices are the CPU."""
    path = os.path.join(ROOT, "chip_smoke.py")
    src = open(path).read().replace('"cuda"', '"cpu"').replace(
        ".cuda()", ".cpu()").replace(
        "activities=[ProfilerActivity.CUDA]",
        "activities=[ProfilerActivity.CPU]").replace(
        "ProfilerActivity.CPU, ProfilerActivity.CUDA]",
        "ProfilerActivity.CPU]")
    torch.cuda.synchronize = lambda *a: None
    torch.cuda._sleep = lambda *a: None
    torch.cuda.Event = _Event
    torch.cuda.max_memory_allocated = lambda: 0
    torch.cuda.reset_peak_memory_stats = lambda: None
    torch.cuda.memory_allocated = lambda: 0
    mod = types.ModuleType("chip_smoke_on_cpu")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    mod.hist_ops._node_hist_int8_cuda = (
        lambda b, p, q, W, B, **_: node_hist_plain(b, p, q, W, B,
                                                   acc_dtype=torch.int32))
    counted = mod.hist_ops.node_histogram

    def plain(b, p, q, W, B, acc_dtype=torch.float32):
        # node_histogram's CPU route: counted as kernel 1 or kernel 2
        if acc_dtype == torch.int32:
            counted.int8_launches += 1
        else:
            counted.launches += 1
        return node_hist_plain(b, p, q, W, B, acc_dtype=acc_dtype)

    def blocked_plain(b, p, q, W, B, blocks, acc_dtype=torch.float32):
        # the blocked route: the deterministic mode, or kernel 2
        if acc_dtype == torch.int32:
            counted.int8_launches += 1
        else:
            counted.det_launches += 1
        return node_hist_blocked_plain(b, p, q, W, B, blocks, acc_dtype)

    mod.hist_ops.node_hist_plain = plain
    mod.hist_ops.node_hist_blocked_plain = blocked_plain
    # 14a holds the mode bit for bit to its fixed-point plain version; here
    # both are the f32 blocked plain version, which the rank processes'
    # CPU route runs too
    mod.node_hist_det_plain = (
        lambda b, p, q, W, B, blocks: node_hist_blocked_plain(b, p, q, W, B,
                                                              blocks))

    # a quantized tree's eager chain (the CPU route) counted as the fused
    # kernel and its amax, and the eager chain on the stack standing in
    # for both launches of the card's route (21c)
    hist, growth = mod.hist_ops, mod.growth_mod
    eager = growth._quantize_for
    quantized = [0]

    def quantize_for(*a, **k):
        quantized[0] += 1
        return eager(*a, **k)

    def amax_plain(grad, hess, vm):
        return torch.stack([grad * vm, hess * vm, vm]).abs().amax(dim=1)

    def quantize_plain(grad, hess, vm, amax, *, q_max, mode, qkey, start,
                       stride):
        base = torch.stack([grad * vm, hess * vm, vm])
        u = (None if mode == hist.QUANT_NEAREST
             else hist.positional_uniform(qkey, 3, len(grad), grad.device,
                                          start=start)
             if mode == hist.QUANT_POSITIONAL
             else mod.prng.uniform(qkey, (3, len(grad)), start=start,
                                   stride=stride, device=grad.device))
        return hist.quantize_stats(base, amax=amax, q_max=q_max, u=u)

    growth._quantize_for = quantize_for
    for m in (hist, growth):
        m.stats_amax_cuda, m.quantize_stats_cuda = amax_plain, quantize_plain
    amax_plain.launches = 0

    # the ragged LambdaRank objective's plain route counted as the kernel's
    # launch
    objectives, rank_ops = mod.objectives_mod, mod.rank_ops
    ragged = objectives._lambdarank_ragged

    def counted_ragged(*a, **k):
        obj = ragged(*a, **k)

        def grad_hess(*x):
            rank_ops.lambdarank_cuda.launches += 1
            return obj.grad_hess(*x)
        return obj._replace(grad_hess=grad_hess)
    objectives._lambdarank_ragged = counted_ragged

    def read_counts():
        # on the CPU the plain versions stand in for every kernel
        return dict(node_hist_bf16=counted.launches,
                    node_hist_int8=counted.int8_launches, hist_bf16=0,
                    node_hist_det=counted.det_launches,
                    quant_stats=quantized[0], stats_amax=quantized[0],
                    lambdarank=rank_ops.lambdarank_cuda.launches, plain=0)

    def reset_counts():
        reset()
        quantized[0] = 0

    reset = mod.reset_counts
    mod.read_counts, mod.reset_counts = read_counts, reset_counts
    mod.COVERTYPE_ROWS, mod.COVERTYPE_HOLDOUT = rows, rows // 4
    mod.HIGGS_ROWS, mod.HIGGS_HOLDOUT = higgs_rows, higgs_rows // 5
    mod.P21C_ROWS, mod.P21C_Q_MAX_ROWS = higgs_rows, 2 * higgs_rows
    mod.MSLR_QUERIES //= 10
    mod.MSLR_HOLDOUT_QUERIES //= 10
    mod.P22_LONG = 1500
    return mod


def phase_sampling(mod) -> dict:
    """Phase 4's default fit, then phase 10 on its rows and model."""
    data = (*mod.higgs_shaped(mod.HIGGS_ROWS, seed=0),
            *mod.higgs_shaped(mod.HIGGS_HOLDOUT, seed=1))
    fit4, base = mod.phase_end_to_end("4", ["node_hist_bf16"], data)
    return {"4": fit4, **mod.phase_sampling(data, base)}


def phase_extensions(mod) -> dict:
    """The fits phase 11 reads its models from, then phase 11."""
    os.environ["MMLSPARK_TPU_SHAP_DEVICE"] = "1"
    data = (*mod.higgs_shaped(mod.HIGGS_ROWS, seed=0),
            *mod.higgs_shaped(mod.HIGGS_HOLDOUT, seed=1))
    _, base = mod.phase_end_to_end("4", ["node_hist_bf16"], data)
    _, quantized = mod.phase_end_to_end("4b", ["node_hist_int8"], data,
                                        useQuantizedGrad=True,
                                        quantWarmupIters=0)
    _, multiclass = mod.phase_multiclass()
    _, categorical = mod.phase_categorical()
    return mod.phase_main_path_extensions(data, base, quantized, multiclass,
                                          categorical)


def phase_serving(mod) -> dict:
    """The fits phase 12 serves, then phase 12."""
    data = (*mod.higgs_shaped(mod.HIGGS_ROWS, seed=0),
            *mod.higgs_shaped(mod.HIGGS_HOLDOUT, seed=1))
    _, quantized = mod.phase_end_to_end("4b", ["node_hist_int8"], data,
                                        useQuantizedGrad=True,
                                        quantWarmupIters=0)
    _, multiclass = mod.phase_multiclass()
    # the device probe of /healthz reads CUDA, which this host lacks
    mod.serving_mod._device_probe = {"devices": 1, "platform": "gpu"}
    return mod.phase_serving(quantized, multiclass, data[2],
                             "CPU rehearsal, no card")


def phase_plan(mod) -> dict:
    """The fits phase 13 reads its models from, then phase 13."""
    data = (*mod.higgs_shaped(mod.HIGGS_ROWS, seed=0),
            *mod.higgs_shaped(mod.HIGGS_HOLDOUT, seed=1))
    _, base = mod.phase_end_to_end("4", ["node_hist_bf16"], data)
    _, quantized = mod.phase_end_to_end("4b", ["node_hist_int8"], data,
                                        useQuantizedGrad=True,
                                        quantWarmupIters=0)
    _, multiclass = mod.phase_multiclass()
    return mod.phase_plan_and_fleet(base, quantized, multiclass, data,
                                    "CPU rehearsal, no card")


def phase_data_group(mod) -> dict:
    """The fits phase 14 reads its models from, then phase 14."""
    data = (*mod.higgs_shaped(mod.HIGGS_ROWS, seed=0),
            *mod.higgs_shaped(mod.HIGGS_HOLDOUT, seed=1))
    _, base = mod.phase_end_to_end("4", ["node_hist_bf16"], data)
    _, quantized = mod.phase_end_to_end("4b", ["node_hist_int8"], data,
                                        useQuantizedGrad=True,
                                        quantWarmupIters=0)
    _, multiclass = mod.phase_multiclass()
    return mod.phase_data_group(base, quantized, multiclass, data)


def phase_vw(mod, vw_rows: int, events: int) -> dict:
    """Phase 15 at ``vw_rows`` Criteo-shaped rows and ``events`` bandit
    events."""
    mod.CRITEO_ROWS, mod.CRITEO_HOLDOUT = vw_rows, vw_rows // 5
    mod.BFGS_ROWS = min(mod.BFGS_ROWS, vw_rows)
    mod.BANDIT_EVENTS = events
    return mod.phase_vw_and_host_stages("CPU rehearsal, no card")


def phase_estimators(mod, higgs_rows: int, sift_base: int,
                     aa_scale: float) -> dict:
    """Phase 16 at ``higgs_rows`` isolation-forest rows, ``sift_base``
    KNN index rows and AccessAnomaly's departments scaled by
    ``aa_scale``."""
    mod.HIGGS_ROWS = higgs_rows
    mod.SIFT_BASE = sift_base
    mod.SIFT_QUERIES = max(mod.KNN_CHECK_QUERIES, sift_base // 100)
    mod.AA_USERS = {d: max(4, int(v * aa_scale))
                    for d, v in mod.AA_USERS.items()}
    mod.AA_RESOURCES = {d: max(4, int(v * aa_scale))
                        for d, v in mod.AA_RESOURCES.items()}
    return mod.phase_estimators("CPU rehearsal, no card")


def phase_dnn(mod, dnn_images: int, feat_rows: int, lime_images: int
              ) -> dict:
    """Phase 17 at ``dnn_images`` images per lane, ``feat_rows`` featurized
    pictures and ``lime_images`` explained pictures."""
    mod.DNN_LANE_IMAGES = dnn_images
    mod.FEAT_TRAIN = feat_rows * 3 // 4
    mod.FEAT_HOLDOUT = feat_rows - mod.FEAT_TRAIN
    mod.FEAT_SUBSET = feat_rows // 4
    mod.DNN_HIST_ROWS = ((mod.FEAT_TRAIN, 1), (mod.FEAT_TRAIN // 2, 8))
    mod.STREAM_ROWS, mod.STREAM_CHUNK = dnn_images // 4, 100
    mod.STREAM_FILES, mod.STREAM_BATCH_FILES = 64, 32
    mod.LIME_IMAGES = lime_images
    return mod.phase_dnn("CPU rehearsal, no card")


def phase_automl(mod, http_rows: int) -> dict:
    """The fits phase 18 reads its models from, then phase 18 with
    ``http_rows`` rows through the HTTP stages."""
    data = (*mod.higgs_shaped(mod.HIGGS_ROWS, seed=0),
            *mod.higgs_shaped(mod.HIGGS_HOLDOUT, seed=1))
    _, base = mod.phase_end_to_end("4", ["node_hist_bf16"], data)
    _, quantized = mod.phase_end_to_end("4b", ["node_hist_int8"], data,
                                        useQuantizedGrad=True,
                                        quantWarmupIters=0)
    mod.HTTP_ROWS = http_rows
    mod.HTTP_BAD_ROWS = min(mod.HTTP_BAD_ROWS, http_rows)
    mod.HTTP_FORWARD_ROWS = min(mod.HTTP_FORWARD_ROWS, http_rows)
    return mod.phase_automl_and_http(data, base, quantized,
                                     "CPU rehearsal, no card")


def phase_transformer(mod, width: int, seq: int) -> dict:
    """Phase 19 with every config cut to ``d_model=width`` (4 heads, 2
    layers, vocab 1,024, ``max_len=seq``) and 19a's batch to 2 x ``seq``
    tokens; 19b's four gloo ranks on the CPU at ``seq // 2`` tokens. The
    profiler reads no device time here: the attention's share prints 1."""
    small = dict(vocab_size=1024, d_model=width, n_heads=4,
                 d_head=width // 4, n_layers=2, d_ff=4 * width,
                 max_len=seq)
    mod.TF_CONFIG = mod.tfm.TransformerConfig(**small)
    mod.TF_RANK_CONFIG = mod.TF_CONFIG._replace(n_layers=1,
                                                dtype=torch.float32)
    mod.TF_BATCH, mod.TF_SEQ = 2, seq
    mod.TF_RANK_SEQ = seq // 2
    mod.device_ms = lambda prof: 1.0
    return mod.phase_transformer("CPU rehearsal, no card")


def phase_group_resume(mod, vw_rows: int) -> dict:
    """Phase 20 on ``HIGGS_ROWS`` rows and ``vw_rows`` VW rows."""
    mod.P20_VW_ROWS = vw_rows
    return mod.phase_group_resume("CPU rehearsal, no card")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phases", nargs="+",
                    choices=["p6", "p8", "p8b", "p9", "p10", "p10b",
                             "p11", "p12", "p13", "p14", "p15", "p16",
                             "p17", "p18", "p19", "p20", "p21", "p7",
                             "p22"])
    ap.add_argument("--rows", type=int, default=40_000)
    ap.add_argument("--higgs-rows", type=int, default=200_000)
    ap.add_argument("--vw-rows", type=int, default=200_000)
    ap.add_argument("--events", type=int, default=2_000)
    ap.add_argument("--sift-base", type=int, default=100_000)
    ap.add_argument("--aa-scale", type=float, default=0.25)
    ap.add_argument("--dnn-images", type=int, default=256)
    ap.add_argument("--feat-rows", type=int, default=1024)
    ap.add_argument("--lime-images", type=int, default=1)
    ap.add_argument("--http-rows", type=int, default=2_000)
    ap.add_argument("--tf-width", type=int, default=64)
    ap.add_argument("--tf-seq", type=int, default=256)
    args = ap.parse_args()
    torch.set_num_threads(4)
    mod = load_on_cpu(args.rows, args.higgs_rows)
    run = {"p6": mod.phase_multiclass, "p8": mod.phase_categorical,
           "p8b": mod.phase_small_categorical, "p9": mod.phase_golden,
           "p10": lambda: phase_sampling(mod),
           "p10b": mod.phase_small_sampling,
           "p11": lambda: phase_extensions(mod),
           "p12": lambda: phase_serving(mod),
           "p13": lambda: phase_plan(mod),
           "p14": lambda: phase_data_group(mod),
           "p15": lambda: phase_vw(mod, args.vw_rows, args.events),
           "p16": lambda: phase_estimators(mod, args.higgs_rows,
                                           args.sift_base, args.aa_scale),
           "p17": lambda: phase_dnn(mod, args.dnn_images, args.feat_rows,
                                    args.lime_images),
           "p18": lambda: phase_automl(mod, args.http_rows),
           "p19": lambda: phase_transformer(mod, args.tf_width,
                                            args.tf_seq),
           "p20": lambda: phase_group_resume(mod, args.vw_rows),
           "p21": lambda: mod.phase_prng("CPU rehearsal, no card"),
           "p7": mod.phase_ranker,
           "p22": lambda: mod.phase_lambdarank("CPU rehearsal, no card")}
    t0 = time.perf_counter()
    for name in args.phases:
        out = run[name]()
        if out is not None:
            mod.log(f"{name}: {out}")
    mod.log(f"rehearsal of {args.phases} on the CPU: "
            f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

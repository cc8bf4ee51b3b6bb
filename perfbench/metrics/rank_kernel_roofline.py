"""``rank_kernel_roofline``: the profiled fit's LambdaRank lambdas at the
H100's published peaks over the profiler's device time of the port's
LambdaRank kernel (kernels named ``lambdarank``), in %. The work is
``rank_work.round_work`` of the run's queries and grades, once a round of
the profiled fit: the larger of its operations at 67 TFLOP/s (float32) and
its bytes at 3.35 TB/s, the bound the run's log names."""

from perfbench import frozen, peaks, rank_work


def read(run):
    fits = [f for f in run.layer.get("fits") or [] if f["profiled"]]
    offsets, labels = run.layer.get("offsets"), run.layer.get("labels")
    if run.trace is None or not fits or offsets is None:
        return None
    kernel_s = run.trace.kernel_s("lambdarank")
    if kernel_s <= 0:
        return None
    ops, nbytes = rank_work.round_work(offsets, labels)
    rounds = fits[0]["booster"].num_trees
    bound_ms, by = frozen.bound_ms(rounds * nbytes, rounds * ops,
                                   peaks.F32_OPS_PER_S)
    run.say(f"rank_kernel_roofline: bound by {by}, {bound_ms:.4f} ms for "
            f"{rounds} rounds against {1e3 * kernel_s:.4f} ms of the kernel")
    return 100.0 * bound_ms / 1e3 / kernel_s

"""``rank_grad_device_ms_per_tree``: the device's milliseconds in the
port's ``gbdt.rank.lambdas`` spans (a round's LambdaRank lambdas over the
query groups), between the timing events the span records on the stream;
over the window's unprofiled fits' trees. None where the program has no
such span."""

from perfbench import span_tree


def read(run):
    return span_tree.device_ms_per_tree(run, "gbdt.rank.lambdas")

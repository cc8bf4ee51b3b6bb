"""``stats_device_ms_per_tree``: the device's milliseconds in the port's
``gbdt.grow.stats`` spans (a tree's masked statistics, their int8
quantization and its stochastic-rounding draws), between the timing events
the span records on the stream; over the window's unprofiled fits' trees."""

from perfbench import span_tree


def read(run):
    return span_tree.device_ms_per_tree(run, "gbdt.grow.stats")

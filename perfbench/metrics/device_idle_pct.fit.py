"""``device_idle_pct.fit``: the share of the profiled fit in which no
kernel, copy or fill ran on the device, in %."""

from perfbench.trace import idle_pct


def read(run):
    return idle_pct(run.trace)

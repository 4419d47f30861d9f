"""The front end's share of its roofline: the least time its launches'
work takes at the card's peaks (port_bench/lib/work.py: each launch's
operations at the FP32 peak or its bytes at the memory bandwidth, the
larger, summed over the launches) over the device time of the kernels the
port's CUDA sources define, over the window's calls."""

from port_bench.lib import peaks, trace, work


def read(run):
    p = run.profile
    if p is None:
        return None
    names = trace.frontend_kernels()
    seconds = p.kernel_seconds(lambda n: trace.base_name(n) in names)
    if seconds <= 0:
        return None
    launches = work.frontend_launches(run.config["features"], run.window["clips"])
    return 100.0 * sum(peaks.least_seconds(o, b) for o, b in launches.values()) / seconds

"""The contrast launch's share of its roofline: launch C's work at the
card's peaks (an FFT of each window at the FP32 peak, the tails as
selections; port_bench/lib/work.py) over the device time of the port's
kernels whose names start with `contrast`."""

from port_bench.lib import peaks, trace, work


def read(run):
    p = run.profile
    if p is None or not run.config["features"]["use_spectral_contrast"]:
        return None
    names = [n for n in trace.frontend_kernels() if n.startswith("contrast")]
    seconds = p.kernel_seconds(lambda n: trace.base_name(n) in names)
    if seconds <= 0:
        return None
    ops, nbytes = work.frontend_launches(run.config["features"], run.window["clips"])["C"]
    return 100.0 * peaks.least_seconds(ops, nbytes) / seconds

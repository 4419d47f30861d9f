"""The classifier's share of its roofline: its forward pass's operations
(from the layer shapes) at the FP32 peak, or its input, weights and logits
at the memory bandwidth, the larger (port_bench/lib/work.py), over the
device time of every kernel of the window that is not the front end's
(the convolutions, norms and pools; the dequantize kernel of the program's
input and the outputs' copies are among them)."""

from port_bench.lib import peaks, trace, work


def read(run):
    p = run.profile
    if p is None:
        return None
    names = trace.frontend_kernels()
    seconds = p.kernel_seconds(lambda n: trace.base_name(n) not in names)
    if seconds <= 0:
        return None
    ops, nbytes = work.classifier(run.config["model"]["model_type"], run.config["features"], run.window["clips"])
    return 100.0 * peaks.least_seconds(ops, nbytes) / seconds

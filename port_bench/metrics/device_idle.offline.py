"""The device's idle share over the scoring window (torch.profiler's
CUDA activity: kernels, copies and sets)."""

from port_bench.metrics._idle import idle as read  # noqa: F401

"""The device's idle share over the serving window (torch.profiler's
CUDA activity: kernels, copies and sets)."""

from port_bench.metrics._idle import idle as read  # noqa: F401

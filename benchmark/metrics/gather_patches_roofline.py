"""The patch gather (``ops/gather_kernel.py`` -> ``csrc/gather_patches.cu``)
in the profiled frames: the least time the card could take over the calls'
inputs (bytes over 3.35 TB/s) as a share of the kernel's device time by name
in the profiler's trace."""


def read(w):
    bound, device_s, calls, launches = w.kernels.get("gather_patches", (0.0, 0.0, 0, 0))
    if device_s <= 0 or calls == 0 or calls != launches:
        return None
    return 100.0 * bound / device_s

"""FAST+NMS (``ops/fast_kernel.py`` -> ``csrc/fast_nms.cu``) in the profiled
frames: the least time the card could take over the calls' inputs (bytes
over 3.35 TB/s or operations over 67 TFLOP/s, whichever is larger) as a
share of the kernel's device time by name in the profiler's trace."""


def read(w):
    bound, device_s, calls, launches = w.kernels.get("fast_nms", (0.0, 0.0, 0, 0))
    if device_s <= 0 or calls == 0 or calls != launches:
        return None
    return 100.0 * bound / device_s

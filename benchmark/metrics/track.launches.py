"""Median over the profiled frames of the device operations (kernels,
copies, fills) that the host launched inside the program's span
``slam.track``: each operation is tied to its launch by the CUDA runtime
record with its correlation id in the profiler's trace.  None without a
device trace or without launch records in it."""

import statistics

from harness import program_trace


def read(w):
    pt = program_trace.read(w)
    if pt is None:
        return None
    launches = [k for k, _ in pt.launched_in(program_trace.TRACK)]
    return float(statistics.median(launches)) if launches else None

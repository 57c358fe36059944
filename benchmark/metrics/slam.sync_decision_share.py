"""The share of the window's tracked frames whose keyframe decision the
engine took at once, waiting for its statistics, rather than a frame late:
100 sync / (sync + deferred), from the program's counters
``slam.decision_sync`` and ``slam.decision_deferred``."""

from harness import program_trace


def read(w):
    pt = program_trace.read(w)
    if pt is None:
        return None
    sync = pt.total_count("slam.decision_sync")
    n = sync + pt.total_count("slam.decision_deferred")
    return 100.0 * sync / n if n else None

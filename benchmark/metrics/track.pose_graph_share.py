"""The share of the window's pose solves that replayed a captured CUDA
graph of the Gauss-Newton chain set rather than running it eagerly:
100 graphed / (graphed + eager), from the program's counters
``pose.solve_graphed`` and ``pose.solve_eager``."""

from harness import program_trace


def read(w):
    pt = program_trace.read(w)
    if pt is None:
        return None
    graphed = pt.total_count("pose.solve_graphed")
    n = graphed + pt.total_count("pose.solve_eager")
    return 100.0 * graphed / n if n else None

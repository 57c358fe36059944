"""The share of the window's mapping stages that replayed a CUDA graph of
the stage captured before them: 100 graphed / (graphed + eager +
captured), from the program's counters ``mapping.graphed``,
``mapping.eager`` and ``mapping.graph_capture`` (each stage counts one of
them; a stage that captures, warm-up, capture and replay, is the longest of
the three).  The three counts go to the log."""

from harness import program_trace
from harness.cell import log


def read(w):
    pt = program_trace.read(w)
    if pt is None:
        return None
    graphed, eager, captured = (pt.total_count(f"mapping.{k}")
                                for k in ("graphed", "eager", "graph_capture"))
    n = graphed + eager + captured
    if not n:
        return None
    log(f"mapping stages in the window: {graphed} graphed, {eager} eager, {captured} captured")
    return 100.0 * graphed / n

"""Median wall time of the window's engine iterations that prefilled
nothing: one decode step of every running request (in a traced run,
those that ended before the trace started)."""
from perfbench.stats import median


def read(run):
    walls = [end - start for start, end, _, _, prefill in run.iterations
             if not prefill and end <= run.untraced]
    return 1e3 * median(walls) if walls else None

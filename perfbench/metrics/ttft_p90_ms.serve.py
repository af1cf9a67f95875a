"""The first-token tail: 90th percentile over every request due in the
window of the wall time from its due time to its first token (one
without it by then counts its wait); in a traced run, the requests due
before the trace started, up to then.  Above the knee the queue grows
through the window, so the tail swings with the smallest change of pace:
it is recorded here and not held."""
from perfbench.serve import ttft_p90_ms


def read(run):
    recs = [r for r in run.records if r.offer.due < run.untraced]
    return ttft_p90_ms(recs, run.untraced) if recs else None

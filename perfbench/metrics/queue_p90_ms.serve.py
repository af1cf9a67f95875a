"""90th percentile over every request due in the window of the wall time
from its due time to the start of the engine iteration that admitted it
(a request still queued at the window's end counts its wait so far); in
a traced run, the requests due before the trace started, up to then."""
from perfbench.serve import waits
from perfbench.stats import percentile


def read(run):
    recs = [r for r in run.records if r.offer.due < run.untraced]
    if not recs:
        return None
    return 1e3 * percentile(waits(recs, "admitted", run.untraced), 90)

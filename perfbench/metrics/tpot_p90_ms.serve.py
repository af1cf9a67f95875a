"""90th percentile over the requests finished in the window of the wall
time per output token after the first: (finish - first token) /
(tokens - 1); in a traced run, those finished before the trace started."""
from perfbench.stats import percentile


def read(run):
    per = [(r.done - r.first) / (len(r.req.output) - 1) for r in run.records
           if r.done is not None and r.done <= run.untraced
           and len(r.req.output) > 1]
    return 1e3 * percentile(per, 90) if per else None

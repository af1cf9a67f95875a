"""Device milliseconds per training step inside the program's
``allreduce`` ranges: the workers' gradient exchange, with the codec's
encode, packing and decode where the mix compresses."""
from perfbench.trace import busy_within


def read(run):
    if run.trace is None or not run.traced_steps:
        return None
    seconds, n = busy_within(run.trace, "allreduce")
    return 1e3 * seconds / run.traced_steps if n else None

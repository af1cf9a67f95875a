"""Device milliseconds per training step of every worker's loss and
gradient: the device's busy time from the start of each of the program's
``forward_backward`` ranges to the start of the ``stack_and_compress``
range that follows it (the backward pass runs on autograd's own thread,
outside the range the program opens)."""
from perfbench.trace import busy_from_to


def read(run):
    if run.trace is None or not run.traced_steps:
        return None
    seconds, n = busy_from_to(run.trace, "forward_backward",
                              "stack_and_compress")
    return 1e3 * seconds / run.traced_steps if n else None

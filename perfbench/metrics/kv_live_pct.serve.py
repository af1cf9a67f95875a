"""The paged cache's live share: the cache tokens that the running
requests hold (each prompt prefilled and each cache read by a decode),
over the tokens the page pool reserves, averaged over the window's engine
iterations by their wall time; in a traced run, the iterations that
ended before the trace started."""
from perfbench.serve import pool_tokens


def read(run):
    its = [it for it in run.iterations if it[1] <= run.untraced]
    wall = sum(end - start for start, end, _, _, _ in its)
    if not wall:
        return None
    held = sum((end - start) * (sum(prefilled) + sum(decoded))
               for start, end, prefilled, decoded, _ in its)
    return 100.0 * held / (wall * pool_tokens(run.mix))

"""Model FLOPs of the window's engine iterations (the prompts prefilled
and the tokens decoded) over the sum of those iterations' wall times
times the card's bf16 peak; in a traced run, the iterations that ended
before the trace started."""
from perfbench.readers import decode_flops, prefill_flops


def read(run):
    its = [it for it in run.iterations if it[1] <= run.untraced]
    if run.peaks is None or not its:
        return None
    flops = wall = 0.0
    for start, end, prefilled, decoded, _ in its:
        flops += sum(prefill_flops(run.cfg, S) for S in prefilled)
        flops += sum(decode_flops(run.cfg, n) for n in decoded)
        wall += end - start
    return 100.0 * flops / (wall * run.peaks["bf16_flops"])

"""The split-K decode attention's share of its byte roofline over the
decode iterations of the traced window: each layer of each iteration
reads every decoding row's cache up to its position."""
from perfbench.reference.transformer import dims
from perfbench.readers import roofline_pct


def read(run):
    if run.peaks is None or run.traced_iterations is None:
        return None
    k = run.load_kernel("flash_decode")
    m = dims(run.cfg)
    a, b = run.traced_iterations
    steps = [it[3] for it in run.iterations[a:b] if it[3]]
    slots = run.mix["slots"]
    bound = sum(k.nbytes(lengths, slots, m["H"], m["KV"], m["hd"], 2)
                for lengths in steps) * m["L"] / run.peaks["hbm_bytes_per_s"]
    want = 2 * len(steps) * m["L"]          # the split pass and the combine
    return roofline_pct(run, list(k.KERNELS),
                        lambda n: bound if n == want and n else None)

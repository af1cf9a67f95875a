"""The bf16 flash-attention prefill's share of its roofline over the
prompts prefilled in the traced window: the least time of each launch is
the larger of its bytes over the card's bandwidth and its operations over
the bf16 peak, summed over every layer of every prompt."""
from perfbench.reference.transformer import dims
from perfbench.readers import roofline_pct


def read(run):
    if run.peaks is None or run.traced_iterations is None:
        return None
    k = run.load_kernel("flash_attention")
    m = dims(run.cfg)
    pk = run.peaks
    a, b = run.traced_iterations
    prompts = [S for it in run.iterations[a:b] for S in it[2]]
    bound = sum(max(k.flops(1, S, m["H"], m["hd"]) / pk["bf16_flops"],
                    k.nbytes(1, S, m["H"], m["KV"], m["hd"], 2)
                    / pk["hbm_bytes_per_s"]) for S in prompts) * m["L"]
    want = len(prompts) * m["L"]
    return roofline_pct(run, [k.KERNELS["bfloat16"]],
                        lambda n: bound if n == want and n else None)

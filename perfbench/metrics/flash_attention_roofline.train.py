"""The fp32 (3xTF32) flash-attention forward's share of its roofline in
the training step: each launch's least time is the larger of its bytes
over the card's bandwidth and its operations over a third of the TF32
peak (three TF32 products make one fp32-accurate one)."""
from perfbench.reference.transformer import dims
from perfbench.readers import roofline_pct


def read(run):
    if run.peaks is None or not run.traced_steps:
        return None
    k = run.load_kernel("flash_attention")
    m = dims(run.cfg)
    pk = run.peaks
    one = max(k.flops(run.batch, run.seq, m["H"], m["hd"])
              / pk["fp32_3xtf32_flops"],
              k.nbytes(run.batch, run.seq, m["H"], m["KV"], m["hd"], 4)
              / pk["hbm_bytes_per_s"])
    want = run.traced_steps * run.workers * m["L"]
    return roofline_pct(run, [k.KERNELS["float32"]],
                        lambda n: one * n if n == want else None)

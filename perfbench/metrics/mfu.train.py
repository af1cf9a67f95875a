"""Model FLOPs of the window's training tokens over the window times the
card's TF32 tensor-core peak (the highest rate any fp32-accurate method
can reach; the fp32 model trains with TF32 off).  In a traced run, the
steps before the trace started, over their time."""
from perfbench.readers import train_flops_per_token


def read(run):
    steps, seconds = run.untraced
    if run.peaks is None or not steps:
        return None
    tokens = steps * run.workers * run.batch * run.seq
    flops = tokens * train_flops_per_token(run.cfg, run.seq)
    return 100.0 * flops / (seconds * run.peaks["tf32_flops"])

"""The fused 1-bit encode's share of its byte roofline in the ring
exchange: per bucket and step, three reduce-scatter hops and the owner's
encode, each one launch over every worker's 256-element rows of its
chunk."""
from perfbench.reference import exchange as X
from perfbench.reference.transformer import weight_specs
from perfbench.readers import roofline_pct


def read(run):
    if run.peaks is None or not run.traced_steps:
        return None
    k = run.load_kernel("onebit_encode_ef")
    K = run.workers
    numel = {n: 1 for n, _, _ in weight_specs(run.cfg)}
    for n, shape, _ in weight_specs(run.cfg):
        for s in shape:
            numel[n] *= s
    leaves = X.leaf_order(run.cfg, list(numel))
    sizes = [len(l) * numel[l[0]] for l in leaves]
    per_step, launches = 0.0, 0
    for b in X.bucket_plan(sizes):
        m = -(-sum(sizes[i] for i in b) // K)
        R = -(-m // X.LANE)
        per_step += 4 * k.nbytes(K * R, X.LANE, mask=m % X.LANE != 0)
        launches += 4
    want = launches * run.traced_steps
    bound = per_step * run.traced_steps / run.peaks["hbm_bytes_per_s"]
    return roofline_pct(run, [k.KERNEL],
                        lambda n: bound if n == want else None)

"""Cells of the benchmark cut to a size the CPU tests can run in a second:
the same files, drivers and checks, with every width and length shrunk."""
from __future__ import annotations

import copy

from perfbench import harness


def config(cfg, L=2, d=32, H=4, KV=2, ff=64, V=128):
    c = copy.deepcopy(cfg)
    KV = KV if cfg["num_key_value_heads"] != cfg["num_attention_heads"] else H
    c.update(hidden_size=d, num_attention_heads=H, num_key_value_heads=KV,
             intermediate_size=ff, vocab_size=V, num_hidden_layers=L)
    port = dict(c["port"], num_layers=L, d_model=d, num_heads=H,
                num_kv_heads=KV, head_dim=d // H, d_ff=ff, vocab_size=V)
    if c.get("rope_scaling"):
        half = d // H // 2
        sections = [half // 4, (half - half // 4) // 2]
        sections.append(half - sum(sections))
        c["rope_scaling"] = {"type": "mrope", "mrope_section": sections}
        port["mrope_sections"] = sections
    c["port"] = port
    return c


def cell(workload: str, **widths):
    """``harness.resolve``'s cell with a tiny configuration (``widths``
    as ``config`` takes them) and mix (the cell's own limits)."""
    c = harness.resolve(harness.manifest(), workload)
    c.config = config(c.config, **widths)
    if c.mix["kind"] == "train":
        c.mix = dict(c.mix, seq_len=16, trace_seconds=0.05)
    else:
        c.mix = dict(c.mix, prompt=dict(c.mix["prompt"], median=12, min=6,
                                         max=24),
                     output=dict(c.mix["output"], min=3, max=6), slots=4,
                     page_size=4, pool_tokens=96, check_tokens=40,
                     trace_seconds=0.05,
                     arrivals=dict(c.mix["arrivals"], rate_per_s=100.0))
    return c

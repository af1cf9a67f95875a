"""Synthetic data pipeline of the port."""
from repro_torch.data.pipeline import (LMDataConfig, make_lm_batches,
                                       synthetic_lm_batch)

__all__ = ["LMDataConfig", "make_lm_batches", "synthetic_lm_batch"]

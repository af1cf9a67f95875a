"""Synthetic data pipeline and federated partitioning of the port."""
from repro_torch.data.partition import dirichlet_partition, iid_partition
from repro_torch.data.pipeline import (EpochCache, LMDataConfig,
                                       ShardedLoader, make_lm_batches,
                                       synthetic_lm_batch)

__all__ = ["EpochCache", "LMDataConfig", "ShardedLoader", "make_lm_batches",
           "synthetic_lm_batch", "dirichlet_partition", "iid_partition"]

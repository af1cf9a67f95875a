"""Training path of the port: the Strategy API over the data-parallel
engine."""
from repro_torch.train.strategy import (Cell, Engine, Strategy, Trainer, fit,
                                        registered_cells)
from repro_torch.train.train_loop import train_loop, value_and_grad

__all__ = ["Cell", "Engine", "Strategy", "Trainer", "fit",
           "registered_cells", "train_loop", "value_and_grad"]

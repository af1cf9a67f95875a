"""Training path of the port: the Strategy API over the data-parallel
engine, and the trainer (``make_train_step`` on one worker, lifted over
the worker axis by ``make_sharded_train_step``)."""
from repro_torch.train.data_parallel import (make_bucketed_allreduce,
                                             make_sharded_train_step)
from repro_torch.train.strategy import (Cell, Engine, Strategy, Trainer, fit,
                                        registered_cells)
from repro_torch.train.train_loop import (TrainState, make_train_step,
                                          train_loop, value_and_grad)

__all__ = ["Cell", "Engine", "Strategy", "Trainer", "TrainState", "fit",
           "make_bucketed_allreduce", "make_sharded_train_step",
           "make_train_step", "registered_cells", "train_loop",
           "value_and_grad"]

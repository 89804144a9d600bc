"""Optimizer and learning-rate schedules of the port (``sgd`` with the
paper's cosine annealing, and the LM driver's warmup + cosine)."""

from repro_torch.optim.optimizers import SGD, sgd
from repro_torch.optim.schedule import (constant, cosine_annealing,
                                        cosine_with_warmup)

__all__ = ["SGD", "constant", "cosine_annealing", "cosine_with_warmup",
           "sgd"]

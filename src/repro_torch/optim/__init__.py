"""Optimizer and learning-rate schedules of the port (``sgd`` with the
paper's cosine annealing)."""

from repro_torch.optim.optimizers import SGD, sgd
from repro_torch.optim.schedule import constant, cosine_annealing

__all__ = ["SGD", "constant", "cosine_annealing", "sgd"]

"""Optimizers and learning-rate schedules of the port (``sgd`` with the
paper's cosine annealing and the LM driver's warmup + cosine; ``adamw``
with global-norm clipping and ``exponential_decay``)."""

from repro_torch.optim.optimizers import SGD, AdamW, adamw, global_norm, sgd
from repro_torch.optim.schedule import (constant, cosine_annealing,
                                        cosine_with_warmup, exponential_decay)

__all__ = ["SGD", "AdamW", "adamw", "constant", "cosine_annealing",
           "cosine_with_warmup", "exponential_decay", "global_norm", "sgd"]

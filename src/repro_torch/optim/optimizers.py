"""SGD with momentum, Nesterov and weight decay, after
``repro/optim/optimizers.py:sgd``.

The learning rate is read at the step count *before* the increment, weight
decay is added to the gradient before momentum, and there is no dampening:
``m = momentum * m + (g + wd * p)`` and ``p -= lr(step) * m``.
``state_tree`` / ``load_state_tree`` are the optimizer's part of a
checkpoint, the reference's ``OptState``: the step count and the f32
momentum slots by parameter name.
"""

from __future__ import annotations

from typing import Callable, Iterable, Union

import numpy as np
import torch

Schedule = Union[float, Callable[[int], float]]


class SGD(torch.optim.Optimizer):
    """Paper default: momentum 0.9, weight decay 5e-4, cosine-annealed lr.

    ``lr`` is a float or a ``step -> lr`` schedule; ``step_count`` is the
    number of steps taken so far.
    """

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule,
                 momentum: float = 0.0, weight_decay: float = 0.0,
                 nesterov: bool = False):
        super().__init__(params, dict(momentum=momentum,
                                      weight_decay=weight_decay,
                                      nesterov=nesterov))
        self.schedule = lr if callable(lr) else (lambda _step: float(lr))
        self.step_count = 0

    @torch.no_grad()
    def step(self, closure=None, grads=None):
        """One update from each parameter's ``.grad``, or from ``grads``
        (a mapping from parameter to gradient, any float dtype) when given:
        the LM step hands in gradients accumulated in f32."""
        lr_t = self.schedule(self.step_count)
        for group in self.param_groups:
            mom, wd = group["momentum"], group["weight_decay"]
            for p in group["params"]:
                g = p.grad if grads is None else grads.get(p)
                if g is None:
                    continue
                g = g.float()
                if wd:
                    g = g + wd * p.float()
                if mom:
                    state = self.state[p]
                    m = state.get("momentum")
                    if m is None:
                        m = state["momentum"] = g.clone()
                    else:   # momentum * m + g, in place (f32 slots)
                        m.mul_(mom).add_(g)
                    d = g + mom * m if group["nesterov"] else m
                else:
                    d = g
                p.add_((-lr_t * d).to(p.dtype))
        self.step_count += 1

    def state_tree(self, named: dict) -> dict:
        """``{"step", "slots": {name: momentum}}`` for the named
        parameters (the slots themselves: a checkpoint save copies them)."""
        return {"step": np.int64(self.step_count),
                "slots": {name: self.state[p]["momentum"]
                          for name, p in named.items()
                          if "momentum" in self.state[p]}}

    def load_state_tree(self, tree: dict, named: dict) -> None:
        """Resume from ``state_tree``'s output, its slots already tensors
        on the parameters' device (``checkpoint.restore_to``)."""
        self.step_count = int(tree["step"])
        for name, slot in tree.get("slots", {}).items():
            self.state[named[name]]["momentum"] = slot

def sgd(params: Iterable[torch.Tensor], lr: Schedule, momentum: float = 0.0,
        weight_decay: float = 0.0, nesterov: bool = False) -> SGD:
    return SGD(params, lr, momentum=momentum, weight_decay=weight_decay,
               nesterov=nesterov)

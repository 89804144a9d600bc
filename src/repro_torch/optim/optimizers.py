"""SGD with momentum, Nesterov and weight decay, and AdamW, after
``repro/optim/optimizers.py``.

Both read the learning rate at the step count *before* the increment and
keep f32 slots; the update is computed in f32 and cast to the parameter's
dtype before it is added.  With ``clip_norm`` the gradients are first
scaled by ``min(1, clip / max(global_norm, 1e-12))`` (in f32, the clipped
gradients f32).  SGD adds weight decay to the gradient before momentum,
with no dampening: ``m = momentum * m + (g + wd * p)`` and
``p -= lr(step) * m``.  AdamW decouples it: ``d = m̂ / (sqrt(v̂) + eps) +
wd * p``, with the bias corrections at ``step + 1`` in f32.

``state_tree`` / ``load_state_tree`` are the optimizer's part of a
checkpoint, the reference's ``OptState``: the step count and the f32 slots
by parameter name (``{"m": ..., "v": ...}`` for AdamW).

On a mesh the parameters are DTensors: each gradient is first brought to
its parameter's placements (``_like_param``), so the update runs on each
rank's shard, and the slots are placed as their parameters.

``global_norm`` sums each tensor's squares, then the tensors in the order
given.  The reference sums its pytree's leaves, each block leaf stacked
over the super-blocks, where the port holds one tensor a super-block: the
two norms agree to the last bits only, not bit for bit.
"""

from __future__ import annotations

from typing import Callable, Iterable, Union

import numpy as np
import torch

from repro_torch.distributed import dtensor as dt

Schedule = Union[float, Callable[[int], float]]


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (a 0-d
    tensor)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def _like_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient in its parameter's placements (a partial sum
    over the data axis reduced, a gathered one sharded again); any other
    gradient as it is."""
    if dt.is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _schedule(lr: Schedule) -> Callable[[int], float]:
    return lr if callable(lr) else (lambda _step: float(lr))


def _gradients(opt: torch.optim.Optimizer, grads, clip_norm):
    """Yield (group, parameter, f32 gradient) for every parameter that has
    one: its ``.grad``, or ``grads[p]`` when a mapping is given; scaled by
    ``min(1, clip_norm / max(global_norm, 1e-12))`` (in f32) when
    ``clip_norm`` is set.  One f32 gradient at a time, so no f32 copy of
    them all is held."""
    found = []
    for group in opt.param_groups:
        for p in group["params"]:
            g = p.grad if grads is None else grads.get(p)
            if g is not None:
                found.append((group, p, _like_param(g, p)))
    scale = None
    if clip_norm is not None and found:
        norm = global_norm(g for _, _, g in found)
        clip = torch.tensor(clip_norm, dtype=torch.float32,
                            device=norm.device)
        scale = torch.clamp_max(clip / torch.clamp_min(norm, 1e-12), 1.0)
    for group, p, g in found:
        g = g.float()
        yield group, p, (g if scale is None else g * scale)


class SGD(torch.optim.Optimizer):
    """Paper default: momentum 0.9, weight decay 5e-4, cosine-annealed lr.

    ``lr`` is a float or a ``step -> lr`` schedule; ``step_count`` is the
    number of steps taken so far.
    """

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule,
                 momentum: float = 0.0, weight_decay: float = 0.0,
                 nesterov: bool = False, clip_norm: float | None = None):
        super().__init__(params, dict(momentum=momentum,
                                      weight_decay=weight_decay,
                                      nesterov=nesterov))
        self.schedule = _schedule(lr)
        self.clip_norm = clip_norm
        self.step_count = 0

    @torch.no_grad()
    def step(self, closure=None, grads=None):
        """One update from each parameter's ``.grad``, or from ``grads``
        (a mapping from parameter to gradient, any float dtype) when given:
        the LM step hands in gradients accumulated in f32."""
        lr_t = self.schedule(self.step_count)
        for group, p, g in _gradients(self, grads, self.clip_norm):
            mom, wd = group["momentum"], group["weight_decay"]
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


class AdamW(torch.optim.Optimizer):
    """AdamW with f32 (m, v) slots: the LM-pretraining default.

    ``lr`` is a float or a ``step -> lr`` schedule; ``step_count`` is the
    number of steps taken so far.
    """

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float | None = 1.0):
        super().__init__(params, dict(b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))
        self.schedule = _schedule(lr)
        self.clip_norm = clip_norm
        self.step_count = 0

    @torch.no_grad()
    def step(self, closure=None, grads=None):
        """One update from each parameter's ``.grad``, or from ``grads``
        (a mapping from parameter to gradient) when given."""
        lr_t = self.schedule(self.step_count)
        t = torch.tensor(float(self.step_count + 1), dtype=torch.float32)
        corrections = {}
        for group, p, g in _gradients(self, grads, self.clip_norm):
            b1, b2, eps, wd = (group[k] for k in ("b1", "b2", "eps",
                                                  "weight_decay"))
            key = (b1, b2, p.device)
            if key not in corrections:   # 1 - b ** (step + 1), in f32
                one = torch.ones((), dtype=torch.float32)
                corrections[key] = tuple(
                    (one - torch.tensor(b, dtype=torch.float32) ** t).to(
                        p.device) for b in (b1, b2))
            c1, c2 = corrections[key]
            state = self.state[p]
            if "m" not in state:   # f32 zeros placed as the parameter
                state["m"] = torch.zeros_like(p, dtype=torch.float32)
                state["v"] = torch.zeros_like(p, dtype=torch.float32)
            m, v = state["m"], state["v"]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square())
            d = (m / c1) / (torch.sqrt(v / c2) + eps)
            if wd:
                d = d + wd * p.float()
            p.add_((-lr_t * d).to(p.dtype))
        self.step_count += 1

    def state_tree(self, named: dict) -> dict:
        """``{"step", "slots": {"m": {name: m}, "v": {name: v}}}`` for the
        named parameters (the slots themselves: a checkpoint save copies
        them); the step an int32, as the reference's."""
        have = {name: self.state[p] for name, p in named.items()
                if "m" in self.state[p]}
        return {"step": np.int32(self.step_count),
                "slots": {k: {name: st[k] for name, st in have.items()}
                          for k in ("m", "v")}}

    def load_state_tree(self, tree: dict, named: dict) -> None:
        """Resume from ``state_tree``'s output, its slots already tensors
        on the parameters' device (``checkpoint.restore_to``)."""
        self.step_count = int(tree["step"])
        slots = tree.get("slots", {})
        for k in ("m", "v"):
            for name, slot in slots.get(k, {}).items():
                self.state[named[name]][k] = slot


def sgd(params: Iterable[torch.Tensor], lr: Schedule, momentum: float = 0.0,
        weight_decay: float = 0.0, nesterov: bool = False,
        clip_norm: float | None = None) -> SGD:
    return SGD(params, lr, momentum=momentum, weight_decay=weight_decay,
               nesterov=nesterov, clip_norm=clip_norm)


def adamw(params: Iterable[torch.Tensor], lr: Schedule, b1: float = 0.9,
          b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
          clip_norm: float | None = 1.0) -> AdamW:
    return AdamW(params, lr, b1=b1, b2=b2, eps=eps,
                 weight_decay=weight_decay, clip_norm=clip_norm)

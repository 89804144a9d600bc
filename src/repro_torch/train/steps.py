"""Step builders for the classifier, after ``repro/train/steps.py``.

The weighted-subset objective is a first-class input: every train step
takes ``batch['weights']`` (the OMP output slice, summing to 1).  The loss
goes through autograd; the proxies come from one forward pass and the fused
``lastlayer_grad`` kernel, with no backprop through the trunk.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import proxies as proxy_lib
from repro_torch.models.classifier import ClassifierNet, classifier_loss


def make_classifier_step(model: ClassifierNet,
                         opt: torch.optim.Optimizer) -> Callable:
    """``step(batch) -> metrics``: one weighted SGD step on ``model``."""

    def step(batch: dict) -> dict:
        opt.zero_grad(set_to_none=True)
        loss, metrics = classifier_loss(model, batch)
        loss.backward()
        opt.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_classifier_eval(model: ClassifierNet) -> Callable:
    """``evaluate(batch) -> {'acc', 'ce'}`` (device scalars)."""

    @torch.no_grad()
    def evaluate(batch: dict) -> dict:
        logits, _ = model(batch["x"])
        lg = logits.float()
        y = batch["y"].long()
        acc = (lg.argmax(-1) == y).float().mean()
        ce = torch.logsumexp(lg, -1) - lg.gather(1, y[:, None])[:, 0]
        return {"acc": acc, "ce": ce.mean()}

    return evaluate


def make_proxy_fn(model: ClassifierNet) -> Callable:
    """``proxy(x, y) -> (per-class proxy (n, d_h + 1), bias proxy (n, C))``
    for the model's current parameters: one forward pass, one kernel."""

    @torch.no_grad()
    def proxy(x: torch.Tensor, y: torch.Tensor):
        logits, hidden = model(x)
        return proxy_lib.lastlayer_proxies(hidden.contiguous(),
                                           logits.float().contiguous(), y)

    return proxy

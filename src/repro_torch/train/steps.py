"""Step builders for the classifier and the LM, after
``repro/train/steps.py``.

The weighted-subset objective is a first-class input: every train step
takes ``batch['weights']`` (the OMP output slice, summing to 1).  The loss
goes through autograd; the proxies come from one forward pass and a fused
kernel (``lastlayer_grad`` for a classifier, ``hidden_grad`` for an LM
head), with no backprop through the trunk.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import proxies as proxy_lib
from repro_torch.models import lm as lm_lib
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


# ---------------------------------------------------------------------------
# LM steps
# ---------------------------------------------------------------------------

def lm_train_step_fn(cfg: ModelConfig, model: lm_lib.LM,
                     opt: torch.optim.Optimizer,
                     microbatches: int = 1) -> Callable:
    """``step(batch) -> metrics``: one weighted step of ``model``.

    ``microbatches > 1`` splits the batch on the leading axis and adds the
    micro-batches' gradients in f32, one after another, as the reference's
    scan does; the weight slices are not renormalized (they sum to 1
    globally), so the sum is the whole weighted batch's gradient.  The
    metrics are the last micro-batch's, as there.
    """

    def step(batch: dict) -> dict:
        opt.zero_grad(set_to_none=True)
        if microbatches == 1:
            loss, metrics = lm_lib.lm_loss(cfg, model, batch)
            loss.backward()
            opt.step()
        else:
            acc = {p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                   for p in model.parameters()}
            parts = {k: v.chunk(microbatches, dim=0)
                     for k, v in batch.items()}
            for i in range(microbatches):
                loss, metrics = lm_lib.lm_loss(
                    cfg, model, {k: v[i] for k, v in parts.items()})
                loss.backward()
                for p, a in acc.items():
                    a.add_(p.grad.float())
                    p.grad = None
            opt.step(grads=acc)
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_lm_proxy_step(cfg: ModelConfig, model: lm_lib.LM) -> Callable:
    """``proxy(batch) -> (B, d_model)`` per-sequence selection proxies for
    the model's current parameters (``lm.selection_proxy``)."""

    def proxy(batch: dict) -> torch.Tensor:
        return lm_lib.selection_proxy(cfg, model, batch)

    return proxy

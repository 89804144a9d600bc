"""Step builders for the classifier and the LM, after
``repro/train/steps.py``.

The weighted-subset objective is a first-class input: every train step
takes ``batch['weights']`` (the OMP output slice, summing to 1).  The loss
goes through autograd; the proxies come from one forward pass and a fused
kernel (``lastlayer_grad`` for a classifier, ``hidden_grad`` for an LM
head), with no backprop through the trunk.  LM steps take micro-batch
accumulation and, opt-in, EF-TopK gradient compression before the
optimizer (``train/compression.py``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import proxies as proxy_lib
from repro_torch.distributed import dtensor as dt
from repro_torch.models import lm as lm_lib
from repro_torch.models.classifier import ClassifierNet, classifier_loss
from repro_torch.train import compression as comp_lib


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
    metrics are the last micro-batch's, as there.  On a mesh each rank
    splits its own rows of the batch (``dtensor.chunk_rows``), so every
    micro-batch stays sharded over the data axis.
    """

    def step(batch: dict) -> dict:
        opt.zero_grad(set_to_none=True)
        if microbatches == 1:
            loss, metrics = lm_lib.lm_loss(cfg, model, batch)
            loss.backward()
            opt.step()
        else:
            acc = {p: torch.zeros_like(p, dtype=torch.float32)
                   for p in model.parameters()}
            parts = {k: dt.chunk_rows(v, microbatches)
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


def reference_leaves(names) -> dict[str, list[str]]:
    """The reference's pytree leaf of each parameter name, in the order
    of ``names``: ``blocks.3.sub0.attn.wq`` is row 3 of the leaf
    ``blocks.sub0.attn.wq``, which the reference stacks over the
    super-blocks; any other name is a leaf of its own."""
    leaves: dict[str, list[str]] = {}
    for name in names:
        parts = name.split(".")
        key = (".".join([parts[0]] + parts[2:]) if parts[0] == "blocks"
               else name)
        leaves.setdefault(key, []).append(name)
    return leaves


def _stacked(named: dict, leaves: dict) -> dict:
    """Each reference leaf of ``named``: the block rows stacked on a
    leading super-block axis, the other leaves as they are."""
    return {key: (torch.stack([named[n] for n in names])
                  if key.startswith("blocks.") else named[names[0]])
            for key, names in leaves.items()}


def reference_tree(model: lm_lib.LM) -> dict:
    """The parameters as the reference's pytree (``lm.params_from_jax``'s
    inverse, for a snapshot the reference reads): nested dicts by name,
    each block leaf stacked over the super-blocks (``_stacked``)."""
    named = {n: p.detach() for n, p in model.named_parameters()}
    tree: dict = {}
    for key, val in _stacked(named, reference_leaves(named)).items():
        *path, last = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[last] = val
    return tree


def _unstacked(tree: dict, leaves: dict) -> dict:
    """``_stacked``'s inverse: each parameter name's row of its leaf."""
    out = {}
    for key, names in leaves.items():
        rows = (tree[key].unbind(0) if key.startswith("blocks.")
                else (tree[key],))
        out.update(zip(names, rows))
    return out


def init_compression_state(model: lm_lib.LM) -> comp_lib.CompressionState:
    """Zero EF-TopK residuals for ``model``, one f32 tensor a reference
    leaf (block leaves stacked over the super-blocks), on its device."""
    named = dict(model.named_parameters())
    return comp_lib.init_state(_stacked(
        {n: p.detach() for n, p in named.items()},
        reference_leaves(named)))


def make_lm_train_step(cfg: ModelConfig, model: lm_lib.LM,
                       opt: torch.optim.Optimizer, microbatches: int = 1,
                       compress_frac: Optional[float] = None) -> Callable:
    """The LM train step; see ``lm_train_step_fn``.

    With ``compress_frac`` it is ``step(batch, comp_state) -> (metrics,
    comp_state)``, starting from ``init_compression_state(model)``: the
    gradients go through ``compression.compress_with_feedback`` before the
    optimizer.  The reference compresses each leaf of its pytree, so a
    block parameter's top k is taken over its leaf stacked over all
    super-blocks, not a super-block at a time; the port stacks them the
    same way.  As in the reference, this form takes one full-batch
    gradient whatever ``microbatches`` is.
    """
    if compress_frac is None:
        return lm_train_step_fn(cfg, model, opt, microbatches)
    params = dict(model.named_parameters())
    leaves = reference_leaves(params)

    def step(batch: dict, comp_state: comp_lib.CompressionState):
        opt.zero_grad(set_to_none=True)
        loss, metrics = lm_lib.lm_loss(cfg, model, batch)
        loss.backward()
        grads = _stacked({n: p.grad for n, p in params.items()}, leaves)
        dense, comp_state = comp_lib.compress_with_feedback(
            grads, comp_state, compress_frac)
        opt.step(grads={params[n]: g
                        for n, g in _unstacked(dense, leaves).items()})
        return {k: v.detach() for k, v in metrics.items()}, comp_state

    return step


def make_lm_proxy_step(cfg: ModelConfig, model: lm_lib.LM) -> Callable:
    """``proxy(batch) -> (B, d_model)`` per-sequence selection proxies for
    the model's current parameters (``lm.selection_proxy``)."""

    def proxy(batch: dict) -> torch.Tensor:
        return lm_lib.selection_proxy(cfg, model, batch)

    return proxy

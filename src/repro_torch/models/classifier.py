"""Small classifiers for the paper-faithful experiments (LeNet-scale), after
``repro/models/classifier.py``.

``ClassifierNet.forward`` returns (logits, last_hidden) so the selection
proxies (last-layer gradients, paper §4) are closed-form.  The CNN takes
NHWC images at its public forward, like the JAX model, and flattens its
pooled map in (H, W, C) order, so parameters carry over from the JAX
package unpermuted (``params_from_jax``).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.paper import ClassifierConfig
from repro_torch.device import resolve_device
from repro_torch.models import common


class ClassifierNet(nn.Module):
    """MLP or LeNet-style CNN; ``forward(x) -> (logits, last_hidden)``."""

    def __init__(self, cfg: ClassifierConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        if cfg.kind == "cnn":
            h, w, c = cfg.image_shape
            self.conv1 = nn.Conv2d(c, 6, 5, bias=False)
            self.conv2 = nn.Conv2d(6, 16, 5, bias=False)
            common.dense_init(self.conv1.weight, fan_in=25 * c,
                              generator=generator)
            common.dense_init(self.conv2.weight, fan_in=25 * 6,
                              generator=generator)
            dims = ((h // 4 - 3) * (w // 4 - 3) * 16,) + cfg.hidden
        else:
            dims = (cfg.in_dim,) + cfg.hidden
        self.fcs = nn.ModuleList(nn.Linear(dims[i], dims[i + 1])
                                 for i in range(len(dims) - 1))
        self.head = nn.Linear(dims[-1], cfg.num_classes)
        for lin in (*self.fcs, self.head):
            common.dense_init(lin.weight, generator=generator)
            nn.init.zeros_(lin.bias)
        self.act = common.activation(cfg.act)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (logits (B, C), last_hidden (B, d)) — the hidden feeding
        the final linear layer, which the GRAD-MATCH proxies need."""
        h = x
        if self.cfg.kind == "cnn":
            h = h.permute(0, 3, 1, 2)                   # NHWC -> NCHW
            h = F.max_pool2d(self.act(self.conv1(h)), 2, 2)
            h = F.max_pool2d(self.act(self.conv2(h)), 2, 2)
            h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)   # (H, W, C)
        for fc in self.fcs:
            h = self.act(fc(h))
        return self.head(h), h


def classifier_loss(model: ClassifierNet, batch: Mapping[str, torch.Tensor]
                    ) -> tuple[torch.Tensor, dict]:
    """Weighted CE: sum_i w_i * CE_i (uniform 1/B weights when the batch
    carries none)."""
    logits, _ = model(batch["x"])
    lg = logits.float()
    y = batch["y"].long()
    ce = torch.logsumexp(lg, dim=-1) - lg.gather(1, y[:, None])[:, 0]
    w = batch.get("weights")
    if w is None:
        w = torch.full_like(ce, 1.0 / ce.shape[0])
    loss = (w * ce).sum()
    acc = (lg.argmax(-1) == y).float().mean()
    return loss, {"loss": loss, "acc": acc, "ce": ce.mean()}


def params_from_jax(cfg: ClassifierConfig,
                    params: Mapping[str, object],
                    device: str | torch.device | None = None
                    ) -> ClassifierNet:
    """Build a ``ClassifierNet`` holding a JAX parameter tree's values, on
    ``device`` (``None``: the card).

    ``params`` is ``repro.models.classifier.init_classifier``'s tree with
    numpy leaves.  Dense weights are ``(in, out)`` in JAX and ``(out, in)``
    in ``nn.Linear``; conv kernels are HWIO in JAX and OIHW in torch.
    """
    device = resolve_device(device)
    model = ClassifierNet(cfg)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    with torch.no_grad():
        if cfg.kind == "cnn":
            model.conv1.weight.copy_(t(params["conv1"]).permute(3, 2, 0, 1))
            model.conv2.weight.copy_(t(params["conv2"]).permute(3, 2, 0, 1))
        for i, fc in enumerate(model.fcs):
            fc.weight.copy_(t(params[f"fc{i}"]["w"]).T)
            fc.bias.copy_(t(params[f"fc{i}"]["b"]))
        model.head.weight.copy_(t(params["head"]["w"]).T)
        model.head.bias.copy_(t(params["head"]["b"]))
    return model.to(device)

"""Wrapper of the fused last-layer gradient kernel ``lastlayer_grad``.

The CUDA source is ``csrc/lastlayer_grad.cu``; it replaces the Pallas
kernel ``repro/kernels/lastlayer_grad.py:lastlayer_grad``.  CUDA tensors go
to the kernel (or raise), CPU tensors to the plain version in ``ref.py``.
``launches`` counts kernel launches, and nothing else.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

launches = {"lastlayer_grad": 0}


def lastlayer_grad(hidden: torch.Tensor, logits: torch.Tensor,
                   labels: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(resid (n, C), hgrad (n, d_h)) for a classification head.

    hidden (n, d_h) f32, logits (n, C) f32, labels (n,) int32/int64 with
    values in [0, C).
    """
    if not hidden.is_cuda:
        return ref.lastlayer_grad_ref(hidden, logits, labels)
    dev = hidden.device
    if hidden.dim() != 2 or logits.dim() != 2 or labels.dim() != 1:
        raise ValueError(
            f"expected hidden (n, d_h), logits (n, C), labels (n,); got "
            f"{tuple(hidden.shape)}, {tuple(logits.shape)}, "
            f"{tuple(labels.shape)}")
    n, dh = hidden.shape
    if logits.shape[0] != n or labels.shape[0] != n:
        raise ValueError(f"row counts differ: hidden {n}, logits "
                         f"{logits.shape[0]}, labels {labels.shape[0]}")
    for name, t in (("logits", logits), ("labels", labels)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, hidden on {dev}")
    if hidden.dtype != torch.float32 or logits.dtype != torch.float32:
        raise TypeError(f"hidden and logits must be float32, got "
                        f"{hidden.dtype} and {logits.dtype}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"labels must be int32 or int64, got {labels.dtype}")
    for name, t in (("hidden", hidden), ("logits", logits),
                    ("labels", labels)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    nc = logits.shape[1]
    resid = torch.empty((n, nc), dtype=torch.float32, device=dev)
    hgrad = torch.empty((n, dh), dtype=torch.float32, device=dev)
    code = build.lib().rt_lastlayer_grad(
        dev.index, hidden.data_ptr(), logits.data_ptr(), labels.data_ptr(),
        int(labels.dtype == torch.int64), resid.data_ptr(), hgrad.data_ptr(),
        n, dh, nc, torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "lastlayer_grad")
    launches["lastlayer_grad"] += 1
    return resid, hgrad

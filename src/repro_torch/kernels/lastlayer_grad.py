"""Wrappers of the fused last-layer gradient kernels ``lastlayer_grad``
(classification heads) and ``hidden_grad_fused`` (LM heads).

The CUDA sources are ``csrc/lastlayer_grad.cu`` and ``csrc/hidden_grad.cu``;
they replace the Pallas kernels ``repro/kernels/lastlayer_grad.py:
lastlayer_grad`` and ``:hidden_grad_fused``.  CUDA tensors go to the kernel
(or raise), CPU tensors to the plain version in ``ref.py``.  ``launches``
counts kernel launches, and nothing else.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.args import check_matrix, check_vector, stream

launches = {"lastlayer_grad": 0, "hidden_grad": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def _vocab_split(n: int, v: int, dh: int, dev: torch.device
                 ) -> tuple[int, int]:
    """(splits, slice): how many slices of V the kernel sums separately,
    each ``slice`` entries long (a multiple of its 32-entry chunk).

    One block computes a (128, 64) output tile over one slice, and an SM
    holds two.  Where the tiles alone leave SMs idle, V is cut so that
    tiles x splits fills them once, at most 8 ways and never below 4 096
    entries a slice; the partials are then added in slice order.  The cut
    depends on the shapes and the card only, so a call's sums have one
    fixed order.
    """
    tiles = -(-n // 128) * -(-dh // 64)
    slots = 2 * torch.cuda.get_device_properties(dev).multi_processor_count
    splits = max(1, min(8, slots // tiles, -(-v // 4096)))
    slice_ = -(-(-(-v // splits)) // 32) * 32
    return -(-v // slice_), slice_


def hidden_grad_fused(logits: torch.Tensor, labels: torch.Tensor,
                      unembed: torch.Tensor) -> torch.Tensor:
    """``(softmax(logits) - onehot(labels)) @ unembed.T`` -> (n, d_h) f32,
    the exact head-input gradient, with no (n, V) residual in memory.

    logits (n, V) f32/bf16 contiguous; labels (n,) int32/int64; unembed the
    (d_h, V) head, f32/bf16, either contiguous or the transpose of a
    contiguous (V, d_h) matrix (``embed.T`` of a tied head).  The kernel
    reads it through its strides: no copy of W is made.
    """
    if not logits.is_cuda:
        return ref.hidden_grad_ref(logits, labels, unembed)
    dev = logits.device
    check_matrix("logits", logits, _DTYPES)
    n, v = logits.shape
    if unembed.dim() != 2 or unembed.shape[1] != v:
        raise ValueError(f"unembed must be (d_h, {v}), got "
                         f"{tuple(unembed.shape)}")
    if unembed.device != dev:
        raise ValueError(f"unembed is on {unembed.device}, logits on {dev}")
    if unembed.dtype not in _DTYPES:
        raise TypeError(f"unembed must be one of {list(_DTYPES)}, got "
                        f"{unembed.dtype}")
    dh = unembed.shape[0]
    if unembed.is_contiguous():
        sh, sv = v, 1
    elif unembed.T.is_contiguous():
        sh, sv = 1, dh
    else:
        raise ValueError("unembed must be contiguous or the transpose of a "
                         f"contiguous matrix, got strides {unembed.stride()}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"labels must be int32 or int64, got {labels.dtype}")
    check_vector("labels", labels, n, dev, labels.dtype)
    if -(-n // 128) > 65535:
        raise ValueError(f"logits has {n} rows; the grid takes at most "
                         f"{65535 * 128}")
    out = torch.empty((n, dh), dtype=torch.float32, device=dev)
    if n == 0 or dh == 0:
        return out
    if v == 0:
        return out.zero_()
    stats = torch.empty((n, 2), dtype=torch.float32, device=dev)
    splits, slice_ = _vocab_split(n, v, dh, dev)
    part = (torch.empty((splits, n, dh), dtype=torch.float32, device=dev)
            if splits > 1 else out)
    code = build.lib().rt_hidden_grad(
        dev.index, logits.data_ptr(), _DTYPES[logits.dtype],
        labels.data_ptr(), int(labels.dtype == torch.int64),
        unembed.data_ptr(), _DTYPES[unembed.dtype], sh, sv, stats.data_ptr(),
        n, v, dh, slice_, splits, part.data_ptr(), out.data_ptr(),
        stream(dev))
    build.check(code, "hidden_grad")
    launches["hidden_grad"] += 1
    return out

"""Wrappers of the OMP scoring kernels ``corr`` and ``corr_argmax``.

The CUDA sources are ``csrc/corr.cu``; they replace the Pallas kernels
``repro/kernels/corr.py:corr`` and ``:corr_argmax``.  A wrapper given CUDA
tensors checks them, launches its kernel on the current stream and raises
if the launch failed; given CPU tensors it runs the plain version in
``ref.py``.  It never falls back from the card to the plain version.
``launches`` counts kernel launches, and nothing else.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

launches = {"corr": 0, "corr_argmax": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_matrix(name: str, m: torch.Tensor, dtypes) -> None:
    if m.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got shape {tuple(m.shape)}")
    if m.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {list(dtypes)}, got "
                        f"{m.dtype}")
    if not m.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if m.shape[0] >= 2 ** 31:
        raise ValueError(f"{name} has {m.shape[0]} rows; at most 2^31 - 1")


def _check_vector(name: str, v: torch.Tensor, length: int,
                  device: torch.device, dtype: torch.dtype) -> None:
    if v.device != device:
        raise ValueError(f"{name} is on {v.device}, the matrix on {device}")
    if v.shape != (length,):
        raise ValueError(f"{name} must have shape ({length},), got "
                         f"{tuple(v.shape)}")
    if v.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {v.dtype}")
    if not v.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _vec_ok(m: torch.Tensor) -> int:
    """1 when every row starts on a 16-byte boundary (16-byte loads)."""
    per_vec = 16 // m.element_size()
    return int(m.data_ptr() % 16 == 0 and m.shape[1] % per_vec == 0)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def corr(grads: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """scores = grads @ residual in f32.  grads (n, d) f32/bf16, residual
    (d,) f32 -> (n,) f32."""
    if not grads.is_cuda:
        return ref.corr_ref(grads, residual)
    _check_matrix("grads", grads, _DTYPES)
    n, d = grads.shape
    _check_vector("residual", residual, d, grads.device, torch.float32)
    out = torch.empty((n,), dtype=torch.float32, device=grads.device)
    code = build.lib().rt_corr(
        grads.device.index, grads.data_ptr(), _DTYPES[grads.dtype],
        residual.data_ptr(), out.data_ptr(), n, d, _vec_ok(grads),
        _stream(grads.device))
    build.check(code, "corr")
    launches["corr"] += 1
    return out


def corr_argmax(colcache: torch.Tensor, w: torch.Tensor, base: torch.Tensor,
                mask: torch.Tensor, absolute: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused masked argmax of ``base - colcache @ w`` (optionally abs).

    colcache (n, p) f32, w (p,) f32, base (n,) f32, mask (n,) bool ->
    (index i32 (), score f32 ()) on the device.  The lowest index wins a
    tie; an all-masked input gives (0, -inf).  The score vector is never
    written to device memory.
    """
    if not colcache.is_cuda:
        return ref.corr_argmax_ref(colcache, w, base, mask, absolute=absolute)
    _check_matrix("colcache", colcache, (torch.float32,))
    n, p = colcache.shape
    dev = colcache.device
    _check_vector("w", w, p, dev, torch.float32)
    _check_vector("base", base, n, dev, torch.float32)
    _check_vector("mask", mask, n, dev, torch.bool)
    scratch = torch.empty((1,), dtype=torch.int64, device=dev)
    idx = torch.empty((), dtype=torch.int32, device=dev)
    val = torch.empty((), dtype=torch.float32, device=dev)
    code = build.lib().rt_corr_argmax(
        dev.index, colcache.data_ptr(), w.data_ptr(),
        base.data_ptr(), mask.data_ptr(), n, p, int(absolute),
        _vec_ok(colcache), scratch.data_ptr(), idx.data_ptr(), val.data_ptr(),
        _stream(dev))
    build.check(code, "corr_argmax")
    launches["corr_argmax"] += 1
    return idx, val

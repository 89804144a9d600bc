"""Argument checks shared by the kernel wrappers: what a kernel does not
take raises here, before anything is launched."""

from __future__ import annotations

import torch


def check_matrix(name: str, m: torch.Tensor, dtypes) -> None:
    if m.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got shape {tuple(m.shape)}")
    if m.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {list(dtypes)}, got "
                        f"{m.dtype}")
    if not m.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if m.shape[0] >= 2 ** 31:
        raise ValueError(f"{name} has {m.shape[0]} rows; at most 2^31 - 1")


def check_vector(name: str, v: torch.Tensor, length: int,
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


def stream(device: torch.device) -> int:
    """The current CUDA stream of ``device``, as the kernels take it."""
    return torch.cuda.current_stream(device).cuda_stream


def argmax_outputs(device: torch.device
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(8-byte key scratch, index i32 (), value f32 ()) for a kernel that
    folds a masked argmax."""
    return (torch.empty((1,), dtype=torch.int64, device=device),
            torch.empty((), dtype=torch.int32, device=device),
            torch.empty((), dtype=torch.float32, device=device))

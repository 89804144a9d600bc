"""Argument checks shared by the kernel wrappers: what a kernel does not
take raises here, before anything is launched."""

from __future__ import annotations

from math import gcd

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
    check_array(name, v, (length,), device, dtype)


def check_array(name: str, t: torch.Tensor, shape: tuple,
                device: torch.device, dtype: torch.dtype) -> None:
    """An operand on ``device`` of exactly ``shape`` and ``dtype``, and
    contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the matrix on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream(device: torch.device) -> int:
    """The current CUDA stream of ``device``, as the kernels take it: the
    raw handle, without the Python Stream object that
    ``torch.cuda.current_stream`` builds (PERF.md §6 gives both costs a
    call)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


BLOCK_SMEM = 232_448    # a block's most shared memory on sm_90 (227 KB)
SM_SMEM = 233_472       # an SM's, of which each block reserves 1 KB


def bank_ways(row_bytes: int) -> int:
    """How many of a warp's 32 rows, ``row_bytes`` apart in shared memory,
    fall on the same bank when each reads its row's first element: the
    rows repeat every 128 bytes / gcd(row_bytes, 128), four bytes a bank.
    The tile routes read a row a thread, so this is their conflict."""
    return max(1, gcd(row_bytes, 128) // 4)


_SMS: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors, which the launch plans read."""
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device.index]


def argmax_outputs(device: torch.device
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(8-byte key scratch, index i32 (), value f32 ()) for a kernel that
    folds a masked argmax."""
    return (torch.empty((1,), dtype=torch.int64, device=device),
            torch.empty((), dtype=torch.int32, device=device),
            torch.empty((), dtype=torch.float32, device=device))

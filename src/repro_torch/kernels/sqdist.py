"""Wrapper of the pairwise squared-distance kernel ``sqdist``.

The CUDA source is ``csrc/sqdist.cu``; it replaces the Pallas kernel
``repro/kernels/sqdist.py:sqdist``.  CUDA tensors go to the kernel (or
raise), CPU tensors to the plain version in ``ref.py``.  ``launches``
counts kernel launches, and nothing else.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.args import check_matrix, stream

launches = {"sqdist": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``max(|a_i|^2 + |b_j|^2 - 2 a_i . b_j, 0)``: a (n, d), b (m, d),
    both f32 or both bf16 -> (n, m) f32, accumulated in f32."""
    if not a.is_cuda:
        return ref.sqdist_ref(a, b)
    check_matrix("a", a, _DTYPES)
    check_matrix("b", b, _DTYPES)
    dev = a.device
    if b.device != dev or b.dtype != a.dtype or b.shape[1] != a.shape[1]:
        raise ValueError(f"b ({tuple(b.shape)}, {b.dtype}, {b.device}) must "
                         f"match a ({tuple(a.shape)}, {a.dtype}, {dev}) in "
                         "width, dtype and device")
    (n, d), m = a.shape, b.shape[0]
    if -(-n // 128) > 65535:
        raise ValueError(f"a has {n} rows; the grid takes at most "
                         f"{65535 * 128}")
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    if n == 0 or m == 0:
        return out
    an = a.float().square().sum(1)
    bn = b.float().square().sum(1)
    code = build.lib().rt_sqdist(
        dev.index, a.data_ptr(), b.data_ptr(), _DTYPES[a.dtype],
        an.data_ptr(), bn.data_ptr(), n, m, d, out.data_ptr(), stream(dev))
    build.check(code, "sqdist")
    launches["sqdist"] += 1
    return out

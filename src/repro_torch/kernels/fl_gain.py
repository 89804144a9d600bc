"""Wrappers of the facility-location gain-scan kernels ``fl_gain_argmax``
and ``fl_gain_argmax_otf``.

The CUDA source is ``csrc/fl_gain.cu``; it replaces the Pallas kernels
``repro/kernels/fl_gain.py:fl_gain_argmax`` and ``:fl_gain_argmax_otf``.
CUDA tensors go to the kernel (or raise), CPU tensors to the plain
versions in ``ref.py``.  ``launches`` counts kernel launches, and nothing
else.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.args import (argmax_outputs, check_matrix,
                                      check_vector, stream)

launches = {"fl_gain_argmax": 0, "fl_gain_argmax_otf": 0}


def fl_gain_argmax(sim: torch.Tensor, cover: torch.Tensor,
                   mask: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gain scan over a resident similarity.

    sim (n, n) f32, cover (n,) f32, mask (n,) bool -> (gains (n,) f32,
    index i32 (), max gain f32 ()) with ``gain_j = sum_i relu(s_ij -
    cover_i)``.  Gains are raw (unmasked); the lowest index wins a tie and
    an all-masked input gives (0, -inf).
    """
    if not sim.is_cuda:
        return ref.fl_gain_argmax_ref(sim, cover, mask)
    check_matrix("sim", sim, (torch.float32,))
    n = sim.shape[0]
    if sim.shape[1] != n or n == 0:
        raise ValueError(f"sim must be square and non-empty, got "
                         f"{tuple(sim.shape)}")
    dev = sim.device
    check_vector("cover", cover, n, dev, torch.float32)
    check_vector("mask", mask, n, dev, torch.bool)
    gains = torch.empty((n,), dtype=torch.float32, device=dev)
    scratch, idx, val = argmax_outputs(dev)
    code = build.lib().rt_fl_gain_argmax(
        dev.index, sim.data_ptr(), cover.data_ptr(), mask.data_ptr(), n,
        gains.data_ptr(), scratch.data_ptr(), idx.data_ptr(), val.data_ptr(),
        stream(dev))
    build.check(code, "fl_gain_argmax")
    launches["fl_gain_argmax"] += 1
    return gains, idx, val


def fl_gain_argmax_otf(grads: torch.Tensor, cover: torch.Tensor,
                       row_ok: torch.Tensor, mask: torch.Tensor,
                       l_max: torch.Tensor,
                       sqnorms: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The same scan with ``s_ij = (l_max - ||g_i - g_j||) * row_ok_i``
    built tile by tile from grads (n, d) f32; the (n, n) matrix never
    exists.  row_ok (n,) bool marks the rows that demand coverage, mask
    (n,) bool the candidate columns, l_max a () f32 tensor; ``sqnorms``
    (n,) f32, the squared row norms, is reduced here when not given.
    """
    if not grads.is_cuda:
        return ref.fl_gain_argmax_otf_ref(grads, cover, row_ok, mask, l_max,
                                          sqnorms=sqnorms)
    check_matrix("grads", grads, (torch.float32,))
    n, d = grads.shape
    if n == 0:
        raise ValueError("grads has no rows")
    dev = grads.device
    if sqnorms is None:
        sqnorms = (grads * grads).sum(1)
    for name, v, dt in (("cover", cover, torch.float32),
                        ("row_ok", row_ok, torch.bool),
                        ("mask", mask, torch.bool),
                        ("sqnorms", sqnorms, torch.float32)):
        check_vector(name, v, n, dev, dt)
    if (not isinstance(l_max, torch.Tensor) or l_max.shape != ()
            or l_max.dtype != torch.float32 or l_max.device != dev):
        raise TypeError("l_max must be a () float32 tensor on the grads' "
                        "device")
    gains = torch.empty((n,), dtype=torch.float32, device=dev)
    scratch, idx, val = argmax_outputs(dev)
    code = build.lib().rt_fl_gain_argmax_otf(
        dev.index, grads.data_ptr(), sqnorms.data_ptr(), cover.data_ptr(),
        row_ok.data_ptr(), mask.data_ptr(), l_max.data_ptr(), n, d,
        gains.data_ptr(), scratch.data_ptr(), idx.data_ptr(), val.data_ptr(),
        stream(dev))
    build.check(code, "fl_gain_argmax_otf")
    launches["fl_gain_argmax_otf"] += 1
    return gains, idx, val

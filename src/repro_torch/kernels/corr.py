"""Wrappers of the OMP scoring kernels ``corr``, ``corr_argmax``, their
batched forms ``corr_batched`` and ``corr_argmax_batched``, and the
streaming certificate's ``bound_max``.

The CUDA sources are ``csrc/corr.cu``, ``csrc/corr_batched.cu`` and
``csrc/bound_max.cu``; they replace the Pallas kernels
``repro/kernels/corr.py:corr``, ``:corr_argmax`` and ``:bound_max``, and
the batched dispatch ``repro/kernels/ops.py:corr_batched`` and
``:corr_argmax_batched`` (a ``lax.map`` of the single kernels on a TPU,
one launch for the whole batch here).  A wrapper given CUDA
tensors checks them, launches its kernel on the current stream and raises
if the launch failed; given CPU tensors it runs the plain version in
``ref.py``.  It never falls back from the card to the plain version.
``launches`` counts kernel launches, and nothing else; ``shapes`` counts the
same launches of ``corr`` and ``bound_max`` by (kernel, rows, d, dtype),
and of the batched kernels by (kernel, rows, d, dtype, B, per-problem).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.args import (argmax_outputs, check_array,
                                      check_matrix, check_vector, stream)

launches = {"corr": 0, "corr_argmax": 0, "corr_batched": 0,
            "corr_argmax_batched": 0, "bound_max": 0}
# corr and bound_max launches by (kernel, rows, d, dtype), the batched
# kernels' by (kernel, rows, d, dtype, B, per-problem matrix), bumped with
# ``launches``: one path calls corr at many shapes (a buffer, a chunk, one
# row), each with its own time, bound_max at its arena's, and a batched
# kernel's time follows its batch.
shapes: dict[tuple, int] = {}


def _count(name: str, m: torch.Tensor, *batch) -> None:
    launches[name] += 1
    key = (name, *m.shape[-2:], str(m.dtype).removeprefix("torch."), *batch)
    shapes[key] = shapes.get(key, 0) + 1

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _vec_ok(m: torch.Tensor) -> int:
    """1 when every row starts on a 16-byte boundary (16-byte loads)."""
    per_vec = 16 // m.element_size()
    return int(m.data_ptr() % 16 == 0 and m.shape[1] % per_vec == 0)


def corr(grads: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """scores = grads @ residual in f32.  grads (n, d) f32/bf16, residual
    (d,) f32 -> (n,) f32."""
    if not grads.is_cuda:
        return ref.corr_ref(grads, residual)
    check_matrix("grads", grads, _DTYPES)
    n, d = grads.shape
    check_vector("residual", residual, d, grads.device, torch.float32)
    out = torch.empty((n,), dtype=torch.float32, device=grads.device)
    code = build.lib().rt_corr(
        grads.device.index, grads.data_ptr(), _DTYPES[grads.dtype],
        residual.data_ptr(), out.data_ptr(), n, d, _vec_ok(grads),
        stream(grads.device))
    build.check(code, "corr")
    _count("corr", grads)
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
    check_matrix("colcache", colcache, (torch.float32,))
    n, p = colcache.shape
    dev = colcache.device
    check_vector("w", w, p, dev, torch.float32)
    check_vector("base", base, n, dev, torch.float32)
    check_vector("mask", mask, n, dev, torch.bool)
    scratch, idx, val = argmax_outputs(dev)
    code = build.lib().rt_corr_argmax(
        dev.index, colcache.data_ptr(), w.data_ptr(),
        base.data_ptr(), mask.data_ptr(), n, p, int(absolute),
        _vec_ok(colcache), scratch.data_ptr(), idx.data_ptr(), val.data_ptr(),
        stream(dev))
    build.check(code, "corr_argmax")
    launches["corr_argmax"] += 1
    return idx, val


def corr_batched(grads: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Batched scores ``grads @ vecs.T`` in f32, pool-major: grads (n, d)
    f32, vecs (B, d) f32 -> (n, B) f32, column b equal to
    ``corr(grads, vecs[b])``."""
    if not grads.is_cuda:
        return ref.corr_batched_ref(grads, vecs)
    check_matrix("grads", grads, (torch.float32,))
    n, d = grads.shape
    dev = grads.device
    bsz = vecs.shape[0] if vecs.dim() == 2 else -1
    check_array("vecs", vecs, (bsz, d), dev, torch.float32)
    out = torch.empty((n, bsz), dtype=torch.float32, device=dev)
    if bsz == 0:
        return out
    code = build.lib().rt_corr_batched(
        dev.index, grads.data_ptr(), vecs.data_ptr(), out.data_ptr(), n, d,
        bsz, _vec_ok(grads), stream(dev))
    build.check(code, "corr_batched")
    _count("corr_batched", grads, bsz, False)
    return out


def corr_argmax_batched(mat: torch.Tensor, w: torch.Tensor,
                        base_t: torch.Tensor, mask_t: torch.Tensor,
                        absolute: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """B fused masked argmaxes of ``base - mat @ w`` (optionally abs).

    mat (n, p) f32 shared by every problem, or (B, n, p) f32 one per
    problem; w (B, p) f32; base_t (n, B) f32 and mask_t (n, B) bool,
    pool-major -> (indices i32 (B,), scores f32 (B,)) on the device.  Per
    problem: the lowest index wins a tie, an all-masked column gives
    (0, -inf).  The (n, B) scores are never written to device memory.
    """
    if not mat.is_cuda:
        return ref.corr_argmax_batched_ref(mat, w, base_t, mask_t,
                                           absolute=absolute)
    dev = mat.device
    if mat.dim() not in (2, 3):
        raise ValueError("mat must be (n, p) or (B, n, p), got shape "
                         f"{tuple(mat.shape)}")
    per_problem = mat.dim() == 3
    n, p = mat.shape[-2:]
    bsz = mat.shape[0] if per_problem else (w.shape[0] if w.dim() == 2
                                            else -1)
    check_array("mat", mat, tuple(mat.shape), dev, torch.float32)
    if n >= 2 ** 31:
        raise ValueError(f"mat has {n} rows; at most 2^31 - 1")
    check_array("w", w, (bsz, p), dev, torch.float32)
    check_array("base_t", base_t, (n, bsz), dev, torch.float32)
    check_array("mask_t", mask_t, (n, bsz), dev, torch.bool)
    idx = torch.empty((bsz,), dtype=torch.int32, device=dev)
    val = torch.empty((bsz,), dtype=torch.float32, device=dev)
    if bsz == 0:
        return idx, val
    scratch = torch.empty((bsz,), dtype=torch.int64, device=dev)
    code = build.lib().rt_corr_argmax_batched(
        dev.index, mat.data_ptr(), w.data_ptr(), base_t.data_ptr(),
        mask_t.data_ptr(), n, p, bsz, int(per_problem), int(absolute),
        int(mat.data_ptr() % 16 == 0 and p % 4 == 0), scratch.data_ptr(),
        idx.data_ptr(), val.data_ptr(), stream(dev))
    build.check(code, "corr_argmax_batched")
    _count("corr_argmax_batched", mat, bsz, per_problem)
    return idx, val


def bound_max(rows: torch.Tensor, norms: torch.Tensor, errn: torch.Tensor,
              residual: torch.Tensor, acc, thresh, mask: torch.Tensor,
              absolute: bool = False
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused interval-bound scan of a compressed row cache; the contract is
    ``ref.bound_max_ref``'s: (max u f32 (), its index i32 (), count i32 ()).

    rows (n, d) bf16/f32, norms/errn (n,) f32, residual (d,) f32, mask (n,)
    bool.  ``acc`` is a Python float (a tensor is read on the host);
    ``thresh`` a float or a 0-d f32 tensor on the rows' device, which the
    kernel reads in place, so a device threshold costs no host sync.
    """
    if not rows.is_cuda:
        return ref.bound_max_ref(rows, norms, errn, residual, acc, thresh,
                                 mask, absolute=absolute)
    check_matrix("rows", rows, _DTYPES)
    n, d = rows.shape
    dev = rows.device
    check_vector("norms", norms, n, dev, torch.float32)
    check_vector("errn", errn, n, dev, torch.float32)
    check_vector("residual", residual, d, dev, torch.float32)
    check_vector("mask", mask, n, dev, torch.bool)
    if not isinstance(thresh, torch.Tensor):
        thresh = torch.full((), float(thresh), dtype=torch.float32,
                            device=dev)
    if (thresh.device != dev or thresh.dtype != torch.float32
            or thresh.numel() != 1):
        raise ValueError("thresh must be one float32 on the rows' device, "
                         f"got {thresh.dtype} {tuple(thresh.shape)} on "
                         f"{thresh.device}")
    scratch, idx, val = argmax_outputs(dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    code = build.lib().rt_bound_max(
        dev.index, rows.data_ptr(), _DTYPES[rows.dtype], norms.data_ptr(),
        errn.data_ptr(), residual.data_ptr(), float(acc), thresh.data_ptr(),
        mask.data_ptr(), n, d, int(absolute), scratch.data_ptr(),
        idx.data_ptr(), val.data_ptr(), count.data_ptr(), stream(dev))
    build.check(code, "bound_max")
    _count("bound_max", rows)
    return val, idx, count

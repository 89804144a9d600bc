"""Wrappers of the facility-location gain-scan kernels ``fl_gain_argmax``
and ``fl_gain_argmax_otf``.

The CUDA sources are ``csrc/fl_gain.cu`` and ``csrc/fl_gain_tc.cu``; they
replace the Pallas kernels ``repro/kernels/fl_gain.py:fl_gain_argmax`` and
``:fl_gain_argmax_otf``.  CUDA tensors go to the kernel (or raise), CPU
tensors to the plain versions in ``ref.py``.  ``launches`` counts kernel
launches, and nothing else.

``fl_gain_argmax_otf`` launches by ``fl_gain_otf_plan``, a pure function of
the shapes: the tensor cores (``rt_fl_gain_argmax_otf_tc``, counted as
``fl_gain_argmax_otf_tc``: a prologue that splits the rows into TF32 halves,
then 3xTF32 ``wgmma`` fed by TMA) for rows of at most 104 columns, the FFMA
kernel of ``fl_gain.cu`` (counted as ``fl_gain_argmax_otf``) for wider
ones.  The tensor-core arithmetic is ``split_tf32`` and ``dot_3xtf32``
below; ``emulate_otf_tc`` runs the whole scan with it on any device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.args import (BLOCK_SMEM, argmax_outputs,
                                      check_matrix, check_vector, stream)

launches = {"fl_gain_argmax": 0, "fl_gain_argmax_otf": 0,
            "fl_gain_argmax_otf_tc": 0}


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


# -- the on-the-fly scan's launch plan (csrc/fl_gain_tc.cu) ------------------
# The source owns the tensor-core kernel's layout and its constants
# (kOtfCols, kOtfRows, kOtfMaxStages, kOtfMaxK8, kOtfStaticSmem,
# kAlignSlack, kWsDone) and refuses a launch that does not fit; these
# mirror them for the plan.

OTF_COLS = 128          # candidate columns a block (wgmma's N)
OTF_ROWS = 64           # rows a ring slot (a warpgroup's M)
OTF_MAX_STAGES = 4
OTF_MAX_K8 = 13         # d_pad <= 104
OTF_STATIC_SMEM = 4736  # the kernel's static shared memory, at most
OTF_ALIGN_SLACK = 1024  # aligns the dynamic part to 1 024 bytes
OTF_WS_WORDS = 17       # the key word; the counter at word 16
FFMA_COLS = 64          # the FFMA kernel's columns a block (kTileJ)


def otf_smem(k8: int, stages: int) -> int:
    """Dynamic shared memory of a tensor-core block: the alignment slack,
    the resident columns' hi and lo (2 k8 planes of 128 rows x 32 bytes)
    and ``stages`` ring slots (2 k8 planes of 64 rows x 32 bytes)."""
    return (OTF_ALIGN_SLACK + 2 * k8 * OTF_COLS * 32
            + stages * 2 * k8 * OTF_ROWS * 32)


@dataclass(frozen=True)
class FlOtfPlan:
    """How ``fl_gain_argmax_otf`` launches.  ``route`` "tc": the prologue,
    then ``grid`` blocks of 128 columns over rows padded to ``d_pad``
    (a multiple of 8), a ring of ``stages`` slots, ``smem`` bytes of dynamic
    shared memory; "ffma": the FFMA kernel, ``grid`` blocks of 64
    columns (``d_pad`` = d, no ring)."""
    route: str
    d_pad: int
    stages: int
    grid: int
    smem: int


def fl_gain_otf_plan(n: int, d: int, route: str | None = None) -> FlOtfPlan:
    """The launch of ``fl_gain_argmax_otf`` over grads (n, d); ``route``
    forces one route (ValueError where the tensor cores cannot take it).

    The tensor cores take d_pad = 8 ceil(d / 8) up to 104, with the most
    ring slots (up to four) whose layout fits a block's 227 KB beside the
    kernel's static part: four at d_pad 72 (the craig-lazy path's d 65) and
    16 (craig-lazy-otf's d 10), two at 104.  Wider rows take the FFMA
    kernel, and so does n d_pad >= 2^31 (32-bit offsets)."""
    if route not in (None, "tc", "ffma"):
        raise ValueError(f"fl_gain_argmax_otf: no route {route!r}")
    k8 = -(-d // 8)
    fits = [s for s in range(OTF_MAX_STAGES, 1, -1)
            if otf_smem(k8, s) + OTF_STATIC_SMEM <= BLOCK_SMEM]
    tc_ok = (n >= 1 and 1 <= k8 <= OTF_MAX_K8 and bool(fits)
             and n * 8 * k8 < 2 ** 31)
    if route == "tc" and not tc_ok:
        raise ValueError(f"fl_gain_argmax_otf: the tensor cores cannot take "
                         f"({n}, {d})")
    if route == "tc" or (route is None and tc_ok):
        return FlOtfPlan("tc", 8 * k8, fits[0], -(-n // OTF_COLS),
                         otf_smem(k8, fits[0]))
    return FlOtfPlan("ffma", d, 0, max(1, -(-n // FFMA_COLS)), 0)


# -- the tensor cores' arithmetic, in torch ----------------------------------

def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    nearest, ties away from zero, an f32 whose low 13 bits are zero.  On
    the bits: the sign is apart from the magnitude, so adding half of the
    last kept unit to the pattern and clearing the low bits rounds the
    magnitude half up.  For finite inputs."""
    u = x.float().contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) = (tf32_rna(x), tf32_rna(x - hi)): x - hi is exact in f32,
    and hi + lo keeps ~22 significant bits of x (all of them when x has at
    most 22)."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x.float() - hi)


def dot_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, d) x (m, d) -> (n, m) f32 as the tensor-core scan forms its dot
    products: lo_a.hi_b + hi_a.lo_b + hi_a.hi_b (lo_a.lo_b dropped).  Each
    TF32 product is exact; here they are summed in f64 and rounded to f32
    once, where the card sums them in f32 on the tensor cores."""
    ha, la = (t.double() for t in split_tf32(a))
    hb, lb = (t.double() for t in split_tf32(b))
    return (la @ hb.T + ha @ lb.T + ha @ hb.T).float()


def emulate_otf_tc(grads: torch.Tensor, cover: torch.Tensor,
                   row_ok: torch.Tensor, mask: torch.Tensor, l_max,
                   sqnorms: torch.Tensor | None = None, block: int = 1024
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``ref.fl_gain_argmax_otf_ref`` with its dot products taken as the
    tensor-core route takes them (``dot_3xtf32``): the same outputs and
    epilogue, on any device."""
    g = grads.float()
    sqn = (g * g).sum(1) if sqnorms is None else sqnorms.float()
    gains = ref.fl_gains_cols_ref(g, sqn, g, sqn, cover.float(), row_ok,
                                  l_max, block=block, dot=dot_3xtf32)
    return (gains, *ref._masked_argmax(gains, mask))


def fl_gain_argmax_otf(grads: torch.Tensor, cover: torch.Tensor,
                       row_ok: torch.Tensor, mask: torch.Tensor,
                       l_max: torch.Tensor,
                       sqnorms: torch.Tensor | None = None, *,
                       route: str | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The same scan with ``s_ij = (l_max - ||g_i - g_j||) * row_ok_i`` built
    tile by tile from grads (n, d) f32; the (n, n) matrix never exists.
    row_ok (n,) bool marks the rows that demand coverage, mask (n,) bool
    the candidate columns, l_max a () f32 tensor; ``sqnorms`` (n,) f32,
    the squared row norms, is reduced here when not given.

    A CUDA call launches by ``fl_gain_otf_plan`` (``route`` forces one, for
    measurement).  On the tensor cores each column's gain is summed in one
    fixed order, so a call gives the same bits as the last; its dot
    products round as ``dot_3xtf32``'s, not as the FFMA kernel's.
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
    plan = fl_gain_otf_plan(n, d, route)
    gains = torch.empty((n,), dtype=torch.float32, device=dev)
    if plan.route == "tc":
        # hi and lo planes (csrc/fl_gain_tc.cu), the key word and counter
        split = torch.empty((2 * n * plan.d_pad,), dtype=torch.float32,
                            device=dev)
        ws = torch.empty((OTF_WS_WORDS,), dtype=torch.int64, device=dev)
        idx = torch.empty((), dtype=torch.int32, device=dev)
        val = torch.empty((), dtype=torch.float32, device=dev)
        code = build.lib().rt_fl_gain_argmax_otf_tc(
            dev.index, grads.data_ptr(), sqnorms.data_ptr(),
            cover.data_ptr(), row_ok.data_ptr(), mask.data_ptr(),
            l_max.data_ptr(), n, d, plan.d_pad // 8, plan.stages,
            split.data_ptr(), ws.data_ptr(), gains.data_ptr(),
            idx.data_ptr(), val.data_ptr(), stream(dev))
        build.check(code, "fl_gain_argmax_otf_tc")
        launches["fl_gain_argmax_otf_tc"] += 1
        return gains, idx, val
    scratch, idx, val = argmax_outputs(dev)
    code = build.lib().rt_fl_gain_argmax_otf(
        dev.index, grads.data_ptr(), sqnorms.data_ptr(), cover.data_ptr(),
        row_ok.data_ptr(), mask.data_ptr(), l_max.data_ptr(), n, d,
        gains.data_ptr(), scratch.data_ptr(), idx.data_ptr(), val.data_ptr(),
        stream(dev))
    build.check(code, "fl_gain_argmax_otf")
    launches["fl_gain_argmax_otf"] += 1
    return gains, idx, val

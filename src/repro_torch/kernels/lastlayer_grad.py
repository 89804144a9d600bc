"""Wrappers of the fused last-layer gradient kernels ``lastlayer_grad``
(classification heads) and ``hidden_grad_fused`` (LM heads).

The CUDA sources are ``csrc/lastlayer_grad.cu``, and for the LM head
``csrc/hidden_grad_tc.cu`` (tensor cores, bf16 heads) and
``csrc/hidden_grad.cu`` (FFMA, the other inputs); they replace the Pallas
kernels ``repro/kernels/lastlayer_grad.py:lastlayer_grad`` and
``:hidden_grad_fused``.  CUDA tensors go to a kernel (or raise), CPU
tensors to the plain version in ``ref.py``.  ``launches`` counts kernel
launches, and nothing else.  ``lastlayer_grad`` launches by
``lastlayer_plan``, a pure function of the shapes and the addresses: the
tile route (rows in flight by bulk copy) or the warp route.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.args import (BLOCK_SMEM, SM_SMEM, bank_ways,
                                      check_matrix, check_vector, sm_count,
                                      stream)

launches = {"lastlayer_grad": 0, "hidden_grad": 0, "hidden_grad_tc": 0}
# lastlayer_grad's launches by route, bumped with ``launches``.
lastlayer_routes = {"tiles": 0, "warps": 0}

# -- lastlayer_grad's launch plan (csrc/lastlayer_grad.cu) -------------------
# The source owns the tile layout (TileLayout) and its constants
# (kTileThreads, kTileMaxRows, kTileMaxC, kTileMaxStages) and refuses a
# launch that does not fit; these mirror them for the plan.
TILE_THREADS = 128      # a tile block's threads (kTileThreads)
TILE_MAX_ROWS = 128     # rows a tile, one softmax a thread (kTileMaxRows)
TILE_MAX_C = 32         # classes, one term a lane (kTileMaxC)
TILE_MIN_ROWS = 8192    # smaller n takes the warps (PERF.md §6)
TILE_BLOCKS_PER_SM = 8  # 128-thread blocks an SM holds
WARP_ROWS = 8           # the warp route: rows (warps) a block
WARP_MAX_BLOCKS = 132 * 8 * 4   # its grid cap (kMaxBlocks)


@dataclass(frozen=True)
class LastlayerPlan:
    """How ``lastlayer_grad`` launches.  ``route`` "tiles": tiles of
    ``rows`` rows loaded by bulk copy into a ring of ``stages``
    shared-memory slots (``smem`` bytes of dynamic shared memory), one
    thread a row's softmax; "warps": one warp a row.  ``grid`` blocks."""
    route: str
    rows: int
    stages: int
    grid: int
    smem: int


def _align128(x: int) -> int:
    return -(-x // 128) * 128


def tile_smem(dh: int, nc: int, label_bytes: int, rows: int,
              stages: int) -> int:
    """Dynamic shared memory of a tile block, the total of the kernel's
    ``TileLayout``: barriers, then ``stages`` slots of a tile's hidden
    rows, logits, labels and own, each part 128-aligned."""
    slot = (_align128(rows * dh * 4) + _align128(rows * nc * 4)
            + _align128(rows * label_bytes) + _align128(rows * 4))
    return 128 + stages * slot


def tile_rows(dh: int, nc: int, label_bytes: int, stages: int) -> int:
    """The most rows a tile (a multiple of 4, at most ``TILE_MAX_ROWS``)
    whose layout fits a block and whose hidden part stays below 2^16
    elements; 0 if not even 4 rows do."""
    rows = TILE_MAX_ROWS
    while rows >= 4 and (tile_smem(dh, nc, label_bytes, rows, stages)
                         > BLOCK_SMEM or rows * dh >= 1 << 16):
        rows -= 4
    return max(rows, 0)


def lastlayer_plan(n: int, dh: int, nc: int, addrs, sms: int = 132,
                   label_bytes: int = 8, route: str | None = None
                   ) -> LastlayerPlan:
    """The launch of ``lastlayer_grad`` on n rows of d_h hidden units and
    C classes, with ``label_bytes``-byte labels, whose operands (hidden,
    logits, labels, resid, hgrad) start at ``addrs``, on a card of ``sms``
    SMs; ``route`` forces one route (ValueError where the tiles cannot
    take the call).

    The tile route takes n >= ``TILE_MIN_ROWS``, 1 <= C <= 32 whose
    logits rows do not put 16 or more of a warp's rows on one bank (C 16
    and 32: a thread reads its row's logits), d_h >= 1 and every address
    on a 16-byte boundary: one slot a block where every tile gets its own
    block in one wave (the main path's 45 000 rows: 352 tiles of 128
    rows), else a persistent wave with a ring of two.  Everything else
    takes the warp route.  On an H100 (PERF.md §6) the
    warps are the faster under 8 192 rows (6.2 against 7.5 us at the
    stream path's 1 024) and at C 16 and 32 (19.5 against 20.6, 22.1
    against 49.2 us at 45 000 rows); the tiles elsewhere (12.3 against
    19.3 us at the main path's (45 000, 64, 10))."""
    rows1 = tile_rows(dh, nc, label_bytes, 1)
    tiles_ok = (n >= 1 and dh >= 1 and 1 <= nc <= TILE_MAX_C and rows1 >= 4
                and all(a % 16 == 0 for a in addrs))
    if route not in (None, "tiles", "warps"):
        raise ValueError(f"lastlayer_grad: no route {route!r}")
    if route == "tiles" and not tiles_ok:
        raise ValueError(f"lastlayer_grad: the tile route cannot take "
                         f"({n}, {dh}, {nc}) at {[hex(a) for a in addrs]}")
    if route == "tiles" or (route is None and tiles_ok
                            and n >= TILE_MIN_ROWS
                            and bank_ways(4 * nc) < 16):
        def per_sm(smem):
            return min(SM_SMEM // (smem + 1024), TILE_BLOCKS_PER_SM)

        # One wave of one-slot blocks, with fewer rows a tile where 128
        # would leave SMs idle (a block's copy, softmax and stores are its
        # latency) ...
        rows = min(rows1, max(4, -(-(-(-n // sms)) // 4) * 4))
        smem = tile_smem(dh, nc, label_bytes, rows, 1)
        if -(-n // rows) <= sms * per_sm(smem):
            return LastlayerPlan("tiles", rows, 1, -(-n // rows), smem)
        # ... else a persistent wave, a ring of two slots where two fit.
        stages = 2 if tile_rows(dh, nc, label_bytes, 2) >= 4 else 1
        rows = tile_rows(dh, nc, label_bytes, stages)
        smem = tile_smem(dh, nc, label_bytes, rows, stages)
        return LastlayerPlan("tiles", rows, stages,
                             min(-(-n // rows), sms * per_sm(smem)), smem)
    grid = max(1, min(-(-n // WARP_ROWS), WARP_MAX_BLOCKS))
    return LastlayerPlan("warps", WARP_ROWS, 0, grid, 0)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def lastlayer_grad(hidden: torch.Tensor, logits: torch.Tensor,
                   labels: torch.Tensor, *, route: str | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(resid (n, C), hgrad (n, d_h)) for a classification head.

    hidden (n, d_h) f32, logits (n, C) f32, labels (n,) int32/int64 with
    values in [0, C).  A CUDA call launches by ``lastlayer_plan``
    (``route`` forces one, for measurement); both routes give the same
    bits.
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
    operands = (hidden, logits, labels, resid, hgrad)
    plan = lastlayer_plan(n, dh, nc, [t.data_ptr() for t in operands],
                          sm_count(dev), labels.element_size(), route)
    code = build.lib().rt_lastlayer_grad(
        dev.index, hidden.data_ptr(), logits.data_ptr(), labels.data_ptr(),
        int(labels.dtype == torch.int64), resid.data_ptr(), hgrad.data_ptr(),
        n, dh, nc, int(plan.route == "tiles"), plan.rows, plan.stages,
        plan.grid, stream(dev))
    build.check(code, "lastlayer_grad")
    launches["lastlayer_grad"] += 1
    lastlayer_routes[plan.route] += 1
    return resid, hgrad


def _vocab_split(n: int, v: int, dh: int, dev: torch.device
                 ) -> tuple[int, int]:
    """(splits, slice) of the FFMA kernel: how many slices of V it sums
    separately, each ``slice`` entries long (a multiple of its 32-entry
    chunk).

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


# The tensor-core kernel's block: a (128, 256) output tile, V in stages of
# 64 entries, one block an SM (its ring takes 197 KB of shared memory).
TC_ROWS, TC_COLS, TC_DEPTH = 128, 256, 64
TC_MIN_SLICE = 16 * TC_DEPTH    # a slice fills the 4-stage ring 4 times
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}


def tc_vocab_split(n: int, v: int, dh: int, sms: int) -> tuple[int, int]:
    """(splits, slice) of the tensor-core kernel for ``sms`` SMs: V is cut
    into ``splits`` slices of ``slice`` entries (a multiple of the 64-entry
    stage), one block per output tile and slice, so that tiles x splits
    fills one wave of the SMs where the tiles alone would not (at most
    ceil(V / ``TC_MIN_SLICE``) slices); the partials are added in slice
    order.  A function of the shapes and the SM count only, so a call's
    sums have one fixed order.  The LM path's (512, 256 000, 2 048) on 132
    SMs: 32 tiles x 4 slices of 64 000 entries, 128 blocks.
    """
    tiles = -(-n // TC_ROWS) * -(-dh // TC_COLS)
    splits = max(1, min(sms // tiles, -(-v // TC_MIN_SLICE)))
    slice_ = -(-(-(-v // splits)) // TC_DEPTH) * TC_DEPTH
    return -(-v // slice_), slice_


def takes_tensor_cores(z_dtype: torch.dtype, w_dtype: torch.dtype, n: int,
                       v: int, dh: int, tied: bool, z_addr: int,
                       w_addr: int) -> bool:
    """The routing rule of ``hidden_grad_fused``: True sends the call to the
    tensor-core kernel, False to the FFMA kernel.

    The tensor-core kernel takes a bf16 head W (exact in bf16: only the
    residual is split in two) with f32 or bf16 logits, where TMA can
    address every operand: each row of Z and of the head's contiguous
    matrix (Z (n, V); ``embed`` (V, d_h) of a tied head, W (d_h, V)
    otherwise) a multiple of 16 bytes long, both data addresses 16-byte
    aligned, and n, V, d_h below 2^31.  Everything else (an f32 head, a
    V or d_h off those multiples, an unaligned view) goes to the FFMA
    kernel.  The rule reads dtypes, shapes, strides and addresses only.
    """
    if w_dtype != torch.bfloat16 or z_dtype not in _ITEMSIZE:
        return False
    return (v * _ITEMSIZE[z_dtype] % 16 == 0
            and (dh if tied else v) % 8 == 0
            and z_addr % 16 == 0 and w_addr % 16 == 0
            and max(n, v, dh) < 2 ** 31)


def _hidden_grad_args(logits: torch.Tensor, labels: torch.Tensor,
                      unembed: torch.Tensor) -> tuple[int, int, int, bool]:
    """Check the CUDA call's arguments; (n, V, d_h, tied): tied when
    ``unembed`` is the transpose of a contiguous (V, d_h) matrix."""
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
        tied = False
    elif unembed.T.is_contiguous():
        tied = True
    else:
        raise ValueError("unembed must be contiguous or the transpose of a "
                         f"contiguous matrix, got strides {unembed.stride()}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"labels must be int32 or int64, got {labels.dtype}")
    check_vector("labels", labels, n, dev, labels.dtype)
    if -(-n // 128) > 65535:
        raise ValueError(f"logits has {n} rows; the grid takes at most "
                         f"{65535 * 128}")
    return n, v, dh, tied


def _empty_result(n: int, v: int, dh: int, dev: torch.device
                  ) -> torch.Tensor | None:
    """The result of a call with nothing to compute (no launch), else
    None."""
    if n == 0 or dh == 0:
        return torch.empty((n, dh), dtype=torch.float32, device=dev)
    if v == 0:
        return torch.zeros((n, dh), dtype=torch.float32, device=dev)
    return None


def hidden_grad_fused(logits: torch.Tensor, labels: torch.Tensor,
                      unembed: torch.Tensor) -> torch.Tensor:
    """``(softmax(logits) - onehot(labels)) @ unembed.T`` -> (n, d_h) f32,
    the exact head-input gradient, with no (n, V) residual in memory.

    logits (n, V) f32/bf16 contiguous; labels (n,) int32/int64 (a label
    outside [0, V) gets no one-hot); unembed the (d_h, V) head, f32/bf16,
    either contiguous or the transpose of a contiguous (V, d_h) matrix
    (``embed.T`` of a tied head).  The kernels read it through its
    strides: no copy of W is made.

    A CUDA call goes by ``takes_tensor_cores`` (dtypes, shapes, strides
    and addresses only) to the tensor-core kernel (``csrc/
    hidden_grad_tc.cu``, counted on ``launches["hidden_grad_tc"]``): a
    bf16 head whose rows, and the logits' rows, TMA can address, as on the
    LM path.  Every other call goes to the FFMA kernel (``csrc/
    hidden_grad.cu``, counted on ``launches["hidden_grad"]``).  A kernel
    that fails raises: neither stands in for the other.
    """
    if not logits.is_cuda:
        return ref.hidden_grad_ref(logits, labels, unembed)
    n, v, dh, tied = _hidden_grad_args(logits, labels, unembed)
    if takes_tensor_cores(logits.dtype, unembed.dtype, n, v, dh, tied,
                          logits.data_ptr(), unembed.data_ptr()):
        return _launch_tc(logits, labels, unembed, tied)
    return _launch_ffma(logits, labels, unembed, tied)


def hidden_grad_ffma(logits: torch.Tensor, labels: torch.Tensor,
                     unembed: torch.Tensor) -> torch.Tensor:
    """``hidden_grad_fused`` on the FFMA kernel, whatever the routing rule
    says (``chip_smoke.py`` times it beside the tensor-core kernel)."""
    if not logits.is_cuda:
        return ref.hidden_grad_ref(logits, labels, unembed)
    _, _, _, tied = _hidden_grad_args(logits, labels, unembed)
    return _launch_ffma(logits, labels, unembed, tied)


def _launch_tc(logits: torch.Tensor, labels: torch.Tensor,
               unembed: torch.Tensor, tied: bool) -> torch.Tensor:
    dev = logits.device
    (n, v), dh = logits.shape, unembed.shape[0]
    out = _empty_result(n, v, dh, dev)
    if out is not None:
        return out
    out = torch.empty((n, dh), dtype=torch.float32, device=dev)
    stats = torch.empty((n, 2), dtype=torch.float32, device=dev)
    splits, slice_ = tc_vocab_split(
        n, v, dh, torch.cuda.get_device_properties(dev).multi_processor_count)
    part = (torch.empty((splits, n, dh), dtype=torch.float32, device=dev)
            if splits > 1 else out)
    code = build.lib().rt_hidden_grad_tc(
        dev.index, logits.data_ptr(), _DTYPES[logits.dtype],
        labels.data_ptr(), int(labels.dtype == torch.int64),
        unembed.data_ptr(), int(tied), stats.data_ptr(), n, v, dh, slice_,
        splits, part.data_ptr(), out.data_ptr(), stream(dev))
    build.check(code, "hidden_grad_tc")
    launches["hidden_grad_tc"] += 1
    return out


def _launch_ffma(logits: torch.Tensor, labels: torch.Tensor,
                 unembed: torch.Tensor, tied: bool) -> torch.Tensor:
    dev = logits.device
    (n, v), dh = logits.shape, unembed.shape[0]
    out = _empty_result(n, v, dh, dev)
    if out is not None:
        return out
    sh, sv = (1, dh) if tied else (v, 1)
    out = torch.empty((n, dh), dtype=torch.float32, device=dev)
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

"""Dispatch for the port's kernels, after ``repro/kernels/ops.py``.

A CUDA tensor goes to the hand-written kernel and a CPU tensor to its plain
version (the wrappers decide by the tensor's device).  ``set_backend("ref")``
is the one way to send a CUDA tensor to the plain version: only the tests
and ``chip_smoke.py``'s comparison phases call it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import corr as corr_kernel
from repro_torch.kernels import fl_gain as fl_gain_kernel
from repro_torch.kernels import lastlayer_grad as llg_kernel
from repro_torch.kernels import ref
from repro_torch.kernels import sqdist as sqdist_kernel

_COUNTERS = (corr_kernel.launches, llg_kernel.launches,
             fl_gain_kernel.launches, sqdist_kernel.launches)

_FORCE: str | None = None   # "ref" | None (by the tensor's device)


def set_backend(mode: str | None) -> None:
    """Send every tensor to the plain versions ('ref'), or dispatch by the
    tensor's device again (None)."""
    global _FORCE
    if mode not in (None, "ref"):
        raise ValueError(f"unknown kernel backend {mode!r}")
    _FORCE = mode


def active_mode() -> str:
    """The dispatch mode in effect: 'ref' when forced, else 'cuda' when a
    card is present (CPU tensors take the plain versions either way)."""
    if _FORCE is not None:
        return _FORCE
    return "cuda" if torch.cuda.is_available() else "ref"


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last ``reset_launch_counts``."""
    return {name: n for counts in _COUNTERS for name, n in counts.items()}


def launch_shapes() -> dict[tuple, int]:
    """``corr`` and ``bound_max`` launches since the last
    ``reset_launch_counts``, by (kernel, rows, d, dtype), and the batched
    kernels' by (kernel, rows, d, dtype, B, per-problem matrix)."""
    return dict(corr_kernel.shapes)


_ROUTES = (("lastlayer_grad", llg_kernel.lastlayer_routes),
           ("bound_max", corr_kernel.bound_routes),
           ("corr", corr_kernel.corr_routes),
           ("corr_argmax", corr_kernel.argmax_routes),
           ("sqdist", sqdist_kernel.sqdist_routes))


def launch_routes() -> dict[str, int]:
    """``lastlayer_grad``, ``bound_max``, ``corr``, ``corr_argmax`` and
    ``sqdist`` launches since the last ``reset_launch_counts``, by route
    ("kernel/route")."""
    return {f"{kernel}/{route}": n for kernel, routes in _ROUTES
            for route, n in routes.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTERS + tuple(routes for _, routes in _ROUTES):
        for name in counts:
            counts[name] = 0
    corr_kernel.shapes.clear()


def corr(grads: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """OMP scores ``G @ r`` -> (n,) f32."""
    if _FORCE == "ref":
        return ref.corr_ref(grads, residual)
    return corr_kernel.corr(grads, residual)


def corr_argmax(colcache: torch.Tensor, w: torch.Tensor, base: torch.Tensor,
                mask: torch.Tensor, *, absolute: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused OMP scoring: masked argmax of ``base - colcache @ w``."""
    if _FORCE == "ref":
        return ref.corr_argmax_ref(colcache, w, base, mask,
                                   absolute=absolute)
    return corr_kernel.corr_argmax(colcache, w, base, mask,
                                   absolute=absolute)


def corr_batched(grads: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Batched OMP scores ``(B, d)`` against one pool -> **(n, B)** f32,
    pool-major: column b is ``corr(grads, vecs[b])``."""
    if _FORCE == "ref":
        return ref.corr_batched_ref(grads, vecs)
    return corr_kernel.corr_batched(grads, vecs)


def corr_argmax_batched(mat: torch.Tensor, w: torch.Tensor,
                        base_t: torch.Tensor, mask_t: torch.Tensor, *,
                        absolute: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched fused OMP scoring: per-problem masked argmax of ``base -
    mat @ w`` with ``mat`` shared ``(n, p)`` or per-problem ``(B, n, p)``
    and ``base_t`` / ``mask_t`` pool-major ``(n, B)`` -> (indices (B,),
    values (B,))."""
    if _FORCE == "ref":
        return ref.corr_argmax_batched_ref(mat, w, base_t, mask_t,
                                           absolute=absolute)
    return corr_kernel.corr_argmax_batched(mat, w, base_t, mask_t,
                                           absolute=absolute)


def bound_max(rows: torch.Tensor, norms: torch.Tensor, errn: torch.Tensor,
              residual: torch.Tensor, acc, thresh, mask: torch.Tensor, *,
              absolute: bool = False
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Streaming certificate scan over the compressed cache -> (max upper
    bound (), its index (), offender count ())."""
    if _FORCE == "ref":
        return ref.bound_max_ref(rows, norms, errn, residual, acc, thresh,
                                 mask, absolute=absolute)
    return corr_kernel.bound_max(rows, norms, errn, residual, acc, thresh,
                                 mask, absolute=absolute)


def lastlayer_grad(hidden: torch.Tensor, logits: torch.Tensor,
                   labels: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(resid, per-gradient hidden grad) for classification heads."""
    if _FORCE == "ref":
        return ref.lastlayer_grad_ref(hidden, logits, labels)
    return llg_kernel.lastlayer_grad(hidden, logits, labels)


def fl_gain_argmax(sim: torch.Tensor, cover: torch.Tensor,
                   mask: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Facility-location gain scan + masked argmax over a resident
    similarity -> (gains (n,), index (), value ())."""
    if _FORCE == "ref":
        return ref.fl_gain_argmax_ref(sim, cover, mask)
    return fl_gain_kernel.fl_gain_argmax(sim, cover, mask)


def fl_gain_argmax_otf(grads: torch.Tensor, cover: torch.Tensor,
                       row_ok: torch.Tensor, mask: torch.Tensor,
                       l_max: torch.Tensor,
                       sqnorms: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The same scan with the similarity built tile by tile from ``grads``
    (n, d); ``sqnorms`` hands in the squared row norms when the caller
    holds them."""
    if _FORCE == "ref":
        return ref.fl_gain_argmax_otf_ref(grads, cover, row_ok, mask, l_max,
                                          sqnorms=sqnorms)
    return fl_gain_kernel.fl_gain_argmax_otf(grads, cover, row_ok, mask,
                                             l_max, sqnorms=sqnorms)


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances (n, d), (m, d) -> (n, m) f32."""
    if _FORCE == "ref":
        return ref.sqdist_ref(a, b)
    return sqdist_kernel.sqdist(a, b)


def hidden_grad(logits: torch.Tensor, labels: torch.Tensor,
                unembed: torch.Tensor) -> torch.Tensor:
    """dL/dh = (softmax(Z) - onehot(Y)) @ W^T for LM heads -> (n, d_h)
    f32; ``unembed`` is W as (d_h, V)."""
    if _FORCE == "ref":
        return ref.hidden_grad_ref(logits, labels, unembed)
    return llg_kernel.hidden_grad_fused(logits, labels, unembed)

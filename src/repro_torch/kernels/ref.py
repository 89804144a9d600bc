"""Plain PyTorch versions of the port's kernels.

Written to the contracts of ``repro/kernels/ref.py``: f32 accumulation, the
lowest index wins a tie, and an all-masked input gives ``(0, -inf)``.  They
are what a kernel wrapper runs for a tensor on the CPU, what the CPU tests
hold against the JAX package, and what the kernels are held against on the
card.
"""

from __future__ import annotations

import torch


def corr_ref(grads: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """OMP residual-correlation scores: (n, d) @ (d,) -> (n,) in f32."""
    return grads.float() @ residual.float()


def _masked_argmax(gains: torch.Tensor, mask: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(index i32 (), value f32 ()) of the masked max; the first maximal
    index wins, an all-False mask gives (0, -inf)."""
    masked = torch.where(mask, gains, float("-inf"))
    idx = torch.argmax(masked)
    return idx.to(torch.int32), masked.index_select(0, idx.view(1))[0]


def corr_argmax_ref(colcache: torch.Tensor, w: torch.Tensor,
                    base: torch.Tensor, mask: torch.Tensor,
                    absolute: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked argmax of ``scores = base - colcache @ w``.

    colcache (n, p), w (p,), base (n,), mask (n,) bool -> (index i32 (),
    score f32 ()).  ``torch.argmax`` returns the first maximal index, so
    ties go to the lowest index; an all-False mask gives (0, -inf).
    """
    scores = base.float() - colcache.float() @ w.float()
    if absolute:
        scores = scores.abs()
    return _masked_argmax(scores, mask)


def corr_batched_ref(grads: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Batched OMP scores: (n, d) @ (B, d)^T -> **(n, B)** in f32.

    Column b is ``corr_ref(grads, vecs[b])``; the output is pool-major, as
    in the reference (the orientation the shared-operand product gives).
    """
    return grads.float() @ vecs.float().T


def corr_argmax_batched_ref(mat: torch.Tensor, w: torch.Tensor,
                            base_t: torch.Tensor, mask_t: torch.Tensor,
                            absolute: bool = False
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """B masked argmaxes of ``base - mat @ w``, one per problem.

    ``mat`` is a shared pool ``(n, p)`` (every problem scores the same rows
    against its own ``w[b]``) or per-problem ``(B, n, p)``; w (B, p);
    ``base_t`` / ``mask_t`` pool-major ``(n, B)`` -> (indices (B,) i32,
    values (B,) f32).  Per problem the single contract holds: the lowest
    index wins a tie and an all-masked column gives (0, -inf).
    """
    w = w.float()
    if mat.dim() == 2:
        scores = base_t.float() - mat.float() @ w.T                # (n, B)
    else:
        scores = base_t.float() - torch.einsum("bnp,bp->nb", mat.float(), w)
    if absolute:
        scores = scores.abs()
    scores = torch.where(mask_t, scores, float("-inf"))
    idx = torch.argmax(scores, dim=0)
    vals = scores.gather(0, idx[None, :])[0]
    return idx.to(torch.int32), vals


def bound_max_ref(rows: torch.Tensor, norms: torch.Tensor,
                  errn: torch.Tensor, residual: torch.Tensor, acc, thresh,
                  mask: torch.Tensor, absolute: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Interval-bound scan over a compressed row cache (the streaming
    certificate's second rung).

    rows (n, d) bf16 or f32, norms/errn (n,) f32 sidecars (exact row norm,
    ``||g - bf16(g)||``), residual (d,), acc () accumulation-margin scalar,
    thresh () comparison threshold, mask (n,) bool -> (max upper bound
    f32 (), its index i32 (), count of masked rows with ``u >= thresh``
    i32 ()), where ``u_i = s_i + (e_i + acc ||g_i||) ||r||`` and ``s_i`` is
    the f32 dot (``abs`` when ``absolute``).  Ties go to the lowest index;
    an all-False mask gives (-inf, 0, 0).
    """
    r = residual.float()
    dev = r.device
    acc = torch.as_tensor(acc, dtype=torch.float32, device=dev)
    thresh = torch.as_tensor(thresh, dtype=torch.float32, device=dev)
    s = rows.float() @ r
    if absolute:
        s = s.abs()
    rnorm = torch.sqrt((r * r).sum())
    u = s + (errn.float() + acc * norms.float()) * rnorm
    idx, val = _masked_argmax(u, mask)
    u_m = torch.where(mask, u, float("-inf"))
    return val, idx, (mask & (u_m >= thresh)).sum().to(torch.int32)


def fl_gain_argmax_ref(sim: torch.Tensor, cover: torch.Tensor,
                       mask: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Facility-location gain scan over a resident similarity.

    sim (n, n), cover (n,), mask (n,) bool -> (gains (n,) f32 with
    ``gain_j = sum_i relu(s_ij - cover_i)``, masked argmax index i32 (),
    max gain f32 ()).  Gains are raw (unmasked); the lowest index wins a
    tie and an all-False mask gives (0, -inf).  Holds one (n, n) f32
    temporary.
    """
    gains = (sim.float() - cover.float()[:, None]).clamp_min_(0.0).sum(0)
    return (gains, *_masked_argmax(gains, mask))


def fl_gains_cols_ref(cand: torch.Tensor, cand_sqn: torch.Tensor,
                      grads: torch.Tensor, sqnorms: torch.Tensor,
                      cover: torch.Tensor, row_ok: torch.Tensor,
                      l_max, block: int = 256, dot=None) -> torch.Tensor:
    """FL gains of the candidates ``cand`` (m, d) against the pool
    ``grads`` (n, d), in strips of ``block`` coverage rows:
    ``gain_j = sum_i relu((l_max - ||g_i - c_j||) * row_ok_i - cover_i)``,
    peak memory O(block * m).  The one copy of the strip computation: the
    full on-the-fly scan runs it with cand = grads and the lazy engine's
    wide refresh on a slice, so their gains reduce in the same order,
    which the lazy certification margin assumes.  ``dot(rows, cand)``
    replaces the strips' ``rows @ cand.T`` (the tensor-core scan's
    emulation, ``fl_gain.emulate_otf_tc``).
    """
    n = grads.shape[0]
    g = grads.float()
    cand = cand.float()
    lm = torch.as_tensor(l_max, dtype=torch.float32, device=g.device)
    ok = row_ok.to(torch.float32)
    gains = torch.zeros((cand.shape[0],), dtype=torch.float32,
                        device=g.device)
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        prod = g[lo:hi] @ cand.T if dot is None else dot(g[lo:hi], cand)
        d2 = (sqnorms[lo:hi, None] + cand_sqn[None, :] - 2.0 * prod)
        s = (lm - torch.sqrt(d2.clamp_min_(0.0))) * ok[lo:hi, None]
        gains = gains + (s - cover[lo:hi, None]).clamp_min_(0.0).sum(0)
    return gains


def fl_gain_argmax_otf_ref(grads: torch.Tensor, cover: torch.Tensor,
                           row_ok: torch.Tensor, mask: torch.Tensor,
                           l_max, block: int = 1024,
                           sqnorms: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """On-the-fly twin of ``fl_gain_argmax_ref``: the same outputs, with
    ``s_ij = (l_max - ||g_i - g_j||) * row_ok_i`` built in (block, n)
    strips from grads (n, d), so the (n, n) matrix never exists.
    ``sqnorms`` (squared row norms) skips their reduction when the caller
    holds them.
    """
    g = grads.float()
    sqn = (g * g).sum(1) if sqnorms is None else sqnorms.float()
    gains = fl_gains_cols_ref(g, sqn, g, sqn, cover.float(), row_ok, l_max,
                              block=block)
    return (gains, *_masked_argmax(gains, mask))


def sqdist_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared euclidean distances (n, d), (m, d) -> (n, m) f32,
    the expanded way ``max(|a|^2 + |b|^2 - 2 a.b, 0)``."""
    a = a.float()
    b = b.float()
    an = (a * a).sum(-1)
    bn = (b * b).sum(-1)
    return (an[:, None] + bn[None, :] - 2.0 * (a @ b.T)).clamp_min_(0.0)


def lastlayer_grad_ref(hidden: torch.Tensor, logits: torch.Tensor,
                       labels: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Last-layer CE gradient pieces for a classification head.

    hidden (n, d_h), logits (n, C), labels (n,) int -> resid (n, C) =
    softmax(logits) - onehot(labels), and hgrad (n, d_h) = resid[i, y_i] *
    hidden_i (the paper's per-gradient approximation).
    """
    z = logits.float()
    z = z - z.max(dim=-1, keepdim=True).values
    e = torch.exp(z)
    p = e / e.sum(dim=-1, keepdim=True)
    y = labels.long()
    onehot = (y[:, None] == torch.arange(z.shape[-1], device=z.device)
              ).to(torch.float32)
    resid = p - onehot
    own = (resid * onehot).sum(dim=-1, keepdim=True)
    return resid, own * hidden.float()


def hidden_grad_ref(logits: torch.Tensor, labels: torch.Tensor,
                    unembed: torch.Tensor) -> torch.Tensor:
    """Exact head-input gradient of an LM head: ``(softmax(logits) -
    onehot(labels)) @ unembed.T`` in f32.

    logits (n, V) f32/bf16, labels (n,) int (a label outside [0, V) gets a
    zero one-hot row), unembed (d_h, V) -> (n, d_h) f32.  The ``(n, V)``
    residual is materialized, as in the reference's plain version.
    """
    z = logits.float()
    z = z - z.max(dim=-1, keepdim=True).values
    e = torch.exp(z)
    resid = e / e.sum(dim=-1, keepdim=True)
    y = labels.long()
    resid = resid - (y[:, None] == torch.arange(z.shape[-1], device=z.device)
                     ).to(torch.float32)
    return resid @ unembed.float().T

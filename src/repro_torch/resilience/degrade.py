"""The graceful-degradation ladder, after ``repro/resilience/degrade.py``:
a labelled answer beats no answer.

When a certified streaming solve cannot be had, a caller walks down a
ladder of weaker answers, and labels each with the rung that produced it
(``DEGRADE_LEVELS``, the reference's names): never passing a weaker
answer off as certified.  The stochastic rung lives here:
``stochastic_fallback`` over the rows a ``ChunkCache`` arena holds and
``stochastic_pool_select`` over a resident pool, each a seeded numpy
subsample (the reference's draws, so both packages sample the same rows)
solved by the port's ``omp_select`` on the rows' device.
"""

from __future__ import annotations

import numpy as np
import torch


class DeadlineExceeded(RuntimeError):
    """The request's deadline expired before a solve could start."""


DEGRADE_LEVELS = ("artifact", "certified", "resumed", "prefix-shared",
                  "anytime-prefix", "stochastic", "shed", "timeout",
                  "failed")


def _sample(pos: np.ndarray, k: int, seed: int, sample_factor: int,
            min_sample: int) -> np.ndarray:
    """The seeded subsample of candidate positions, sorted."""
    sample = min(max(int(sample_factor) * int(k), int(min_sample)),
                 int(pos.size))
    rng = np.random.default_rng(int(seed))
    return np.sort(rng.choice(pos, size=sample, replace=False))


def _solve_sample(rows: torch.Tensor, ids: np.ndarray, target, k: int,
                  lam: float, eps: float, positive: bool):
    """In-memory OMP over the sampled rows; picks mapped to ``ids``."""
    from repro_torch.core import omp as omp_lib
    from repro_torch.core.gradmatch import SelectionResult

    target = torch.as_tensor(target, dtype=torch.float32).to(rows.device)
    idx, w, mask, err = omp_lib.omp_select(rows, target, int(k), lam=lam,
                                           eps=eps, positive=positive)
    local = idx.cpu().numpy()
    m = mask.cpu().numpy()
    global_idx = np.where(m, ids[np.clip(local, 0, len(ids) - 1)], -1)
    return SelectionResult(
        torch.as_tensor(global_idx.astype(np.int32), device=rows.device),
        w, mask, err)


def stochastic_fallback(cache, target, k: int, seed: int = 0,
                        lam: float = 0.5, eps: float = 1e-10,
                        positive: bool = True, sample_factor: int = 4,
                        min_sample: int = 256):
    """Last-resort selection from whatever the chunk cache holds, on the
    cache's device.

    Upcasts the live (non-quarantined) bf16 arena rows of a seeded
    subsample of ``max(sample_factor*k, min_sample)`` of them and runs
    the in-memory OMP on it: cheap, loader-free, approximate.  Returns a
    ``SelectionResult`` whose indices are global row ids, or ``None`` when
    the cache holds nothing usable.
    """
    if cache is None or cache.gids is None:   # no arena (cache_bytes=0)
        return None
    gids = cache.gids.cpu().numpy()
    live = (gids >= 0) & cache.ok.cpu().numpy()
    if not live.any():
        return None
    pick = _sample(np.flatnonzero(live), k, seed, sample_factor, min_sample)
    rows = cache.rows[torch.as_tensor(pick, device=cache.device)].float()
    return _solve_sample(rows, gids[pick].astype(np.int64), target, k, lam,
                         eps, positive)


def stochastic_pool_select(grads, target, k: int, seed: int = 0,
                           lam: float = 0.5, eps: float = 1e-10,
                           positive: bool = True, valid=None,
                           sample_factor: int = 4, min_sample: int = 256,
                           device: str | torch.device | None = None):
    """The stochastic rung for a resident ``(n, d)`` pool: a seeded
    subsample of the valid rows, in-memory OMP over it, indices mapped
    back to global row ids; on the pool's device (a tensor's, else
    ``device``, whose ``None`` is the card).  ``None`` when no row is
    valid."""
    from repro_torch.core import streaming

    dev = (grads.device if isinstance(grads, torch.Tensor) and device is None
           else streaming.resolve_device(device))
    g = streaming._rows(grads, dev)
    n = g.shape[0]
    if valid is not None:
        v = valid.cpu().numpy() if isinstance(valid, torch.Tensor) else valid
        pos = np.flatnonzero(np.asarray(v, bool))
    else:
        pos = np.arange(n)
    if pos.size == 0:
        return None
    pick = _sample(pos, k, seed, sample_factor, min_sample)
    rows = g[torch.as_tensor(pick, device=dev)]
    return _solve_sample(rows, pick, target, k, lam, eps, positive)

"""CRAIG baseline (Mirzasoleiman et al. 2020a): facility-location greedy,
after ``repro/core/craig.py``.

CRAIG maximizes ``F(X) = sum_i max_{j in X} (L_max - ||g_i - g_j||)``
with the 1 - 1/e greedy; weights are cluster sizes, ``w_j = #{i : j =
argmax_j s_ij}``.  The greedy runs on ``core/greedy.py`` in three tiers
(``method``): ``"dense"`` (the full-rescan oracle), ``"lazy"`` (certified
lazy greedy, index-identical to dense) and ``"stochastic"`` (seeded
per-round subsampling).  Beyond ``greedy._OTF_AUTO_BYTES`` (or with
``on_the_fly=True``) the lazy and stochastic tiers rebuild the similarity
from ``grads`` and never hold the (n, n) matrix.  ``dist_fn`` (e.g.
``ops.sqdist``) builds a resident similarity from squared distances.
"""

from __future__ import annotations

import torch

from repro_torch.core import greedy as greedy_lib
from repro_torch.core.gradmatch import SelectionResult, _normalize
from repro_torch.core.greedy import pairwise_sim  # noqa: F401  (re-export)


def craig(
    grads: torch.Tensor,              # (n, d)
    k: int,
    sim: torch.Tensor | None = None,  # optional precomputed (n, n) similarity
    valid: torch.Tensor | None = None,
    dist_fn=None,
    method: str = "dense",            # "dense" | "lazy" | "stochastic"
    l_max=None,
    block: int = 64,                  # lazy: top-B bound-refresh width
    sample: int = 64,                 # stochastic: per-round sample size
    generator: torch.Generator | None = None,   # stochastic sampling
    on_the_fly: bool | None = None,
) -> SelectionResult:
    n = grads.shape[0]
    k = int(k)
    g = grads.float()
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=g.device)
    if sim is None and dist_fn is not None:
        sim = greedy_lib.build_sim(g, l_max=l_max, dist_fn=dist_fn)
    # Resolve the scan once, here: the weights and objective below use the
    # (sim, L_max, on-the-fly) the selection ran under.
    sim, lm, otf = greedy_lib.resolve_fl_scan(g, sim, method, l_max=l_max,
                                              on_the_fly=on_the_fly)
    res = greedy_lib.fl_greedy(
        g, k, sim=sim, valid=valid, l_max=lm, method=method, block=block,
        sample=sample, generator=generator, on_the_fly=otf)

    # Weights: the size of each medoid's cluster.  Medoid similarities are
    # read as rows (k, n): the similarity is symmetric, and a row gather is
    # contiguous.
    sel = torch.where(res.mask, res.indices, 0).long()
    if otf:
        sim_sel = greedy_lib.fl_rows(g, (g * g).sum(1), valid.float(), lm,
                                     sel)
    else:
        sim_sel = sim[sel]
    sim_sel = torch.where(res.mask[:, None], sim_sel, float("-inf"))
    assign = torch.argmax(sim_sel, dim=0)                    # (n,) slots
    w = torch.zeros((k,), dtype=torch.float32, device=g.device).index_add_(
        0, assign, valid.float())
    w = torch.where(res.mask, w, 0.0)
    # Remaining coverage deficit sum_i (L_max - cover_i) over valid rows;
    # rows zeroed out of the similarity demand no coverage.
    err = torch.where(valid, lm - res.cover, 0.0).sum()
    return SelectionResult(res.indices, _normalize(w, res.mask), res.mask,
                           err)


def craig_pb(example_proxies: torch.Tensor, batch_size: int, k_batches: int,
             dist_fn=None, method: str = "dense",
             generator: torch.Generator | None = None) -> SelectionResult:
    """CRAIGPB: facility location over mini-batch mean gradients."""
    from repro_torch.core import proxies as proxy_lib

    pb = proxy_lib.per_batch(example_proxies, batch_size)
    return craig(pb, k=k_batches, dist_fn=dist_fn, method=method,
                 generator=generator)

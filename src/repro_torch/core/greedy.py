"""Shared greedy-maximization engine (CRAIG's facility location, GLISTER's
Taylor greedy), after ``repro/core/greedy.py``.

- **Certified lazy greedy** (``method="lazy"``): cached stale gains are
  upper bounds by submodularity.  Each round re-evaluates the top-``B``
  block of candidates by stale bound and accepts the block argmax when its
  exact gain strictly beats the best stale bound outside the block (by a
  relative margin); else a wide block is tried, then one full gain scan
  (the ``fl_gain_argmax`` kernels) restores every bound.  Selections are
  index-identical to the dense greedy, ties to the lowest id.
- **Stochastic greedy** (``method="stochastic"``): per round a seeded
  uniform sample of the available candidates is scored exactly.
- **Dense greedy** (``method="dense"``): the full-rescan oracle; it calls
  no kernel.
- **On-the-fly similarity** (``on_the_fly=True``, auto beyond
  ``_OTF_AUTO_BYTES``): ``s_ij = L_max - ||g_i - g_j||`` is rebuilt from
  the (n, d) gradients wherever it is read; the (n, n) matrix never exists.

The reference runs each solver as one jitted ``fori_loop``; here the rounds
are a Python loop.  The lazy engine reads its certificate on the host once
a block refresh (one device sync each), and the number of growing rounds
is known on the host from the count of valid rows, so no other round
syncs.  ``modular_greedy`` is the non-submodular sibling: a fixed-k greedy
over ``grads @ v``, argmax'd by the ``corr_argmax`` kernel (GLISTER).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.kernels import ops, ref

_NEG_INF = float("-inf")

# Materialize the similarity below this footprint; rebuild it from grads
# above (n = 11585 at f32).  The reference's value: it decides which path
# a pool size takes, so it is part of the result, not a tuning knob.
_OTF_AUTO_BYTES = 512 << 20

# Rows of the (n, n) similarity built at once by the plain pairwise_sim.
_SIM_ROW_BLOCK = 4096


def pairwise_sim(grads: torch.Tensor, dist_fn=None,
                 l_max=None) -> torch.Tensor:
    """Similarity ``s_ij = L_max - ||g_i - g_j||`` (n, n).

    ``l_max`` defaults to the max observed distance; pass it explicitly
    when resident and on-the-fly scans must use one offset
    (``default_l_max`` gives the cheap O(n·d) bound).  ``dist_fn(a, b)``
    returns squared distances (``ops.sqdist``); without it they are built
    in row blocks.  The result is built in place in one (n, n) buffer.
    """
    n = grads.shape[0]
    if dist_fn is not None:
        dist = dist_fn(grads, grads)
    else:
        sq = (grads * grads).sum(-1)
        dist = torch.empty((n, n), dtype=sq.dtype, device=grads.device)
        for lo in range(0, n, _SIM_ROW_BLOCK):
            hi = min(lo + _SIM_ROW_BLOCK, n)
            dist[lo:hi] = (sq[lo:hi, None] + sq[None, :]
                           - 2.0 * (grads[lo:hi] @ grads.T))
    dist.clamp_min_(0.0).sqrt_()
    lm = (dist.max() if l_max is None
          else torch.as_tensor(l_max, dtype=torch.float32,
                               device=dist.device))
    return dist.neg_().add_(lm)          # lm - dist, bit for bit


def default_l_max(grads: torch.Tensor) -> torch.Tensor:
    """O(n·d) distance upper bound: the diameter bound 2·max‖g‖."""
    g = grads.float()
    return 2.0 * torch.sqrt((g * g).sum(1).max())


def auto_on_the_fly(n: int) -> bool:
    """Rebuild the similarity on the fly once the (n, n) f32 matrix would
    exceed ``_OTF_AUTO_BYTES``."""
    return n * n * 4 > _OTF_AUTO_BYTES


def build_sim(grads: torch.Tensor, l_max=None, dist_fn=None
              ) -> torch.Tensor:
    """``pairwise_sim`` of the f32 gradients."""
    return pairwise_sim(grads.float(), dist_fn=dist_fn, l_max=l_max)


@dataclass(frozen=True)
class GreedyStats:
    """Accounting for benchmarks and the certification tests."""
    rounds: int = 0             # accepted selections
    certified_rounds: int = 0   # rounds resolved without a full scan
    rescans: int = 0            # full gain scans (incl. the round-0 init)
    block_evals: int = 0        # top-B refresh iterations


class GreedyResult(NamedTuple):
    indices: torch.Tensor   # (k,) int32 candidate ids, -1 on unused slots
    mask: torch.Tensor      # (k,) bool
    gains: torch.Tensor     # (k,) f32 accepted marginal gain per round
    cover: torch.Tensor     # (n,) f32 final coverage  max_{j in S} s_ij
    stats: Optional[GreedyStats]


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def taken_mask(indices: torch.Tensor, mask: torch.Tensor, n: int
               ) -> torch.Tensor:
    """(n,) bool of already-selected candidates.  Unused slots write to an
    out-of-bounds sentinel slot n that is sliced away (an in-bounds
    sentinel would race with a genuine pick of row n - 1)."""
    buf = torch.zeros((n + 1,), dtype=torch.bool, device=indices.device)
    buf[torch.where(mask, indices.long(), n)] = mask
    return buf[:n]


def _row(m: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``m[i]`` for a 0-dim device index, without a host sync."""
    return m.index_select(0, i.reshape(1))[0]


def _top_ids(vals: torch.Tensor, avail: torch.Tensor, b: int
             ) -> torch.Tensor:
    """Ids of the ``b`` largest of ``vals`` over ``avail`` (others -inf),
    lower id first on ties, as ``lax.top_k`` orders them."""
    masked = torch.where(avail, vals, _NEG_INF)
    return torch.sort(masked, descending=True, stable=True).indices[:b]


def _lowest_id_argmax(vals: torch.Tensor, ids: torch.Tensor, sentinel: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(max value, winning global id, local position), ties -> lowest id.

    The candidates are ordered by stale bound, not by id, so the tie is
    re-broken by id explicitly.
    """
    m = vals.max()
    pos = torch.argmin(torch.where(vals == m, ids, sentinel))
    return m, _row(ids, pos), pos


def _threshold(outside: torch.Tensor, rel: float) -> torch.Tensor:
    """The outside bound inflated by the certification margin."""
    return torch.where(torch.isfinite(outside),
                       outside + rel * outside.abs(), outside)


def _outside_max(bounds: torch.Tensor, avail: torch.Tensor,
                 ids: torch.Tensor) -> torch.Tensor:
    """Best stale bound of the available candidates not in ``ids``."""
    rest = torch.where(avail, bounds, _NEG_INF)
    rest[ids] = _NEG_INF
    return rest.max()


def fl_rows(grads: torch.Tensor, sqnorms: torch.Tensor,
            row_okf: torch.Tensor, l_max: torch.Tensor, ids: torch.Tensor
            ) -> torch.Tensor:
    """Similarity columns of candidates ``ids``, transposed to (B, n):
    ``(l_max - ||g_i - g_j||) * row_ok_i``.  Row b is the cover update
    vector of candidate ids[b]."""
    ids = ids.long()
    cand = grads[ids]
    d2 = (sqnorms[ids][:, None] + sqnorms[None, :]
          - 2.0 * (cand @ grads.T))
    return (l_max - torch.sqrt(d2.clamp_min_(0.0))) * row_okf[None, :]


def fl_gains_cols(cand: torch.Tensor, cand_sqn: torch.Tensor,
                  grads: torch.Tensor, sqnorms: torch.Tensor,
                  cover: torch.Tensor, row_okf: torch.Tensor,
                  l_max: torch.Tensor, block: int = 256) -> torch.Tensor:
    """FL gains of an explicit candidate slice, blocked over coverage rows:
    the same implementation as the plain full on-the-fly scan
    (``ref.fl_gains_cols_ref``), so the two reduce in the same order."""
    return ref.fl_gains_cols_ref(cand, cand_sqn, grads, sqnorms, cover,
                                 row_okf, l_max, block=block)


def _doubly_masked(sim: torch.Tensor, valid: torch.Tensor, n_valid: int
                   ) -> torch.Tensor:
    """Zero the rows and columns of invalid candidates (kept symmetric:
    the block refresh reads rows where the scan sums columns).  With every
    row valid the factors are 1 and the matrix is returned as it is."""
    sim = sim.float()
    if n_valid == valid.shape[0]:
        return sim
    okf = valid.float()
    return (sim * okf[:, None]).mul_(okf[None, :])


class _Scan:
    """The similarity one solve reads: resident (``sim``) or rebuilt from
    ``grads`` on the fly."""

    def __init__(self, sim, grads, valid, n_valid, l_max, otf: bool):
        self.otf = otf
        self.valid = valid
        self.row_okf = valid.float()
        self.l_max = l_max
        if otf:
            self.grads = grads.float()
            self.sqnorms = (self.grads * self.grads).sum(1)
            self.sim = None
        else:
            self.grads = self.sqnorms = None
            self.sim = _doubly_masked(sim, valid, n_valid)

    def gains_ids(self, cover, ids):
        """Exact gains and similarity rows (B, n) of a candidate block.
        The resident path gathers rows of the symmetric matrix (contiguous
        reads) and sums along them; row b is the cover update of ids[b]."""
        if self.otf:
            rows = fl_rows(self.grads, self.sqnorms, self.row_okf,
                           self.l_max, ids)
        else:
            rows = self.sim[ids]
        return (rows - cover[None, :]).clamp_min_(0.0).sum(1), rows

    def gains_all(self, cover, avail):
        """Full exact gain scan through the kernels' dispatch."""
        if self.otf:
            return ops.fl_gain_argmax_otf(self.grads, cover, self.valid,
                                          avail, self.l_max,
                                          sqnorms=self.sqnorms)
        return ops.fl_gain_argmax(self.sim, cover, avail)

    def gains_wide(self, cover, ids):
        """Exact gains of a wide block (and its rows when resident).  The
        on-the-fly path runs the blocked column scan, peak
        O(1024 · wide)."""
        if self.otf:
            return fl_gains_cols(self.grads[ids], self.sqnorms[ids],
                                 self.grads, self.sqnorms, cover,
                                 self.row_okf, self.l_max,
                                 block=1024), None
        return self.gains_ids(cover, ids)

    def col_of(self, e):
        """Cover update vector of candidate ``e`` (0-dim device index)."""
        if self.otf:
            return fl_rows(self.grads, self.sqnorms, self.row_okf,
                           self.l_max, e.reshape(1))[0]
        return _row(self.sim, e)


def _empty_result(k: int, n: int, device):
    return (torch.full((k,), -1, dtype=torch.int32, device=device),
            torch.zeros((k,), dtype=torch.bool, device=device),
            torch.zeros((n,), dtype=torch.float32, device=device),
            torch.zeros((k,), dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# facility-location greedy solvers
# ---------------------------------------------------------------------------

def _fl_lazy(sim, grads, valid, l_max, *, k: int, block: int,
             max_tries: int, otf: bool):
    # Escalation tier: when the top-B block cannot certify, one refresh of
    # a much wider stale-bound block usually can, at O(wide · n) against
    # the O(n²) rescan.  The resident escalation gathers similarity rows
    # and stays narrower so the (wide, n) gather stays small.
    n = valid.shape[0]
    wide = min((64 if otf else 8) * block, n)
    n_valid = int(valid.sum())
    scan = _Scan(sim, grads, valid, n_valid, l_max, otf)
    # Certification margin: resident block and scan sums share their
    # inputs; the on-the-fly paths rebuild them in another order, so the
    # outside bound is inflated past f32 reassociation noise (failing
    # closed into a rescan is exact, certifying on noise is not).
    rel = 1e-5 if otf else 1e-6

    indices, mask, cover, picked = _empty_result(k, n, valid.device)
    # Round 0 is a full scan: it sets every bound exactly.
    bounds, e0, val0 = scan.gains_all(cover, valid)
    if n_valid > 0 and k > 0:
        indices[0] = e0
        mask[0] = True
        cover = torch.maximum(cover, scan.col_of(e0))
        picked[0] = val0
    evals, rescans, certified = 0, 1, 0

    # Rounds past the valid count are exhausted and skipped whole: no
    # refreshes, no rescan, stats untouched.
    for t in range(1, min(k, n_valid)):
        avail = valid & ~taken_mask(indices, mask, n)
        cert, tries = False, 0
        while not cert and tries < max_tries:
            bids = _top_ids(bounds, avail, block)
            exact, rows = scan.gains_ids(cover, bids)
            # Exact gains are valid bounds for any candidate.
            bounds[bids] = exact
            ex_m = torch.where(avail[bids], exact, _NEG_INF)
            bmax, e, pos = _lowest_id_argmax(ex_m, bids, n)
            thresh = _threshold(_outside_max(bounds, avail, bids), rel)
            cert = bool(bmax > thresh)
            tries += 1
        if cert:
            gain, col, scanned = _row(ex_m, pos), _row(rows, pos), 0
        else:
            scanned = 1
            if wide > block:
                wids = _top_ids(bounds, avail, wide)
                exact, rows_w = scan.gains_wide(cover, wids)
                bounds[wids] = exact
                ex_m = torch.where(avail[wids], exact, _NEG_INF)
                bmax, e, pos = _lowest_id_argmax(ex_m, wids, n)
                thresh = _threshold(_outside_max(bounds, avail, wids), rel)
                if bool(bmax > thresh):
                    gain = _row(ex_m, pos)
                    col = (scan.col_of(e) if otf else _row(rows_w, pos))
                    scanned = 0
            if scanned:
                bounds, e, gain = scan.gains_all(cover, avail)
                col = scan.col_of(e)
        indices[t] = e
        mask[t] = True
        cover = torch.maximum(cover, col)
        picked[t] = gain
        evals += tries
        rescans += scanned
        certified += scanned == 0
    return indices, mask, picked, cover, evals, rescans, certified


def _fl_stochastic(sim, grads, valid, l_max, generator, *, k: int,
                   sample: int, otf: bool):
    n = valid.shape[0]
    n_valid = int(valid.sum())
    scan = _Scan(sim, grads, valid, n_valid, l_max, otf)
    indices, mask, cover, picked = _empty_result(k, n, valid.device)
    for t in range(min(k, n_valid)):
        avail = valid & ~taken_mask(indices, mask, n)
        # Uniform sample without replacement over the available pool: the
        # top-s of i.i.d. uniforms masked to avail.
        u = torch.rand((n,), generator=generator, device=valid.device)
        sids = _top_ids(u, avail, sample)
        exact, rows = scan.gains_ids(cover, sids)
        ex_m = torch.where(avail[sids], exact, _NEG_INF)
        _, e, pos = _lowest_id_argmax(ex_m, sids, n)
        indices[t] = e
        mask[t] = True
        cover = torch.maximum(cover, _row(rows, pos))
        picked[t] = _row(ex_m, pos)
    return indices, mask, picked, cover


def _fl_dense(sim, valid, *, k: int):
    """Naive full-rescan greedy, the parity oracle: every round scores all
    n candidates exactly; nothing cached, nothing certified, no kernel."""
    n = valid.shape[0]
    n_valid = int(valid.sum())
    sim = sim.float()
    if n_valid < n:
        sim = sim * valid[:, None].float()
    indices, mask, cover, picked = _empty_result(k, n, valid.device)
    for t in range(min(k, n_valid)):
        avail = valid & ~taken_mask(indices, mask, n)
        gains = (sim - cover[:, None]).clamp_min_(0.0).sum(0)
        gains = torch.where(avail, gains, _NEG_INF)
        e = torch.argmax(gains)
        indices[t] = e
        mask[t] = True
        cover = torch.maximum(cover, sim.index_select(1, e.reshape(1))[:, 0])
        picked[t] = _row(gains, e)
    return indices, mask, picked, cover


def resolve_fl_scan(grads, sim, method: str, l_max=None,
                    on_the_fly: bool | None = None):
    """Decide how the similarity is scanned: returns ``(sim, l_max,
    on_the_fly)`` with the resident matrix built when needed and the offset
    defaulted consistently (``l_max`` a () f32 tensor on the data's
    device).  ``fl_greedy`` and ``craig`` both go through here, so the
    weights and objective use the offset the selection ran under."""
    if grads is None and sim is None:
        raise ValueError("need grads or a resident sim")
    src = sim if grads is None else grads
    n = src.shape[0]
    if sim is not None or method == "dense":
        if on_the_fly:
            raise ValueError(
                "on_the_fly=True contradicts a resident similarity: the "
                "dense oracle scans a materialized sim, and a passed-in "
                "sim is already materialized — drop one or the other")
        on_the_fly = False
    elif on_the_fly is None:
        on_the_fly = auto_on_the_fly(n)
    if on_the_fly:
        if grads is None:
            raise ValueError("on-the-fly similarity needs grads")
        lm = default_l_max(grads) if l_max is None else l_max
        sim = None
    else:
        if sim is None:
            sim = build_sim(grads, l_max=l_max)
        lm = sim.max() if l_max is None else l_max
    return (sim, torch.as_tensor(lm, dtype=torch.float32, device=src.device),
            on_the_fly)


def fl_greedy(
    grads: torch.Tensor | None = None,   # (n, d); required when on the fly
    k: int = 1,
    *,
    sim: torch.Tensor | None = None,     # (n, n) resident similarity
    valid: torch.Tensor | None = None,
    l_max=None,
    method: str = "lazy",                # "lazy" | "stochastic" | "dense"
    block: int = 64,                     # B: lazy top-B refresh width
    max_tries: int = 6,                  # block refreshes before escalating
    sample: int = 64,                    # s: stochastic per-round sample
    generator: torch.Generator | None = None,   # stochastic sampling
    on_the_fly: bool | None = None,      # None: auto by footprint
) -> GreedyResult:
    """Facility-location maximization over ``grads`` (or a resident,
    symmetric ``sim``).  ``method="lazy"`` is index-identical to
    ``"dense"``; ``"stochastic"`` is the seeded approximate tier, drawing
    from ``generator`` (default: seeded 0 on the data's device)."""
    if grads is None and sim is None:
        raise ValueError("need grads or a resident sim")
    src = sim if grads is None else grads
    n = src.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=src.device)
    sim, lm, on_the_fly = resolve_fl_scan(grads, sim, method, l_max=l_max,
                                          on_the_fly=on_the_fly)
    k = int(k)

    if method == "dense":
        indices, mask, picked, cover = _fl_dense(sim, valid, k=k)
        rounds = int(mask.sum())
        stats = GreedyStats(rounds=rounds, rescans=rounds)
    elif method == "stochastic":
        if generator is None:
            generator = torch.Generator(device=src.device).manual_seed(0)
        indices, mask, picked, cover = _fl_stochastic(
            sim, grads, valid, lm, generator, k=k,
            sample=min(int(sample), n), otf=on_the_fly)
        stats = GreedyStats(rounds=int(mask.sum()))
    elif method == "lazy":
        indices, mask, picked, cover, evals, rescans, certified = _fl_lazy(
            sim, grads, valid, lm, k=k, block=min(int(block), n),
            max_tries=int(max_tries), otf=on_the_fly)
        stats = GreedyStats(rounds=int(mask.sum()),
                            certified_rounds=int(certified),
                            rescans=int(rescans), block_evals=int(evals))
    else:
        raise ValueError(f"unknown greedy method {method!r}")
    return GreedyResult(indices, mask, picked, cover, stats)


# ---------------------------------------------------------------------------
# modular greedy (GLISTER): argmax of grads @ v with a state-advance hook
# ---------------------------------------------------------------------------

def modular_greedy(
    grads: torch.Tensor,              # (n, d)
    k: int,
    advance: Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor],
    v0: torch.Tensor,                 # (d,) initial score state
    valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-k greedy over the scores ``grads @ v_t``.

    ``advance(v, e, t)`` gives the score state after accepting candidate
    ``e`` (a 0-dim device index) in round ``t``.  The masked argmax runs
    through the ``corr_argmax`` kernel; rows exhaust when k >= #valid
    (mask False, index -1).  Returns (indices (k,), mask (k,), picked
    scores (k,)).
    """
    n = grads.shape[0]
    g = grads.float()
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=g.device)
    zeros = torch.zeros((n,), dtype=torch.float32, device=g.device)
    k = int(k)
    indices = torch.full((k,), -1, dtype=torch.int32, device=g.device)
    mask = torch.zeros((k,), dtype=torch.bool, device=g.device)
    picked = torch.zeros((k,), dtype=torch.float32, device=g.device)
    v = v0.float()
    for t in range(min(k, int(valid.sum()))):
        avail = valid & ~taken_mask(indices, mask, n)
        # scores = g @ v  ==  zeros - g @ (-v): the corr_argmax contract.
        e, val = ops.corr_argmax(g, -v, zeros, avail)
        indices[t] = e
        mask[t] = True
        v = advance(v, e, t)
        picked[t] = val
    return indices, mask, picked

"""The port's continual selection (``repro_torch/continual``,
``repro_torch/core/decremental.py``) against the JAX package's, on the
CPU.

Inside the port, the reference's guarantees (``tests/test_continual.py``):
after every admitted batch the buffer's committed solution equals a fresh
solve over the rows that survive in it (indices exact, weights to rtol
2e-4 / atol 2e-5); a downdate, then an extension, equals a fresh solve on
the surviving rows; truncation equals a fresh prefix; the traced
extension equals the block extension bit for bit; a killed stream
resumes bit for bit.  Across the packages: on the same stream the port's
buffer keeps the reference's slots, gids and counters, its weights to
rtol 1e-4 / atol 1e-5, and its downdates and truncations pick what the
reference's pick.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.continual import BufferMaintainer as JBuffer  # noqa: E402
from repro.core import decremental as jdec  # noqa: E402
from repro.core import omp as jomp  # noqa: E402
from repro_torch.continual import (BufferMaintainer,  # noqa: E402
                                   continual_select)
from repro_torch.core import omp  # noqa: E402
from repro_torch.core import selection as sel_lib  # noqa: E402
from repro_torch.core.decremental import (certify_admission,  # noqa: E402
                                          omp_downdate,
                                          session_extend_traced,
                                          session_truncate)
from repro_torch.core.gradmatch import gradmatch  # noqa: E402
from repro_torch.core.streaming import (SelectStats,  # noqa: E402
                                        StreamingPassBudgetError)

SEED = int(os.environ.get("FAULT_SEED", "7"))
CPU = "cpu"


def _pool(seed, n, d, dups=True):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, d)).astype(np.float32)
    if dups and n >= 8:
        g[n // 2] = g[1]            # duplicate rows: tie-breaking must
        g[n - 2] = g[1]             # not depend on arrival order
    return g


def _buffer(**kw):
    return BufferMaintainer(device=CPU, **kw)


def _feed(m, g, bs):
    n = g.shape[0]
    for lo in range(0, n, bs):
        hi = min(lo + bs, n)
        m.admit(g[lo:hi], gids=np.arange(lo, hi, dtype=np.int64))
    return m


def _assert_matches_scratch(m, what):
    """The maintained slot-space solution equals a fresh solve on the
    surviving buffer rows."""
    pool, ok = m.pool_view()
    idx, w, mask, err = m.slot_result()
    fresh = omp.omp_session_start(pool, m.target, m.k, valid=ok,
                                  lam=m.lam, eps=m.eps,
                                  positive=m.positive, block=m.block)
    np.testing.assert_array_equal(idx.numpy(), fresh.indices.numpy(),
                                  err_msg=f"{what}: indices diverged")
    np.testing.assert_array_equal(mask.numpy(), fresh.mask.numpy(),
                                  err_msg=f"{what}: mask diverged")
    np.testing.assert_allclose(w.numpy(), fresh.weights.numpy(),
                               rtol=2e-4, atol=2e-5,
                               err_msg=f"{what}: weights diverged")
    np.testing.assert_allclose(float(err), float(fresh.err), rtol=1e-4,
                               err_msg=f"{what}: err diverged")


def _assert_matches_jax(m, jm, what):
    """The port's buffer against the reference's after the same stream."""
    idx, w, mask, err = m.slot_result()
    ji, jw, jmask, jerr = jm.slot_result()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji), err_msg=what)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask),
                                  err_msg=what)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-4,
                               atol=1e-5, err_msg=what)
    np.testing.assert_allclose(float(err), float(jerr), rtol=1e-4,
                               atol=1e-5, err_msg=what)
    np.testing.assert_array_equal(m._gids, jm._gids, err_msg=what)
    np.testing.assert_array_equal(m._ok, jm._ok, err_msg=what)
    got = {k: v for k, v in vars(m.stats).items() if k != "host_syncs"}
    assert got == vars(jm.stats), what


# ---------------------------------------------------------------------------
# differential: the (n, k, batch_size, buffer_cap) grid, and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,k,bs,cap", [
    (64, 8, 8, 16, 32),      # roomy buffer: mostly free evictions
    (96, 8, 12, 8, 16),      # tight buffer: committed evictions (downdates)
    (48, 24, 6, 6, 48),      # capacity covers the pool: nothing evicted
    (40, 8, 16, 8, 12),      # k >= buffer: degenerate re-pick rounds
    (64, 24, 10, 32, 24),    # wide-ish proxies, batch > capacity wave split
])
def test_differential_after_every_batch(n, d, k, bs, cap):
    g = _pool(SEED, n, d)
    tgt = g.sum(axis=0)
    m = _buffer(capacity=cap, d=d, target=tgt, k=k, compress=False,
                seed=SEED)
    jm = JBuffer(capacity=cap, d=d, target=jnp.asarray(tgt), k=k,
                 compress=False, seed=SEED)
    for lo in range(0, n, bs):
        hi = min(lo + bs, n)
        m.admit(g[lo:hi], gids=np.arange(lo, hi, dtype=np.int64))
        jm.admit(g[lo:hi], gids=np.arange(lo, hi, dtype=np.int64))
        what = f"n={n} k={k} bs={bs} cap={cap} @row{hi}"
        _assert_matches_scratch(m, what)
        _assert_matches_jax(m, jm, what)
    assert m.stats.admits == n
    if cap < n:
        assert m.stats.evicts > 0


def test_compressed_stream_matches_the_reference():
    """compress=True on both sides: the arena's bf16 bits, the pool view
    and the maintained solution are the reference's."""
    g = _pool(11, 80, 8)
    tgt = g.sum(axis=0)
    m = _feed(_buffer(capacity=24, d=8, target=tgt, k=8, compress=True,
                      seed=11), g, 10)
    jm = _feed(JBuffer(capacity=24, d=8, target=jnp.asarray(tgt), k=8,
                       compress=True, seed=11), g, 10)
    _assert_matches_jax(m, jm, "compressed")
    np.testing.assert_array_equal(
        m._rows_bf.view(torch.int16).numpy(),
        np.asarray(jm._rows_bf).view(np.int16))
    np.testing.assert_array_equal(m._pool.numpy(), np.asarray(jm._pool))
    np.testing.assert_array_equal(m.memory_bytes(), jm.memory_bytes())


def test_differential_vs_omp_select_smoke():
    g = _pool(3, 96, 16, dups=True)
    tgt = g.sum(axis=0)
    m = _feed(_buffer(capacity=40, d=16, target=tgt, k=12, compress=False,
                      seed=3), g, 16)
    pool, ok = m.pool_view()
    idx, w, mask, err = m.slot_result()
    i2, w2, m2, _ = omp.omp_select(pool, torch.from_numpy(tgt), 12,
                                   valid=ok)
    np.testing.assert_array_equal(idx.numpy(), i2.numpy())
    np.testing.assert_allclose(w.numpy(), w2.numpy(), rtol=2e-4, atol=2e-5)


def test_compressed_storage_still_exact():
    g = _pool(11, 80, 8)
    m = _feed(_buffer(capacity=24, d=8, target=g.sum(0), k=8, compress=True,
                      seed=11), g, 10)
    pool, ok = m.pool_view()
    assert torch.equal(pool, m._rows_bf.float())
    _assert_matches_scratch(m, "compressed")


def test_invalidated_rows_leave_the_solution():
    g = _pool(SEED + 1, 64, 8, dups=False)
    m = _feed(_buffer(capacity=32, d=8, target=g.sum(0), k=10,
                      compress=False, seed=SEED), g, 16)
    committed = [int(i) for i in m.result().indices.tolist() if i >= 0]
    dropped = committed[:3] + [9999]       # unknown gids are a no-op
    assert m.invalidate(dropped) == 3
    assert m.stats.downdates >= 3
    _assert_matches_scratch(m, "after invalidate")
    left = m.result().indices.numpy()
    assert not np.isin(left[left >= 0], committed[:3]).any()
    # non-committed invalidation is free (no replay rounds charged)
    rounds_before = m.stats.rounds
    spectator = [int(gid) for gid in m._gids[m._ok]
                 if int(gid) not in left[left >= 0]][:1]
    if spectator:
        m.invalidate(spectator)
        assert m.stats.rounds == rounds_before
        _assert_matches_scratch(m, "after free invalidate")


def test_capacity_covering_pool_matches_gradmatch():
    g = _pool(2, 72, 12, dups=False)
    ref = gradmatch(torch.from_numpy(g), 10)
    got = continual_select(torch.from_numpy(g), 10, batch=24)
    np.testing.assert_array_equal(got.indices.numpy(), ref.indices.numpy())
    np.testing.assert_allclose(got.weights.numpy(), ref.weights.numpy(),
                               rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# decremental OMP: downdate + truncate differentials
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["last", "middle", "first"])
def test_downdate_matches_scratch_on_surviving_rows(which):
    n, d, k = 96, 16, 12
    gn = _pool(5, n, d)
    g = torch.from_numpy(gn)
    tgt = g.sum(dim=0)
    sess = omp.omp_session_start(g, tgt, k)
    ind = sess.indices.numpy()
    pick = {"last": ind[k - 1], "middle": ind[k // 2], "first": ind[0]}[which]
    down, info = omp_downdate(g, sess, int(pick))
    assert info.replayed == {"last": 0, "middle": k - 1 - k // 2,
                             "first": k - 1}[which]
    assert info.resolved == (which == "first")
    assert torch.equal(sess.indices, torch.from_numpy(ind))  # left alone
    surviving = torch.ones((n,), dtype=torch.bool)
    surviving[int(pick)] = False
    ref = omp.omp_session_start(g, tgt, k - 1, valid=surviving)
    np.testing.assert_array_equal(down.indices.numpy(), ref.indices.numpy())
    np.testing.assert_allclose(down.weights.numpy(), ref.weights.numpy(),
                               rtol=2e-4, atol=2e-5)
    ext = omp.omp_session_extend(g, down, k)
    i2, w2, m2, _ = omp.omp_select(g, tgt, k, valid=surviving)
    np.testing.assert_array_equal(ext.indices.numpy(), i2.numpy())
    np.testing.assert_allclose(ext.weights.numpy(), w2.numpy(), rtol=2e-4,
                               atol=2e-5)
    # the reference's downdate of the same pick
    jsess = jomp.omp_session_start(jnp.asarray(gn), jnp.asarray(gn.sum(0)),
                                   k)
    jdown, jinfo = jdec.omp_downdate(jnp.asarray(gn), jsess, int(pick))
    assert tuple(info) == tuple(jinfo)
    np.testing.assert_array_equal(down.indices.numpy(),
                                  np.asarray(jdown.indices))
    np.testing.assert_allclose(down.weights.numpy(),
                               np.asarray(jdown.weights), rtol=1e-4,
                               atol=1e-5)


def test_downdate_rejects_non_committed():
    g = torch.from_numpy(_pool(6, 32, 8, dups=False))
    sess = omp.omp_session_start(g, g.sum(0), 4)
    loser = next(i for i in range(32) if i not in sess.indices.tolist())
    with pytest.raises(ValueError, match="not committed"):
        omp_downdate(g, sess, loser)


@pytest.mark.parametrize("t", [0, 1, 5, 9])
def test_truncate_matches_fresh_prefix(t):
    n, d, k = 64, 8, 9
    gn = _pool(8, n, d)
    g = torch.from_numpy(gn)
    tgt = g.sum(dim=0)
    sess = omp.omp_session_start(g, tgt, k)
    cut = session_truncate(sess, t)
    assert cut.k == t
    if t:
        fresh = omp.omp_session_start(g, tgt, t)
        np.testing.assert_array_equal(cut.indices.numpy(),
                                      fresh.indices.numpy())
        np.testing.assert_allclose(cut.weights.numpy(),
                                   fresh.weights.numpy(), rtol=2e-4,
                                   atol=2e-5)
        jcut = jdec.session_truncate(
            jomp.omp_session_start(jnp.asarray(gn), jnp.asarray(gn.sum(0)),
                                   k), t)
        np.testing.assert_allclose(cut.st.weights.numpy(),
                                   np.asarray(jcut.st.weights), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(cut.st.gram_absrow.numpy(),
                                   np.asarray(jcut.st.gram_absrow),
                                   rtol=1e-5)
    # re-extending recovers the original solve
    back = omp.omp_session_extend(g, cut, k)
    assert torch.equal(back.indices, sess.indices)


def test_traced_extend_matches_block_extend():
    n, d, k = 48, 8, 10
    gn = _pool(9, n, d)
    g = torch.from_numpy(gn)
    tgt = g.sum(dim=0)
    blocked = omp.omp_session_start(g, tgt, k)
    base = session_truncate(blocked, 0)
    traced, trace = session_extend_traced(g, base, k)
    assert torch.equal(traced.indices, blocked.indices)
    assert torch.equal(traced.st.weights, blocked.st.weights)
    assert torch.equal(traced.st.residual, blocked.st.residual)
    assert trace.resid.shape == (k, d) and trace.win.shape == (k,)
    assert np.isfinite(trace.win).all()
    assert base.k == 0 and int(base.st.mask.sum()) == 0   # left alone
    # the recorded winner gains dominate a zero newcomer (certified keep)
    assert certify_admission(np.zeros((3, d), np.float32), trace, k) == k
    # a newcomer equal to round 0's winner cannot be certified past it
    hot = gn[int(traced.indices[0])][None, :]
    assert certify_admission(hot, trace, k) == 0
    # the reference's trace of the same extension
    jblocked = jomp.omp_session_start(jnp.asarray(gn), jnp.asarray(
        gn.sum(0)), k)
    _, jtrace = jdec.session_extend_traced(
        jnp.asarray(gn), jdec.session_truncate(jblocked, 0), k)
    np.testing.assert_allclose(trace.resid, jtrace.resid, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(trace.win, jtrace.win, rtol=1e-4, atol=1e-5)


def test_certify_admission_sentinels():
    """+inf rounds (eps-stopped) always certify, -inf rounds (degenerate
    re-picks) never do, and no inf - inf reaches the comparison."""
    from repro_torch.core.decremental import ReplayTrace
    trace = ReplayTrace(resid=np.ones((3, 2), np.float32),
                        win=np.array([5.0, np.inf, -np.inf], np.float32))
    rows = np.zeros((1, 2), np.float32)
    assert certify_admission(rows, trace, 2) == 2
    assert certify_admission(rows, trace, 3) == 2
    with np.errstate(all="raise"):
        assert certify_admission(rows, trace, 3) == 2


# ---------------------------------------------------------------------------
# kill / resume
# ---------------------------------------------------------------------------

def test_kill_resume_bit_exact(tmp_path):
    n, d, k, bs, cap = 96, 8, 10, 8, 20
    g = _pool(SEED + 2, n, d)
    tgt = g.sum(axis=0)
    never_killed = _feed(_buffer(capacity=cap, d=d, target=tgt, k=k,
                                 compress=True, seed=SEED), g, bs)

    ckpt = str(tmp_path / "stream")
    m = _buffer(capacity=cap, d=d, target=tgt, k=k, compress=True,
                seed=SEED, checkpoint_dir=ckpt)
    kill_after = 5
    for i, lo in enumerate(range(0, n, bs)):
        if i == kill_after:
            break
        m.admit(g[lo:lo + bs], gids=np.arange(lo, lo + bs, dtype=np.int64))
    del m                                             # "killed" here

    res = BufferMaintainer.restore(ckpt, device=CPU)
    assert res is not None and res.batches == kill_after
    assert res.stats.resumes == 1
    for i, lo in enumerate(range(0, n, bs)):
        if i < kill_after:
            continue
        hi = min(lo + bs, n)
        res.admit(g[lo:hi], gids=np.arange(lo, hi, dtype=np.int64))

    for a, b in zip(never_killed.slot_result(), res.slot_result()):
        assert torch.equal(a, b)
    assert torch.equal(never_killed._pool, res._pool)
    np.testing.assert_array_equal(never_killed._gids, res._gids)
    np.testing.assert_array_equal(never_killed._trace.win, res._trace.win)
    np.testing.assert_array_equal(never_killed._trace.resid,
                                  res._trace.resid)


def test_jax_buffer_checkpoint_resumes_in_the_port(tmp_path):
    """A stream killed under the reference resumes in the port: the
    snapshot's format and keys are shared, and the resumed port buffer
    ends where the reference's never-killed one does."""
    n, d, k, bs, cap = 64, 8, 8, 8, 24
    g = _pool(SEED + 3, n, d)
    tgt = g.sum(axis=0)
    ckpt = str(tmp_path / "jax")
    jm = JBuffer(capacity=cap, d=d, target=jnp.asarray(tgt), k=k,
                 compress=True, seed=SEED, checkpoint_dir=ckpt)
    for lo in range(0, 32, bs):
        jm.admit(g[lo:lo + bs], gids=np.arange(lo, lo + bs, dtype=np.int64))
    res = BufferMaintainer.restore(ckpt, device=CPU)
    assert res.batches == 4 and res.stats.resumes == 1
    for lo in range(32, n, bs):
        res.admit(g[lo:lo + bs], gids=np.arange(lo, lo + bs, dtype=np.int64))
        jm.admit(g[lo:lo + bs], gids=np.arange(lo, lo + bs, dtype=np.int64))
    jm.stats.resumes = 1
    jm.stats.checkpoints = res.stats.checkpoints
    _assert_matches_jax(res, jm, "resumed from the reference's snapshot")


def test_restore_empty_dir_returns_none(tmp_path):
    assert BufferMaintainer.restore(str(tmp_path / "nothing"),
                                    device=CPU) is None


# ---------------------------------------------------------------------------
# counters and memory
# ---------------------------------------------------------------------------

def test_counters_surface_in_summary():
    s = SelectStats()
    assert "admits=" not in s.summary()       # quiet until continual runs
    s.admits, s.evicts, s.downdates, s.resolves = 40, 7, 3, 1
    assert "admits=40 evicts=7 downdates=3 resolves=1" in s.summary()
    assert "downdates=3" in str(StreamingPassBudgetError(2, s))


def test_maintainer_counters_account():
    g = _pool(13, 80, 8)
    m = _feed(_buffer(capacity=16, d=8, target=g.sum(0), k=10,
                      compress=False, seed=13), g, 10)
    assert m.stats.admits == 80
    assert m.stats.evicts >= 80 - 16          # everything beyond capacity
    assert m.stats.downdates > 0              # tight buffer forces them
    assert m.result().stats is m.stats
    assert "admits=80" in m.stats.summary()


def test_memory_stays_flat():
    g = _pool(17, 60, 8, dups=False)
    m = _buffer(capacity=12, d=8, target=g.sum(0), k=6, compress=True)
    sizes = []
    for lo in range(0, 60, 6):
        m.admit(g[lo:lo + 6])
        sizes.append(m.memory_bytes())
    assert len(set(sizes)) == 1, f"memory grew: {sizes}"


# ---------------------------------------------------------------------------
# selection.select dispatch + kwarg validation
# ---------------------------------------------------------------------------

def test_select_dispatch_continual():
    g = torch.from_numpy(_pool(1, 48, 8, dups=False))
    sel = sel_lib.select("gradmatch-continual", None, g, k=8, buffer_cap=24,
                         continual_batch=16)
    idx, msk = sel.indices.numpy(), sel.mask.numpy()
    assert ((idx[msk] >= 0) & (idx[msk] < 48)).all()
    assert abs(float(sel.weights[sel.mask].sum()) - 1.0) < 1e-4
    assert sel.stats is not None and sel.stats.evicts > 0
    assert sel_lib.NOT_PORTED == {}


@pytest.mark.parametrize("kw", [{"buffer_cap": 8}, {"continual_batch": 8}])
def test_select_rejects_continual_kwargs_elsewhere(kw):
    g = torch.from_numpy(_pool(1, 16, 4, dups=False))
    with pytest.raises(ValueError, match="gradmatch-continual"):
        sel_lib.select("gradmatch", None, g, k=4, **kw)


@pytest.mark.parametrize("kw", [{"buffer_cap": 0}, {"continual_batch": -1}])
def test_select_rejects_nonpositive_continual_kwargs(kw):
    g = torch.from_numpy(_pool(1, 16, 4, dups=False))
    with pytest.raises(ValueError, match="must be >= 1"):
        sel_lib.select("gradmatch-continual", None, g, k=4, **kw)


def test_select_rejects_unknown_strategy():
    g = torch.from_numpy(_pool(1, 16, 4, dups=False))
    with pytest.raises(ValueError, match="unknown strategy"):
        sel_lib.select("gradmatch-typo", None, g, k=4)

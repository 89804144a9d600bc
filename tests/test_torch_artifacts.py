"""The port's selection artifacts (``repro_torch/artifacts``) and the
store's disk faults against the JAX package's, on the CPU.

Inside the port, the reference's claims (``tests/test_artifacts.py``), each
proof mirrored: an artifact round-trips through disk bit-equal to the
port's anytime session engine at every ``k <= k_max`` and index-identical
to its ``omp_select``; under every disk fault kind and every crash stage a
read is a verified artifact or a miss, never a corrupt answer, and the
service then answers off the live path with the live path's bits;
mark-then-sweep GC never takes a referenced blob.

Across the packages the store format carries state: an artifact committed
by either package verifies and serves in the other, the keys and
fingerprints of one numpy pool (or a CPU tensor of it) are equal, and one
disk fault mutates the same bytes in twin stores.  A cross-package *hit*
needs the target's bytes to match, and each package's default target is
its own sum (the last bit may differ), so those cases pass the target.
Selections across packages meet the ROADMAP's standard: indices and masks
equal, weights and ``err`` to rtol 1e-4 / atol 1e-5.
"""

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import artifacts as jart  # noqa: E402
from repro.core import omp as jomp  # noqa: E402
from repro.resilience import inject_disk_fault as j_inject  # noqa: E402
from repro.serve import registry as jreg  # noqa: E402
from repro.serve.service import SelectionService as JService  # noqa: E402
from repro_torch.artifacts import (SCHEMA_VERSION, ArtifactStore,  # noqa
                                   artifact_key_for, build_artifact,
                                   content_digest_array, load_verified)
from repro_torch.artifacts.store import (CRASH_STAGES,  # noqa: E402
                                         manifest_self_sha)
from repro_torch.core.gradmatch import _normalize  # noqa: E402
from repro_torch.core.omp import (omp_select, omp_session_start,  # noqa
                                  session_result)
from repro_torch.resilience import (DISK_FAULT_KINDS,  # noqa: E402
                                    SimulatedCrash, crash_after,
                                    inject_disk_fault, store_manifest_size)
from repro_torch.serve import registry as treg  # noqa: E402
from repro_torch.serve.service import SelectionService  # noqa: E402

SEED = int(os.environ.get("FAULT_SEED", "7"))
N, D, K_MAX = 256, 24, 24
CPU = "cpu"


def _pool(seed=SEED, n=N, d=D):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _target(g):
    """The port's default target: its own sum of the pool."""
    return torch.from_numpy(g).sum(dim=0).numpy()


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_parity(got, want, what):
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]),
                                  err_msg=f"{what}: indices differ")
    np.testing.assert_array_equal(_np(got[2]), _np(want[2]),
                                  err_msg=f"{what}: masks differ")
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=1e-4,
                               atol=1e-5, err_msg=f"{what}: weights differ")
    np.testing.assert_allclose(float(_np(got[3])), float(_np(want[3])),
                               rtol=1e-4, atol=1e-5,
                               err_msg=f"{what}: err differs")


def _tree(root):
    """Every file under ``root``: relative path -> bytes."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture()
def store(tmp_path):
    return ArtifactStore(str(tmp_path / "store"))


@pytest.fixture()
def built(store):
    g = _pool()
    tgt = _target(g)
    key, ident = build_artifact(store, g, tgt, K_MAX, device=CPU)
    return store, g, tgt, key, ident


@pytest.fixture(scope="module")
def jax_sessions():
    """JAX's anytime session at every k of the shared pool (its picks and
    weights; the port's artifacts are held against them)."""
    g = _pool()
    tgt = _target(g)
    sess = jomp.omp_session_start(jnp.asarray(g), jnp.asarray(tgt), K_MAX)
    return g, tgt, {k: jomp.session_prefix_result(sess, k)[:3]
                    for k in range(1, K_MAX + 1)}, sess


# -- differential guarantee, inside the port -------------------------------

def test_roundtrip_bit_exact_at_every_k(built):
    store, g, tgt, key, _ = built
    art = store.get(key)
    assert art is not None and art.k_max == K_MAX
    gt, tt = torch.from_numpy(g), torch.from_numpy(tgt)
    for k in range(1, K_MAX + 1):
        idx, w, mask, err = art.slice(k)
        li, lw, lm, _ = omp_select(gt, tt, k)
        sess = omp_session_start(gt, tt, k)
        assert np.array_equal(idx, _np(li)), k
        assert np.array_equal(mask, _np(lm)), k
        assert np.array_equal(idx, _np(sess.indices)), k
        assert np.array_equal(w, _np(sess.weights)), k
        assert np.allclose(w, _np(lw), rtol=1e-4, atol=1e-5), k
        assert np.array_equal(err, np.float32(_np(sess.err))), k


def test_artifact_slices_match_jax_sessions(built, jax_sessions):
    store, g, tgt, key, _ = built
    jg, jtgt, jslices, jsess = jax_sessions
    assert np.array_equal(g, jg) and np.array_equal(tgt, jtgt)
    art = store.get(key)
    for k in (1, 5, K_MAX // 2, K_MAX):
        idx, w, mask, err = art.slice(k)
        ji, jw, jm = jslices[k]
        np.testing.assert_array_equal(idx, np.asarray(ji))
        np.testing.assert_array_equal(mask, np.asarray(jm))
    # the last slice against JAX's session at K_MAX, weights and err too
    _assert_parity(art.slice(K_MAX), jomp.session_result(jsess),
                   "port artifact vs JAX session")


def test_trajectory_rows_equal_fresh_starts(built):
    """The one-copy trajectory: every row is a fresh start at its k."""
    store, g, tgt, key, _ = built
    art = store.get(key)
    gt, tt = torch.from_numpy(g), torch.from_numpy(tgt)
    for k in (1, 7, K_MAX):
        sess = session_result(omp_session_start(gt, tt, k))
        got = art.slice(k)
        for a, b, name in zip(got, sess, ("indices", "weights", "mask",
                                          "err")):
            assert np.array_equal(np.asarray(a), _np(b)), (k, name)


def test_slice_bounds(built):
    store, _, _, key, _ = built
    art = store.get(key)
    for bad in (0, -1, K_MAX + 1):
        with pytest.raises(ValueError):
            art.slice(bad)


def test_key_isolation_full_content_digest(store):
    """The artifact key hashes every byte: two pools equal in the
    registry's sampled rows but apart in one unsampled element get
    distinct artifacts."""
    g1 = _pool()
    g2 = g1.copy()
    g2[1, 0] += 1.0          # row 1 is unsampled at 64-row stride over 256
    assert treg._fingerprint_array(g1) == treg._fingerprint_array(g2)
    assert content_digest_array(g1) != content_digest_array(g2)
    k1, _ = build_artifact(store, g1, _target(g1), 4, device=CPU)
    k2, _ = build_artifact(store, g2, _target(g2), 4, device=CPU)
    assert k1.ident() != k2.ident()
    a1, a2 = store.get(k1), store.get(k2)
    assert not np.array_equal(a1.arrays["weights_traj"],
                              a2.arrays["weights_traj"])


def test_key_sensitivity(built):
    store, g, tgt, _, _ = built
    assert store.get(artifact_key_for(g, tgt, 0.25, 1e-10, True)) is None
    assert store.get(artifact_key_for(g, tgt, 0.5, 1e-10, False)) is None
    assert store.get(
        artifact_key_for(g, tgt + np.float32(1), 0.5, 1e-10, True)) is None


# -- fail closed under disk faults -------------------------------------------

@pytest.mark.parametrize("kind", DISK_FAULT_KINDS)
def test_disk_fault_fail_closed(built, kind):
    store, g, tgt, key, ident = built
    info = inject_disk_fault(store, ident, kind, seed=SEED)
    assert info["kind"] == kind
    assert store.get(key) is None
    if kind != "kill-between-rename":        # manifest gone entirely
        assert not os.path.exists(store.manifest_path(ident))
    assert store.quarantined == (0 if kind == "kill-between-rename" else 1)
    # the store stays usable: a rebuild recommits and serves again
    key2, ident2 = build_artifact(store, g, tgt, K_MAX, device=CPU)
    assert ident2 == ident
    art = store.get(key2)
    assert art is not None
    idx, w, _, _ = art.slice(K_MAX)
    sess = omp_session_start(torch.from_numpy(g), torch.from_numpy(tgt),
                             K_MAX)
    assert np.array_equal(idx, _np(sess.indices))
    assert np.array_equal(w, _np(sess.weights))


@pytest.mark.parametrize("kind", DISK_FAULT_KINDS)
def test_disk_fault_deterministic(built, kind):
    """Same (seed, kind, ident), same mutation; a recommit heals the
    store in between (put verifies resident blobs)."""
    store, g, tgt, _, ident = built
    a = inject_disk_fault(store, ident, kind, seed=SEED)
    build_artifact(store, g, tgt, K_MAX, device=CPU)
    b = inject_disk_fault(store, ident, kind, seed=SEED)
    assert a == b


def test_disk_fault_unknown_kind(built):
    store, _, _, _, ident = built
    with pytest.raises(ValueError, match="unknown disk fault"):
        inject_disk_fault(store, ident, "cosmic-ray")
    assert store_manifest_size(store, ident) == os.path.getsize(
        store.manifest_path(ident))


@pytest.mark.parametrize("stage", ["pre-blob", "between-rename"])
def test_crash_during_put_not_servable(store, stage):
    g = _pool()
    tgt = _target(g)
    with pytest.raises(SimulatedCrash):
        build_artifact(store, g, tgt, 6, crash=crash_after(stage),
                       device=CPU)
    key = artifact_key_for(g, tgt, 0.5, 1e-10, True)
    assert store.get(key) is None            # miss, not corruption
    key2, _ = build_artifact(store, g, tgt, 6, device=CPU)
    assert store.get(key2) is not None


def test_crash_post_commit_is_servable(store):
    g = _pool()
    tgt = _target(g)
    assert CRASH_STAGES[-1] == "post-commit"
    with pytest.raises(SimulatedCrash):
        build_artifact(store, g, tgt, 6, crash=crash_after("post-commit"),
                       device=CPU)
    art = store.get(artifact_key_for(g, tgt, 0.5, 1e-10, True))
    assert art is not None and art.k_max == 6


def test_stale_version_quarantined_on_read(built):
    store, _, _, key, ident = built
    inject_disk_fault(store, ident, "stale-version", seed=SEED)
    with open(store.manifest_path(ident)) as f:
        assert json.load(f)["schema"] != SCHEMA_VERSION
    assert store.get(key) is None
    assert os.path.exists(os.path.join(store.quarantine_dir,
                                       f"{ident}.json"))
    with open(os.path.join(store.quarantine_dir, f"{ident}.reason")) as f:
        assert "schema" in f.read()


def test_tampered_manifest_field_rejected(built):
    store, _, _, key, ident = built
    path = store.manifest_path(ident)
    with open(path) as f:
        man = json.load(f)
    man["meta"]["k_max"] = 999
    with open(path, "w") as f:
        json.dump(man, f, sort_keys=True)
    assert store.get(key) is None
    assert store.quarantined == 1


def test_norm_sidecar_catches_value_swap(built):
    store, _, _, key, ident = built
    path = store.manifest_path(ident)
    with open(path) as f:
        man = json.load(f)
    a, b = man["blobs"]["indices"], man["blobs"]["err_trace"]
    man["blobs"]["indices"], man["blobs"]["err_trace"] = b, a
    man["manifest_sha"] = manifest_self_sha(man)
    with open(path, "w") as f:
        json.dump(man, f, sort_keys=True)
    assert store.get(key) is None
    assert store.quarantined == 1


def test_clean_miss_has_no_side_effects(store):
    g = _pool()
    assert load_verified(store, artifact_key_for(g, _target(g), 0.5, 1e-10,
                                                 True)) is None
    assert store.quarantined == 0 and store.loads == 0


# -- GC safety ----------------------------------------------------------------

def test_gc_never_collects_referenced_blobs(built):
    store, _, _, key, _ = built
    assert store.gc(grace_s=0.0)["objects_swept"] == 0
    assert store.get(key) is not None


def test_gc_sweeps_orphans_after_grace(built):
    store, _, _, key, _ = built
    g2 = _pool(SEED + 1)
    with pytest.raises(SimulatedCrash):
        build_artifact(store, g2, _target(g2), 4,
                       crash=crash_after("between-rename"), device=CPU)
    assert store.gc(grace_s=3600.0)["objects_swept"] == 0
    rep = store.gc(grace_s=0.0)
    assert rep["objects_swept"] > 0 and rep["tmp_swept"] >= 1
    assert store.get(key) is not None


def test_gc_ignores_unparseable_manifest(built):
    store, _, _, key, ident = built
    inject_disk_fault(store, ident, "truncated-manifest", seed=SEED)
    assert store.gc(grace_s=3600.0)["marked"] == 0
    assert store.get(key) is None


# -- serve integration --------------------------------------------------------

def _service(tmp_path, g):
    svc = SelectionService(artifact_store=str(tmp_path / "store"),
                           device=CPU)
    return svc, svc.register_pool(g)


def _live(g, k):
    live = SelectionService(device=CPU)
    t = live.submit(live.register_pool(g), k)
    live.drain()
    assert t.status == "done" and t.degradation != "artifact"
    return t


def test_serve_hit_bit_equal_live_session(tmp_path):
    """Artifact tickets against the live session at the same k, bit for
    bit (indices, mask, normalized weights, err), and against the live
    queued path (the batched solver) index for index."""
    g = _pool()
    svc, pid = _service(tmp_path, g)
    entry = svc.registry.get(pid)
    build_artifact(svc.artifacts, entry.grads, entry.target_sum, K_MAX,
                   fingerprint=entry.content_digest)
    for k in (1, K_MAX // 2, K_MAX):
        t = svc.submit(pid, k)
        assert t.status == "done" and t.degradation == "artifact"
        sess = omp_session_start(entry.grads, entry.target_sum, k)
        assert torch.equal(t.result.indices, sess.indices)
        assert torch.equal(t.result.mask, sess.mask)
        assert torch.equal(t.result.weights,
                           _normalize(sess.weights, sess.mask))
        assert torch.equal(t.result.err, sess.err)
        lt = _live(g, k)
        assert torch.equal(t.result.indices, lt.result.indices)
        assert torch.allclose(t.result.weights, lt.result.weights,
                              rtol=1e-6, atol=1e-7)
    st = svc.stats()
    assert st["registry"]["artifact_hits"] == 3
    assert st["artifacts"]["loads"] == 1     # memoized after the first hit
    c = svc.scheduler.counters
    assert c["admitted"] == c["completed"] == 3
    assert svc.scheduler.degraded_served == {"artifact": 3}


def test_serve_miss_falls_through_live(tmp_path):
    g = _pool()
    svc, pid = _service(tmp_path, g)
    entry = svc.registry.get(pid)
    build_artifact(svc.artifacts, entry.grads, entry.target_sum, 8,
                   fingerprint=entry.content_digest)
    t = svc.submit(pid, 12)                  # beyond coverage
    assert t in svc.drain() and t.degradation != "artifact"
    t2 = svc.submit(pid, 4, target=_np(entry.target_sum) + np.float32(1))
    svc.drain()
    assert t2.status == "done" and t2.degradation != "artifact"
    t3 = svc.submit(pid, 8)
    assert t3.degradation == "artifact"
    c = svc.scheduler.counters
    assert c["admitted"] == (c["completed"] + c["shed"] + c["failed"]
                             + svc.scheduler.pending())
    assert svc.registry.stats()["artifact_misses"] == 2


@pytest.mark.parametrize("kind", DISK_FAULT_KINDS)
def test_serve_fault_falls_through_never_corrupt(tmp_path, kind):
    """Under any disk fault the service answers off the live path with
    the bits a fault-free live solve produces."""
    g = _pool()
    svc, pid = _service(tmp_path, g)
    entry = svc.registry.get(pid)
    _, ident = build_artifact(svc.artifacts, entry.grads, entry.target_sum,
                              K_MAX, fingerprint=entry.content_digest)
    inject_disk_fault(svc.artifacts, ident, kind, seed=SEED)
    t = svc.submit(pid, K_MAX)
    if t.status != "done":
        svc.drain()
    assert t.status == "done" and t.degradation != "artifact"
    lt = _live(g, K_MAX)
    for a, b in zip(t.result[:4], lt.result[:4]):
        assert torch.equal(a, b)
    st = svc.stats()["registry"]
    assert st["artifact_hits"] == 0
    assert st["artifact_quarantined"] == (
        0 if kind == "kill-between-rename" else 1)


def test_chunked_pools_have_no_artifact_path(tmp_path):
    from repro_torch.data.loader import ChunkedPool
    g = _pool(n=128, d=8)
    svc = SelectionService(artifact_store=str(tmp_path / "store"),
                           device=CPU)
    pid = svc.register_chunked_pool(ChunkedPool(g, chunk_size=32))
    assert svc.registry.get(pid).content_digest is None
    t = svc.submit(pid, 8)
    svc.drain()
    assert t.status == "done" and t.degradation != "artifact"


# -- across the packages ------------------------------------------------------

@pytest.mark.parametrize("with_valid", [False, True])
def test_digests_and_keys_equal_across_packages(with_valid):
    """One numpy pool (and a CPU tensor of it): the same full-content
    digest, artifact ident, sampled fingerprint and registry entry keys
    in both packages."""
    g = _pool()
    valid = (np.arange(N) % 3 != 0) if with_valid else None
    tgt = _target(g)
    want = jart.content_digest_array(g, valid)
    for pool in (g, torch.from_numpy(g)):
        v = None if valid is None else (
            torch.from_numpy(valid) if isinstance(pool, torch.Tensor)
            else valid)
        assert content_digest_array(pool, v) == want
        assert (artifact_key_for(pool, tgt, 0.5, 1e-10, True, valid=v)
                .ident() == jart.artifact_key_for(
                    g, tgt, 0.5, 1e-10, True, valid=valid).ident())
        assert treg._fold_valid(treg._fingerprint_array(pool), v) == \
            jreg._fold_valid(jreg._fingerprint_array(g), valid)
    assert jart.target_sha256(tgt) == jart.target_sha256(
        torch.from_numpy(tgt).numpy())
    jr = jreg.PoolRegistry()
    tr = treg.PoolRegistry(device=CPU)
    je = jr.get(jr.register(g, valid=valid))
    te = tr.get(tr.register(torch.from_numpy(g), valid=valid))
    assert (te.pool_id, te.fingerprint, te.content_digest) == (
        je.pool_id, je.fingerprint, je.content_digest)


def test_jax_artifact_verifies_and_serves_in_the_port(tmp_path,
                                                      jax_sessions):
    g, tgt, _, jsess = jax_sessions
    root = str(tmp_path / "store")
    key, ident = jart.build_artifact(jart.ArtifactStore(root), g, tgt, K_MAX)
    store = ArtifactStore(root)
    art = store.get(artifact_key_for(g, tgt, 0.5, 1e-10, True))
    assert art is not None and art.key.ident() == ident
    # served by the port's service (the target passed: its default is the
    # port's own sum)
    svc = SelectionService(artifact_store=store, device=CPU)
    pid = svc.register_pool(g)
    gt, tt = torch.from_numpy(g), torch.from_numpy(tgt)
    for k in (1, K_MAX // 2, K_MAX):
        t = svc.submit(pid, k, target=tgt)
        assert t.status == "done" and t.degradation == "artifact"
        want = omp_session_start(gt, tt, k)
        _assert_parity((t.result.indices, t.result.weights, t.result.mask,
                        t.result.err),
                       (want.indices, _normalize(want.weights, want.mask),
                        want.mask, want.err), f"JAX artifact at k {k}")
    assert store.quarantined == 0 and svc.registry.art_hits == 3


def test_port_artifact_passes_jax_load_verified(tmp_path, jax_sessions):
    g, tgt, jslices, jsess = jax_sessions
    root = str(tmp_path / "store")
    key, ident = build_artifact(ArtifactStore(root), g, tgt, K_MAX,
                                device=CPU)
    jstore = jart.ArtifactStore(root)
    jkey = jart.artifact_key_for(g, tgt, 0.5, 1e-10, True)
    assert jkey.ident() == ident
    art = jart.load_verified(jstore, jkey)
    assert art is not None and jstore.quarantined == 0
    for k in range(1, K_MAX + 1):
        idx, w, mask, err = art.slice(k)
        ji, jw, jm = jslices[k]
        np.testing.assert_array_equal(idx, np.asarray(ji))
        np.testing.assert_array_equal(mask, np.asarray(jm))
    _assert_parity(art.slice(K_MAX), jomp.session_result(jsess),
                   "port artifact in JAX's reader")
    # and JAX's service serves it
    jsvc = JService(artifact_store=jstore)
    t = jsvc.submit(jsvc.register_pool(g), K_MAX // 2, target=tgt)
    assert t.status == "done" and t.degradation == "artifact"


@pytest.mark.parametrize("kind", DISK_FAULT_KINDS)
def test_disk_fault_same_bytes_in_twin_stores(tmp_path, kind):
    """Twin stores (one committed artifact, copied): each package's fault
    at the same seed returns the same description and leaves the same
    files, byte for byte; both readers then refuse it."""
    g = _pool()
    tgt = _target(g)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    key, ident = build_artifact(ArtifactStore(a), g, tgt, K_MAX, device=CPU)
    shutil.copytree(a, b)
    ta, jb = ArtifactStore(a), jart.ArtifactStore(b)
    assert inject_disk_fault(ta, ident, kind, seed=SEED) == j_inject(
        jb, ident, kind, seed=SEED)
    assert _tree(a) == _tree(b)
    assert ta.get(key) is None
    assert jart.load_verified(jb, jart.artifact_key_for(
        g, tgt, 0.5, 1e-10, True)) is None
    assert _tree(a) == _tree(b)              # quarantined alike

"""Fail-closed artifact verification (the read half of the store), after
``repro/artifacts/verify.py``: the same checks in the same order, and a
failure quarantines exactly where the reference quarantines.

Nothing read off disk is trusted until it has survived every check below;
anything that fails any check is **quarantined** (moved out of the
servable namespace with a recorded reason) and reported as a miss, so
the caller falls through the degradation ladder to the live
certified solver.  A stale-but-valid artifact is a correct answer; a
corrupt one is silently wrong — so the bias is always toward rejecting.

Check order on load (each failure names the fault kind it catches):

1. manifest parses as JSON                 — torn/truncated manifest
2. ``manifest_sha`` self-checksum matches  — in-place edit, bit-flip in
                                             the manifest itself
3. ``schema == SCHEMA_VERSION``            — version skew (an old reader
                                             must not guess at a new
                                             layout, and vice versa)
4. key fields round-trip                   — manifest filed under the
                                             wrong ident
5. required blobs present with coherent
   shapes (k_max/n/d cross-checks)         — build bugs, partial puts
6. per blob: byte count, SHA-256 over the
   raw bytes, dtype/shape decode           — bit rot, torn blob writes,
                                             kill-between-rename (blob
                                             file missing entirely)
7. per blob: f64 norm sidecar matches      — semantic cross-check (a
                                             hash collision or a check
                                             ordering bug still cannot
                                             serve wrong magnitudes)
8. trajectory invariants: indices valid in
   [0, n) where masked, weights_traj lower
   -triangular, err_trace finite           — a *valid-looking* artifact
                                             that would still poison the
                                             solver contract
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from repro_torch.artifacts.store import (
    SCHEMA_VERSION,
    ArtifactKey,
    ArtifactStore,
    SelectionArtifact,
    _norm_sidecar,
    manifest_self_sha,
)

import hashlib

# Blobs every selection artifact must carry (name -> expected dtype).
REQUIRED_BLOBS = {
    "indices": "int32",
    "mask": "bool",
    "weights_traj": "float32",
    "err_trace": "float32",
    "target": "float32",
}

# Norm sidecars are f64 recomputed from the exact bytes read back, so
# agreement is near-exact; the tolerance only absorbs the JSON float
# round-trip (IEEE doubles survive json exactly, but keep a belt).
_NORM_RTOL = 1e-12


class VerifyError(Exception):
    """One named reason an artifact failed verification."""


def _fail(reason: str) -> None:
    raise VerifyError(reason)


def read_manifest(store: ArtifactStore, ident: str) -> dict:
    """Parse + self-check + schema-check one manifest (checks 1-3)."""
    path = store.manifest_path(ident)
    try:
        with open(path) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        _fail(f"manifest-unreadable: {e.__class__.__name__}")
    if not isinstance(manifest, dict):
        _fail("manifest-not-an-object")
    recorded = manifest.get("manifest_sha")
    if recorded != manifest_self_sha(manifest):
        _fail("manifest-self-checksum-mismatch")
    schema = manifest.get("schema")
    if schema != SCHEMA_VERSION:
        _fail(f"schema-version-skew: artifact={schema!r} "
              f"reader={SCHEMA_VERSION}")
    return manifest


def _verify_blob(store: ArtifactStore, name: str, spec: dict) -> np.ndarray:
    """Checks 6-7 for one blob: bytes exist, hash, decode, norm."""
    digest = spec.get("sha256")
    if not isinstance(digest, str) or len(digest) != 64:
        _fail(f"blob-{name}: malformed digest")
    path = store.object_path(digest)
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        _fail(f"blob-{name}: object missing ({digest[:12]})")
    if len(raw) != int(spec.get("nbytes", -1)):
        _fail(f"blob-{name}: size {len(raw)} != recorded "
              f"{spec.get('nbytes')}")
    if hashlib.sha256(raw).hexdigest() != digest:
        _fail(f"blob-{name}: sha256 mismatch")
    try:
        dtype = np.dtype(spec["dtype"])
        shape = tuple(int(s) for s in spec["shape"])
        arr = np.frombuffer(raw, dtype=dtype).reshape(shape)
    except (KeyError, TypeError, ValueError) as e:
        _fail(f"blob-{name}: undecodable ({e})")
    norm = _norm_sidecar(arr)
    recorded = spec.get("norm")
    if not isinstance(recorded, (int, float)) or not np.isclose(
            norm, float(recorded), rtol=_NORM_RTOL, atol=0.0):
        _fail(f"blob-{name}: norm sidecar mismatch "
              f"({norm!r} != {recorded!r})")
    return arr


def verify_manifest(store: ArtifactStore, key: ArtifactKey,
                    manifest: dict) -> SelectionArtifact:
    """Checks 4-8: key round-trip, blob set, blob integrity, semantics.

    Raises VerifyError on the first failure; returns the fully-verified
    in-memory artifact otherwise.
    """
    mkey = manifest.get("key", {})
    if (mkey.get("fingerprint") != key.fingerprint
            or mkey.get("target_sha") != key.target_sha
            or float(mkey.get("lam", np.nan)) != float(key.lam)
            or float(mkey.get("eps", np.nan)) != float(key.eps)
            or bool(mkey.get("positive")) != bool(key.positive)):
        _fail("key-mismatch: manifest filed under wrong ident")

    meta = manifest.get("meta", {})
    try:
        n, d, k_max = int(meta["n"]), int(meta["d"]), int(meta["k_max"])
    except (KeyError, TypeError, ValueError):
        _fail("meta-missing-dims")
    if k_max < 1 or n < 1 or d < 1:
        _fail(f"meta-bad-dims: n={n} d={d} k_max={k_max}")

    blobs = manifest.get("blobs", {})
    missing = sorted(set(REQUIRED_BLOBS) - set(blobs))
    if missing:
        _fail(f"blobs-missing: {missing}")

    arrays: dict[str, np.ndarray] = {}
    for name in sorted(blobs):
        arr = _verify_blob(store, name, blobs[name])
        want = REQUIRED_BLOBS.get(name)
        if want is not None and str(arr.dtype) != want:
            _fail(f"blob-{name}: dtype {arr.dtype} != {want}")
        arrays[name] = arr

    expect = {"indices": (k_max,), "mask": (k_max,),
              "weights_traj": (k_max, k_max), "err_trace": (k_max,),
              "target": (d,)}
    for name, shape in expect.items():
        if arrays[name].shape != shape:
            _fail(f"blob-{name}: shape {arrays[name].shape} != {shape}")

    # Check 8: semantic invariants of a trajectory (a byte-perfect blob
    # can still be a build bug; refuse to serve it).
    idx, mask = arrays["indices"], arrays["mask"]
    if ((mask & ((idx < 0) | (idx >= n))).any()
            or (~mask & (idx != -1)).any()):
        _fail("trajectory-invalid-indices")
    wt = arrays["weights_traj"]
    if np.any(wt[np.triu_indices(k_max, k=1)] != 0.0):
        _fail("trajectory-weights-not-lower-triangular")
    if not np.all(np.isfinite(wt)) or not np.all(
            np.isfinite(arrays["err_trace"])):
        _fail("trajectory-nonfinite")

    return SelectionArtifact(key, meta, arrays)


def load_verified(store: ArtifactStore,
                  key: ArtifactKey) -> Optional[SelectionArtifact]:
    """The store's read path: verified artifact, or None (miss).

    A clean miss (no manifest on disk) returns None without side
    effects.  *Any* verification failure quarantines the manifest — the
    artifact becomes a durable miss and the reason is kept as evidence —
    then returns None.  Either way the caller must fall through to the
    live solver; there is no partially-trusted result.
    """
    ident = key.ident()
    if not os.path.exists(store.manifest_path(ident)):
        return None
    try:
        manifest = read_manifest(store, ident)
        art = verify_manifest(store, key, manifest)
    except FileNotFoundError:
        return None          # raced a concurrent quarantine: plain miss
    except VerifyError as e:
        store.quarantine(ident, str(e))
        return None
    store.loads += 1
    return art

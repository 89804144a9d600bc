"""Durable content-addressed store for offline selection artifacts, after
``repro/artifacts/store.py``, whose on-disk format it keeps byte for byte
(an artifact committed by either package verifies and serves in the
other).

Keys hash host bytes: ``content_digest_array`` and ``target_sha256`` take
a numpy array or a tensor, and a tensor is copied to the host as f32
numpy once before hashing (``repr`` of a torch dtype is not numpy's, so
hashing the tensor itself would give another key).

The MILO-style fast path (DESIGN.md §12): GRAD-MATCH solves the
same gradient-matching OMP problem repeatedly over hot pools, so a full
anytime-OMP *trajectory* to ``k_max`` is precomputed once per
(pool-content, λ, ε, positive, target) tuple and any budget ``k <=
k_max`` is answered in O(1) by slicing it.  That fast path is only
shippable if the persistence layer is robust — a disk artifact must
survive kill-during-write, bit rot and version skew, and the serve tier
must be able to *trust or provably reject* what it reads (fail closed to
the live certified solver).  This module is the write half; the read/
verify half lives in ``verify.py``.

Layout under one store root::

    root/
      objects/<aa>/<sha256-hex>     content-addressed blobs (raw array
                                    bytes; <aa> = first two hex chars)
      manifests/<ident>.json        one manifest per artifact, named by
                                    the key's identity hash
      quarantine/<ident>.json       manifests the verifier rejected
      tmp/<pid>-<token>/            staging for in-flight commits

Integrity discipline (the ChunkCache checksum idea, applied to disk):

* every blob is referenced from the manifest by **SHA-256 + byte count +
  dtype/shape + an f64 norm sidecar** — the hash catches bit rot and
  torn writes, the norm is the semantic cross-check (a blob that hashes
  correctly but decodes to the wrong magnitudes is still rejected);
* the manifest carries an explicit ``schema`` version and a
  **self-checksum** (``manifest_sha`` over the canonical JSON of every
  other field), so truncation and in-place edits are detectable without
  trusting any field being checked;
* commits are **atomic**: blobs are staged in ``tmp/``, fsynced, renamed
  into ``objects/`` one at a time, and only then is the manifest fsynced
  and renamed into place.  A kill at any byte leaves either the previous
  state or a complete new artifact — never a manifest that references a
  partial blob.  (A kill *between* the blob renames and the manifest
  rename leaves orphaned objects; see GC.)

GC is **mark-then-sweep** and crash-safe by construction: mark = every
digest referenced by a parseable manifest; sweep = unreferenced objects
older than ``grace_s`` plus all stale ``tmp/`` dirs.  GC never touches
manifests, so a crash mid-sweep only leaves garbage that the next sweep
collects — it can never un-commit an artifact.  ``grace_s`` exists
because a concurrent ``put`` renames its blobs before its manifest: a
sweep racing it must not collect blobs younger than the grace window.

``ArtifactStore.put`` accepts a ``crash`` hook (see
``resilience.faults.crash_after``) that raises at named commit stages —
the kill-during-write adversary the fault suite drives.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import uuid
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

SCHEMA_VERSION = 1

# Named stages the ``crash`` hook is called at, in commit order.  A hook
# that raises at "between-rename" leaves committed blobs with no
# manifest — exactly the kill-between-rename fault the GC must sweep.
CRASH_STAGES = ("pre-blob", "between-rename", "post-commit")


def host_array(x, dtype=np.float32) -> np.ndarray:
    """A C-contiguous numpy copy of ``x`` (a tensor on any device is
    copied to the host once)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x, dtype))


def array_sha256(x: np.ndarray) -> str:
    """Content digest of one array's raw bytes (C-contiguous)."""
    return hashlib.sha256(
        np.ascontiguousarray(x).tobytes()).hexdigest()


def _norm_sidecar(x: np.ndarray) -> float:
    """f64 L2 norm of the array's values — the ChunkCache-style semantic
    checksum recorded next to the byte hash.  Deterministic for a given
    byte string, so the verifier can require exact agreement."""
    return float(np.linalg.norm(
        np.ascontiguousarray(x).astype(np.float64).reshape(-1)))


def _canonical(obj) -> bytes:
    return json.dumps(obj, sort_keys=True,
                      separators=(",", ":")).encode()


def manifest_self_sha(manifest: dict) -> str:
    """Self-checksum over every manifest field except ``manifest_sha``."""
    body = {k: v for k, v in manifest.items() if k != "manifest_sha"}
    return hashlib.sha256(_canonical(body)).hexdigest()


def content_digest_array(x, valid=None) -> str:
    """Full-content pool digest: SHA-256 over shape, dtype, every row's
    raw f32 bytes, and the validity mask.  This is the *artifact key*
    fingerprint — unlike the registry's 64-row sampled fingerprint (an
    in-memory dedupe heuristic), two pools differing in any single
    element can never collide here, so an artifact can never be served
    for the wrong pool."""
    arr = host_array(x)
    h = hashlib.sha256()
    h.update(repr((arr.shape, str(arr.dtype))).encode())
    h.update(arr.tobytes())
    if valid is not None:
        v = host_array(valid, bool)
        h.update(b"|valid|")
        h.update(v.tobytes())
    return h.hexdigest()


@dataclass(frozen=True)
class ArtifactKey:
    """What one selection artifact answers for: a pool's *full-content*
    digest (``content_digest_array`` above — the registry's sampled
    fingerprint is a dedupe key, never an artifact key), the solve
    parameters, and the target vector's digest."""

    fingerprint: str          # full-content pool digest (sha256 hex)
    lam: float
    eps: float
    positive: bool
    target_sha: str           # sha256 hex of the f32 target bytes

    def ident(self) -> str:
        return hashlib.sha256(_canonical(
            [self.fingerprint, float(self.lam), float(self.eps),
             bool(self.positive), self.target_sha])).hexdigest()[:32]


def target_sha256(target) -> str:
    return array_sha256(host_array(target))


class SelectionArtifact:
    """A *verified* artifact resident in memory: the anytime trajectory
    to ``k_max`` plus its per-round weight/residual traces.  ``slice``
    answers any budget ``k <= k_max`` in O(k) copies — the serve tier's
    O(1)-per-request fast path (no pool scan, no solve)."""

    def __init__(self, key: ArtifactKey, meta: dict,
                 arrays: dict[str, np.ndarray]):
        self.key = key
        self.meta = dict(meta)
        self.arrays = arrays

    @property
    def k_max(self) -> int:
        return int(self.meta["k_max"])

    @property
    def n(self) -> int:
        return int(self.meta["n"])

    @property
    def d(self) -> int:
        return int(self.meta["d"])

    def slice(self, k: int) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.floating]:
        """(indices (k,), weights (k,), mask (k,), err ()) at budget
        ``k`` — bit-identical to what the anytime session engine reports
        after round ``k`` (and index-identical to a one-shot
        ``omp_select(k)``; see DESIGN.md §12)."""
        k = int(k)
        if not 1 <= k <= self.k_max:
            raise ValueError(
                f"artifact covers 1 <= k <= {self.k_max}, asked {k}")
        return (self.arrays["indices"][:k],
                self.arrays["weights_traj"][k - 1, :k],
                self.arrays["mask"][:k],
                self.arrays["err_trace"][k - 1])


class ArtifactStore:
    """Content-addressed, crash-safe artifact persistence (module doc)."""

    def __init__(self, root: str):
        self.root = str(root)
        self.objects_dir = os.path.join(self.root, "objects")
        self.manifests_dir = os.path.join(self.root, "manifests")
        self.quarantine_dir = os.path.join(self.root, "quarantine")
        self.tmp_dir = os.path.join(self.root, "tmp")
        for p in (self.objects_dir, self.manifests_dir,
                  self.quarantine_dir, self.tmp_dir):
            os.makedirs(p, exist_ok=True)
        self.puts = 0
        self.loads = 0
        self.quarantined = 0
        self.gc_objects_swept = 0
        self.gc_tmp_swept = 0

    # -- paths ---------------------------------------------------------------
    def object_path(self, digest: str) -> str:
        return os.path.join(self.objects_dir, digest[:2], digest)

    def manifest_path(self, ident: str) -> str:
        return os.path.join(self.manifests_dir, f"{ident}.json")

    def has(self, key: ArtifactKey) -> bool:
        return os.path.exists(self.manifest_path(key.ident()))

    def idents(self) -> list[str]:
        return sorted(f[:-5] for f in os.listdir(self.manifests_dir)
                      if f.endswith(".json"))

    # -- commit --------------------------------------------------------------
    def put(self, key: ArtifactKey, arrays: dict[str, np.ndarray],
            meta: dict,
            crash: Optional[Callable[[str], None]] = None) -> str:
        """Atomically commit one artifact; returns its manifest ident.

        Stage order (and the ``crash`` hook's stage names): every blob is
        written to ``tmp/``, fsynced, renamed into ``objects/``
        (``crash("pre-blob")`` before the first write,
        ``crash("between-rename")`` after the last blob rename); then the
        manifest is written to ``tmp/``, fsynced, and renamed into
        ``manifests/`` (``crash("post-commit")`` after).  Re-putting an
        existing ident atomically replaces the manifest — blobs are
        content-addressed, so identical payload bytes are shared, and a
        changed payload's old blobs become garbage for the next sweep.
        """
        ident = key.ident()
        stage = os.path.join(self.tmp_dir,
                             f"{os.getpid()}-{uuid.uuid4().hex[:12]}")
        os.makedirs(stage)
        try:
            if crash is not None:
                crash("pre-blob")
            blobs = {}
            for name in sorted(arrays):
                arr = np.ascontiguousarray(arrays[name])
                raw = arr.tobytes()
                digest = hashlib.sha256(raw).hexdigest()
                blobs[name] = {
                    "sha256": digest,
                    "nbytes": len(raw),
                    "dtype": str(arr.dtype),
                    "shape": list(arr.shape),
                    "norm": _norm_sidecar(arr),
                }
                final = self.object_path(digest)
                # Dedupe on collision — but never *trust* it: a resident
                # file at this path whose bytes no longer hash to its
                # name (bit rot, torn write) would make the recommit a
                # reference to corruption.  Verify, and heal in place
                # with an atomic replace if the bytes disagree.
                resident_ok = False
                if os.path.exists(final):
                    try:
                        with open(final, "rb") as f:
                            resident_ok = (hashlib.sha256(
                                f.read()).hexdigest() == digest)
                    except OSError:
                        resident_ok = False
                if not resident_ok:
                    os.makedirs(os.path.dirname(final), exist_ok=True)
                    tmp_blob = os.path.join(stage, f"blob-{name}")
                    with open(tmp_blob, "wb") as f:
                        f.write(raw)
                        f.flush()
                        os.fsync(f.fileno())
                    os.replace(tmp_blob, final)
            if crash is not None:
                crash("between-rename")
            manifest = {
                "schema": SCHEMA_VERSION,
                "key": {"fingerprint": key.fingerprint,
                        "lam": float(key.lam), "eps": float(key.eps),
                        "positive": bool(key.positive),
                        "target_sha": key.target_sha},
                "meta": dict(meta),
                "blobs": blobs,
            }
            manifest["manifest_sha"] = manifest_self_sha(manifest)
            tmp_man = os.path.join(stage, "manifest.json")
            with open(tmp_man, "w") as f:
                json.dump(manifest, f, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp_man, self.manifest_path(ident))
            self._fsync_dir(self.manifests_dir)
            if crash is not None:
                crash("post-commit")
        finally:
            # Only the happy path cleans its staging dir: after a crash
            # hook fired, the partial state is exactly what the fault
            # suite wants on disk (GC sweeps it later).
            if crash is None:
                shutil.rmtree(stage, ignore_errors=True)
        self.puts += 1
        return ident

    @staticmethod
    def _fsync_dir(path: str) -> None:
        try:
            fd = os.open(path, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    # -- read (delegates to verify.py) ---------------------------------------
    def get(self, key: ArtifactKey) -> Optional[SelectionArtifact]:
        """Verified artifact for ``key``, or None (miss *or* quarantined
        — either way the caller falls through to the live solver)."""
        from repro_torch.artifacts.verify import load_verified
        return load_verified(self, key)

    def quarantine(self, ident: str, reason: str) -> None:
        """Fail closed: move the manifest out of the servable namespace
        (atomic rename) and record why.  The artifact becomes a plain
        miss; its now-unreferenced blobs are swept by the next GC.  The
        quarantined manifest is kept as evidence, with the reason in a
        sidecar, rather than deleted — a corrupt artifact is a bug report,
        not just garbage."""
        src = self.manifest_path(ident)
        dst = os.path.join(self.quarantine_dir, f"{ident}.json")
        try:
            os.replace(src, dst)
        except OSError:
            try:
                os.unlink(src)
            except OSError:
                pass
        try:
            with open(os.path.join(self.quarantine_dir,
                                   f"{ident}.reason"), "w") as f:
                f.write(reason)
        except OSError:
            pass
        self.quarantined += 1

    # -- GC ------------------------------------------------------------------
    def gc(self, grace_s: float = 3600.0) -> dict:
        """Mark-then-sweep: delete objects no parseable manifest
        references (older than ``grace_s``) and stale tmp dirs.  Never
        touches manifests, so it cannot un-commit an artifact; a crash
        mid-sweep leaves only garbage the next sweep collects."""
        marked: set[str] = set()
        for ident in self.idents():
            try:
                with open(self.manifest_path(ident)) as f:
                    man = json.load(f)
                for b in man.get("blobs", {}).values():
                    marked.add(str(b.get("sha256")))
            except (OSError, json.JSONDecodeError, AttributeError):
                # Unparseable manifest: mark nothing for it — its blobs
                # are unreachable anyway (the verifier quarantines it on
                # the next read).
                continue
        import time as _time
        now = _time.time()
        objects_swept = 0
        for sub in os.listdir(self.objects_dir):
            subdir = os.path.join(self.objects_dir, sub)
            if not os.path.isdir(subdir):
                continue
            for name in os.listdir(subdir):
                path = os.path.join(subdir, name)
                if name in marked:
                    continue
                try:
                    if now - os.path.getmtime(path) < grace_s:
                        continue
                    os.unlink(path)
                    objects_swept += 1
                except OSError:
                    continue
        tmp_swept = 0
        for name in os.listdir(self.tmp_dir):
            path = os.path.join(self.tmp_dir, name)
            try:
                if now - os.path.getmtime(path) < grace_s:
                    continue
            except OSError:
                continue
            shutil.rmtree(path, ignore_errors=True)
            tmp_swept += 1
        self.gc_objects_swept += objects_swept
        self.gc_tmp_swept += tmp_swept
        return {"marked": len(marked), "objects_swept": objects_swept,
                "tmp_swept": tmp_swept}

    def stats(self) -> dict:
        return {"artifacts": len(self.idents()),
                "puts": self.puts,
                "loads": self.loads,
                "quarantined": self.quarantined,
                "gc_objects_swept": self.gc_objects_swept,
                "gc_tmp_swept": self.gc_tmp_swept}

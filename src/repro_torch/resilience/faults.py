"""Fault kinds and seeded, deterministic fault injection for chunk streams
and row fetches, after ``repro/resilience/faults.py``.

The streaming engine's recovery carries a differential guarantee: under
transient faults the selection is bit-identical to the fault-free run.
The wrappers here are its adversary, on a schedule that is a pure function
of ``(seed, site)`` (``_draw`` is ``np.random.default_rng((seed, kind,
*coords))``, as in the reference, so both packages inject the same faults
in the same places).

``TransientFault``     goes away on re-read; the retry policy's domain.
  ``ChunkReadError``   a chunk read raised (I/O error analogue).
  ``RowFetchError``    an exact-row fetch raised.
  ``CorruptChunkError``a re-read chunk's content disagrees with the
                       cache's exact-norm sidecars; raised by the engine.
``StreamDied``         permanent: the stream is dead once its yield
                       budget is spent.  Not retryable.
``SimulatedCrash``     raised by ``crash_after`` hooks (a kill mid-commit).

Corruption is injected silently (perturbed rows, no exception), and never
on a chunk's first read: the sidecar written then is the ground truth the
engine's detector compares against.

The disk faults (``DISK_FAULT_KINDS``, ``inject_disk_fault``) are the
artifact store's adversary: each corrupts a committed artifact in place
at seeded coordinates drawn as the reference draws them, so one fault
mutates the same bytes in both packages' stores.
"""

from __future__ import annotations

import os
import time
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch


class FaultError(RuntimeError):
    """Base class for injected and recovered stream faults."""


class TransientFault(FaultError):
    """A fault expected to clear on re-read; retry policies catch these."""


class ChunkReadError(TransientFault):
    """Transient chunk-read failure (I/O error analogue)."""


class RowFetchError(TransientFault):
    """Transient exact-row fetch failure."""


class CorruptChunkError(TransientFault):
    """A chunk's content disagrees with its exact-norm sidecars.

    Transient because a re-read usually clears it; persistent disagreement
    is quarantined row by row by the engine.
    """


class StreamDied(FaultError):
    """Permanent mid-pass stream death: retries cannot help."""


class SimulatedCrash(FaultError):
    """Raised by ``crash_after`` hooks to model a kill mid-commit; never
    retried (the point is what the next process finds)."""


_KIND = {"io": 1, "corrupt": 2, "slow": 3, "row_io": 4, "row_corrupt": 5,
         "disk": 6}


def _draw(seed: int, kind: str, *coords: int) -> float:
    """Uniform in [0, 1), a pure function of (seed, kind, coords)."""
    rng = np.random.default_rng((int(seed), _KIND[kind]) + tuple(
        int(c) for c in coords))
    return float(rng.random())


@dataclass(frozen=True)
class FaultPlan:
    """What to inject, at what rate, keyed on ``seed``.

    Rates are per *encounter*: the e-th time chunk ``c`` (or a row-fetch
    call) is served draws independently from the (seed, c, e) stream, so
    retries see fresh draws but identical runs see identical schedules.
    """

    seed: int = 0
    transient_rate: float = 0.0   # P(chunk read raises ChunkReadError)
    corrupt_rate: float = 0.0     # P(chunk content perturbed); never on
                                  # first encounter (sidecar = ground truth)
    slow_rate: float = 0.0        # P(chunk delayed by slow_s)
    slow_s: float = 0.001
    die_after_chunks: Optional[int] = None  # StreamDied once this many
                                            # chunks were yielded, forever
    die_once: bool = False        # death fires once, then the stream is
                                  # healthy (crashed-and-restarted loader)
    row_transient_rate: float = 0.0  # P(row_fetch call raises)
    row_corrupt_rate: float = 0.0    # P(a fetched row is perturbed), per
                                     # row per call (transient)
    corrupt_ids: tuple = ()          # row ids row_fetch *always* returns
                                     # corrupted (persistent corruption)


def _perturb(rows):
    """Corrupt row content so its f32 norm moves decisively (scale and
    shift: a sign flip would keep the norm).  Tensors stay tensors, on
    their device; anything else comes back as a numpy f32 array."""
    if isinstance(rows, torch.Tensor):
        return rows.float() * 1.5 + 0.125
    bad = np.asarray(rows, np.float32).copy()
    bad *= 1.5
    bad += 0.125
    return bad


class FaultyChunkIterator:
    """Wrap a ``(chunk, valid)`` factory with a seeded fault schedule.

    Instances are callables with the factory's protocol (each call opens a
    fresh pass), so they drop into ``omp_select_streaming`` and
    ``streaming_target`` unchanged.  The counters are observational; the
    schedule depends only on the plan and per-chunk encounter numbers.
    """

    def __init__(self, inner: Callable, plan: FaultPlan,
                 sleeper: Callable[[float], None] = time.sleep):
        self.inner = inner
        self.plan = plan
        self._sleep = sleeper
        self.passes = 0
        self.yielded = 0            # total chunks served across all passes
        self.encounters: Counter = Counter()   # chunk idx -> times served
        self.injected: Counter = Counter()     # fault kind -> count

    def __call__(self):
        self.passes += 1
        plan = self.plan

        def gen():
            for cidx, item in enumerate(self.inner()):
                if (plan.die_after_chunks is not None
                        and self.yielded >= plan.die_after_chunks
                        and not (plan.die_once
                                 and self.injected["died"] > 0)):
                    self.injected["died"] += 1
                    raise StreamDied(
                        f"stream died after {self.yielded} chunks "
                        f"(die_after_chunks={plan.die_after_chunks})")
                enc = self.encounters[cidx]
                self.encounters[cidx] += 1
                if _draw(plan.seed, "io", cidx, enc) < plan.transient_rate:
                    self.injected["transient"] += 1
                    raise ChunkReadError(
                        f"injected transient read fault at chunk {cidx} "
                        f"(encounter {enc}, seed {plan.seed})")
                if plan.slow_rate and _draw(
                        plan.seed, "slow", cidx, enc) < plan.slow_rate:
                    self.injected["slow"] += 1
                    self._sleep(plan.slow_s)
                chunk, valid = item
                if enc > 0 and _draw(
                        plan.seed, "corrupt", cidx, enc) < plan.corrupt_rate:
                    self.injected["corrupt"] += 1
                    chunk = _perturb(chunk)
                self.yielded += 1
                yield chunk, valid

        return gen()


def faulty_row_fetch(inner: Callable, plan: FaultPlan,
                     injected: Optional[Counter] = None) -> Callable:
    """Wrap a ``row_fetch(ids) -> rows`` callable with seeded faults.

    Transient raises and transient per-row corruption draw per call
    (encounter = call number); rows in ``plan.corrupt_ids`` come back
    corrupted on *every* call: the persistent case the engine must
    quarantine.  A fetch that returns a tensor keeps returning tensors.
    """
    counts = injected if injected is not None else Counter()
    calls = [0]

    def fetch(ids):
        call = calls[0]
        calls[0] += 1
        if _draw(plan.seed, "row_io", call) < plan.row_transient_rate:
            counts["row_transient"] += 1
            raise RowFetchError(
                f"injected transient row-fetch fault (call {call}, "
                f"seed {plan.seed})")
        rows = inner(ids)
        if isinstance(rows, torch.Tensor):
            rows = rows.float()
        else:
            rows = np.asarray(rows, np.float32)
        ids_np = np.asarray(ids, np.int64)
        bad = np.zeros(len(ids_np), bool)
        if plan.row_corrupt_rate:
            bad |= np.array([
                _draw(plan.seed, "row_corrupt", call, j)
                < plan.row_corrupt_rate
                for j in range(len(ids_np))])
        if plan.corrupt_ids:
            bad |= np.isin(ids_np, np.asarray(plan.corrupt_ids, np.int64))
        if bad.any():
            counts["row_corrupt"] += int(bad.sum())
            rows = rows.clone() if isinstance(rows, torch.Tensor) else (
                rows.copy())
            sel = (torch.as_tensor(np.flatnonzero(bad), device=rows.device)
                   if isinstance(rows, torch.Tensor) else bad)
            rows[sel] = _perturb(rows[sel])
        return rows

    fetch.injected = counts
    return fetch


# ---------------------------------------------------------------------------
# disk faults: the artifact store's adversary (DESIGN.md §12)
# ---------------------------------------------------------------------------

# Every way the fault suite knows how to corrupt a committed artifact: for
# each kind the store must either serve a verified artifact or report a
# miss, never a corrupt result.
DISK_FAULT_KINDS = (
    "torn-write",          # a blob truncated at a seeded byte offset
    "bit-flip",            # one seeded bit flipped inside a blob
    "truncated-manifest",  # the manifest cut off at a seeded offset
    "kill-between-rename", # blobs committed, manifest never renamed in
    "stale-version",       # valid manifest from an old schema version
)


def crash_after(stage: str) -> Callable[[str], None]:
    """A commit hook that raises ``SimulatedCrash`` when the commit reaches
    ``stage``, leaving the state a kill at that point would leave."""

    def hook(at: str) -> None:
        if at == stage:
            raise SimulatedCrash(f"simulated kill at commit stage {at!r}")

    return hook


def inject_disk_fault(store, ident: str, kind: str, seed: int = 0) -> dict:
    """Corrupt the *committed* artifact ``ident`` in ``store`` in place.

    Pure function of ``(seed, kind, ident)``: which blob, which byte and
    which bit are draws of ``np.random.default_rng((seed, disk, kind
    index, int(ident[:8], 16)))``, the reference's, so the same fault
    mutates the same bytes in either package.  Returns a description of
    what was done.  ``store`` is an ``ArtifactStore``, imported lazily.
    """
    import json

    if kind not in DISK_FAULT_KINDS:
        raise ValueError(f"unknown disk fault kind {kind!r}; "
                         f"known: {DISK_FAULT_KINDS}")
    man_path = store.manifest_path(ident)
    with open(man_path) as f:
        manifest = json.load(f)
    rng = np.random.default_rng(
        (int(seed), _KIND["disk"], DISK_FAULT_KINDS.index(kind),
         int(ident[:8], 16)))

    if kind in ("torn-write", "bit-flip"):
        blobs = sorted(manifest["blobs"].items())
        name, spec = blobs[int(rng.integers(len(blobs)))]
        path = store.object_path(spec["sha256"])
        size = spec["nbytes"]
        if kind == "torn-write":
            cut = int(rng.integers(max(size - 1, 1)))
            with open(path, "rb+") as f:
                f.truncate(cut)
            return {"kind": kind, "blob": name, "cut_at": cut}
        byte = int(rng.integers(size))
        bit = int(rng.integers(8))
        with open(path, "rb+") as f:
            f.seek(byte)
            (old,) = f.read(1)
            f.seek(byte)
            f.write(bytes([old ^ (1 << bit)]))
        return {"kind": kind, "blob": name, "byte": byte, "bit": bit}

    if kind == "truncated-manifest":
        size = max(store_manifest_size(store, ident), 2)
        cut = int(rng.integers(1, size))
        with open(man_path, "rb+") as f:
            f.truncate(cut)
        return {"kind": kind, "cut_at": cut}

    if kind == "kill-between-rename":
        # The state a kill between the blob renames and the manifest
        # rename leaves: objects present, manifest absent.
        os.unlink(man_path)
        return {"kind": kind}

    # stale-version: a self-consistent manifest (valid checksum) whose
    # schema the reader does not speak: version skew, not bit rot.
    from repro_torch.artifacts.store import manifest_self_sha
    manifest["schema"] = 0
    manifest["manifest_sha"] = manifest_self_sha(manifest)
    with open(man_path, "w") as f:
        json.dump(manifest, f, sort_keys=True)
    return {"kind": kind, "schema": 0}


def store_manifest_size(store, ident: str) -> int:
    return os.path.getsize(store.manifest_path(ident))

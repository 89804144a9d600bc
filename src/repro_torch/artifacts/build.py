"""Offline artifact build: one anytime solve -> one durable artifact,
after ``repro/artifacts/build.py``.

``build_artifact`` is what the launch pipeline
(``repro_torch.launch.build_artifacts``) calls: it runs the port's
``omp_session_trajectory`` to ``k_max`` over a pool on the pool's device,
takes the trajectory to the host in one copy, and commits it with the
target (and the optional FL-scan bound) to an ``ArtifactStore`` under the
pool's full-content digest, as numpy blobs in the reference's format.
The solve is the expensive part; every later request at any ``k <=
k_max`` is an O(1) verified slice.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.artifacts.store import (ArtifactKey, ArtifactStore,
                                         content_digest_array, host_array,
                                         target_sha256)
from repro_torch.core.omp import omp_session_trajectory
from repro_torch.device import resolve_device


def artifact_key_for(grads, target, lam: float, eps: float,
                     positive: bool, valid=None,
                     fingerprint: Optional[str] = None) -> ArtifactKey:
    """Key a (pool, target, params) tuple as ``build_artifact`` does.

    ``fingerprint`` short-circuits the O(n·d) content digest when the
    caller (the registry) already computed it at pool admission.
    """
    if fingerprint is None:
        fingerprint = content_digest_array(grads, valid)
    return ArtifactKey(fingerprint=fingerprint, lam=float(lam),
                       eps=float(eps), positive=bool(positive),
                       target_sha=target_sha256(target))


def build_artifact(
    store: ArtifactStore,
    grads,                     # (n, d) candidate pool: tensor or host array
    target,                    # (d,)
    k_max: int,
    lam: float = 0.5,
    eps: float = 1e-10,
    nnls_iters: int = 50,
    positive: bool = True,
    valid=None,
    block: int = 128,
    fingerprint: Optional[str] = None,
    fl_l_max: Optional[float] = None,   # FL-scan cache (registry peek)
    crash: Optional[Callable[[str], None]] = None,
    device: str | torch.device | None = None,
) -> tuple[ArtifactKey, str]:
    """Solve to ``k_max`` and commit the trajectory; returns (key, ident).

    The solve runs on the pool's device (a tensor's, else ``device``,
    whose ``None`` is the card).  ``crash`` is forwarded to
    ``ArtifactStore.put``: the fault suite's kill-during-commit hook.
    ``fl_l_max`` rides along as an extra verified blob.
    """
    dev = (grads.device if isinstance(grads, torch.Tensor) and device is None
           else resolve_device(device))
    target_np = host_array(target)
    k_max = int(k_max)
    if fingerprint is None:
        fingerprint = content_digest_array(grads, valid)
    key = artifact_key_for(None, target_np, lam, eps, positive,
                           fingerprint=fingerprint)
    g = (grads if isinstance(grads, torch.Tensor)
         else torch.from_numpy(host_array(grads))).to(dev, torch.float32)
    v = None if valid is None else torch.as_tensor(
        host_array(valid, bool), device=dev)
    n, d = g.shape

    _, traj = omp_session_trajectory(
        g, torch.from_numpy(target_np).to(dev), k_max, lam=lam, eps=eps,
        nnls_iters=nnls_iters, positive=positive, valid=v, block=block)

    arrays = {
        "indices": traj.indices,
        "mask": traj.mask,
        "weights_traj": traj.weights_traj,
        "err_trace": traj.err_trace,
        "target": target_np,
    }
    if fl_l_max is not None:
        arrays["fl_l_max"] = np.asarray([fl_l_max], np.float32)
    meta = {
        "n": int(n), "d": int(d), "k_max": k_max, "block": int(block),
        "lam": float(lam), "eps": float(eps),
        "nnls_iters": int(nnls_iters), "positive": bool(positive),
    }
    ident = store.put(key, arrays, meta, crash=crash)
    return key, ident

"""Durable selection artifacts, after ``repro/artifacts/``:
content-addressed offline trajectories with end-to-end integrity and a
fail-closed serve fast path, in the reference's on-disk format.

``store`` is the crash-safe write half, ``verify`` the fail-closed read
half, ``build`` the offline solve-and-commit pipeline (the solve on the
card).
"""

from repro_torch.artifacts.build import artifact_key_for, build_artifact
from repro_torch.artifacts.store import (
    SCHEMA_VERSION,
    ArtifactKey,
    ArtifactStore,
    SelectionArtifact,
    content_digest_array,
    target_sha256,
)
from repro_torch.artifacts.verify import VerifyError, load_verified

__all__ = [
    "SCHEMA_VERSION",
    "ArtifactKey",
    "ArtifactStore",
    "SelectionArtifact",
    "VerifyError",
    "artifact_key_for",
    "build_artifact",
    "content_digest_array",
    "load_verified",
    "target_sha256",
]

"""Fault-tolerant checkpointing of nested dicts of tensors, after
``repro/checkpoint/checkpoint.py``.

The reference's properties, kept here:

  - **Atomicity**: write to ``<dir>/tmp.<step>.<pid>``, fsync the files,
    then one ``os.rename`` to ``step_<n>``; a crash mid-write never
    corrupts the latest checkpoint, and restore ignores tmp dirs.
  - **Async**: ``CheckpointManager.save(..., blocking=False)`` copies every
    leaf to host memory on the caller's thread (a blocking copy, so a
    parameter updated in place by the next step cannot leak into the
    snapshot) and hands serialization to a writer thread.
  - **Keep-K GC**: old steps are pruned after a successful rename, never
    before; manifest-less step dirs and stale tmp dirs are swept.
  - **Restore onto a device**: ``restore_to`` moves every leaf onto one
    device (the reference's ``restore_sharded`` reshards over a mesh; the
    port runs on one card).

Format, the reference's: one ``arrays.npz`` per checkpoint plus a
``manifest.json`` (``step``, ``keys``, ``shapes``, ``dtypes``), keys the
``/``-joined paths of the nested dicts.  bf16 (and fp8) leaves are stored
as same-width unsigned views under their dtype's name, so a checkpoint
written by either package loads in the other with the same keys, dtypes
and bits.  Loaded leaves are numpy arrays, except bf16 / fp8 ones, which
numpy cannot hold: those come back as CPU tensors of their dtype.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.distributed import dtensor as dt

_SEP = "/"

# dtype name -> (numpy storage view, torch view of the same width)
_VIEW_AS = {"bfloat16": (np.uint16, torch.int16),
            "float8_e4m3fn": (np.uint8, torch.uint8),
            "float8_e5m2": (np.uint8, torch.uint8)}
_TORCH_NAMES = {torch.bfloat16: "bfloat16",
                torch.float8_e4m3fn: "float8_e4m3fn",
                torch.float8_e5m2: "float8_e5m2"}


def _host(leaf) -> tuple[np.ndarray, str]:
    """(a host copy of ``leaf`` that npz can store, its dtype name)."""
    if isinstance(leaf, torch.Tensor):
        # a DTensor is stored whole: a snapshot has no layout
        x = dt.gather_full(leaf.detach())
        name = _TORCH_NAMES.get(x.dtype)
        if name is not None:
            np_view, t_view = _VIEW_AS[name]
            arr = x.view(t_view).to("cpu", copy=True).numpy().view(np_view)
            return arr, name
        arr = x.to("cpu", copy=True).numpy()
        return arr, str(arr.dtype)
    arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def _items(tree: Any, prefix: tuple = ()):
    """(path, leaf) pairs in the order of ``jax.tree_util`` (dict keys
    sorted; lists, tuples and NamedTuples by position, NamedTuple fields
    by name); ``None`` is an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _items(tree[key], prefix + (str(key),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _items(getattr(tree, name), prefix + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _items(sub, prefix + (str(i),))
    else:
        yield _SEP.join(prefix), tree


def _host_flat(tree: Any) -> tuple[dict, dict]:
    """Host copies of every leaf by path, and their dtype names."""
    flat, dtypes = {}, {}
    for key, leaf in _items(tree):
        flat[key], dtypes[key] = _host(leaf)
    return flat, dtypes


def _from_storable(arr: np.ndarray, dtype_name: str):
    if dtype_name in _VIEW_AS:
        _, t_view = _VIEW_AS[dtype_name]
        raw = arr.view(np.int16 if t_view is torch.int16 else np.uint8)
        return torch.from_numpy(raw).view(getattr(torch, dtype_name))
    return arr


def _unflatten(flat: dict) -> dict:
    """Nested dicts from path keys (lists come back as dicts with
    integer-string keys, as in the reference)."""
    root: dict = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def _write(directory: str, step: int, flat: dict, dtypes: dict,
           keep: Optional[int]) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}.{os.getpid()}")
    final = os.path.join(directory, f"step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    manifest = {
        "step": step,
        "keys": sorted(flat),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": dtypes,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    if keep is not None:
        _gc(directory, keep)
    return final


def save_checkpoint(directory: str, step: int, tree: Any,
                    keep: Optional[int] = None) -> str:
    """Atomic synchronous save.  Returns the final checkpoint path."""
    flat, dtypes = _host_flat(tree)
    return _write(directory, step, flat, dtypes, keep)


def _gc(directory: str, keep: int) -> None:
    """Prune to the newest ``keep`` *intact* checkpoints.

    A ``step_`` dir without its manifest is a partial write that can never
    be restored: it is swept as an orphan rather than counted toward
    keep-K (counting it would shrink the real retention).
    """
    steps = sorted(
        d for d in os.listdir(directory) if d.startswith("step_"))
    intact = [d for d in steps
              if os.path.exists(os.path.join(directory, d, "manifest.json"))]
    orphans = [d for d in steps if d not in intact]
    doomed = orphans + (intact[:-keep] if keep > 0 else [])
    for d in doomed:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
    # stale tmp dirs from crashed writers
    for d in os.listdir(directory):
        if d.startswith("tmp."):
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def intact_steps(directory: str) -> list[int]:
    """Step numbers with a manifest on disk, ascending.  Intact means the
    atomic rename completed; the arrays may still be unreadable, which
    only ``load_checkpoint`` can discover."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(d.split("_")[1]) for d in os.listdir(directory)
        if d.startswith("step_")
        and os.path.exists(os.path.join(directory, d, "manifest.json")))


def latest_step(directory: str) -> Optional[int]:
    steps = intact_steps(directory)
    return steps[-1] if steps else None


def load_checkpoint(directory: str, step: Optional[int] = None) -> dict:
    """Load a (nested-dict) checkpoint; ``step=None`` -> latest."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: _from_storable(z[k], manifest["dtypes"][k])
                for k in z.files}
    return _unflatten(flat)


def restore_to(tree: Any, device: str | torch.device) -> Any:
    """Every leaf of a loaded tree as a tensor on ``device``: the one-card
    counterpart of the reference's ``restore_sharded``."""
    if isinstance(tree, dict):
        return {k: restore_to(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device)


class CheckpointManager:
    """Async keep-K checkpointer."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        self.wait()  # one in-flight write at a time
        # The snapshot is taken now, on this thread: blocking host copies.
        flat, dtypes = _host_flat(tree)

        def work():
            try:
                _write(self.directory, step, flat, dtypes, self.keep)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        if blocking:
            work()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def restore(self, step: Optional[int] = None) -> dict:
        self.wait()
        return load_checkpoint(self.directory, step)

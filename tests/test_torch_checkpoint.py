"""The port's checkpointing (``repro_torch/checkpoint``) against the JAX
package's, on the CPU.

The twelve cases of ``tests/test_checkpoint.py`` on the port (atomic
save, latest step, keep-K GC, crashed tmp dirs, orphaned step dirs, the
solver-state fallbacks, the async manager, restore onto a device, and a
snapshot isolated from later in-place updates), then the two formats
across the packages: a tree of f32, int64, bool and bf16 leaves saved by
either package loads in the other with equal keys, dtypes and bits.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ml_dtypes  # noqa: E402

from repro.checkpoint import load_checkpoint as j_load  # noqa: E402
from repro.checkpoint import save_checkpoint as j_save  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    load_checkpoint, load_solver_state,
                                    restore_to, save_checkpoint,
                                    save_solver_state)
from repro_torch.checkpoint.checkpoint import (intact_steps,  # noqa: E402
                                               latest_step)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 4), generator=g),
                   "b": torch.zeros((4,))},
        "opt": {"step": torch.tensor(7, dtype=torch.int32),
                "slots": {"w": torch.ones((8, 4)), "b": torch.ones((4,))}},
        "meta": {"epoch": np.int64(3)},
    }


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    return np.asarray(x)


def _assert_tree_equal(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(_np(x), _np(y), err_msg=k)


def test_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 10, t)
    got = load_checkpoint(str(tmp_path))
    _assert_tree_equal(t, got)
    assert got["opt"]["step"].dtype == np.int32


def test_latest_selection(tmp_path):
    for s in (5, 20, 10):
        save_checkpoint(str(tmp_path), s, _tree(s))
    assert latest_step(str(tmp_path)) == 20
    _assert_tree_equal(_tree(20), load_checkpoint(str(tmp_path)))


def test_keep_k_gc(tmp_path):
    for s in range(6):
        save_checkpoint(str(tmp_path), s, _tree(s), keep=3)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(steps) == 3
    assert steps[-1] == "step_0000000005"


def test_crashed_tmp_ignored(tmp_path):
    """A partial tmp dir (a crash mid-write) must not corrupt restore."""
    save_checkpoint(str(tmp_path), 1, _tree(1))
    os.makedirs(tmp_path / "tmp.99.12345")
    (tmp_path / "tmp.99.12345" / "arrays.npz").write_bytes(b"garbage")
    _assert_tree_equal(_tree(1), load_checkpoint(str(tmp_path)))
    # a later save GCs the stale tmp dir
    save_checkpoint(str(tmp_path), 2, _tree(2), keep=5)
    assert not any(d.startswith("tmp.") for d in os.listdir(tmp_path))


def test_gc_sweeps_partial_step_dirs(tmp_path):
    """A manifest-less step dir is swept as an orphan, not counted toward
    keep-K: with keep=2 both restorable checkpoints survive."""
    save_checkpoint(str(tmp_path), 1, _tree(1))
    save_checkpoint(str(tmp_path), 2, _tree(2))
    partial = tmp_path / "step_0000000099"
    os.makedirs(partial)
    (partial / "arrays.npz").write_bytes(b"torn")
    save_checkpoint(str(tmp_path), 3, _tree(3), keep=2)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_0000000002", "step_0000000003"]
    assert intact_steps(str(tmp_path)) == [2, 3]
    _assert_tree_equal(_tree(2), load_checkpoint(str(tmp_path), 2))


def test_solver_state_falls_back_past_corrupt_latest(tmp_path):
    save_solver_state(str(tmp_path), 1, {"s": np.arange(3)})
    save_solver_state(str(tmp_path), 2, {"s": np.arange(3) * 2})
    (tmp_path / "step_0000000002" / "arrays.npz").write_bytes(b"rotted")
    got = load_solver_state(str(tmp_path))
    assert got is not None
    np.testing.assert_array_equal(got["s"], np.arange(3))


def test_solver_state_empty_latest_step_dir(tmp_path):
    save_solver_state(str(tmp_path), 1, {"s": torch.ones(2)})
    save_solver_state(str(tmp_path), 2, {"s": torch.zeros(2)})
    d = tmp_path / "step_0000000002"
    for f in os.listdir(d):
        os.unlink(d / f)
    np.testing.assert_array_equal(load_solver_state(str(tmp_path))["s"],
                                  np.ones(2, np.float32))


def test_solver_state_none_when_nothing_loads(tmp_path):
    assert load_solver_state(str(tmp_path)) is None        # no dir at all
    save_solver_state(str(tmp_path), 1, {"s": np.ones(2)})
    (tmp_path / "step_0000000001" / "arrays.npz").write_bytes(b"x")
    assert load_solver_state(str(tmp_path)) is None


def test_async_manager(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    t = _tree(3)
    m.save(100, t, blocking=False)
    m.wait()
    _assert_tree_equal(t, m.restore())


def test_async_overlapping_saves(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    for s in range(4):
        m.save(s, _tree(s), blocking=False)  # each save joins the previous
    m.wait()
    assert m.latest_step() == 3
    assert intact_steps(str(tmp_path)) == [2, 3]


def test_restore_to_device(tmp_path):
    """The one-card counterpart of ``restore_sharded``: every leaf a tensor
    on the device asked for, with its bits and dtype."""
    t = _tree()
    t["half"] = torch.randn(5).to(torch.bfloat16)
    save_checkpoint(str(tmp_path), 1, t)
    placed = restore_to(load_checkpoint(str(tmp_path)), "cpu")
    _assert_tree_equal(t, placed)
    for _, leaf in _leaves(placed):
        assert isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu"
    assert placed["half"].dtype == torch.bfloat16
    assert placed["opt"]["step"].dtype == torch.int32


def test_snapshot_isolated_from_mutation(tmp_path):
    """The async save copies at call time: an in-place update after it (the
    next SGD step on a parameter, a numpy buffer reused) does not leak in."""
    m = CheckpointManager(str(tmp_path))
    arr = np.ones((4,), np.float32)
    param = torch.ones((4,))
    m.save(1, {"a": arr, "p": param}, blocking=False)
    arr[:] = 7.0
    param.add_(6.0)
    m.wait()
    got = m.restore()
    assert got["a"].sum() == 4.0 and got["p"].sum() == 4.0


# ---------------------------------------------------------------------------
# the two packages' formats
# ---------------------------------------------------------------------------

def _mixed_numpy(seed=0):
    """f32, int64, bool and bf16 leaves, as numpy (bf16: ml_dtypes)."""
    rng = np.random.default_rng(seed)
    return {
        "f32": rng.standard_normal((6, 3)).astype(np.float32),
        "i64": rng.integers(-2**40, 2**40, (7,)).astype(np.int64),
        "flag": rng.random((5,)) < 0.5,
        "nest": {"bf16": rng.standard_normal((4, 2)).astype(
            ml_dtypes.bfloat16), "scalar": np.int64(9)},
    }


def _bits(x):
    a = _np(x)
    if a.dtype == ml_dtypes.bfloat16:
        return a.view(np.uint16)
    return a


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    want = _mixed_numpy(1)
    # numpy leaves: jnp would narrow int64 to int32 without x64 mode
    j_save(str(tmp_path), 4, want)
    got = load_checkpoint(str(tmp_path))
    assert sorted(k for k, _ in _leaves(got)) == sorted(
        k for k, _ in _leaves(want))
    assert got["nest"]["bf16"].dtype == torch.bfloat16
    for (k, w), (_, g) in zip(_leaves(want), _leaves(got)):
        if k != "nest/bf16":
            assert _np(g).dtype == w.dtype, k
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=k)


def test_port_checkpoint_loads_in_jax(tmp_path):
    src = _mixed_numpy(2)
    tree = {"f32": torch.from_numpy(src["f32"]),
            "i64": torch.from_numpy(src["i64"]),
            "flag": torch.from_numpy(src["flag"]),
            "nest": {"bf16": torch.from_numpy(
                src["nest"]["bf16"].view(np.int16)).view(torch.bfloat16),
                "scalar": src["nest"]["scalar"]}}
    path = save_checkpoint(str(tmp_path), 5, tree)
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert man["step"] == 5 and man["dtypes"]["nest/bf16"] == "bfloat16"
    assert man["keys"] == sorted(man["keys"])
    got = j_load(str(tmp_path))
    assert got["nest"]["bf16"].dtype == ml_dtypes.bfloat16
    for (k, w), (_, g) in zip(_leaves(src), _leaves(got)):
        assert np.asarray(g).dtype == w.dtype, k
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=k)

"""The port's LM driver on a mesh (``--mesh-data`` / ``--mesh-model`` /
``--fsdp``), and the hint rules, on the CPU.

  - ``--mesh-data 2 --fsdp`` in one process is clamped to one rank, as
    the JAX driver clamps to its one device: DTensor parameters on a
    one-rank gloo group of the driver's own, the losses and picks of the
    plain driver bit for bit, and the JAX driver's (same flags, run in a
    subprocess beside this file's other tests) within
    ``tests/test_torch_lm_train.py``'s tolerance.
  - Two gloo ranks, in a subprocess of their own, at ``--mesh-data 2``:
    the batch split over the two ranks and the selection through
    ``sharded_omp_select``; the one-rank picks, and losses within 1e-5;
    at ``--mesh-model 2`` (tensor parallel) the same.
    The same ranks resume a one-rank snapshot and continue the
    never-killed run.
  - With rules on a fake mesh, ``hints.constrain`` gives the table's
    placements, and is the identity without them.

Each test leaves no default process group behind: the driver destroys the
group it made, the fake group here is torn down by its fixture, and the
two ranks run in a subprocess.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data.tokens import TokenStream as JaxTokenStream  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed import dtensor as dt  # noqa: E402
from repro_torch.distributed import hints  # noqa: E402
from repro_torch.distributed.sharding import (fit_spec,  # noqa: E402
                                              logical_rules, placements)
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import lm  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = ["--mesh-data", "2", "--fsdp"]
SMALL = ["--smoke", "--device", "cpu", "--steps", "4", "--select-every",
         "2", "--window", "4", "--micro-batch", "2", "--seq-len", "8"]
ARGS = ["--arch", "gemma-2b", "--smoke", "--steps", "4", "--select-every",
        "2", "--window", "4", "--budget", "0.5", "--micro-batch", "2",
        "--seq-len", "16", "--seed", "0"]


@pytest.fixture(autouse=True)
def no_group_left():
    yield
    assert not dist.is_initialized()


class _JaxTokens:
    """The JAX driver's token stream, its batches handed over as tensors."""

    def __init__(self, cfg):
        self.stream = JaxTokenStream(seed=0, batch_per_shard=2, seq_len=16,
                                     vocab=cfg.vocab_size, n_shards=4)

    def batch(self, step, shard=0):
        return {k: torch.from_numpy(np.array(v))
                for k, v in self.stream.batch(step, shard).items()}


_JAX_DRIVER = textwrap.dedent("""
    import pickle, sys
    import jax
    import numpy as np
    import repro.launch.train as jax_train
    from repro.configs import get_smoke_config
    from repro.models import lm as jlm

    cfg = get_smoke_config("gemma-2b").replace(param_dtype="float32")
    picks, losses = [], []
    gradmatch = jax_train.gm_lib.gradmatch
    step_fn = jax_train.lm_train_step_fn

    def recording_gradmatch(*a, **kw):
        sel = gradmatch(*a, **kw)
        m = np.asarray(sel.mask)
        picks.append((np.asarray(sel.indices)[m],
                      np.asarray(sel.weights)[m]))
        return sel

    def recording_step_fn(*a, **kw):
        step = step_fn(*a, **kw)

        def wrapped(params, opt_state, batch):
            out = step(params, opt_state, batch)
            jax.debug.callback(lambda x: losses.append(float(x)),
                               out[2]["loss"])
            return out
        return wrapped

    jax_train.get_smoke_config = lambda arch: cfg
    jax_train.gm_lib.gradmatch = recording_gradmatch
    jax_train.lm_train_step_fn = recording_step_fn
    jax_train.main(sys.argv[2:])
    jax.effects_barrier()
    params = jlm.init_lm(cfg, jax.random.PRNGKey(0))
    with open(sys.argv[1], "wb") as f:
        pickle.dump(dict(picks=picks, losses=losses,
                         params=jax.tree_util.tree_map(np.asarray, params)),
                    f)
""")


@pytest.fixture(scope="module", autouse=True)
def jax_driver(tmp_path_factory):
    """The JAX driver at f32 (same flags), recording each selection and
    step loss, in a subprocess started before this file's first test so
    that it runs beside them."""
    d = tmp_path_factory.mktemp("jax_driver")
    script = d / "run_driver.py"
    script.write_text(_JAX_DRIVER)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, str(script), str(d / "out.pkl"), *ARGS, *MESH],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def result():
        _, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, stderr[-3000:]
        with open(d / "out.pkl", "rb") as f:
            return pickle.load(f)

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_both_mesh_axes_run_clamped_to_one_rank():
    rep = train.main(SMALL + ["--steps", "2", "--mesh-data", "2",
                              "--mesh-model", "2"])
    assert rep["mesh"] == {"data": 1, "model": 1}
    assert len(rep["losses"]) == 2 and np.isfinite(rep["losses"]).all()


_RANKS = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, world, out):
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(out, "store"), world),
            rank=rank, world_size=world)
        import torch
        from repro_torch.configs import get_smoke_config
        from repro_torch.launch import train
        from repro_torch.models import lm

        def f32_model():
            cfg = get_smoke_config("gemma-2b").replace(param_dtype="float32")
            return lm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")

        small = sys.argv[2].split()
        rep = train.main(small + ["--mesh-data", "2"], model=f32_model())
        tp = train.main(small + ["--mesh-model", "2"], model=f32_model())
        resumed = train.main(small + ["--mesh-data", "2", "--checkpoint-dir",
                                      os.path.join(out, "ckpt"),
                                      "--checkpoint-every", "2"],
                             model=f32_model())
        assert dist.is_initialized()        # the caller's group stays
        np.savez(os.path.join(out, f"rank{rank}.npz"),
                 losses=rep["losses"], mesh=str(rep["mesh"]),
                 picks=np.array([s["indices"] for s in rep["selections"]]),
                 weights=np.array([s["weights"] for s in rep["selections"]]),
                 resumed=resumed["losses"], start=resumed["start_step"],
                 tp_losses=tp["losses"], tp_mesh=str(tp["mesh"]),
                 tp_picks=np.array([s["indices"] for s in tp["selections"]]))
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=(2, sys.argv[1]), nprocs=2)
        print("OK2")
""")


def _f32_model():
    cfg = get_smoke_config("gemma-2b").replace(param_dtype="float32")
    return lm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")


def test_two_gloo_ranks_give_the_one_rank_run(tmp_path):
    """Two ranks at ``--mesh-data 2`` (f32 parameters: the two ranks add
    their gradients in another order than one rank does): the one-rank
    picks, losses within 1e-5; then a snapshot the one-rank driver wrote
    at step 2, resumed on the two ranks, continues the never-killed
    run."""
    one = train.main(SMALL, model=_f32_model())
    killed = train.main([*SMALL[:4], "2", *SMALL[5:], "--checkpoint-dir",
                         str(tmp_path / "ckpt"), "--checkpoint-every", "2"],
                        model=_f32_model())
    assert killed["start_step"] == 0 and len(killed["losses"]) == 2
    script = tmp_path / "ranks.py"
    script.write_text(_RANKS)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")    # one thread a rank: workers share
    r = subprocess.run([sys.executable, str(script), str(tmp_path),
                        " ".join(SMALL)], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "OK2" in r.stdout
    ranks = [np.load(tmp_path / f"rank{i}.npz") for i in range(2)]
    for rk in ranks:
        assert str(rk["mesh"]) == str({"data": 2, "model": 1})
        np.testing.assert_array_equal(rk["picks"], ranks[0]["picks"])
        np.testing.assert_array_equal(rk["losses"], ranks[0]["losses"])
        np.testing.assert_array_equal(
            rk["picks"], np.array([s["indices"] for s in one["selections"]]))
        np.testing.assert_allclose(
            rk["weights"], np.array([s["weights"] for s in
                                     one["selections"]]),
            rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(rk["losses"], one["losses"], rtol=1e-5)
        # the same two ranks on the 'model' axis: the heads, the FFN and
        # the vocabulary split, the row-parallel products all-reduced
        assert str(rk["tp_mesh"]) == str({"data": 1, "model": 2})
        np.testing.assert_array_equal(rk["tp_picks"], rk["picks"])
        np.testing.assert_allclose(rk["tp_losses"], one["losses"],
                                   rtol=1e-5)
        # resumed from the one-rank snapshot at step 2
        assert int(rk["start"]) == 2
        np.testing.assert_allclose(rk["resumed"], one["losses"][2:],
                                   rtol=1e-5)


@pytest.fixture
def fake_mesh():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield init_device_mesh("cpu", (2, 2, 2),
                               mesh_dim_names=("pod", "data", "model"))
    finally:
        dist.destroy_process_group()


def test_constrain_gives_the_table_placements(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    x = distribute_tensor(torch.zeros(4, 6, 8, device="meta"), fake_mesh,
                          [Replicate()] * 3)
    plain = torch.zeros(4, 6, 8)
    assert hints.constrain(x, "residual") is x          # no rules
    table = logical_rules(fake_mesh)
    with hints.use_rules(fake_mesh, table):
        for name in ("residual", "logits", "ffn_inner", "attn_out"):
            y = hints.constrain(x, name)
            want = placements(fit_spec((4, 6, 8), table[name], fake_mesh),
                              fake_mesh)
            assert tuple(y.placements) == want, name
        # the vocabulary dim over 'model', the batch over ('pod', 'data')
        assert tuple(hints.constrain(x, "logits").placements) == (
            Shard(0), Shard(0), Shard(2))
        assert hints.constrain(x, "q_full") is x        # no rule: as is
        assert hints.constrain(plain, "residual") is plain   # not a DTensor
    assert hints.constrain(x, "residual") is x          # rules gone again


def test_mesh_mode_takes_model_made_tensors_as_replicated(fake_mesh):
    """Inside ``mesh_mode`` a plain tensor meets a DTensor as replicated
    (a RoPE table, a mask), and ``reshape`` gathers a dim it would split
    unevenly."""
    from torch.distributed.tensor import Shard, distribute_tensor
    x = distribute_tensor(torch.zeros(4, 6, 8, device="meta"), fake_mesh,
                          [Shard(0), Shard(0), Shard(2)])
    with dt.mesh_mode(fake_mesh, logical_rules(fake_mesh)):
        y = x * torch.ones(8, device="meta")
        assert dt.is_dtensor(y) and tuple(y.placements) == tuple(
            x.placements)
        z = dt.reshape(x, 4, 6, 2, 4)     # 2 of 8 on a model axis of 2: kept
        assert z.placements[2] == Shard(2)
        w = dt.reshape(x, 4, 6, 1, 8)     # splits 8 into (1, 8): on dim 3
        assert tuple(w.shape) == (4, 6, 1, 8)
        v = dt.reshape(dt.reshape(x, 4, 48), 4, 3, 16)   # merge, then split
        assert tuple(v.shape) == (4, 3, 16)


def test_one_rank_mesh_equals_the_plain_driver_and_jax(jax_driver):
    jax_run = jax_driver()
    jcfg = jax_smoke("gemma-2b").replace(param_dtype="float32")
    tcfg = get_smoke_config("gemma-2b").replace(param_dtype="float32")
    reps = {}
    for name, flags in (("plain", []), ("mesh", MESH)):
        model = lm.params_from_jax(tcfg, jax_run["params"], device="cpu")
        reps[name] = train.main(ARGS + ["--device", "cpu"] + flags,
                                stream=_JaxTokens(jcfg), model=model)
    plain, mesh = reps["plain"], reps["mesh"]
    assert mesh["mesh"] == {"data": 1, "model": 1}
    assert plain["mesh"] is None
    assert mesh["losses"] == plain["losses"]              # bit for bit
    assert mesh["selections"] == plain["selections"]
    assert len(mesh["selections"]) == len(jax_run["picks"]) == 2
    for sel, (idx, w) in zip(mesh["selections"], jax_run["picks"]):
        np.testing.assert_array_equal(sel["indices"], idx)
        np.testing.assert_allclose(sel["weights"], w, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(mesh["losses"], jax_run["losses"], rtol=1e-5)

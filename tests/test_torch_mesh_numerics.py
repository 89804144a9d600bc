"""A training step of the port's LM on a two-rank mesh against the same
step on plain tensors, on the CPU.

Two gloo ranks, in a subprocess of their own, place one smoke arch of
each family (dense MQA and GQA, MoE, hybrid, xLSTM, vlm, audio) on a
1 x 2 mesh (tensor and expert parallel over 'model') and a 2 x 1 mesh
(the batch over 'data'), both with FSDP, and take one weighted SGD step
under the hint rules.  Every leaf's gradient and post-step value is held
against the plain run's on the same seed, leaf by leaf.  The mesh paths
this covers and no other test does: the MoE's per-rank routing, dispatch
and experts over 'model' and its aux-loss sum, the SSD / mLSTM / sLSTM
scans on each rank's heads, a rank taking its one KV head (gemma-2b's MQA
at 'model' 2) or its block of KV heads (GQA), cross-attention, the audio
head.

Limits, from readings (the largest part of a leaf's max |gradient| by
which the mesh run differs).  A mesh adds partial sums in another order
than one rank does, so at f32 a leaf parts from the plain run by rounding
carried through the backward: up to 1.4e-6 (dense, MoE, vlm, audio) and
6.2e-6 (zamba2's SSD), each limit a few times that.  xLSTM's exponential
gates amplify the same rounding to 1.4e-4 at 1 x 2, so the xLSTM step is
taken at f64 (the port's ``lm``, ``common`` and ``xlstm`` sources with
their f32 casts made f64), where mesh and plain part by at most 2.6e-13.
The input-gate biases ``b_i`` have an exact gradient near 0 (the mLSTM and
sLSTM cells are invariant to a shift of the input gate; the sLSTM's is
4.8e-9 at f64 against 5.1e-4 for its ``b_f``), so a ``b_i`` is held
against the largest gate-bias gradient of its block, not its own.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# arch -> (dtype of the step, limit)
CASES = {
    "gemma-2b": ("float32", 1e-5),
    "starcoder2-3b": ("float32", 1e-5),
    "qwen3-moe-30b-a3b": ("float32", 1e-5),
    "zamba2-7b": ("float32", 3e-5),
    "xlstm-1.3b": ("float64", 1e-11),
    "llama-3.2-vision-90b": ("float32", 1e-5),
    "hubert-xlarge": ("float32", 1e-5),
}
MESHES = ("1x2", "2x1")
LR = 0.1

_RANKS = textwrap.dedent("""
    import contextlib, inspect, os, pickle, sys, types
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def f64(module):
        # a copy of a port module with its f32 casts made f64
        src = inspect.getsource(module).replace(".float()", ".double()")
        src = src.replace("torch.float32", "torch.float64")
        copy = types.ModuleType(module.__name__ + "_f64")
        exec(compile(src, copy.__name__, "exec"), copy.__dict__)
        return copy

    def run(rank, out, cases, lr):
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(out, "store"), 2),
            rank=rank, world_size=2)
        torch.set_num_threads(1)
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.configs import get_smoke_config
        from repro_torch.configs.base import MLSTM, SLSTM
        from repro_torch.distributed import dtensor as dt
        from repro_torch.distributed.sharding import (
            distribute_model, logical_rules, param_shardings)
        from repro_torch.launch import specs
        from repro_torch.models import common, lm, xlstm
        from repro_torch.optim import sgd

        lm64, xl64 = f64(lm), f64(xlstm)
        lm64.common = f64(common)
        for kind in (MLSTM, SLSTM):
            lm64._MIXERS[kind] = tuple(getattr(xl64, f.__name__)
                                       for f in lm._MIXERS[kind])
        meshes = {name: init_device_mesh("cpu", shape,
                                         mesh_dim_names=("data", "model"))
                  for name, shape in (("1x2", (1, 2)), ("2x1", (2, 1)))}
        res = {}
        for case in cases:
            arch, dtype = case.split(":")
            lm_mod = lm64 if dtype == "float64" else lm
            fdt = getattr(torch, dtype)
            cfg = get_smoke_config(arch).replace(param_dtype=dtype)
            g = torch.Generator().manual_seed(0)
            B, S = 4, 16
            batch = {"targets": torch.randint(0, cfg.vocab_size, (B, S),
                                              generator=g)}
            if cfg.family == "audio":
                batch["embeds"] = torch.randn(B, S, cfg.d_model, generator=g,
                                              dtype=fdt)
            else:
                batch["tokens"] = torch.randint(0, cfg.vocab_size, (B, S),
                                                generator=g)
            if cfg.family == "vlm":
                batch["vision"] = torch.randn(B, cfg.vision.n_tokens,
                                              cfg.vision.d_embed, generator=g,
                                              dtype=fdt)
            batch["weights"] = torch.tensor([0.4, 0.3, 0.2, 0.1], dtype=fdt)
            for name in ("plain", *meshes):
                model = lm_mod.init_lm(cfg, torch.Generator().manual_seed(1),
                                       "cpu")
                b, ctx = batch, contextlib.nullcontext()
                if name != "plain":
                    mesh = meshes[name]
                    model = distribute_model(
                        model, param_shardings(cfg, model, mesh, fsdp=True))
                    sh = specs.batch_shardings(mesh, batch)
                    b = {k: distribute_tensor(v, mesh, sh[k].placements)
                         for k, v in batch.items()}
                    ctx = dt.mesh_mode(mesh, logical_rules(mesh))
                opt = sgd(model.parameters(), lr, momentum=0.9)
                with ctx:
                    loss, _ = lm_mod.lm_loss(cfg, model, b)
                    loss.backward()
                    grads = {n: dt.gather_full(p.grad).numpy().copy()
                             for n, p in model.named_parameters()}
                    opt.step()
                params = {n: dt.gather_full(p.detach()).numpy().copy()
                          for n, p in model.named_parameters()}
                res[arch, name] = dict(
                    loss=float(dt.gather_full(loss.detach())), grads=grads,
                    params=params)
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=(sys.argv[1], sys.argv[2].split(","),
                            float(sys.argv[3])), nprocs=2)
        print("OK2")
""")


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    """Each rank's gathered loss, gradients and post-step parameters, by
    (arch, 'plain' / '1x2' / '2x1')."""
    d = tmp_path_factory.mktemp("mesh_numerics")
    script = d / "ranks.py"
    script.write_text(_RANKS)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")    # one thread a rank: workers share
    cases = ",".join(f"{a}:{dtype}" for a, (dtype, _) in CASES.items())
    r = subprocess.run([sys.executable, str(script), str(d), cases, str(LR)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "OK2" in r.stdout
    ranks = []
    for i in range(2):
        with open(d / f"rank{i}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


def _block(name: str) -> str:
    return name.rsplit(".", 1)[0]


def _scale(name: str, grads: dict) -> float:
    """The size a gradient is held against: its own max |g|, or for an
    input-gate bias its block's largest gate-bias gradient."""
    if name.endswith(".b_i"):
        blk = _block(name)
        return max(float(np.abs(g).max()) for n, g in grads.items()
                   if _block(n) == blk
                   and n.rsplit(".", 1)[1] in ("b_i", "b_f", "b_z", "b_o"))
    return float(np.abs(grads[name]).max())


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", list(CASES))
def test_mesh_step_equals_plain(readings, arch, mesh):
    plain = readings[0][arch, "plain"]
    lim = CASES[arch][1]
    for rk in readings:
        run = rk[arch, mesh]
        assert abs(run["loss"] - plain["loss"]) <= lim * abs(plain["loss"])
        assert set(run["grads"]) == set(plain["grads"])
        for n, g in plain["grads"].items():
            dg = float(np.abs(run["grads"][n] - g).max())
            assert dg <= lim * _scale(n, plain["grads"]), (n, dg)
        # SGD's first update is lr times the gradient, taken in f32: the
        # gradient's allowance, plus the rounding of the update and of the
        # parameter it is added to
        for n, p in plain["params"].items():
            dp = float(np.abs(run["params"][n] - p).max())
            step = LR * float(np.abs(plain["grads"][n]).max())
            ulp = float(np.spacing(np.abs(p).max())
                        + np.spacing(np.float32(step)))
            assert dp <= LR * lim * _scale(n, plain["grads"]) + 2 * ulp, (
                n, dp)
    # both ranks gathered the same values
    for n, g in readings[0][arch, mesh]["grads"].items():
        np.testing.assert_array_equal(readings[1][arch, mesh]["grads"][n], g)

"""The port's dry run (``repro_torch.launch.dryrun``) and its inputs,
against the JAX package where both compute the same thing.

Two subprocesses, one a mesh, install fake process groups (so this test
process never holds a default group) and run:

  - six smoke cells, one per family and kind, on fake (2, 2) and
    (2, 2, 2) meshes: dense train, MoE decode, hybrid prefill, xLSTM
    train, vlm prefill, audio train; each must give a record whose
    per-rank parameter bytes are the specs' reckoning;
  - a data-parallel train cell on (2, 1) against the one-rank count
    (sub-meshes of the (2, 2) group):
    half the FLOPs per chip;
  - a model-parallel prefill cell on (1, 2): two all-reduces a layer, the
    row-parallel attention output and FFN down projection.

The reference's ``dryrun.py`` sets ``XLA_FLAGS`` to 512 host devices when
imported, so its ``analytic_memory_gib`` and ``hlo_analysis.
analytic_hbm_bytes`` are computed in a subprocess of their own; the
port's must equal them for all 32 full cells on both meshes, with the
weight-gathered-decode choice given as the reference makes it (8 GiB of
TP-sharded weights, half a TPU v5e; the port's own threshold is half an
H100's 80 GB).
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import all_cells as j_all_cells  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro_torch.configs import (SHAPES, all_cells, get_config,  # noqa: E402,E501
                                 get_smoke_config)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.comm_analysis import analytic_hbm_bytes  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one thread a subprocess: the meta run is host dispatch, and the suite's
# workers share the machine
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
           OMP_NUM_THREADS="1")

_CELLS = textwrap.dedent("""
    import json, sys, torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as tsh
    from repro_torch.launch import dryrun, specs

    KINDS = {"train": ShapeConfig("train_s", 8, 8, "train"),
             "prefill": ShapeConfig("prefill_s", 16, 4, "prefill"),
             "decode": ShapeConfig("decode_s", 32, 8, "decode")}
    # the train cells on the 2-D mesh: DTensor's first propagation of a
    # backward on the 3-D mesh costs ~15 s
    CELLS = {(2, 2): [("gemma-2b", "train"), ("xlstm-1.3b", "train"),
                      ("hubert-xlarge", "train")],
             (2, 2, 2): [("qwen3-moe-30b-a3b", "decode"),
                         ("zamba2-7b", "prefill"),
                         ("llama-3.2-vision-90b", "prefill")]}

    def spec_bytes(cfg, mesh, fsdp):
        model = specs.param_specs_shapes(cfg)
        sh = tsh.param_shardings(cfg, model, mesh, fsdp=fsdp)
        total = 0
        for name, p in model.named_parameters():
            n = p.numel()
            for entry in sh[name].spec:
                if entry is not None:
                    n //= tsh.axis_size(mesh, entry)
            total += n * p.element_size()
        return total

    shape = (2, 2, 2) if sys.argv[2] == "3d" else (2, 2)
    axes = ("pod", "data", "model")[-len(shape):]
    out = {"cells": []}
    dryrun.install_fake_group(8 if len(shape) == 3 else 4)
    try:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        for arch, kind in CELLS[shape]:
            cfg = get_smoke_config(arch)
            rec = dryrun.run_cell(cfg, KINDS[kind], mesh)
            fsdp = kind == "train" or (kind == "decode" and
                                       dryrun.gathered_decode(cfg, mesh))
            rec["spec_param_bytes"] = spec_bytes(cfg, mesh, fsdp)
            out["cells"].append(rec)
        if len(shape) == 2:
            # data- and model-parallel cells on sub-meshes of the group
            cfg = get_smoke_config("gemma-2b")

            def sub(d, m):
                return DeviceMesh("cpu", torch.arange(d * m).reshape(d, m),
                                  mesh_dim_names=("data", "model"))

            out["dp"] = [dryrun.run_cell(cfg, KINDS["train"], sub(d, 1), 1)
                         ["hlo_flops_per_chip"] for d in (1, 2)]
            out["mp"] = dryrun.run_cell(cfg, KINDS["prefill"], sub(1, 2))
    finally:
        dist.destroy_process_group()
    json.dump(out, open(sys.argv[1], "w"))
""")

_JAX_ANALYTIC = textwrap.dedent("""
    import json, sys
    from repro.configs import SHAPES, all_cells, get_config
    from repro.launch.dryrun import analytic_memory_gib
    from repro.launch.hlo_analysis import analytic_hbm_bytes

    class FakeMesh:
        def __init__(self, **axes):
            self.axis_names = tuple(axes)
            self.shape = dict(axes)
            self.size = 1
            for v in axes.values():
                self.size *= v

    out = []
    for axes in ({"data": 16, "model": 16},
                 {"pod": 2, "data": 16, "model": 16}):
        mesh = FakeMesh(**axes)
        dp = mesh.size // 16
        for arch, shape_name in all_cells():
            cfg, shape = get_config(arch), SHAPES[shape_name]
            mb = (max(shape.global_batch // (2 * dp), 1)
                  if shape.kind == "train" else 1)
            fsdp = cfg.param_count() * 2 / 16 / 2**30 > 8.0
            out.append({"arch": arch, "shape": shape_name, "axes": axes,
                        "mb": mb, "fsdp": fsdp,
                        "mem": analytic_memory_gib(cfg, shape, mesh, mb),
                        "hbm": analytic_hbm_bytes(cfg, shape, mesh.size, 16,
                                                  mb, fsdp_decode=fsdp)})
    json.dump(out, open(sys.argv[1], "w"))
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three subprocesses (each mesh's cells, the reference's tables),
    started together."""
    d = tmp_path_factory.mktemp("dryrun")
    procs = {}
    for name, code, args in (("2d", _CELLS, ["2d"]), ("3d", _CELLS, ["3d"]),
                             ("jax", _JAX_ANALYTIC, [])):
        script = d / f"run_{name}.py"     # not "jax.py": it would shadow jax
        script.write_text(code)
        procs[name] = subprocess.Popen(
            [sys.executable, str(script), str(d / f"{name}.json"), *args],
            env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-3000:]
        with open(d / f"{name}.json") as f:
            out[name] = json.load(f)
    out["cells"] = {"cells": out["2d"]["cells"] + out["3d"]["cells"],
                    "dp": out["2d"]["dp"], "mp": out["2d"]["mp"]}
    return out


def test_six_smoke_cells_place_and_run(runs):
    recs = runs["cells"]["cells"]
    assert {(r["arch"], r["kind"], r["mesh"]) for r in recs} == {
        ("gemma-2b", "train", "2x2"), ("xlstm-1.3b", "train", "2x2"),
        ("hubert-xlarge", "train", "2x2"),
        ("qwen3-moe-30b-a3b", "decode", "2x2x2"),
        ("zamba2-7b", "prefill", "2x2x2"),
        ("llama-3.2-vision-90b", "prefill", "2x2x2")}
    for r in recs:
        assert r["ok"]
        assert r["memory"]["resident_bytes"]["params"] == \
            r["spec_param_bytes"], r["arch"]
        assert r["hlo_flops_per_chip"] > 0 and r["model_flops_global"] > 0
        assert r["roofline"]["dominant"] in ("compute", "memory",
                                             "collective")
        assert r["collectives"]["total_bytes"] == sum(
            r["collectives"]["operand_bytes"].values())
        assert r["params_total"] == get_smoke_config(r["arch"]).param_count()
        if r["kind"] == "train":
            # f32 momentum: twice a bf16 parameter's bytes, once an f32
            # norm scale's
            res = r["memory"]["resident_bytes"]
            assert res["params"] < res["momentum"] <= 2 * res["params"]
        else:
            assert r["memory"]["resident_bytes"]["decode_state"] > 0 or \
                get_config(r["arch"]).encoder_only


def test_data_parallel_cell_halves_the_flops_per_chip(runs):
    one, two = runs["cells"]["dp"]
    assert two == pytest.approx(one / 2, rel=1e-2)


def test_model_parallel_cell_counts_the_row_parallel_all_reduces(runs):
    # one attention layer a super-block: its output projection and its
    # FFN's down projection are row-parallel, each one all-reduce (the
    # record extrapolates the one- and two-super-block passes); and one
    # for the vocab-parallel embedding lookup
    rec = runs["cells"]["mp"]
    assert rec["collectives"]["counts"]["all-reduce"] == \
        2 * get_smoke_config("gemma-2b").n_superblocks + 1


def test_analytic_memory_and_hbm_equal_the_reference(runs):
    want = runs["jax"]
    assert len(want) == 64
    for w in want:
        mesh = _Mesh(w["axes"])
        cfg, shape = get_config(w["arch"]), SHAPES[w["shape"]]
        assert dryrun.default_microbatches(shape, mesh) == w["mb"] or \
            shape.kind != "train"
        got = dryrun.analytic_memory_gib(cfg, shape, mesh, w["mb"],
                                         fsdp_decode=w["fsdp"])
        assert got == w["mem"], (w["arch"], w["shape"])
        hbm = analytic_hbm_bytes(cfg, shape, mesh.size, 16, w["mb"],
                                 fsdp_decode=w["fsdp"])
        assert hbm == w["hbm"], (w["arch"], w["shape"])


class _Mesh:
    def __init__(self, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)
        self.size = int(np.prod(list(axes.values())))


def test_all_cells_equal_the_reference():
    assert all_cells() == j_all_cells()
    assert len(all_cells()) == 32


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_and_flops_per_token_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_config(arch)
    for active in (False, True):
        assert cfg.param_count(active_only=active) == \
            jcfg.param_count(active_only=active)
    assert cfg.flops_per_token() == jcfg.flops_per_token()


def test_gathered_decode_threshold_is_half_the_card():
    assert dryrun.GATHER_DECODE_BYTES == dryrun.H100_HBM_BYTES / 2 == 40e9
    mesh = _Mesh({"data": 16, "model": 16})
    big = get_config("llama-3.2-vision-90b")
    assert not dryrun.gathered_decode(big, mesh)   # ~11 GB a TP shard
    assert dryrun.gathered_decode(big, _Mesh({"data": 256, "model": 1}))


def test_a_missing_fake_store_raises_naming_the_module(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_fake_pg(name, *a, **kw):
        if name.endswith("fake_pg"):
            raise ImportError(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_fake_pg)
    with pytest.raises(RuntimeError, match="fake_pg"):
        dryrun.install_fake_group(4)

"""Elastic restore in the port (``repro_torch.launch.elastic``) against the
JAX package's forward, after ``tests/test_elastic.py``.

A snapshot of starcoder2-3b's smoke parameters at f32, in the port's
driver format (flat parameter names) and in the JAX package's (its own
``save_checkpoint``, blocks stacked), is restored by ``rendezvous`` onto a
one-rank gloo mesh with FSDP; the forward on the placed DTensors must give
JAX's hidden states within rtol 1e-5 (atol 1e-6 near 0), and the port's
plain forward bit for bit.  The one-rank group is the mesh
module's own and is destroyed after each test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import save_checkpoint as j_save  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402,E501
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed import dtensor as dt  # noqa: E402
from repro_torch.distributed.sharding import (Sharding, P,  # noqa: E402
                                              logical_rules)
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch.elastic import rendezvous, reshard_like  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402


@pytest.fixture
def own_group():
    yield
    mesh_lib.close_host_group()
    assert not torch.distributed.is_initialized()


@pytest.fixture(scope="module")
def reference():
    jcfg = j_smoke("starcoder2-3b").replace(param_dtype="float32")
    params = jlm.init_lm(jcfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0,
                              jcfg.vocab_size)
    h0, _, _ = jlm.forward(jcfg, params, toks, mode="train")
    return dict(params=jax.tree_util.tree_map(np.asarray, params),
                toks=np.asarray(toks), h0=np.asarray(h0, np.float32))


@pytest.mark.parametrize("fmt", ["port", "jax"])
def test_rendezvous_roundtrip(tmp_path, reference, own_group, fmt):
    """Save in one layout, restore onto a one-rank mesh with FSDP: the
    forward equals JAX's (the reshard is value-preserving)."""
    cfg = get_smoke_config("starcoder2-3b").replace(param_dtype="float32")
    if fmt == "jax":
        j_save(str(tmp_path), 1, {"params": reference["params"]})
    else:
        model = tlm.params_from_jax(cfg, reference["params"], device="cpu")
        save_checkpoint(str(tmp_path), 1, {"params": dict(
            model.named_parameters())})
    snap = load_checkpoint(str(tmp_path))
    mesh, params = rendezvous(cfg, snap["params"], data=1, model=1,
                              fsdp=True, device_type="cpu")
    assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == {"data": 1,
                                                          "model": 1}
    assert all(dt.is_dtensor(p) for p in params.parameters())
    toks = torch.from_numpy(reference["toks"].copy())
    with dt.mesh_mode(mesh, logical_rules(mesh)), torch.no_grad():
        h1, _, _ = tlm.forward(cfg, params, toks)
    h1 = dt.gather_full(h1)
    # f32 across the two packages: 1e-5 relative, 1e-6 absolute where the
    # hidden states pass near 0 (measured: 9.5e-7)
    np.testing.assert_allclose(h1.numpy(), reference["h0"], rtol=1e-5,
                               atol=1e-6)
    # and the port's plain forward on the same values, bit for bit
    plain = tlm.params_from_jax(cfg, reference["params"], device="cpu")
    with torch.no_grad():
        h_plain, _, _ = tlm.forward(cfg, plain, toks)
    assert torch.equal(h1, h_plain)


def test_rendezvous_clamps_to_the_ranks_there_are(own_group):
    cfg = get_smoke_config("gemma-2b")
    model = tlm.init_lm(cfg, None, "cpu")
    mesh, params = rendezvous(cfg, {n: p.detach() for n, p in
                                    model.named_parameters()},
                              data=4, model=2, device_type="cpu")
    assert tuple(mesh.shape) == (1, 1)
    for (n, p), (_, q) in zip(model.named_parameters(),
                              params.named_parameters()):
        assert torch.equal(dt.gather_full(q), p.detach()), n


def test_reshard_like_moves_leaves(own_group):
    mesh = mesh_lib.make_host_mesh(1, 1, "cpu")
    tree = {"a": np.ones((4, 4), np.float32),
            "b": [torch.arange(6.0).reshape(2, 3)]}
    sh = {"a": Sharding(mesh, P("data", "model")),
          "b": [Sharding(mesh, P())]}
    out = reshard_like(tree, sh)
    assert dt.is_dtensor(out["a"]) and dt.is_dtensor(out["b"][0])
    np.testing.assert_array_equal(dt.gather_full(out["a"]).numpy(),
                                  tree["a"])
    assert torch.equal(dt.gather_full(out["b"][0]), tree["b"][0])
    again = reshard_like(out, sh)        # a DTensor leaf goes through too
    assert torch.equal(dt.gather_full(again["b"][0]), tree["b"][0])


def test_replicate_and_shard_rows_place_on_the_mesh(own_group):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.core import distributed as dist_lib
    mesh = mesh_lib.make_host_mesh(1, 1, "cpu")
    x = torch.arange(12.0).reshape(6, 2)
    rep = dist_lib.replicate(mesh, x)
    rows = dist_lib.shard_rows(mesh, x, axis="data")
    assert tuple(rep.placements) == (Replicate(), Replicate())
    assert tuple(rows.placements) == (Shard(0), Replicate())
    for t in (rep, rows):
        assert torch.equal(dt.gather_full(t), x)

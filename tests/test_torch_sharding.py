"""The port's partition rules (``repro_torch.distributed.sharding``,
``repro_torch.launch.specs``) against the JAX package's, and its
placements against JAX's block order.

The rules are pure functions of names and shapes: ``fit_spec`` over
hypothesis draws, ``param_specs`` for every leaf of the ten smoke archs
(a block parameter against the JAX spec of its stacked leaf without the
leading ``None``), ``batch_shardings``, ``state_shardings`` and
``logical_rules`` on the duck-typed ``FakeMesh(pod=2, data=16,
model=16)`` of ``tests/test_sharding.py``.  The placements are held on a
fake process group of (2, 4, 4) ranks: each rank's local block of a
DTensor must be the block JAX gives that device (row-major over an
entry's axes).  The per-device parameter bytes of the ten full configs on
16 x 16 with FSDP are reckoned from both packages' specs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

import jax  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import SHAPES, get_config, get_smoke_config  # noqa: E402,E501
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402


class FakeMesh:
    """Duck-typed mesh: the rules read ``axis_names`` and ``shape``."""

    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)


MESH = FakeMesh(pod=2, data=16, model=16)
MESHES = {"2x16x16": MESH, "16x16": FakeMesh(data=16, model=16),
          "4x2": FakeMesh(data=4, model=2)}

_ENTRY = st.sampled_from([None, "pod", "data", "model", ("pod", "data"),
                          ("data", "model"), ("pod", "data", "model")])


@given(dims=st.lists(st.integers(1, 96), min_size=1, max_size=4),
       entries=st.lists(_ENTRY, min_size=0, max_size=4),
       mesh=st.sampled_from(sorted(MESHES)))
@settings(max_examples=200, deadline=None)
def test_fit_spec_equals_jax(dims, entries, mesh):
    m = MESHES[mesh]
    got = tsh.fit_spec(tuple(dims), tsh.P(*entries), m)
    want = jsh.fit_spec(tuple(dims), JP(*entries), m)
    assert tuple(got) == tuple(want)


def _jax_leaf(tree, name):
    """The JAX leaf of a port parameter name and whether it is stacked."""
    parts = name.split(".")
    stacked = parts[0] == "blocks"
    if stacked:
        parts = [parts[0]] + parts[2:]
    node = tree
    for p in parts:
        node = node[p]
    return node, stacked


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_jax_on_every_leaf(arch, fsdp):
    jcfg = j_smoke(arch)
    jparams = jax.eval_shape(lambda: jlm.init_lm(jcfg, jax.random.PRNGKey(0)))
    jspec_tree = jsh.param_specs(jcfg, jparams, fsdp=fsdp)
    cfg = get_smoke_config(arch)
    model = tlm.init_lm(cfg, None, "meta")
    specs = tsh.param_specs(cfg, model, fsdp=fsdp)
    n_stacked = 0
    for name, t in model.named_parameters():
        jspec, stacked = _jax_leaf(jspec_tree, name)
        jleaf, _ = _jax_leaf(jparams, name)
        want = tuple(jspec)[1:] if stacked else tuple(jspec)
        assert tuple(specs[name]) == want, name
        shape = tuple(jleaf.shape[1:] if stacked else jleaf.shape)
        assert tuple(t.shape) == shape, name
        fitted = tsh.fit_spec(shape, specs[name], MESH)
        jfit = jsh.fit_spec(tuple(jleaf.shape), jspec, MESH)
        assert tuple(fitted) == (tuple(jfit)[1:] if stacked
                                 else tuple(jfit)), name
        n_stacked += stacked
    n_leaves = len(jax.tree_util.tree_leaves(jparams))
    n_block_leaves = len(jax.tree_util.tree_leaves(jparams.get("blocks",
                                                               {})))
    assert n_stacked == n_block_leaves * cfg.n_superblocks
    assert len(specs) == n_leaves - n_block_leaves + n_stacked


def test_logical_rules_equal_jax():
    for m in MESHES.values():
        got, want = tsh.logical_rules(m), jsh.logical_rules(m)
        assert {k: tuple(v) for k, v in got.items()} == {
            k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("arch", ["gemma-2b", "llama-3.2-vision-90b",
                                  "hubert-xlarge"])
def test_batch_shardings_equal_jax(monkeypatch, arch, seq_shard):
    monkeypatch.setattr(jspecs, "NamedSharding", lambda mesh, spec: spec)
    for shape_name in ("train_4k", "decode_32k", "long_500k"):
        jb = jspecs.input_specs(j_config(arch), J_SHAPES[shape_name])
        tb = tspecs.input_specs(get_config(arch), SHAPES[shape_name])
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert tuple(tb[k].shape) == tuple(jb[k].shape), k
            assert str(tb[k].dtype).split(".")[-1] == jb[k].dtype.name, k
        for m in MESHES.values():
            want = jspecs.batch_shardings(m, jb, seq_shard=seq_shard)
            got = tspecs.batch_shardings(m, tb, seq_shard=seq_shard)
            assert {k: tuple(s.spec) for k, s in got.items()} == {
                k: tuple(v) for k, v in want.items()}


def _state_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _state_leaves(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _state_leaves(v, prefix + (str(i),))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if not get_smoke_config(a).encoder_only])
def test_state_shardings_equal_jax(monkeypatch, arch):
    monkeypatch.setattr(jspecs, "NamedSharding", lambda mesh, spec: spec)
    for shape_name, seq_shard in (("decode_32k", False),
                                  ("long_500k", True)):
        jcfg, cfg = j_smoke(arch), get_smoke_config(arch)
        shape = SHAPES[shape_name]
        small = type(shape)(shape.name, 64, shape.global_batch, shape.kind)
        jstate = jax.eval_shape(lambda: jlm.init_decode_state(
            jcfg, small.global_batch, small.seq_len))
        tstate = tspecs.decode_state_specs(cfg, small)
        for m in MESHES.values():
            want = jspecs.state_shardings(jcfg, m, jstate,
                                          seq_shard=seq_shard)
            got = tspecs.state_shardings(cfg, m, tstate,
                                         seq_shard=seq_shard)
            leaves = list(_state_leaves(got))
            assert leaves
            for path, sh in leaves:
                stacked = path[0] == "blocks"
                jpath = (path[:1] + path[2:]) if stacked else path
                node = want
                for p in jpath:
                    node = node[p]
                assert tuple(sh.spec) == (tuple(node)[1:] if stacked
                                          else tuple(node)), path


def _local_bytes(spec, shape, itemsize, mesh):
    n = int(np.prod(shape))
    for entry in spec:
        if entry is not None:
            n //= tsh.axis_size(mesh, entry)
    return n * itemsize


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_param_bytes_per_device_equal_jax(arch):
    """Per-device parameter bytes on 16 x 16 with FSDP: the port's fitted
    specs over its meta parameters against the JAX specs over
    ``jax.eval_shape(init_lm)``."""
    mesh = MESHES["16x16"]
    jcfg = j_config(arch)
    jparams = jax.eval_shape(lambda: jlm.init_lm(jcfg, jax.random.PRNGKey(0)))
    jspec = jsh.param_specs(jcfg, jparams, fsdp=True)
    want = sum(
        _local_bytes(jsh.fit_spec(leaf.shape, spec, mesh), leaf.shape,
                     leaf.dtype.itemsize, mesh)
        for leaf, spec in zip(jax.tree_util.tree_leaves(jparams),
                              jax.tree_util.tree_leaves(
                                  jspec, is_leaf=lambda s: isinstance(s,
                                                                      JP))))
    cfg = get_config(arch)
    model = tspecs.param_specs_shapes(cfg)
    shardings = tsh.param_shardings(cfg, model, mesh, fsdp=True)
    got = sum(_local_bytes(shardings[n].spec, tuple(p.shape),
                           p.element_size(), mesh)
              for n, p in model.named_parameters())
    assert got == want


# ---------------------------------------------------------------------------
# placements on a fake (2, 4, 4) process group, rank by rank
# ---------------------------------------------------------------------------

_CASES = [((8, 12), tsh.P(("pod", "data"), "model")),
          ((16, 4, 6), tsh.P(("pod", "data", "model"))),
          ((6, 8), tsh.P(None, ("data", "model"))),
          ((4, 8, 2), tsh.P("model", "data", "pod")),
          ((12, 16), tsh.P("pod", ("data", "model")))]


def _jax_block(arr, spec, coords, mesh_axes, sizes):
    """The block of ``arr`` JAX gives the device at ``coords``: each
    entry's axes index the blocks of its dim row-major."""
    idx = []
    for d, entry in enumerate(tuple(spec) + (None,) * arr.ndim):
        if d >= arr.ndim:
            break
        if entry is None:
            idx.append(slice(None))
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        block, count = 0, 1
        for n in names:
            block = block * sizes[n] + coords[mesh_axes.index(n)]
            count *= sizes[n]
        size = arr.shape[d] // count
        idx.append(slice(block * size, (block + 1) * size))
    return arr[tuple(idx)]


def test_placements_follow_jax_block_order_on_every_rank():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    axes, shape = ("pod", "data", "model"), (2, 4, 4)
    sizes = dict(zip(axes, shape))
    for rank in range(32):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=32)
        try:
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
            coords = np.unravel_index(rank, shape)
            for dims, spec in _CASES:
                full = torch.arange(int(np.prod(dims))).reshape(dims)
                spec = tsh.fit_spec(dims, spec, mesh)
                local = distribute_tensor(full, mesh,
                                          tsh.placements(spec, mesh),
                                          src_data_rank=None).to_local()
                want = _jax_block(full.numpy(), spec, coords, axes, sizes)
                np.testing.assert_array_equal(local.numpy(), want,
                                              err_msg=f"{rank} {spec}")
        finally:
            dist.destroy_process_group()
    assert not dist.is_initialized()


def test_placements_refuse_axes_out_of_mesh_order():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        with pytest.raises(ValueError, match="axis order"):
            tsh.placements(tsh.P(("model", "data")), mesh)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_over_the_fake_group(multi_pod):
    """The dry run's meshes: ``make_production_mesh`` over the fake group
    of 256 or 512 ranks that ``install_fake_group`` installs."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    dryrun.install_fake_group(512 if multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        want = {"pod": 2, "data": 16, "model": 16} if multi_pod else {
            "data": 16, "model": 16}
        assert tsh.axis_sizes(mesh) == want
        assert mesh.device_type == "cpu"
    finally:
        dist.destroy_process_group()

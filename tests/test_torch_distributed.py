"""The port's rank- and device-parallel selection
(``repro_torch/core/distributed.py``) against the JAX package's, on the
CPU.

Same numpy inputs into both packages; the standard is ``_assert_parity`` of
``tests/test_omp_parity.py`` (indices and masks equal, weights and ``err``
to rtol 1e-4 / atol 1e-5).  The cases mirror ``tests/test_distributed.py``
(the rank-parallel OMP on one rank against JAX's one-device mesh, and on
four ranks, here ``torch.distributed`` over gloo in a subprocess, against
the single solver), the pmap chunk scorer of ``tests/test_streaming.py``
and the pmap gain scan of ``tests/test_greedy_parity.py``, each on the one
local CPU device and on three patched ones.  CRAIG pools lie on a 1/8 grid,
where every distance is exact in f32 in both packages.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import distributed as jdist  # noqa: E402
from repro.core import greedy as jgreedy  # noqa: E402
from repro.core import streaming as jstream  # noqa: E402
from repro.core.omp import omp_select as j_omp  # noqa: E402
from repro.core.omp import omp_select_dense as j_dense  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core import greedy as tgreedy  # noqa: E402
from repro_torch.core import omp as tomp  # noqa: E402
from repro_torch.core import streaming as tstream  # noqa: E402

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pool(seed, n, d):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_parity(got, want, what):
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]),
                                  err_msg=f"{what}: indices differ")
    np.testing.assert_array_equal(_np(got[2]), _np(want[2]),
                                  err_msg=f"{what}: masks differ")
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=1e-4,
                               atol=1e-5, err_msg=f"{what}: weights differ")
    np.testing.assert_allclose(_np(got[3]), _np(want[3]), rtol=1e-4,
                               atol=1e-5, err_msg=f"{what}: err differs")


def _devices(monkeypatch, count):
    if count > 1:
        monkeypatch.setattr(tdist, "local_devices",
                            lambda dev: [torch.device(CPU)] * count)


# ---------------------------------------------------------------------------
# rank-parallel OMP
# ---------------------------------------------------------------------------

def test_sharded_omp_single_rank_matches_jax_mesh():
    mesh = make_host_mesh(data=1, model=1)
    g = _pool(0, 96, 32)
    t = g[:9].sum(axis=0)
    got = tdist.sharded_omp_select(torch.from_numpy(g), torch.from_numpy(t),
                                   9, lam=0.3)
    want = jdist.sharded_omp_select(mesh, jnp.asarray(g), jnp.asarray(t),
                                    k=9, lam=0.3)
    _assert_parity(got, want, "sharded OMP, one rank, port vs JAX")
    i1, _, _, e1 = tomp.omp_select(torch.from_numpy(g), torch.from_numpy(t),
                                   9, lam=0.3)
    np.testing.assert_array_equal(np.sort(_np(i1)), np.sort(_np(got.indices)))
    np.testing.assert_allclose(float(e1), float(got.err), rtol=1e-5)


def test_sharded_gradmatch_pb_single_rank():
    mesh = make_host_mesh(data=1, model=1)
    g = _pool(1, 64, 16)
    got = tdist.sharded_gradmatch_pb(torch.from_numpy(g), 4, 4)
    want = jdist.sharded_gradmatch_pb(mesh, jnp.asarray(g), batch_size=4,
                                      k_batches=4)
    _assert_parity(got, want, "sharded GRAD-MATCHPB, one rank, port vs JAX")
    assert int(got.mask.sum()) == 4
    assert abs(float(got.weights.sum()) - 1.0) < 1e-4


_RANKS = textwrap.dedent("""
    import socket
    import sys

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, world, port, out):
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
        from repro_torch.core import distributed as D
        g = np.random.default_rng(0).standard_normal((128, 48)).astype(
            np.float32)
        t = g[:12].sum(axis=0)
        sel = D.sharded_omp_select(torch.from_numpy(g), torch.from_numpy(t),
                                   12, group=dist.group.WORLD, lam=0.3)
        pb = D.sharded_gradmatch_pb(torch.from_numpy(g), 4, 6,
                                    group=dist.group.WORLD)
        np.savez(f"{out}/rank{rank}.npz",
                 **{f"{n}{i}": np.asarray(x) for n, r in (("s", sel),
                                                          ("p", pb))
                    for i, x in enumerate(r[:4])})
        dist.destroy_process_group()

    if __name__ == "__main__":
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        mp.spawn(run, args=(4, port, sys.argv[1]), nprocs=4)
        print("OK4")
""")


def test_sharded_omp_4_ranks_gloo_subprocess(tmp_path):
    """Four ranks over gloo: every rank returns the same selection, the
    one-rank solve's, and the single solver's set (JAX's and the port's)."""
    script = tmp_path / "ranks.py"
    script.write_text(_RANKS)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, str(script), str(tmp_path)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "OK4" in r.stdout
    ranks = [np.load(tmp_path / f"rank{i}.npz") for i in range(4)]
    for other in ranks[1:]:
        for key in ranks[0].files:
            np.testing.assert_array_equal(other[key], ranks[0][key])
    sel = [ranks[0][f"s{i}"] for i in range(4)]
    pb = [ranks[0][f"p{i}"] for i in range(4)]

    g = _pool(0, 128, 48)
    t = g[:12].sum(axis=0)
    one = tdist.sharded_omp_select(torch.from_numpy(g), torch.from_numpy(t),
                                   12, lam=0.3)
    _assert_parity(sel, one, "four ranks vs one rank")
    _assert_parity(pb, tdist.sharded_gradmatch_pb(torch.from_numpy(g), 4, 6),
                   "GRAD-MATCHPB, four ranks vs one rank")
    for name, (i1, w1, _, e1) in (
            ("port", tomp.omp_select(torch.from_numpy(g),
                                     torch.from_numpy(t), 12, lam=0.3)),
            ("JAX", j_omp(jnp.asarray(g), jnp.asarray(t), k=12, lam=0.3))):
        assert sorted(_np(i1).tolist()) == sorted(sel[0].tolist()), name
        np.testing.assert_allclose(float(e1), float(sel[3]), rtol=1e-4)
        np.testing.assert_allclose(np.sort(_np(w1)),
                                   np.sort(sel[1] * float(_np(w1).sum())),
                                   rtol=1e-3, atol=1e-5)


# ---------------------------------------------------------------------------
# device-parallel chunk scorer and gain scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("devices", [1, 3])
def test_pmap_chunk_scorer_parity(monkeypatch, devices):
    """The device-parallel chunk scorer is a drop-in for the local one:
    the dense oracle's selection, and the JAX engine's statistics under
    JAX's pmap scorer."""
    _devices(monkeypatch, devices)
    g = _pool(8, 160, 16)
    target = g.sum(axis=0)
    out = tstream.omp_select_streaming(
        tstream.array_chunks(g, 48), target, 20, lam=0.2, buffer_size=32,
        score_chunk_fn=tdist.pmap_chunk_topm, device=CPU)
    ref = j_dense(jnp.asarray(g), jnp.asarray(target), 20, lam=0.2)
    _assert_parity(out, ref, f"pmap chunk scorer on {devices} devices")
    want = jstream.omp_select_streaming(
        jstream.array_chunks(g, 48), jnp.asarray(target), 20, lam=0.2,
        buffer_size=32, score_chunk_fn=jdist.pmap_chunk_topm)
    want_stats = vars(want.stats)
    assert {k: v for k, v in vars(out.stats).items()
            if k in want_stats} == want_stats


@pytest.mark.parametrize("devices,n,k,masked", [(1, 96, 12, False),
                                                (3, 96, 12, False),
                                                (3, 96, 12, True),
                                                (3, 10, 12, False)])
def test_pmap_gain_scan_matches_dense(monkeypatch, devices, n, k, masked):
    """The sharded per-round gain scan elects the dense oracle's medoids
    under a shared L_max: ragged shards, a masked pool, k past the pool."""
    _devices(monkeypatch, devices)
    g = (np.round(_pool(15, n, 12) * 8) / 8).astype(np.float32)
    valid = np.ones(n, bool)
    if masked:
        valid[::5] = False
    lm = float(jgreedy.default_l_max(jnp.asarray(g)))
    want = jgreedy.fl_greedy(jnp.asarray(g), k, method="dense", l_max=lm,
                             valid=jnp.asarray(valid))
    got = tdist.fl_greedy_pmap(torch.from_numpy(g), k,
                               valid=torch.from_numpy(valid), l_max=lm)
    np.testing.assert_array_equal(_np(got.indices), _np(want.indices))
    np.testing.assert_array_equal(_np(got.mask), _np(want.mask))
    np.testing.assert_allclose(_np(got.gains), _np(want.gains), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(got.cover), _np(want.cover), rtol=1e-5,
                               atol=1e-5)
    dense = tgreedy.fl_greedy(torch.from_numpy(g), k, method="dense",
                              l_max=lm, valid=torch.from_numpy(valid))
    assert torch.equal(got.indices, dense.indices)
    assert got.stats.rounds == got.stats.rescans == min(k, int(valid.sum()))

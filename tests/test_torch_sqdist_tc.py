"""The tensor-core ``sqdist``'s arithmetic (3xTF32) and its mirrored
layout, emulated in torch on the CPU, against the JAX package.

``csrc/sqdist_tc.cu`` splits each f32 x into hi and lo TF32 halves
(``fl_gain.split_tf32``), forms every dot product as lo.hi + hi.lo + hi.hi
on the tensor cores (``fl_gain.dot_3xtf32``; a bf16 input is its own hi, lo
0), and, when a is b, computes each unordered pair once and writes it to
both places, its diagonal (where the expanded form is all rounding) by the
FFMA kernel's own dot. ``sqdist.emulate_sqdist_tc`` runs the whole function
with that arithmetic, and ``sqdist.block_tiles`` / ``box_kind`` mirror how
the kernel walks and writes its tiles. These tests hold the emulation
against ``repro/kernels/ref.py`` and the Pallas kernel run by the Pallas
interpreter on seeded numpy inputs, its mirrored build's symmetry, resident
lazy CRAIG on it against the JAX package, and the tile walk's cover of the
output.

Tolerances.  On pools rounded to multiples of 1/8 every product and sum is
exact in f32, for both packages: the results are equal bit for bit.  On
raw floats the expanded form ``|a_i|^2 + |b_j|^2 - 2 a_i.b_j`` cancels two
terms of size ``|a_i|^2 + |b_j|^2`` and keeps their rounding: both packages
round them at f32 (a few ulp of that size; 3.9e-7 of it measured here), so
the tolerance is 4e-6 of ``|a_i|^2 + |b_j|^2``, about 32 ulp.  After the
square root in CRAIG's similarity that is the ~sqrt(eps)|g| noise near
distance 0 (ROADMAP §3).  The kernel itself runs on the card
(``test_torch_kernels_cuda.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import craig as jcraig  # noqa: E402
from repro.core import greedy as jg  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.sqdist import sqdist as pallas_sqdist  # noqa: E402
from repro_torch.core import craig as tcraig  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import sqdist as sq  # noqa: E402

SHAPES = [(1, 1, 1), (9, 17, 3), (129, 65, 65), (200, 90, 10),
          (64, 64, 80), (130, 129, 130)]
RAW_TOL = 4e-6


def _pools(seed, n, m, d, grid, dtype="float32"):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, d))
    b = rng.standard_normal((m, d))
    if grid:
        a, b = np.round(a * 8) / 8, np.round(b * 8) / 8
    a, b = a.astype(np.float32), b.astype(np.float32)
    ta = torch.from_numpy(a).to(getattr(torch, dtype))
    tb = torch.from_numpy(b).to(getattr(torch, dtype))
    ja = jnp.asarray(a).astype(getattr(jnp, dtype))
    jb = jnp.asarray(b).astype(getattr(jnp, dtype))
    return ta, tb, ja, jb


def _jax(ja, jb):
    return (np.asarray(jref.sqdist_ref(ja, jb)),
            np.asarray(pallas_sqdist(ja, jb, interpret=True)))


@pytest.mark.parametrize("n,m,d", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_sqdist_equals_jax_on_a_grid(n, m, d, dtype):
    """1/8-grid pools (exact in bf16 too): the emulation equals JAX's
    reference and Pallas kernel bit for bit, and so does its mirrored
    build of a against itself (the exact distances are symmetric)."""
    ta, tb, ja, jb = _pools(n * 7 + m + d, n, m, d, grid=True, dtype=dtype)
    got = sq.emulate_sqdist_tc(ta, tb).numpy()
    for want in _jax(ja, jb):
        np.testing.assert_array_equal(got, want)
    mirrored = sq.emulate_sqdist_tc(ta, ta).numpy()
    for want in _jax(ja, ja):
        np.testing.assert_array_equal(mirrored, want)
    np.testing.assert_array_equal(mirrored, ref.sqdist_ref(ta, ta).numpy())


@pytest.mark.parametrize("n,m,d", SHAPES)
def test_emulated_sqdist_near_jax_on_raw_floats(n, m, d):
    """Raw floats: within 4e-6 of |a_i|^2 + |b_j|^2 of JAX's reference and
    Pallas kernel (the expanded form's rounding), never negative."""
    ta, tb, ja, jb = _pools(n + 3 * m + d, n, m, d, grid=False)
    got = sq.emulate_sqdist_tc(ta, tb).numpy().astype(np.float64)
    a64, b64 = ta.double().numpy(), tb.double().numpy()
    scale = (a64 ** 2).sum(1)[:, None] + (b64 ** 2).sum(1)[None, :]
    for want in _jax(ja, jb):
        assert np.all(np.abs(got - want) <= RAW_TOL * scale)
    assert got.min() >= 0.0


@pytest.mark.parametrize("n,d", [(1, 5), (127, 65), (129, 65), (300, 10),
                                 (257, 130)])
def test_emulated_mirror_is_bitwise_symmetric(n, d):
    """sqdist(a, a) as "tc-sym" builds it: symmetric bit for bit, above
    the diagonal the unmirrored emulation's, on it the FFMA kernel's dot
    (fmaf over k in order), near the plain version."""
    rng = np.random.default_rng(n + d)
    a = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    s = sq.emulate_sqdist_tc(a, a)
    assert torch.equal(s, s.T)
    full = sq.emulate_sqdist_tc(a, a, mirror=False)
    assert torch.equal(s.triu(1), full.triu(1))
    norms = a.square().sum(1)
    dots = [np.float32(0)] * n
    for i in range(n):
        for x in a[i].numpy():
            dots[i] = np.float32(np.float64(dots[i]) + np.float64(x) ** 2)
    want = (norms + norms - 2 * torch.tensor(dots)).clamp_min(0)
    assert torch.equal(s.diagonal(), want)
    scale = 2 * (a.double() ** 2).sum(1).max()
    assert float((s.double() - ref.sqdist_ref(a, a).double()).abs().max()
                 ) <= RAW_TOL * float(scale)


def test_resident_lazy_craig_on_emulated_sqdist_picks_as_jax():
    """Resident lazy CRAIG over a similarity built by the emulated
    tensor-core sqdist picks what the JAX package's resident lazy CRAIG
    picks (its similarity built by its own sqdist), on a 1/8-grid pool:
    the same indices, weights and err."""
    rng = np.random.default_rng(11)
    g = (np.round(rng.standard_normal((400, 14)) * 8) / 8).astype(np.float32)
    lm = float(jg.default_l_max(jnp.asarray(g)))
    calls = []

    def emulated(a, b):
        calls.append(a.shape)
        return sq.emulate_sqdist_tc(a, b)

    port = tcraig.craig(torch.from_numpy(g), 60, method="lazy", l_max=lm,
                        dist_fn=emulated, on_the_fly=False)
    want = jcraig.craig(jnp.asarray(g), 60, method="lazy", l_max=lm,
                        dist_fn=jref.sqdist_ref)
    assert calls == [(400, 14)]
    np.testing.assert_array_equal(port.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_allclose(port.weights.numpy(), np.asarray(want.weights),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(port.err), float(want.err), rtol=1e-5)


def _walk(n, m, sym, grid):
    """Run the kernel's tile walk and box writes over an (n, m) output:
    for each output element, the (row of a, row of b) whose product was
    written there, or (-1, -1); and how many times each was written."""
    src = np.full((n, m, 2), -1, dtype=np.int64)
    hits = np.zeros((n, m), dtype=np.int64)

    def put(rows, cols, sr, sc):
        keep = (rows < n) & (cols < m)
        rows, cols, sr, sc = rows[keep], cols[keep], sr[keep], sc[keep]
        np.add.at(hits, (rows, cols), 1)
        src[rows, cols, 0] = sr
        src[rows, cols, 1] = sc

    r, c = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    for b in range(grid):
        for I, J in sq.block_tiles(b, grid, n, m, sym):
            for bi in range(4):
                for bj in range(4):
                    kind = sq.box_kind(sym, I == J, bi, bj)
                    gr = I * 128 + 32 * bi + r        # the product's a row
                    gc = J * 128 + 32 * bj + c        # and its b row
                    if kind in (1, 2):
                        put(gr, gc, gr, gc)
                    if kind == 2:
                        put(gc, gr, gr, gc)
                    if kind == 3:
                        up = r <= c
                        put(gr[up], gc[up], gr[up], gc[up])
                        low = r < c
                        put(gc[low], gr[low], gr[low], gc[low])
    return src, hits


@pytest.mark.parametrize("n", [1, 31, 127, 128, 129, 300])
@pytest.mark.parametrize("grid", [1, 3, 132])
def test_mirrored_tiles_write_each_pair_once_to_both_places(n, grid):
    """On "tc-sym" the blocks' tile ranges cover the tiles I <= J once
    each; every element of the (n, n) output is written exactly once, from
    the product of its own pair (i, j) or of (j, i) with i <= j, so element
    (i, j) and element (j, i) hold the same computed value."""
    ti = -(-n // 128)
    tiles = [t for b in range(grid)
             for t in sq.block_tiles(b, grid, n, n, True)]
    assert sorted(tiles) == [(i, j) for i in range(ti) for j in range(i, ti)]
    src, hits = _walk(n, n, True, grid)
    assert np.all(hits == 1)
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    lo, hi = np.minimum(i, j), np.maximum(i, j)
    np.testing.assert_array_equal(src[..., 0], lo)
    np.testing.assert_array_equal(src[..., 1], hi)


@pytest.mark.parametrize("n,m", [(1, 1), (9, 17), (129, 65), (300, 257),
                                 (257, 300)])
@pytest.mark.parametrize("grid", [1, 5])
def test_full_grid_tiles_write_each_element_once(n, m, grid):
    """On "tc" (a is not b) every tile is computed once and every element
    written once, from its own product; ragged edges are clipped."""
    tj = -(-m // 128)
    tiles = [t for b in range(grid)
             for t in sq.block_tiles(b, grid, n, m, False)]
    assert tiles == [(i, j) for i in range(-(-n // 128)) for j in range(tj)]
    src, hits = _walk(n, m, False, grid)
    assert np.all(hits == 1)
    i, j = np.meshgrid(np.arange(n), np.arange(m), indexing="ij")
    np.testing.assert_array_equal(src[..., 0], i)
    np.testing.assert_array_equal(src[..., 1], j)

"""The tensor-core ``fl_gain_argmax_otf``'s arithmetic (3xTF32), emulated in
torch on the CPU, against the JAX package.

``csrc/fl_gain_tc.cu`` splits each f32 x into hi = tf32_rna(x) and
lo = tf32_rna(x - hi) and forms every dot product as lo.hi + hi.lo + hi.hi
on the tensor cores.  ``repro_torch.kernels.fl_gain`` documents that
arithmetic as ``tf32_rna``, ``split_tf32`` and ``dot_3xtf32``, and
``emulate_otf_tc`` runs the whole scan with it.  These tests hold the
rounding (ties away from zero, the split exact for values of at most 22
significant bits), the dot's error against f64, and the emulated scan
against ``repro/kernels/ref.py`` and the Pallas kernel run by the Pallas
interpreter, on seeded numpy inputs.

Tolerances.  On pools rounded to multiples of 1/8 every distance is exact
in f32 for both packages (hi is the value and lo is 0): the gains agree to
1e-6 of the largest and the emulated scan equals the port's plain version
bit for bit.  On raw floats each column's own term is rounding noise of
~sqrt(eps)|g_j| (the expanded distance near 0, ROADMAP §3), which the
port's own plain version and JAX's already round ~1e-5 of the largest gain
apart: there the on-the-fly tolerance of ``test_torch_kernels.py``, 1e-3.
The kernel itself runs on the card (``test_torch_kernels_cuda.py``).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import greedy as jg  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.fl_gain import (  # noqa: E402
    fl_gain_argmax_otf as pallas_fl_gain_argmax_otf)
from repro_torch.core import greedy as tg  # noqa: E402
from repro_torch.kernels import fl_gain as fl  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def _rna_reference(x: float) -> float:
    """A normal f32 rounded to 11 significant bits, ties away from zero,
    by exact arithmetic on its significand."""
    m, e = math.frexp(x)            # x = m 2^e, 0.5 <= |m| < 1
    scaled = abs(m) * 2.0 ** 11     # exact: m has at most 24 bits
    r = math.floor(scaled + 0.5)    # halves go up: away from zero
    return math.copysign(math.ldexp(r, e - 11), x)


def test_tf32_rna_ties_away_from_zero():
    """Hand-picked values: exact halves go away from zero, either side of
    a half go to the nearest, zeros keep their sign."""
    cases = [(1 + 2.0 ** -11, 1 + 2.0 ** -10),
             (1 + 3 * 2.0 ** -11, 1 + 2.0 ** -9),
             (-(1 + 2.0 ** -11), -(1 + 2.0 ** -10)),
             (1 + 2.0 ** -11 - 2.0 ** -23, 1.0),
             (1 + 2.0 ** -11 + 2.0 ** -23, 1 + 2.0 ** -10),
             (-(3 + 2.0 ** -10), -(3 + 2.0 ** -9)),
             (2.0 ** -120 * (1 + 2.0 ** -11), 2.0 ** -120 * (1 + 2.0 ** -10)),
             (0.75, 0.75), (0.0, 0.0), (-0.0, -0.0)]
    x = torch.tensor([c[0] for c in cases], dtype=torch.float32)
    got = fl.tf32_rna(x)
    want = torch.tensor([c[1] for c in cases], dtype=torch.float32)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    rng = np.random.default_rng(0)
    v = (rng.standard_normal(4000) * np.exp(rng.uniform(-40, 40, 4000))
         ).astype(np.float32)
    got = fl.tf32_rna(torch.from_numpy(v)).numpy()
    want = np.array([_rna_reference(float(a)) for a in v], np.float32)
    np.testing.assert_array_equal(got, want)
    assert not (got.view(np.int32) & 0x1FFF).any()


def test_split_is_exact_up_to_22_bits():
    """hi + lo == x for every value of at most 22 significant bits; both
    halves are TF32 (their low 13 bits zero); on raw floats hi + lo keeps
    x to 2^-22 of |x|."""
    rng = np.random.default_rng(1)
    sig = rng.integers(1, 2 ** 22, 5000) * rng.choice([-1, 1], 5000)
    x = torch.from_numpy(np.ldexp(sig.astype(np.float64),
                                  rng.integers(-60, 40, 5000)).astype(
                                      np.float32))
    hi, lo = fl.split_tf32(x)
    assert torch.equal(hi + lo, x)
    for half in (hi, lo):
        assert not bool((half.view(torch.int32) & 0x1FFF).any())
    raw = torch.from_numpy(rng.standard_normal(5000).astype(np.float32))
    hi, lo = fl.split_tf32(raw)
    assert bool(((hi.double() + lo.double() - raw.double()).abs()
                 <= 2.0 ** -22 * raw.double().abs()).all())


def test_dot_3xtf32_keeps_f32_grade():
    """Against an f64 dot of the same f32 rows the three passes are off by
    at most ~2^-21 of sum |a_k b_k| (lo.lo dropped, lo rounded) plus the
    final f32 rounding."""
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((50, 65)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((70, 65)).astype(np.float32))
    got = fl.dot_3xtf32(a, b).double()
    want = a.double() @ b.double().T
    scale = a.double().abs() @ b.double().abs().T
    assert bool(((got - want).abs()
                 <= 2.0 ** -21 * scale + 2.0 ** -24 * want.abs()).all())
    # a 1/8 grid: exact
    g = torch.from_numpy((np.round(rng.standard_normal((40, 30)) * 8) / 8
                          ).astype(np.float32))
    assert torch.equal(fl.dot_3xtf32(g, g), g @ g.T)


def _case(seed, n, d, grid):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, d))
    if grid:
        g = np.round(g * 8) / 8
    g = g.astype(np.float32)
    sq = (g.astype(np.float64) ** 2).sum(1)
    dist = np.sqrt(np.maximum(sq[:, None] + sq[None, :]
                              - 2.0 * g.astype(np.float64) @ g.T, 0))
    lm = np.float32(dist.max())
    cover = np.abs(rng.standard_normal(n)).astype(np.float32)
    mask = rng.random(n) < 0.7
    rok = np.arange(n) % 3 != 1
    return g, cover, rok, mask, lm


def _jax_scans(g, cover, rok, mask, lm):
    jargs = (jnp.asarray(g), jnp.asarray(cover), jnp.asarray(rok),
             jnp.asarray(mask), jnp.asarray(lm))
    return (jref.fl_gain_argmax_otf_ref(*jargs),
            pallas_fl_gain_argmax_otf(*jargs, interpret=True))


SHAPES = [(129, 65), (300, 10), (200, 1), (200, 7), (200, 72), (200, 73)]


@pytest.mark.parametrize("n,d", SHAPES)
def test_emulated_scan_matches_jax_on_a_grid(n, d):
    """1/8-grid pools: gains within 1e-6 of the largest of JAX's reference
    and Pallas kernel, the same argmax; the port's plain version bit for
    bit (its dot products are the same exact values)."""
    g, cover, rok, mask, lm = _case(n + d, n, d, grid=True)
    targs = (torch.from_numpy(cover), torch.from_numpy(rok),
             torch.from_numpy(mask), torch.tensor(lm))
    tg_ = torch.from_numpy(g)
    got = fl.emulate_otf_tc(tg_, *targs)
    for wg, wi, wv in _jax_scans(g, cover, rok, mask, lm):
        scale = float(np.abs(np.asarray(wg)).max())
        np.testing.assert_allclose(got[0].numpy(), np.asarray(wg),
                                   rtol=0, atol=1e-6 * scale)
        assert int(got[1]) == int(np.asarray(wi).reshape(()))
        np.testing.assert_allclose(float(got[2]), float(np.asarray(wv)),
                                   rtol=1e-6)
    plain = ref.fl_gain_argmax_otf_ref(tg_, *targs)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,d", SHAPES)
def test_emulated_scan_near_jax_on_raw_floats(n, d):
    """Raw floats: JAX's reference and Pallas kernel at the on-the-fly
    tolerance (the diagonal's noise), the same argmax unless the two gains
    tie within it; an all-masked input (0, -inf)."""
    g, cover, rok, mask, lm = _case(7 * n + d, n, d, grid=False)
    targs = (torch.from_numpy(cover), torch.from_numpy(rok),
             torch.from_numpy(mask), torch.tensor(lm))
    got = fl.emulate_otf_tc(torch.from_numpy(g), *targs)
    for wg, wi, wv in _jax_scans(g, cover, rok, mask, lm):
        wg = np.asarray(wg)
        np.testing.assert_allclose(got[0].numpy(), wg, rtol=1e-3,
                                   atol=1e-3)
        gi, wi = int(got[1]), int(np.asarray(wi).reshape(()))
        if gi != wi:
            assert abs(wg[gi] - wg[wi]) <= 1e-3 * abs(wg[wi])
    none = fl.emulate_otf_tc(torch.from_numpy(g), targs[0], targs[1],
                             torch.zeros(n, dtype=torch.bool), targs[3])
    assert int(none[1]) == 0 and float(none[2]) == float("-inf")


def test_lazy_craig_on_the_emulated_scan_picks_as_jax(monkeypatch):
    """Lazy CRAIG on the fly with every full scan taken by the emulated
    tensor-core arithmetic picks what the JAX lazy greedy picks, on a
    1/8-grid pool (GreedyStats equal: the same rounds certify)."""
    rng = np.random.default_rng(5)
    g = (np.round(rng.standard_normal((400, 14)) * 8) / 8).astype(np.float32)
    lm = float(jg.default_l_max(jnp.asarray(g)))
    scans = []

    def emulated(grads, cover, row_ok, mask, l_max, sqnorms=None):
        scans.append(1)
        return fl.emulate_otf_tc(grads, cover, row_ok, mask, l_max,
                                 sqnorms=sqnorms)

    monkeypatch.setattr(ops, "fl_gain_argmax_otf", emulated)
    port = tg.fl_greedy(torch.from_numpy(g), 60, method="lazy", block=16,
                        l_max=lm, on_the_fly=True)
    want = jg.fl_greedy(jnp.asarray(g), 60, method="lazy", block=16,
                        l_max=lm, on_the_fly=True)
    assert scans, "the lazy greedy took no full scan"
    np.testing.assert_array_equal(port.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_allclose(port.gains.numpy(), np.asarray(want.gains),
                               rtol=1e-5, atol=1e-5)
    assert port.stats == tg.GreedyStats(**vars(want.stats))

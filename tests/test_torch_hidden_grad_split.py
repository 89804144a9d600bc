"""The tensor-core ``hidden_grad`` kernel's arithmetic and routing (CPU).

``csrc/hidden_grad_tc.cu`` forms the residual r = softmax(Z) - onehot(Y)
in f32, cuts it into hi = bf16(r) and lo = bf16(r - hi), and sums two bf16
products, hi W + lo W, in f32.  Here that arithmetic is emulated in plain
torch (each bf16 x bf16 product is exact in f32) and held against the JAX
package's ``ops.hidden_grad`` (ref mode, as on the CPU) and its Pallas
kernel under the interpreter, on the same numpy inputs.  One pass (hi W
alone) misses the kernels' limit, 1e-4 of max |out|; two meet it.  The
wrapper's routing rule and its vocabulary split are pure functions of
shapes, dtypes, strides and the SM count, tested here on fake values.  (The
kernel itself runs on the card: ``test_torch_kernels_cuda.py``.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.lastlayer_grad import (  # noqa: E402
    hidden_grad_fused as pallas_hidden_grad)
from repro_torch.kernels import lastlayer_grad as llg  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

LIMIT = 1e-4        # of max |out|, as the card tests and chip_smoke.py hold


def _inputs(n, v, dh):
    """Logits ~ N(0, 2^2), labels in [0, V), a head exact in bf16 (the
    tensor-core kernel takes a bf16 head: only the residual is split)."""
    rng = np.random.default_rng(n * 10_007 + v * 31 + dh)
    z = (2 * rng.standard_normal((n, v))).astype(np.float32)
    y = rng.integers(0, v, n)
    w = (rng.standard_normal((dh, v)) / np.sqrt(v)).astype(np.float32)
    w = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
    return z, y, w


def _split_product(z, y, w, passes):
    """The kernel's arithmetic: p = exp(z - m) * (1 / l), r = p - onehot,
    then hi W (+ lo W) with bf16 operands and f32 sums."""
    z, w = torch.from_numpy(z), torch.from_numpy(w)
    e = torch.exp(z - z.max(dim=1, keepdim=True).values)
    r = e * (1.0 / e.sum(dim=1, keepdim=True))
    r = r - torch.nn.functional.one_hot(torch.from_numpy(y),
                                        z.shape[1]).float()
    hi = r.to(torch.bfloat16).float()
    out = hi @ w.T
    if passes == 2:
        out = out + (r - hi).to(torch.bfloat16).float() @ w.T
    return out.numpy()


def _jax(z, y, w):
    """JAX's ops.hidden_grad (ref mode) and the Pallas kernel (interpret)."""
    jz, jy, jw = jnp.asarray(z), jnp.asarray(y), jnp.asarray(w)
    return (np.asarray(jops.hidden_grad(jz, jy, jw)),
            np.asarray(pallas_hidden_grad(jz, jy, jw, interpret=True)))


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# The grid of tests/test_kernels.py's hidden_grad_fused test (n = 1 and
# ragged against the TPU's 128-row tile, V ragged against its 512-wide
# chunk, d_h against its 512-wide hidden chunk), and one long vocabulary.
@pytest.mark.parametrize("n,v,dh", [
    *[(n, v, dh) for n in (1, 60, 128) for v in (16, 100, 513, 1024)
      for dh in (32, 512, 600)],
    (32, 64_000, 128)])
def test_two_pass_split_matches_jax_and_one_pass_does_not(n, v, dh):
    z, y, w = _inputs(n, v, dh)
    two = _split_product(z, y, w, passes=2)
    one = _split_product(z, y, w, passes=1)
    for want in _jax(z, y, w):
        assert _rel(two, want) <= LIMIT
        # hi alone keeps 8 of r's 24 bits: 1.8e-4 to 2.2e-3 of max |out|
        # on these inputs, against 4e-7 to 4e-6 for two passes.
        assert _rel(one, want) > LIMIT
        assert _rel(two, want) < _rel(one, want) / 40


# -- the wrapper's split of V ------------------------------------------

@pytest.mark.parametrize("n,v,dh,sms", [
    (512, 256_000, 2048, 132), (512, 256_000, 2048, 114),
    (300, 1000, 600, 132), (1, 16, 32, 132), (60, 33_336, 104, 132),
    (4096, 256_000, 2048, 132), (129, 70_001, 600, 78), (8, 64, 8, 1)])
def test_tc_vocab_split_is_deterministic_and_cuts_whole_stages(n, v, dh,
                                                               sms):
    splits, slice_ = llg.tc_vocab_split(n, v, dh, sms)
    assert (splits, slice_) == llg.tc_vocab_split(n, v, dh, sms)
    assert slice_ % llg.TC_DEPTH == 0 and slice_ > 0
    assert splits == -(-v // slice_)            # every slice holds entries
    assert (splits - 1) * slice_ < v <= splits * slice_
    tiles = -(-n // llg.TC_ROWS) * -(-dh // llg.TC_COLS)
    assert splits == 1 or tiles * splits <= sms  # never past one wave
    assert splits <= max(1, -(-v // llg.TC_MIN_SLICE))


def test_tc_vocab_split_fills_one_wave_at_the_lm_shape():
    """(512, 256 000, 2 048) on an H100's 132 SMs: 4 x 8 tiles, 4 slices of
    64 000 entries, 128 blocks: one wave, 4 SMs idle."""
    assert llg.tc_vocab_split(512, 256_000, 2048, 132) == (4, 64_000)
    splits, _ = llg.tc_vocab_split(512, 256_000, 2048, 132)
    tiles = 4 * 8
    assert tiles * splits <= 132 < tiles * (splits + 1)


def test_tc_vocab_split_depends_on_shapes_and_sm_count_only():
    """More SMs never give fewer slices; few output tiles give many
    slices, at most ceil(V / TC_MIN_SLICE)."""
    prev = 0
    for sms in (1, 16, 66, 132, 264):
        splits, _ = llg.tc_vocab_split(128, 100_000, 256, sms)
        assert splits >= prev
        prev = splits
    assert llg.tc_vocab_split(128, 100_000, 256, 1) == (1, 100_032)
    assert llg.tc_vocab_split(1, 2048, 8, 132) == (2, 1024)


# -- the routing rule -------------------------------------------------

BF, F32, F16 = torch.bfloat16, torch.float32, torch.float16


@pytest.mark.parametrize("z_dtype,w_dtype,n,v,dh,tied,z_addr,w_addr,tc", [
    # the LM path: bf16 logits, the tied bf16 head embed.T
    (BF, BF, 512, 256_000, 2048, True, 0, 0, True),
    (BF, BF, 512, 256_000, 2048, False, 0, 0, True),
    (F32, BF, 300, 1000, 600, True, 256, 512, True),
    (F32, BF, 300, 1004, 600, False, 0, 0, False),   # W rows 2 008 bytes
    (F32, BF, 300, 1004, 600, True, 0, 0, True),     # f32 rows 4 016 bytes
    (BF, BF, 300, 1004, 600, True, 0, 0, False),     # bf16 rows 2 008 bytes
    (BF, BF, 60, 513, 600, True, 0, 0, False),       # V = 513: rows 1 026
    (BF, BF, 60, 512, 601, True, 0, 0, False),       # embed rows 1 202 bytes
    (BF, BF, 60, 512, 601, False, 0, 0, True),       # W (601, 512) rows 1 KB
    (BF, F32, 512, 256_000, 2048, True, 0, 0, False),  # an f32 head
    (F32, F32, 64, 1024, 256, False, 0, 0, False),
    (BF, BF, 64, 1024, 256, False, 8, 0, False),     # an unaligned view
    (BF, BF, 64, 1024, 256, False, 0, 1040, True),
    (BF, BF, 64, 1024, 256, True, 0, 1032, False),
    (F16, BF, 64, 1024, 256, True, 0, 0, False),
    (BF, BF, 2 ** 31, 1024, 256, True, 0, 0, False),
])
def test_routing_rule(z_dtype, w_dtype, n, v, dh, tied, z_addr, w_addr, tc):
    assert llg.takes_tensor_cores(z_dtype, w_dtype, n, v, dh, tied, z_addr,
                                  w_addr) is tc


def test_cpu_tensors_take_the_plain_version_through_every_entry():
    """On the CPU the router and the FFMA kernel's own entry compute the
    plain version and launch nothing."""
    z, y, w = _inputs(60, 513, 96)
    tz, ty = torch.from_numpy(z), torch.from_numpy(y)
    tw = torch.from_numpy(w).to(torch.bfloat16)
    before = dict(llg.launches)
    want = ref.hidden_grad_ref(tz, ty, tw)
    for fn in (llg.hidden_grad_fused, llg.hidden_grad_ffma):
        np.testing.assert_array_equal(fn(tz, ty, tw).numpy(), want.numpy())
    assert llg.launches == before

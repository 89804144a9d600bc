"""The port's prefill and decode (``repro_torch.models.lm.prefill_step`` /
``decode_step``, the KV caches and rings of ``models/attention.py``,
flash-decoding, ``launch/serve._seat``) against the JAX package, on the
CPU.

The same parameters (``repro.models.lm.init_lm``, carried over by
``lm.params_from_jax``) and the same numpy tokens go through both
packages: a prompt is prefilled, its caches seated into ``s_max`` slots,
and the rest decoded a token at a time.  Limits, relative to the largest
magnitude of the reference's output (logits over the real vocabulary):

- ``param_dtype="float32"``: 1e-5 for every logit row and cache (measured:
  up to 1.2e-6);
- the published bf16: logits 3e-2, caches 2.5e-2 (measured: 1.35e-2,
  1.12e-2; one bf16 rounding is 3.9e-3 of a value, and the two packages
  round bf16 products at other places).

Where the reference's sliding-window ring is inconsistent (a prompt longer
than the window and not a multiple of it) the port keeps position ``p``
in slot ``p mod window`` and its decode equals its own teacher-forced
forward, where the reference's parts (ROADMAP §3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch.serve import _seat as jax_seat  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.serve import _seat  # noqa: E402
from repro_torch.models import attention, lm  # noqa: E402

LIMITS = {"float32": dict(logits=1e-5, cache=1e-5),
          "bfloat16": dict(logits=3e-2, cache=2.5e-2)}
DENSE = ["gemma-2b", "gemma2-9b", "starcoder2-3b", "codeqwen1.5-7b"]
B = 2


def _rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


def _pair(arch, dtype="float32", **kw):
    """(jax cfg, jax params, torch cfg, port model) on the same values."""
    jcfg = jax_smoke(arch).replace(param_dtype=dtype, **kw)
    tcfg = get_smoke_config(arch).replace(param_dtype=dtype, **kw)
    jp = jlm.init_lm(jcfg, jax.random.PRNGKey(0))
    model = lm.params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
    return jcfg, jp, tcfg, model


def _tokens(cfg, s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)


def _caches(tcfg, tstate):
    """(super-block, sub-layer name, cache dict) of the port's state."""
    for i, blk in enumerate(tstate["blocks"]):
        for name in (f"sub{si}" for si in range(len(tcfg.layer_pattern))):
            yield i, name, blk[name]


def _port_serve(tcfg, model, tok, s0, s_max):
    """Prefill tok[:, :s0], seat, teacher-forced decode to s_max: each
    step's logits over the real vocabulary and the caches after prefill
    and at the end."""
    v = tcfg.vocab_size
    logits, pstate = lm.prefill_step(tcfg, model, torch.from_numpy(tok[:,
                                                                       :s0]))
    pcopy = jax.tree_util.tree_map(lambda t: t.clone(), pstate)
    state = _seat(lm.init_decode_state(tcfg, B, s_max, "cpu"), pstate)
    out = [logits[:, :v]]
    for t in range(s0, s_max):
        logits, state = lm.decode_step(
            tcfg, model, state, torch.from_numpy(tok[:, t:t + 1]), t)
        out.append(logits[:, :v])
    return out, pcopy, state


def _jax_serve(jcfg, jp, tok, s0, s_max):
    """The reference's loop, prefill and decode each jitted once."""
    v = jcfg.vocab_size
    prefill = jax.jit(lambda p, t: jlm.prefill_step(jcfg, p, t))
    decode = jax.jit(lambda p, st, t, pos: jlm.decode_step(jcfg, p, st, t,
                                                           pos))
    logits, pstate = prefill(jp, jnp.asarray(tok[:, :s0]))
    state = jax_seat(jlm.init_decode_state(jcfg, B, s_max), pstate)
    out = [np.asarray(logits)[:, :v]]
    for t in range(s0, s_max):
        logits, state = decode(jp, state, jnp.asarray(tok[:, t:t + 1]),
                               jnp.int32(t))
        out.append(np.asarray(logits)[:, :v])
    return out, pstate, state


def _port_forward_logits(tcfg, model, tok, s0):
    """The teacher-forced forward's logits at positions s0-1 .. S-1."""
    with torch.no_grad():
        h, _, _ = lm.forward(tcfg, model, torch.from_numpy(tok))
        logits = lm.mask_padded_logits(tcfg, lm._head_out(tcfg, model, h))
    return [logits[:, t, :tcfg.vocab_size] for t in range(s0 - 1,
                                                          tok.shape[1])]


def _assert_caches_equal_jax(tcfg, tstate, jstate, lim):
    for i, name, cache in _caches(tcfg, tstate):
        jc = jstate["blocks"][name]
        for key in ("k", "v"):
            assert cache[key].dtype == lm.common.dtype_of(tcfg)
            assert _rel(np.asarray(jc[key])[i], cache[key]) <= lim, (
                i, name, key)
        if "slot_pos" in cache:
            np.testing.assert_array_equal(np.asarray(jc["slot_pos"])[i],
                                          cache["slot_pos"].numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax(arch, dtype):
    """Prompt 6, decode to 12: every logit row, the prefill's caches and
    the caches after the last decode step (rows, ring positions)."""
    lim = LIMITS[dtype]
    jcfg, jp, tcfg, model = _pair(arch, dtype)
    tok = _tokens(tcfg, 12)
    want, jpre, jend = _jax_serve(jcfg, jp, tok, 6, 12)
    got, tpre, tend = _port_serve(tcfg, model, tok, 6, 12)
    for t, (w, g) in enumerate(zip(want, got)):
        assert _rel(w, g) <= lim["logits"], t
    _assert_caches_equal_jax(tcfg, tpre, jpre, lim["cache"])
    _assert_caches_equal_jax(tcfg, tend, jend, lim["cache"])


def test_ring_wraps_during_decode_as_in_jax():
    """gemma2-9b smoke (window 32): prompt 20, decode to 48, so the ring
    wraps at position 32 and the last 16 writes overwrite slots 0-15."""
    jcfg, jp, tcfg, model = _pair("gemma2-9b")
    tok = _tokens(tcfg, 48, seed=1)
    want, _, jend = _jax_serve(jcfg, jp, tok, 20, 48)
    got, _, tend = _port_serve(tcfg, model, tok, 20, 48)
    for t, (w, g) in enumerate(zip(want, got)):
        assert _rel(w, g) <= 1e-5, t
    _assert_caches_equal_jax(tcfg, tend, jend, 1e-5)
    ring = tend["blocks"][0]["sub0"]["slot_pos"]
    assert ring.shape == (B, 32) and ring[0].tolist() == (
        list(range(32, 48)) + list(range(16, 32)))
    for t, (f, g) in enumerate(zip(_port_forward_logits(tcfg, model, tok,
                                                        20), got)):
        assert _rel(f.numpy(), g) <= 1e-5, t


@pytest.mark.parametrize("prompt", [32, 40, 64])
def test_ring_layout_against_jax(prompt):
    """Prompts past the window (32): at a multiple of it (32, 64) the
    port's prefill ring is the reference's; at 40 it holds the same rows
    with position p in slot p mod 32 where the reference has slot
    p - 8.  At every prompt the port's decode to 72 equals its
    teacher-forced forward; at 40 the reference's parts from its own."""
    jcfg, jp, tcfg, model = _pair("gemma2-9b")
    tok = _tokens(tcfg, 72, seed=2)
    s_max, w = 72, tcfg.sliding_window
    got, tpre, _ = _port_serve(tcfg, model, tok, prompt, s_max)
    _, jpre = jlm.prefill_step(jcfg, jp, jnp.asarray(tok[:, :prompt]))
    slots = np.arange(prompt - w, prompt) % w     # port slot of each row
    for i, name, cache in _caches(tcfg, tpre):
        jc = {k: np.asarray(a)[i] for k, a in jpre["blocks"][name].items()}
        if "slot_pos" not in cache:                # global: the full cache
            assert _rel(jc["k"], cache["k"]) <= 1e-5
            continue
        np.testing.assert_array_equal(cache["slot_pos"].numpy()[:, slots],
                                      jc["slot_pos"])
        for key in ("k", "v"):
            assert _rel(jc[key], cache[key][:, slots]) <= 1e-5, (i, key)
            if prompt % w == 0:
                assert _rel(jc[key], cache[key]) <= 1e-5
    forward = _port_forward_logits(tcfg, model, tok, prompt)
    for t, (f, g) in enumerate(zip(forward, got)):
        assert _rel(f.numpy(), g) <= 1e-5, (prompt, t)
    if prompt == 40:
        want, _, _ = _jax_serve(jcfg, jp, tok, prompt, s_max)
        parted = max(_rel(f.numpy(), w_) for f, w_ in zip(forward, want))
        assert parted > 1e-2      # the reference's inconsistent ring


@pytest.mark.parametrize("arch", ["gemma-2b", "gemma2-9b"])
def test_flash_decoding_matches_jax(arch):
    """``flash_threshold`` 16, ``flash_block_kv`` 8: the prompt (6)
    prefills dense, the 24-slot full caches flash-decode in chunks of 8
    (gemma2-9b's local layers keep their ring); logits and caches against
    the reference, and against the port's blockwise forward at 24."""
    kw = dict(flash_threshold=16, flash_block_kv=8)
    jcfg, jp, tcfg, model = _pair(arch, **kw)
    tok = _tokens(tcfg, 24, seed=3)
    want, _, jend = _jax_serve(jcfg, jp, tok, 6, 24)
    got, _, tend = _port_serve(tcfg, model, tok, 6, 24)
    for t, (w, g) in enumerate(zip(want, got)):
        assert _rel(w, g) <= 1e-5, t
    _assert_caches_equal_jax(tcfg, tend, jend, 1e-5)
    for t, (f, g) in enumerate(zip(_port_forward_logits(tcfg, model, tok,
                                                        6), got)):
        assert _rel(f.numpy(), g) <= 1e-5, t


@pytest.mark.parametrize("pos", [0, 5, 8, 17, 31])
def test_decode_attend_blockwise_matches_jax(pos):
    """The split-KV scan alone (GQA, softcap 50, chunks of 8 over 32
    slots) at positions inside the first chunk, on a chunk's edge and in
    the last: the chunks past ``pos`` the port skips change nothing."""
    cfg = get_smoke_config("gemma2-9b").replace(param_dtype="float32",
                                                flash_block_kv=8)
    jcfg = jax_smoke("gemma2-9b").replace(param_dtype="float32",
                                          flash_block_kv=8)
    rng = np.random.default_rng(pos)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32) * 3
    k = rng.standard_normal((2, 32, 2, 16)).astype(np.float32) * 3
    v = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    want = jattn._decode_attend_blockwise(jcfg, jnp.asarray(q),
                                          jnp.asarray(k), jnp.asarray(v),
                                          jnp.int32(pos))
    got = attention._decode_attend_blockwise(
        cfg, torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        pos)
    assert _rel(want, got) <= 1e-5
    mask = (torch.arange(32) <= pos)[None, None, :]
    dense = attention._attend(cfg, torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), mask)
    assert _rel(dense.numpy(), got) <= 1e-5


def test_flash_decoding_needs_a_multiple_of_the_chunk():
    """The reference asserts that the cache is a whole number of
    ``flash_block_kv`` chunks; the port raises a ``ValueError`` naming
    both."""
    kw = dict(flash_threshold=16, flash_block_kv=8)
    _, _, tcfg, model = _pair("gemma-2b", **kw)
    tok = torch.from_numpy(_tokens(tcfg, 6))
    _, pstate = lm.prefill_step(tcfg, model, tok)
    state = _seat(lm.init_decode_state(tcfg, B, 20, "cpu"), pstate)
    with pytest.raises(ValueError, match=r"20 .*flash_block_kv \(8\)"):
        lm.decode_step(tcfg, model, state, tok[:, :1], 6)


@pytest.mark.parametrize("s_max", [12, 40])
def test_seat_matches_jax(s_max):
    """``_seat`` on gemma2-9b smoke (prompt 6, window 32): the full caches
    copied into ``s_max`` slots; the ring cut to 12 slots (s_max below the
    window) or kept whole (40); ``slot_pos`` included."""
    jcfg, jp, tcfg, model = _pair("gemma2-9b")
    tok = _tokens(tcfg, 6, seed=4)
    _, jpre = jlm.prefill_step(jcfg, jp, jnp.asarray(tok))
    _, tpre = lm.prefill_step(tcfg, model, torch.from_numpy(tok))
    want = jax_seat(jlm.init_decode_state(jcfg, B, s_max), jpre)
    got = _seat(lm.init_decode_state(tcfg, B, s_max, "cpu"), tpre)
    assert got["blocks"][0]["sub0"]["k"].shape[1] == min(s_max, 32)
    assert got["blocks"][0]["sub1"]["k"].shape[1] == s_max
    _assert_caches_equal_jax(tcfg, got, want, 1e-5)


def test_init_decode_state_matches_jax():
    """Shapes, dtypes and the unfilled ring positions of a fresh state."""
    cfg = get_smoke_config("gemma2-9b")
    want = jlm.init_decode_state(jax_smoke("gemma2-9b"), 3, 50)
    got = lm.init_decode_state(cfg, 3, 50, "cpu")
    assert len(got["blocks"]) == cfg.n_superblocks
    for i, name, cache in _caches(cfg, got):
        for key, arr in want["blocks"][name].items():
            assert tuple(cache[key].shape) == arr.shape[1:], (name, key)
            assert str(cache[key].dtype).split(".")[1] == str(arr.dtype)
        if "slot_pos" in cache:
            assert bool((cache["slot_pos"] == -1).all())


def test_forward_refuses_an_unknown_mode():
    _, _, tcfg, model = _pair("gemma-2b")
    with pytest.raises(ValueError, match="mode 'serve'"):
        lm.forward(tcfg, model, torch.zeros((1, 4), dtype=torch.int32),
                   mode="serve")

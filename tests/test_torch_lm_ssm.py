"""The port's Mamba2 block (``repro_torch.models.ssm``) and the zamba2
hybrid (three Mamba2 prologue layers, super-blocks of five Mamba2 layers
and the weight-shared attention block, ``models/lm.py``) against the JAX
package, on the CPU.

The same parameters (``repro.models.ssm.init_mamba`` / ``lm.init_lm``,
carried over by ``lm.params_from_jax``) and the same numpy inputs go
through both packages, on zamba2-7b's smoke config (d 64, 8 SSD heads of
16, state 16, chunk 16).  Limits, relative to the largest magnitude of the
reference's output:

- ``param_dtype="float32"``: 1e-5 for the SSD scan and its state, the
  block's output and state, every decode step, the hybrid's hidden
  states, loss, proxies, the parameters after one SGD step and the
  decode logits (measured: up to 2.4e-6, and 8.2e-6 for the momentum of
  the first prologue layer's ``dt_proj``, whose gradient sums the SSD's
  decay exponentials over the chunk);
- the published bf16: each package's hidden states and loss against an
  f32 forward on the same weights, the port's no further off than 1.25x
  the reference's (or the dense archs' 2e-2 / 1e-3 where wider); decode
  against the port's own forward within the reference's decode test's
  5e-2 of max |logit|.

A sequence longer than the chunk must be a multiple of it, as the
reference asserts; the port raises a ``ValueError`` naming both numbers.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch.serve import _seat as jax_seat  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.optim import cosine_with_warmup as jax_cosine_warmup  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro.train.steps import lm_train_step_fn as jax_step_fn  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.serve import _seat  # noqa: E402
from repro_torch.models import lm, ssm  # noqa: E402
from repro_torch.optim import cosine_with_warmup, sgd  # noqa: E402
from repro_torch.train.steps import lm_train_step_fn  # noqa: E402

ARCH = "zamba2-7b"
B = 2
LR_STEP = 12


def _rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _cfgs(dtype="float32"):
    return (jax_smoke(ARCH).replace(param_dtype=dtype),
            get_smoke_config(ARCH).replace(param_dtype=dtype))


def _pair(dtype="float32"):
    jcfg, tcfg = _cfgs(dtype)
    jp = jlm.init_lm(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, lm.params_from_jax(tcfg, _np(jp), device="cpu")


def _mixer(seed=0):
    jcfg, tcfg = _cfgs()
    jp = _np(jssm.init_mamba(jcfg, jax.random.PRNGKey(seed)))
    # a_log, d_skip, dt_bias start constant: vary them so every head
    # decays at its own rate
    rng = np.random.default_rng(seed)
    for key, lo, hi in (("a_log", -1.0, 1.0), ("d_skip", 0.5, 1.5),
                        ("dt_bias", -3.0, 0.0)):
        jp[key] = rng.uniform(lo, hi, jp[key].shape).astype(np.float32)
    return jcfg, tcfg, jp, _t(jp)


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,chunk", [(16, 16), (48, 16), (12, 16)],
                         ids=["one-chunk", "three-chunks", "short"])
def test_ssd_chunked_matches_jax(t, chunk):
    """The SSD scan on random inputs from a non-zero state: one chunk,
    three (the inter-chunk loop), and a sequence shorter than the chunk."""
    rng = np.random.default_rng(t)
    h, p, n = 4, 8, 16
    xh = rng.standard_normal((B, t, h, p)).astype(np.float32)
    dtv = rng.uniform(0.01, 0.5, (B, t, h)).astype(np.float32)
    bm = rng.standard_normal((B, t, n)).astype(np.float32)
    cm = rng.standard_normal((B, t, n)).astype(np.float32)
    a = -rng.uniform(0.2, 2.0, (h,)).astype(np.float32)
    s0 = rng.standard_normal((B, h, p, n)).astype(np.float32)
    jy, js = jssm._ssd_chunked(*(jnp.asarray(v) for v in (xh, dtv, bm, cm,
                                                          a)), chunk,
                               jnp.asarray(s0))
    ty, ts = ssm._ssd_chunked(*(torch.from_numpy(v) for v in (xh, dtv, bm,
                                                              cm, a)),
                              chunk, torch.from_numpy(s0))
    assert ty.dtype == ts.dtype == torch.float32
    assert _rel(jy, ty) <= 1e-5
    assert _rel(js, ts) <= 1e-5


def test_ssd_chunk_precondition_raises():
    """A sequence longer than the chunk and not a multiple of it."""
    x = torch.zeros((1, 40, 2, 4))
    with pytest.raises(ValueError, match="40 tokens .* chunk 16"):
        ssm._ssd_chunked(x, torch.zeros((1, 40, 2)), torch.zeros((1, 40, 8)),
                         torch.zeros((1, 40, 8)), -torch.ones(2), 16,
                         torch.zeros((1, 2, 4, 8)))
    _, tcfg = _cfgs()
    model = lm.init_lm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="not a multiple of the SSD chunk"):
        lm.prefill_step(tcfg, model, torch.zeros((1, 40), dtype=torch.int32))


@pytest.mark.parametrize("t", [16, 48], ids=["one-chunk", "three-chunks"])
def test_mamba_apply_and_its_gradients_match_jax(t):
    """The whole block at f32 (projections, the three causal convs, the
    scan, the skip, the gated norm): output and state from a zero state,
    then the next 16 tokens from that state; and the gradients of
    ``sum(y * r)`` with respect to x and every weight."""
    jcfg, tcfg, jp, tp = _mixer()
    rng = np.random.default_rng(t)
    x = rng.standard_normal((B, t + 16, jcfg.d_model)).astype(np.float32)
    apply = jax.jit(lambda p, xx, st: jssm.mamba_apply(
        jcfg, p, xx, state=st, return_state=True))
    jy, jst = apply(jp, jnp.asarray(x[:, :t]), None)
    ty, tst = ssm.mamba_apply(tcfg, tp, torch.from_numpy(x[:, :t]),
                              return_state=True)
    assert _rel(jy, ty) <= 1e-5
    for key in ("ssd", "conv_x", "conv_b", "conv_c"):
        assert tst[key].dtype == (torch.float32)
        assert _rel(jst[key], tst[key]) <= 1e-5, key
    jy2, jst2 = apply(jp, jnp.asarray(x[:, t:]), jst)
    ty2, tst2 = ssm.mamba_apply(tcfg, tp, torch.from_numpy(x[:, t:]),
                                state=tst, return_state=True)
    assert _rel(jy2, ty2) <= 1e-5
    assert _rel(jst2["ssd"], tst2["ssd"]) <= 1e-5

    r = rng.standard_normal((B, t, jcfg.d_model)).astype(np.float32)
    jgp, jgx = jax.jit(jax.grad(lambda p, xx: jnp.sum(
        jssm.mamba_apply(jcfg, p, xx)[0] * r), argnums=(0, 1)))(
            jp, jnp.asarray(x[:, :t]))
    tp = jax.tree_util.tree_map(lambda v: v.clone().requires_grad_(), tp)
    tx = torch.from_numpy(x[:, :t]).requires_grad_()
    (ssm.mamba_apply(tcfg, tp, tx)[0] * torch.from_numpy(r)).sum().backward()
    assert _rel(jgx, tx.grad) <= 1e-5
    for key, g in jgp.items():
        assert torch.isfinite(tp[key].grad).all(), key
        assert _rel(g, tp[key].grad) <= 1e-5, key


def test_mamba_decode_step_by_step_matches_jax():
    """The O(1) recurrence, eight tokens one at a time from a prefilled
    state: each output and the state after it; and the recurrence against
    the chunked form over the same 24 tokens."""
    jcfg, tcfg, jp, tp = _mixer(1)
    x = np.random.default_rng(4).standard_normal(
        (B, 24, jcfg.d_model)).astype(np.float32)
    _, jst = jax.jit(lambda p, xx: jssm.mamba_apply(
        jcfg, p, xx, return_state=True))(jp, jnp.asarray(x[:, :16]))
    step = jax.jit(lambda p, xx, st: jssm.mamba_decode(jcfg, p, xx, st))
    _, tst = ssm.mamba_apply(tcfg, tp, torch.from_numpy(x[:, :16]),
                             return_state=True)
    outs = []
    for i in range(16, 24):
        jy, jst = step(jp, jnp.asarray(x[:, i:i + 1]), jst)
        ty, tst = ssm.mamba_decode(tcfg, tp, torch.from_numpy(x[:, i:i + 1]),
                                   tst)
        assert _rel(jy, ty) <= 1e-5, i
        for key in tst:
            assert _rel(jst[key], tst[key]) <= 1e-5, (i, key)
        outs.append(ty)
    whole, _ = ssm.mamba_apply(
        tcfg.replace(ssm=dataclasses.replace(tcfg.ssm, chunk=8)), tp,
        torch.from_numpy(x))
    assert _rel(whole[:, 16:].numpy(), torch.cat(outs, 1)) <= 1e-5


# ---------------------------------------------------------------------------
# The hybrid LM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def zamba():
    """zamba2 smoke at f32 (3 Mamba2 prologue layers, one super-block of
    five Mamba2 layers and the shared block): the JAX forward, loss,
    proxies and one SGD step, computed once, on 4 x 32 tokens (two
    chunks)."""
    jcfg, jp, tcfg, model = _pair()
    rng = np.random.default_rng(0)
    tok = rng.integers(0, jcfg.vocab_size, (4, 32)).astype(np.int32)
    tgt = rng.integers(0, jcfg.vocab_size, (4, 32)).astype(np.int32)
    w = rng.random(4).astype(np.float32)
    w /= w.sum()
    jb = {"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt),
          "weights": jnp.asarray(w)}
    tb = {"tokens": torch.from_numpy(tok), "targets": torch.from_numpy(tgt),
          "weights": torch.from_numpy(w)}
    (h, _, _), (loss, _), proxy = jax.jit(lambda p, b: (
        jlm.forward(jcfg, p, b["tokens"]), jlm.lm_loss(jcfg, p, b),
        jlm.selection_proxy(jcfg, p, b)))(jp, jb)
    opt = jax_sgd(jax_cosine_warmup(0.05, 10, 100), momentum=0.9)
    state = opt.init(jp)._replace(step=jnp.int32(LR_STEP))
    stepped, state, sm = jax.jit(jax_step_fn(jcfg, opt))(jp, state, jb)
    return dict(jcfg=jcfg, jp=jp, tcfg=tcfg, model=model, tb=tb,
                hidden=np.asarray(h), loss=float(loss),
                proxy=np.asarray(proxy), stepped=_np(stepped),
                slots=_np(state.slots), step_loss=float(sm["loss"]))


def test_hybrid_tree_has_the_shared_block_outside_the_blocks(zamba):
    model, cfg = zamba["model"], zamba["tcfg"]
    names = [n for n, _ in model.named_parameters()]
    assert any(n.startswith("shared.attn.") for n in names)
    assert any(n.startswith("prologue.pro2.mixer.") for n in names)
    assert not any(n.startswith("blocks.0.sub5") for n in names)
    assert len(model["blocks"]) == cfg.n_superblocks
    assert sorted(model["blocks"][0]._modules) == [f"sub{i}"
                                                   for i in range(5)]


def test_hybrid_forward_loss_and_proxy_match_jax(zamba):
    cfg, model, tb = zamba["tcfg"], zamba["model"], zamba["tb"]
    with torch.no_grad():
        h, states, aux = lm.forward(cfg, model, tb["tokens"])
        loss, _ = lm.lm_loss(cfg, model, tb)
    assert states == {} and float(aux) == 0.0
    assert _rel(zamba["hidden"], h) <= 1e-5
    assert abs(float(loss) - zamba["loss"]) <= 1e-5 * zamba["loss"]
    assert _rel(zamba["proxy"], lm.selection_proxy(cfg, model, tb)) <= 1e-5


def _leaf(tree, name):
    parts = name.split(".")
    if parts[0] == "blocks":
        node = tree["blocks"]
        for p in parts[2:]:
            node = node[p]
        return node[int(parts[1])]
    node = tree
    for p in parts:
        node = node[p]
    return node


def test_hybrid_train_step_matches_jax(zamba):
    """One weighted SGD step: every parameter and momentum slot, the
    shared block's (its gradient summed over the super-blocks'
    invocations) and the prologue's among them, with remat on and off."""
    for remat in (False, True):
        jcfg, jp, cfg, model = _pair()
        cfg = cfg.replace(remat=remat)
        opt = sgd(model.parameters(), cosine_with_warmup(0.05, 10, 100),
                  momentum=0.9)
        opt.step_count = LR_STEP
        metrics = lm_train_step_fn(cfg, model, opt)(zamba["tb"])
        assert abs(float(metrics["loss"]) - zamba["step_loss"]) <= (
            1e-5 * zamba["step_loss"])
        for name, p in model.named_parameters():
            assert _rel(_leaf(zamba["stepped"], name), p) <= 1e-5, name
            assert _rel(_leaf(zamba["slots"], name),
                        opt.state[p]["momentum"]) <= 1e-5, name


def test_hybrid_bf16_is_as_close_to_f32_as_jax():
    """The published bf16: the port's hidden states and loss are no
    further from an f32 forward on the same (bf16-valued) weights than
    the reference's bf16 forward is (within 1.25x, or the dense archs'
    limits, hidden 2e-2 and loss 1e-3, where those are wider).  The two
    bf16 forwards part by ~3e-2 of max |h| after nine layers (measured),
    each ~3e-2 from f32: one bf16 rounding is 3.9e-3, and each package
    rounds at its own places."""
    jcfg, jp, tcfg, model = _pair("bfloat16")
    cfg32 = tcfg.replace(param_dtype="float32")
    m32 = lm.params_from_jax(cfg32, jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), _np(jp)), device="cpu")
    tok = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    tgt = np.roll(tok, -1, axis=1)
    jb = {"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt)}
    tb = {"tokens": torch.from_numpy(tok), "targets": torch.from_numpy(tgt)}
    h, _, _ = jax.jit(lambda p, t: jlm.forward(jcfg, p, t))(jp, jb["tokens"])
    loss, _ = jax.jit(lambda p, b: jlm.lm_loss(jcfg, p, b))(jp, jb)
    with torch.no_grad():
        th, _, _ = lm.forward(tcfg, model, tb["tokens"])
        tloss, _ = lm.lm_loss(tcfg, model, tb)
        h32, _, _ = lm.forward(cfg32, m32, tb["tokens"])
        loss32, _ = lm.lm_loss(cfg32, m32, tb)
    assert th.dtype == torch.bfloat16
    want = h32.numpy()
    assert _rel(want, th) <= max(2e-2, 1.25 * _rel(want, np.asarray(
        h, np.float32)))
    l32 = float(loss32)
    assert abs(float(tloss) - l32) <= max(1e-3 * l32, 1.25 * abs(
        float(loss) - l32))


def _serve_both(jcfg, jp, tcfg, model, tok, s0):
    v, s_max = jcfg.vocab_size, tok.shape[1]
    prefill = jax.jit(lambda p, t: jlm.prefill_step(jcfg, p, t))
    decode = jax.jit(lambda p, st, t, pos: jlm.decode_step(jcfg, p, st, t,
                                                           pos))
    jl, jps = prefill(jp, jnp.asarray(tok[:, :s0]))
    jst = jax_seat(jlm.init_decode_state(jcfg, B, s_max), jps)
    tl, tps = lm.prefill_step(tcfg, model, torch.from_numpy(tok[:, :s0]))
    tst = _seat(lm.init_decode_state(tcfg, B, s_max, "cpu"), tps)
    out = [(np.asarray(jl)[:, :v], tl[:, :v])]
    for t in range(s0, s_max):
        jl, jst = decode(jp, jst, jnp.asarray(tok[:, t:t + 1]), jnp.int32(t))
        tl, tst = lm.decode_step(tcfg, model, tst,
                                 torch.from_numpy(tok[:, t:t + 1]), t)
        out.append((np.asarray(jl)[:, :v], tl[:, :v]))
    return out, jps, tps, tst


def test_hybrid_prefill_and_decode_match_jax():
    """f32: prefill 32 tokens (two chunks), seat into 48 slots, decode 16:
    every step's logits against JAX's ``decode_step`` and against the
    port's teacher-forced forward over the 48 tokens; the prefill states
    (the Mamba2 states and the shared block's caches) against JAX's."""
    jcfg, jp, tcfg, model = _pair()
    tok = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (B, 48)).astype(np.int32)
    steps, jps, tps, tst = _serve_both(jcfg, jp, tcfg, model, tok, 32)
    for i, (jl, tl) in enumerate(steps):
        assert _rel(jl, tl) <= 1e-5, i
    for i in range(3):
        for key in ("ssd", "conv_x", "conv_b", "conv_c"):
            assert _rel(jps["prologue"][f"pro{i}"][key],
                        tps["prologue"][f"pro{i}"][key]) <= 1e-5, (i, key)
    blk = tps["blocks"][0]
    for key in ("k", "v"):
        assert _rel(jps["blocks"]["sub5"][key][0], blk["sub5"][key]) <= 1e-5
    assert _rel(jps["blocks"]["sub2"]["ssd"][0], blk["sub2"]["ssd"]) <= 1e-5
    # the seated state keeps the Mamba2 states' shapes and dtypes
    assert tst["blocks"][0]["sub0"]["ssd"].dtype == torch.float32
    with torch.no_grad():
        h, _, _ = lm.forward(tcfg, model, torch.from_numpy(tok))
        fwd = lm._head_out(tcfg, model, h)[..., :tcfg.vocab_size]
    for i, (_, tl) in enumerate(steps):
        assert _rel(fwd[:, 31 + i].numpy(), tl) <= 1e-5, i


def test_hybrid_bf16_decode_matches_its_forward():
    """The published bf16: prefill 32, decode 16 against the port's own
    teacher-forced forward, within the reference's own decode test's 5e-2
    of max |logit| (``tests/test_models.py:104-109``).  Across the
    packages bf16 is held by ``test_hybrid_bf16_is_as_close_to_f32_as_jax``
    (the two bf16 prefills part by ~4e-2 of max |logit| after nine
    layers, measured)."""
    _, _, tcfg, model = _pair("bfloat16")
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (B, 48)).astype(np.int32))
    v = tcfg.vocab_size
    logits, pstate = lm.prefill_step(tcfg, model, tok[:, :32])
    state = _seat(lm.init_decode_state(tcfg, B, 48, "cpu"), pstate)
    dec = [logits[:, :v]]
    for t in range(32, 48):
        logits, state = lm.decode_step(tcfg, model, state, tok[:, t:t + 1], t)
        dec.append(logits[:, :v])
    with torch.no_grad():
        h, _, _ = lm.forward(tcfg, model, tok)
        fwd = lm._head_out(tcfg, model, h)[..., :v].float().numpy()
    for i, got in enumerate(dec):
        assert torch.isfinite(got).all()
        assert _rel(fwd[:, 31 + i], got) <= 5e-2, i

"""The port's LM (``repro_torch.models.lm`` with attention, FFN, loss, the
selection proxy and the train step) against the JAX package, on the CPU.

The same parameters (``repro.models.lm.init_lm``, carried over by
``lm.params_from_jax``) and the same numpy batches go through both
packages.  Limits, relative to the largest magnitude of the reference's
output:

- ``param_dtype="float32"``: 1e-5 for the hidden states, loss, proxies and
  the parameters after one SGD step (measured: up to 2e-6; the two
  libraries sum in other orders);
- the published bf16: hidden 2e-2, loss 1e-3, proxies 2e-3, parameters
  after a step 1.6e-2 (measured: 7.9e-3, 6.7e-5, 2.5e-4, 6.3e-3; one bf16
  rounding is 3.9e-3 of a value, and the two packages round bf16 products
  at other places).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import cosine_with_warmup as jax_cosine_warmup  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro.train.steps import lm_train_step_fn as jax_step_fn  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import attention, common, lm  # noqa: E402
from repro_torch.optim import cosine_with_warmup, sgd  # noqa: E402
from repro_torch.train.steps import lm_train_step_fn  # noqa: E402

LIMITS = {"float32": dict(hidden=1e-5, loss=1e-5, proxy=1e-5, params=1e-5),
          "bfloat16": dict(hidden=2e-2, loss=1e-3, proxy=2e-3,
                           params=1.6e-2)}
B, S = 4, 16
LR_STEP = 12      # the schedule's step for the compared update (past warmup)


def _rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


def _batch(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    tgt = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    w = rng.random(b).astype(np.float32)
    w /= w.sum()
    return ({"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt),
             "weights": jnp.asarray(w)},
            {"tokens": torch.from_numpy(tok), "targets": torch.from_numpy(tgt),
             "weights": torch.from_numpy(w)})


def _pair(arch, dtype="float32", **kw):
    """(jax cfg, jax params, torch cfg, port model) on the same values."""
    jcfg = jax_smoke(arch).replace(param_dtype=dtype, **kw)
    tcfg = get_smoke_config(arch).replace(param_dtype=dtype, **kw)
    jp = jlm.init_lm(jcfg, jax.random.PRNGKey(0))
    model = lm.params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
    return jcfg, jp, tcfg, model


def _jax_leaf(tree, name):
    """The JAX leaf of a port parameter name (``blocks.3.sub0.attn.wq`` is
    ``tree['blocks']['sub0']['attn']['wq'][3]``)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        node = tree["blocks"]
        for p in parts[2:]:
            node = node[p]
        return np.asarray(node[int(parts[1])], np.float32)
    node = tree
    for p in parts:
        node = node[p]
    return np.asarray(node, np.float32)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def gemma(request):
    """gemma-2b smoke in both dtypes: the JAX outputs (forward, loss,
    proxies, one SGD step) computed once for the module."""
    dtype = request.param
    jcfg, jp, tcfg, model = _pair("gemma-2b", dtype)
    jb, tb = _batch(jcfg)
    h, _, _ = jax.jit(lambda p, t: jlm.forward(jcfg, p, t))(jp, jb["tokens"])
    loss, metrics = jax.jit(lambda p, b: jlm.lm_loss(jcfg, p, b))(jp, jb)
    proxy = jax.jit(lambda p, b: jlm.selection_proxy(jcfg, p, b))(jp, jb)
    opt = jax_sgd(jax_cosine_warmup(0.05, 10, 100), momentum=0.9)
    state = opt.init(jp)._replace(step=jnp.int32(LR_STEP))
    stepped, state, smetrics = jax.jit(jax_step_fn(jcfg, opt))(jp, state, jb)
    return dict(dtype=dtype, jcfg=jcfg, tcfg=tcfg, model=model, tb=tb,
                hidden=np.asarray(h, np.float32), loss=float(loss),
                ce=float(metrics["ce"]), proxy=np.asarray(proxy),
                stepped=stepped, slots=state.slots,
                step_loss=float(smetrics["loss"]))


def test_gemma_forward_loss_and_proxy_match_jax(gemma):
    lim = LIMITS[gemma["dtype"]]
    cfg, model, tb = gemma["tcfg"], gemma["model"], gemma["tb"]
    with torch.no_grad():
        h, states, aux = lm.forward(cfg, model, tb["tokens"])
        loss, metrics = lm.lm_loss(cfg, model, tb)
    assert h.dtype == common.dtype_of(cfg) and states == {}
    assert float(aux) == 0.0
    assert _rel(gemma["hidden"], h) <= lim["hidden"]
    assert abs(float(loss) - gemma["loss"]) <= lim["loss"] * gemma["loss"]
    assert abs(float(metrics["ce"]) - gemma["ce"]) <= lim["loss"] * gemma["ce"]
    proxy = lm.selection_proxy(cfg, model, tb)
    assert proxy.shape == (B, cfg.d_model) and proxy.dtype == torch.float32
    assert _rel(gemma["proxy"], proxy) <= lim["proxy"]


def test_gemma_train_step_matches_jax(gemma):
    """One step of SGD (momentum 0.9, warmup + cosine at step 12) on the
    weighted loss: the loss, every parameter and every momentum slot."""
    lim = LIMITS[gemma["dtype"]]
    cfg = gemma["tcfg"]
    jcfg, jp, _, model = _pair("gemma-2b", gemma["dtype"])
    opt = sgd(model.parameters(), cosine_with_warmup(0.05, 10, 100),
              momentum=0.9)
    opt.step_count = LR_STEP
    metrics = lm_train_step_fn(cfg, model, opt)(gemma["tb"])
    assert abs(float(metrics["loss"]) - gemma["step_loss"]) <= (
        lim["loss"] * gemma["step_loss"])
    for name, p in model.named_parameters():
        assert p.dtype == (torch.float32 if name.endswith("scale")
                           else common.dtype_of(cfg)), name
        assert _rel(_jax_leaf(gemma["stepped"], name), p) <= lim["params"], \
            name
        slot = opt.state[p]["momentum"]
        assert slot.dtype == torch.float32
        assert _rel(_jax_leaf(gemma["slots"], name), slot) <= max(
            lim["params"], lim["proxy"]), name


def test_init_matches_jax_names_shapes_and_dtypes():
    """The port's own init has the reference's tree: names, shapes, dtypes,
    and the full gemma-2b count (on the meta device: no memory)."""
    cfg = get_smoke_config("gemma-2b")
    jp = jlm.init_lm(jax_smoke("gemma-2b"), jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    model = lm.init_lm(cfg, gen, device="cpu")
    for name, p in model.named_parameters():
        assert tuple(p.shape) == _jax_leaf(jp, name).shape, name
        # the reference's dtypes: f32 norm scales, bf16 weights
        assert p.dtype == (torch.float32 if name.endswith("scale")
                           else torch.bfloat16), name
    # one port tensor per JAX leaf and super-block
    leaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(list(model.parameters())) == sum(
        cfg.n_superblocks if path[0].key == "blocks" else 1
        for path, _ in leaves)
    emb = model["embed"].detach().float()
    assert abs(float(emb.std()) - 0.02) < 0.003
    full = lm.init_lm(get_config("gemma-2b"), device="meta")
    shapes = jax.eval_shape(lambda: jlm.init_lm(jax_config("gemma-2b"),
                                                jax.random.PRNGKey(0)))
    assert common.count_params(full) == jcommon.count_params(shapes) == (
        2_506_172_416)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "codeqwen1.5-7b",
                                  "gemma2-9b"])
def test_dense_configs_forward_and_loss_match_jax(arch):
    """The other dense smoke configs: LayerNorm + biases + plain GELU
    (starcoder2), SwiGLU + full MHA + biases (codeqwen), local/global
    windows + softcaps + post-norms (gemma2)."""
    jcfg, jp, tcfg, model = _pair(arch)
    jb, tb = _batch(jcfg, seed=1, s=40)
    h, _, _ = jax.jit(lambda p, t: jlm.forward(jcfg, p, t))(jp, jb["tokens"])
    loss, _ = jax.jit(lambda p, b: jlm.lm_loss(jcfg, p, b))(jp, jb)
    with torch.no_grad():
        th, _, _ = lm.forward(tcfg, model, tb["tokens"])
        tloss, _ = lm.lm_loss(tcfg, model, tb)
        tlogits = lm.mask_padded_logits(tcfg, lm._head_out(tcfg, model, th))
    assert _rel(h, th) <= 1e-5
    assert abs(float(tloss) - float(loss)) <= 1e-5 * float(loss)
    # the serving paths' logits: padded vocabulary columns at -1e9
    logits = jlm.mask_padded_logits(jcfg, jlm._head_out(jcfg, jp, h))
    assert float(tlogits[..., tcfg.vocab_size:].max()) == -1e9
    assert _rel(np.asarray(logits)[..., :jcfg.vocab_size],
                tlogits[..., :tcfg.vocab_size]) <= 1e-5


@pytest.mark.parametrize("causal,window", [(True, None), (True, 12),
                                           (False, None)])
def test_blockwise_attention_matches_jax(causal, window):
    """``_attend_blockwise`` (8 x 8 tiles, GQA, softcap) against the
    reference's on the same q, k, v, and against the port's dense
    ``_attend`` with the same mask."""
    cfg = get_smoke_config("gemma2-9b").replace(
        param_dtype="float32", flash_block_q=8, flash_block_kv=8)
    jcfg = jax_smoke("gemma2-9b").replace(
        param_dtype="float32", flash_block_q=8, flash_block_kv=8)
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    want = np.asarray(jattn._attend_blockwise(
        jcfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = attention._attend_blockwise(cfg, tq, tk, tv, causal=causal,
                                      window=window)
    assert _rel(want, got) <= 1e-5
    if not causal:
        mask = None
    elif window is None:
        mask = common.causal_mask(32, 32, 0)
    else:
        mask = common.window_mask(32, 32, 0, window)
    dense = attention._attend(cfg, tq, tk, tv, mask)
    assert _rel(dense.numpy(), got) <= 1e-5


def test_blockwise_path_in_the_model_matches_jax():
    """gemma2-9b smoke at a lowered ``flash_threshold`` (S = 32 >= 16, 8 x 8
    tiles, window 12): the whole forward through the blockwise path."""
    kw = dict(flash_threshold=16, flash_block_q=8, flash_block_kv=8,
              sliding_window=12)
    jcfg, jp, tcfg, model = _pair("gemma2-9b", **kw)
    jb, tb = _batch(jcfg, seed=2, s=32)
    h, _, _ = jax.jit(lambda p, t: jlm.forward(jcfg, p, t))(jp, jb["tokens"])
    with torch.no_grad():
        th, _, _ = lm.forward(tcfg, model, tb["tokens"])
    assert _rel(h, th) <= 1e-5


def _grads(model, cfg, tb):
    model.zero_grad(set_to_none=True)
    loss, _ = lm.lm_loss(cfg, model, tb)
    loss.backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def test_remat_gives_the_same_gradients():
    """Recomputing each super-block in the backward pass
    (``torch.utils.checkpoint``) changes no number."""
    _, _, tcfg, model = _pair("gemma-2b", remat=True)
    _, tb = _batch(tcfg)
    with_remat = _grads(model, tcfg, tb)
    without = _grads(model, tcfg.replace(remat=False), tb)
    for name, g in with_remat.items():
        assert torch.equal(g, without[name]), name


def test_microbatches_agree_with_one_batch_and_with_jax():
    """``microbatches=4`` adds the four micro-batches' gradients in f32
    without renormalizing their weights: the same step as one batch (up to
    the order of the sums) and as the reference's scan."""
    jcfg, jp, tcfg, model1 = _pair("gemma-2b")
    model4 = lm.params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    jb, tb = _batch(jcfg, seed=4, b=8)
    out = {}
    for mb, model in ((1, model1), (4, model4)):
        opt = sgd(model.parameters(), 0.1)
        out[mb] = lm_train_step_fn(tcfg, model, opt, microbatches=mb)(tb)
    jopt = jax_sgd(0.1)
    jstepped, _, jm = jax.jit(jax_step_fn(jcfg, jopt, microbatches=4))(
        jp, jopt.init(jp), jb)
    for (name, p1), p4 in zip(model1.named_parameters(), model4.parameters()):
        assert _rel(p1.detach().numpy(), p4) <= 1e-5, name
        assert _rel(_jax_leaf(jstepped, name), p4) <= 1e-5, name
    # the metrics are the last micro-batch's, as in the reference
    assert abs(float(out[4]["loss"]) - float(jm["loss"])) <= 1e-5 * float(
        jm["loss"])


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "zamba2-7b",
                                  "xlstm-1.3b", "hubert-xlarge",
                                  "llama-3.2-vision-90b"])
def test_unported_archs_raise_naming_the_roadmap_item(arch):
    with pytest.raises(NotImplementedError, match="The rest of the LM side"):
        lm.init_lm(get_smoke_config(arch), device="cpu")


def test_cosine_with_warmup_matches_jax():
    """The driver's schedule (lr 3e-3, 10 warmup steps, 100 steps) and an
    uneven one, step by step, to two f32 roundings (numpy's and XLA's
    cosines differ by one)."""
    for args in ((3e-3, 10, 100), (0.05, 7, 33, 0.25)):
        port, ref = cosine_with_warmup(*args), jax_cosine_warmup(*args)
        for step in range(args[2] + 5):
            want = float(ref(jnp.int32(step)))
            assert port(step) == pytest.approx(want, rel=2.4e-7, abs=0), step

"""The port's encoder-only path against the JAX package, on the CPU:
hubert-xlarge's smoke config (frame ``embeds`` in place of tokens, no
``embed``, the ``unit_head``, non-causal attention) through
``lm.init_lm``, ``lm.forward``, ``lm_loss``, ``selection_proxy``, one SGD
step, micro-batches, the non-causal blockwise attention route,
``train.steps.reference_tree`` and the launchers.

The same parameters (``repro.models.lm.init_lm``, carried over by
``lm.params_from_jax``) and the same numpy inputs go through both
packages; the frames are seeded normals cast to bf16 in both, as
``tests/test_models.py`` makes them.  Limits, relative to the largest
magnitude of the reference's output, are ``tests/test_torch_lm_model.py``'s:

- ``param_dtype="float32"``: 1e-5 (measured: up to 5e-7);
- the published bf16: hidden 2e-2, loss 1e-3, proxy 2e-3, parameters
  after a step 1.6e-2 (measured: 6.8e-3, 2.6e-4, 7.3e-4, 7.8e-3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import cosine_with_warmup as jax_cosine  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro.train.steps import lm_train_step_fn as jax_step_fn  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import attention, common, lm  # noqa: E402
from repro_torch.optim import cosine_with_warmup, sgd  # noqa: E402
from repro_torch.train.steps import (lm_train_step_fn,  # noqa: E402
                                     reference_tree)

ARCH = "hubert-xlarge"
LIMITS = {"float32": dict(hidden=1e-5, loss=1e-5, proxy=1e-5, params=1e-5),
          "bfloat16": dict(hidden=2e-2, loss=1e-3, proxy=2e-3,
                           params=1.6e-2)}
B, S = 4, 16
LR_STEP = 12
# the blockwise route at S 16: 8 x 8 tiles from a threshold of 8
FLASH = dict(flash_threshold=8, flash_block_q=8, flash_block_kv=8)


def _rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


def _pair(dtype="float32", **kw):
    """(jax cfg, jax params, torch cfg, port model) on the same values."""
    jcfg = jax_smoke(ARCH).replace(param_dtype=dtype, **kw)
    tcfg = get_smoke_config(ARCH).replace(param_dtype=dtype, **kw)
    jp = jlm.init_lm(jcfg, jax.random.PRNGKey(0))
    model = lm.params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
    return jcfg, jp, tcfg, model


def _batch(cfg, seed=0, b=B, s=S):
    """bf16 frames (B, S, d_model) and unit targets, in both packages."""
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    tgt = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    w = rng.random(b).astype(np.float32)
    w /= w.sum()
    return ({"embeds": jnp.asarray(e).astype(jnp.bfloat16),
             "targets": jnp.asarray(tgt), "weights": jnp.asarray(w)},
            {"embeds": torch.from_numpy(e).bfloat16(),
             "targets": torch.from_numpy(tgt), "weights": torch.from_numpy(w)})


def _jax_leaf(tree, name):
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


def test_init_has_no_embed_and_a_unit_head():
    """The port's own init: no ``embed``, ``unit_head`` (d_model, Vpad) =
    (64, 256) at vocab 96, the reference's paths, shapes and dtypes; the
    full config's count (meta device) against the reference's."""
    cfg = get_smoke_config(ARCH)
    jp = jlm.init_lm(jax_smoke(ARCH), jax.random.PRNGKey(0))
    model = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert "embed" not in model and "embed" not in jp
    assert "lm_head" not in model
    assert tuple(model["unit_head"].shape) == (64, 256) == (
        cfg.d_model, cfg.padded_vocab)
    assert lm.head_weight(cfg, model) is model["unit_head"]
    for name, p in model.named_parameters():
        assert tuple(p.shape) == _jax_leaf(jp, name).shape, name
        assert p.dtype == (torch.float32 if name.split(".")[-1] in (
            "scale", "bias") else torch.bfloat16), name
    leaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(list(model.parameters())) == sum(
        cfg.n_superblocks if path[0].key == "blocks" else 1
        for path, _ in leaves)
    full = lm.init_lm(get_config(ARCH), device="meta")
    shapes = jax.eval_shape(lambda: jlm.init_lm(jax_config(ARCH),
                                                jax.random.PRNGKey(0)))
    assert common.count_params(full) == jcommon.count_params(shapes) == (
        944_622_080)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def audio(request):
    """hubert smoke in both dtypes: the JAX outputs (forward, loss,
    proxies, one SGD step) computed once for the module."""
    dtype = request.param
    jcfg, jp, tcfg, model = _pair(dtype)
    jb, tb = _batch(jcfg)
    h, (loss, metrics), proxy = jax.jit(lambda p, b: (
        jlm.forward(jcfg, p, embeds=b["embeds"])[0],
        jlm.lm_loss(jcfg, p, b), jlm.selection_proxy(jcfg, p, b)))(jp, jb)
    opt = jax_sgd(jax_cosine(0.05, 10, 100), momentum=0.9)
    state = opt.init(jp)._replace(step=jnp.int32(LR_STEP))
    stepped, state, smetrics = jax.jit(jax_step_fn(jcfg, opt))(jp, state, jb)
    return dict(dtype=dtype, tcfg=tcfg, model=model, tb=tb,
                hidden=np.asarray(h, np.float32), loss=float(loss),
                ce=float(metrics["ce"]), proxy=np.asarray(proxy),
                stepped=stepped, slots=state.slots,
                step_loss=float(smetrics["loss"]))


def test_forward_loss_and_proxy_match_jax(audio):
    """The forward on bf16 frames (cast to the parameter dtype), the loss,
    and the proxy on ``unit_head``."""
    lim = LIMITS[audio["dtype"]]
    cfg, model, tb = audio["tcfg"], audio["model"], audio["tb"]
    with torch.no_grad():
        h, states, aux = lm.forward(cfg, model, embeds=tb["embeds"])
        loss, metrics = lm.lm_loss(cfg, model, tb)
    assert h.dtype == common.dtype_of(cfg) and states == {}
    assert _rel(audio["hidden"], h) <= lim["hidden"]
    assert abs(float(loss) - audio["loss"]) <= lim["loss"] * audio["loss"]
    assert abs(float(metrics["ce"]) - audio["ce"]) <= lim["loss"] * audio["ce"]
    proxy = lm.selection_proxy(cfg, model, tb)
    assert proxy.shape == (B, cfg.d_model) and proxy.dtype == torch.float32
    assert _rel(audio["proxy"], proxy) <= lim["proxy"]


def test_train_step_matches_jax(audio):
    """One SGD step (momentum 0.9, warmup + cosine at step 12): the loss,
    every parameter and every momentum slot."""
    lim = LIMITS[audio["dtype"]]
    cfg = audio["tcfg"]
    _, _, _, model = _pair(audio["dtype"])
    opt = sgd(model.parameters(), cosine_with_warmup(0.05, 10, 100),
              momentum=0.9)
    opt.step_count = LR_STEP
    metrics = lm_train_step_fn(cfg, model, opt)(audio["tb"])
    assert abs(float(metrics["loss"]) - audio["step_loss"]) <= (
        lim["loss"] * audio["step_loss"])
    for name, p in model.named_parameters():
        assert _rel(_jax_leaf(audio["stepped"], name), p) <= lim["params"], \
            name
        assert _rel(_jax_leaf(audio["slots"], name),
                    opt.state[p]["momentum"]) <= max(lim["params"],
                                                     lim["proxy"]), name


def test_blockwise_route_matches_jax_and_the_dense_route():
    """Non-causal attention on the blockwise route (threshold 8, 8 x 8
    tiles at S 16): the port's forward against the reference's on the
    same config, and against its own dense ``_attend`` route (the
    default threshold), both within 1e-5 at f32; the tiles themselves
    against ``_attend`` with no mask."""
    jcfg, jp, tcfg, model = _pair(**FLASH)
    jb, tb = _batch(jcfg, seed=5)
    want = jax.jit(lambda p, e: jlm.forward(jcfg, p, embeds=e)[0])(
        jp, jb["embeds"])
    dense_cfg = tcfg.replace(flash_threshold=get_smoke_config(
        ARCH).flash_threshold)
    assert S >= tcfg.flash_threshold and S < dense_cfg.flash_threshold
    with torch.no_grad():
        got = lm.forward(tcfg, model, embeds=tb["embeds"])[0]
        dense = lm.forward(dense_cfg, model, embeds=tb["embeds"])[0]
    assert _rel(want, got) <= 1e-5
    assert _rel(dense.numpy(), got) <= 1e-5
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, S, 4, 16)).astype(
        np.float32)) for _ in range(3))
    tiles = attention._attend_blockwise(tcfg, q, k, v, causal=False,
                                        window=None)
    assert _rel(attention._attend(tcfg, q, k, v, None).numpy(),
                tiles) <= 1e-5


def test_microbatches_chunk_embeds_and_match_jax():
    """``microbatches=2`` splits ``embeds`` with every other key: the same
    step as the reference's scan."""
    jcfg, jp, tcfg, model = _pair()
    jb, tb = _batch(jcfg, seed=4)
    out = lm_train_step_fn(tcfg, model, sgd(model.parameters(), 0.1),
                           microbatches=2)(tb)
    jopt = jax_sgd(0.1)
    jstepped, _, jm = jax.jit(jax_step_fn(jcfg, jopt, microbatches=2))(
        jp, jopt.init(jp), jb)
    for name, p in model.named_parameters():
        assert _rel(_jax_leaf(jstepped, name), p) <= 1e-5, name
    assert abs(float(out["loss"]) - float(jm["loss"])) <= 1e-5 * float(
        jm["loss"])


def test_reference_tree_gives_jax_back_exactly():
    """``params_from_jax`` then ``reference_tree``: the reference's tree
    with no ``embed``, every leaf bit for bit (bf16 through its bits)."""
    jp = jax.tree_util.tree_map(np.asarray, jlm.init_lm(
        jax_smoke(ARCH), jax.random.PRNGKey(2)))
    model = lm.params_from_jax(get_smoke_config(ARCH), jp, device="cpu")
    back = reference_tree(model)
    assert "embed" not in back and back.keys() == jp.keys()
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jp))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(back))
    assert flat_j.keys() == flat_t.keys()
    for path, want in flat_j.items():
        got = flat_t[path]
        if want.dtype.name == "bfloat16":
            got = got.view(torch.int16).numpy().view(np.uint16)
            want = want.view(np.uint16)
        else:
            got = got.numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), path


def test_serve_main_refuses_an_encoder_only_model():
    """The reference's own refusal (``repro/launch/serve.py:39-40``)."""
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])


def test_train_main_refuses_its_own_token_stream_naming_the_seam():
    with pytest.raises(SystemExit, match="stream="):
        train.main(["--arch", ARCH, "--smoke", "--device", "cpu"])

"""The port's vision path against the JAX package, on the CPU: the
``xattn`` sub-layer of llama-3.2-vision-90b (``attention.cross_attention``
and ``init_attention(cross=True)``, the tanh gates, the plain FFN, the
vision K / V in the decode state) through ``lm.forward``, ``lm_loss``,
``selection_proxy``, one SGD step, micro-batches, EF-TopK, prefill and
decode, ``launch/serve._seat`` / ``generate`` and ``launch/serve.main``'s
refusal (the driver: ``tests/test_torch_lm_vision_audio_driver.py``).

The same parameters (``repro.models.lm.init_lm``, carried over by
``lm.params_from_jax``) and the same numpy inputs go through both
packages; the vision states are seeded normals cast to bf16 in both, as
``tests/test_models.py`` makes them.  The gates start at 0, where
``tanh(0) = 0`` hides the cross-attention and its FFN entirely: every
comparison past the init and the gates' own gradients sets them to 0.7
(``gate_attn``) and -0.4 (``gate_mlp``) in the JAX tree first.  Limits,
relative to the largest magnitude of the reference's output, are
``tests/test_torch_lm_model.py``'s:

- ``param_dtype="float32"``: 1e-5 (measured: up to 1.2e-6);
- the published bf16: hidden 2e-2, loss 1e-3, proxy 2e-3, parameters
  after a step 1.6e-2 (measured: 1.1e-2, 1.2e-4, 1.8e-3, 8.9e-3);
  prefill and decode logits 3e-2 and caches 2.5e-2, as in
  ``tests/test_torch_lm_decode.py`` (measured: 1.2e-2, 0).

One quantity needs more at bf16: the momentum slots after the step, which
hold the step's gradients.  Their limit is 4e-2 here (``test_torch_lm_
model.py`` holds gemma's to 1.6e-2): measured 2.7e-2 on this file's batch
and up to 3.6e-2 over three seeds, on ``wq`` / ``wk`` of the self-attention
layers, whose gradients flow back through the bf16 cross-attention.  The
two 0-d gates' gradients are each one sum over B x S x d products with
much cancellation, rounded in bf16 by both packages: the reference's
parts from an f32 recomputation on the same weights by up to 61% of its
value (the port's by up to 7%), so at bf16 only the gates' values after
the step are held; their gradients are held at f32, to 1e-5.

At f32 the EF-TopK residuals after two steps are held to 2e-4: each is
the gradient that top-k dropped, summed over the steps, and the dropped
one of the two stacked ``gate_mlp`` gradients (one sum with cancellation,
as above) parts from the reference's by 9.2e-5 of its size; ``embed``'s
by 1.9e-5 (its rows hold only the tokens of the batch).  The parameters
after those steps stay within 1e-5 (measured: 7e-7).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs.base import VisionStubConfig as JaxVision  # noqa: E402
from repro.launch.serve import _seat as jax_seat  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import cosine_with_warmup as jax_cosine  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro.train.steps import lm_train_step_fn as jax_step_fn  # noqa: E402
from repro.train.steps import make_lm_train_step as jax_make_step  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.base import VisionStubConfig  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serve import _seat  # noqa: E402
from repro_torch.models import attention, common, lm  # noqa: E402
from repro_torch.optim import cosine_with_warmup, sgd  # noqa: E402
from repro_torch.train.steps import (init_compression_state,  # noqa: E402
                                     lm_train_step_fn, make_lm_train_step,
                                     reference_tree)

ARCH = "llama-3.2-vision-90b"
LIMITS = {"float32": dict(hidden=1e-5, loss=1e-5, proxy=1e-5, params=1e-5,
                          slots=1e-5, logits=1e-5, cache=1e-5),
          "bfloat16": dict(hidden=2e-2, loss=1e-3, proxy=2e-3,
                           params=1.6e-2, slots=4e-2, logits=3e-2,
                           cache=2.5e-2)}
GATES = (0.7, -0.4)       # gate_attn, gate_mlp: live, tanh 0.60 / -0.38
XSUB = "sub4"             # the xattn sub-layer of (4 x attn, xattn)
B, S = 4, 16
LR_STEP = 12


def _rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


def _set_gates(jp, gates):
    """The JAX tree with every super-block's gates set to ``gates``."""
    n = jp["blocks"][XSUB]["gate_attn"].shape[0]
    jp["blocks"][XSUB]["gate_attn"] = jnp.full((n,), gates[0], jnp.float32)
    jp["blocks"][XSUB]["gate_mlp"] = jnp.full((n,), gates[1], jnp.float32)
    return jp


def _pair(dtype="float32", gates=GATES, **kw):
    """(jax cfg, jax params, torch cfg, port model) on the same values."""
    jcfg = jax_smoke(ARCH).replace(param_dtype=dtype, **kw)
    tcfg = get_smoke_config(ARCH).replace(param_dtype=dtype, **kw)
    jp = jlm.init_lm(jcfg, jax.random.PRNGKey(0))
    if gates is not None:
        jp = _set_gates(jp, gates)
    model = lm.params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
    return jcfg, jp, tcfg, model


def _vision(cfg, b, seed):
    """Seeded normals (B, n_img, d_embed), bf16 in both packages."""
    v = np.random.default_rng(seed).standard_normal(
        (b, cfg.vision.n_tokens, cfg.vision.d_embed)).astype(np.float32)
    return jnp.asarray(v).astype(jnp.bfloat16), torch.from_numpy(v).bfloat16()


def _batch(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    tgt = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    w = rng.random(b).astype(np.float32)
    w /= w.sum()
    jv, tv = _vision(cfg, b, seed + 100)
    return ({"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt),
             "weights": jnp.asarray(w), "vision": jv},
            {"tokens": torch.from_numpy(tok), "targets": torch.from_numpy(tgt),
             "weights": torch.from_numpy(w), "vision": tv})


def _jax_leaf(tree, name):
    """The JAX leaf of a port parameter name (``blocks.0.sub4.gate_attn``
    is ``tree['blocks']['sub4']['gate_attn'][0]``)."""
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


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# cross_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["kv_states", "kv_cache", "qk_norm",
                                  "d_embed"])
def test_cross_attention_matches_jax(case):
    """``cross_attention`` on the reference's parameters: over the vision
    states (with the cache it returns), then a new query against that
    cache (K taken as it is, not normed again).  ``qk_norm`` runs both
    with head norms of random scales; ``d_embed`` projects K / V from 48
    vision features into a width-64 model."""
    kw = {"param_dtype": "float32"}
    if case == "qk_norm":
        kw["qk_norm"] = True
    if case == "d_embed":
        kw["vision"] = None       # set per package below
    jcfg = jax_smoke(ARCH).replace(**kw)
    tcfg = get_smoke_config(ARCH).replace(**kw)
    if case == "d_embed":
        jcfg = jcfg.replace(vision=JaxVision(n_tokens=16, d_embed=48))
        tcfg = tcfg.replace(vision=VisionStubConfig(n_tokens=16, d_embed=48))
    jp = jattn.init_attention(jcfg, jax.random.PRNGKey(1), cross=True)
    rng = np.random.default_rng(5)
    if case == "qk_norm":
        for key in ("q_norm", "k_norm"):
            jp[key] = jnp.asarray(rng.uniform(0.5, 1.5, jcfg.head_dim),
                                  jnp.float32)
    tp = _torch_tree(jax.tree_util.tree_map(np.asarray, jp))
    own = attention.init_attention(tcfg, "cpu", cross=True)
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in tp.items()}
    assert tuple(own["wk"].shape) == (tcfg.vision.d_embed, tcfg.kv_dim)
    x = rng.standard_normal((2, 8, jcfg.d_model)).astype(np.float32)
    vis = rng.standard_normal((2, 16, jcfg.vision.d_embed)).astype(
        np.float32)
    want, jcache = jattn.cross_attention(jcfg, jp, jnp.asarray(x),
                                         kv_states=jnp.asarray(vis),
                                         return_cache=True)
    got, tcache = attention.cross_attention(tcfg, tp, torch.from_numpy(x),
                                            kv_states=torch.from_numpy(vis),
                                            return_cache=True)
    assert _rel(want, got) <= 1e-5
    for key in ("k", "v"):
        assert tcache[key].shape == (2, 16, tcfg.n_kv_heads, tcfg.head_dim)
        assert _rel(jcache[key], tcache[key]) <= 1e-5, key
    _, none = attention.cross_attention(tcfg, tp, torch.from_numpy(x),
                                        kv_states=torch.from_numpy(vis))
    assert none is None
    if case == "kv_states":
        return
    x1 = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    want, _ = jattn.cross_attention(jcfg, jp, jnp.asarray(x1),
                                    kv_cache=jcache)
    got, _ = attention.cross_attention(tcfg, tp, torch.from_numpy(x1),
                                       kv_cache=tcache)
    assert _rel(want, got) <= 1e-5


# ---------------------------------------------------------------------------
# init, forward, loss, proxy, step
# ---------------------------------------------------------------------------

def test_init_matches_jax_tree_with_zero_gates():
    """The port's own init: the reference's paths, shapes and dtypes, the
    gates 0-d f32 zeros, the xattn K / V from ``d_embed``, the FFN plain;
    and the count at full width, cut to one super-block as the card runs
    it (meta device), against the reference's."""
    cfg = get_smoke_config(ARCH)
    jp = jlm.init_lm(jax_smoke(ARCH), jax.random.PRNGKey(0))
    model = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    names = [n for n, _ in model.named_parameters()]
    for name, p in model.named_parameters():
        assert tuple(p.shape) == _jax_leaf(jp, name).shape, name
    leaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(names) == sum(cfg.n_superblocks if path[0].key == "blocks"
                             else 1 for path, _ in leaves)
    for gate in ("gate_attn", "gate_mlp"):
        g = model["blocks"][0][XSUB][gate]
        assert g.shape == () and g.dtype == torch.float32
        assert float(g.detach()) == 0
        assert jp["blocks"][XSUB][gate].shape == (cfg.n_superblocks,)
    assert "w_gate" in model["blocks"][0][XSUB]["mlp"]
    cut = dict(n_superblocks=1, n_layers=5)
    full = lm.init_lm(get_config(ARCH).replace(**cut), device="meta")
    shapes = jax.eval_shape(lambda: jlm.init_lm(
        jax_config(ARCH).replace(**cut), jax.random.PRNGKey(0)))
    assert common.count_params(full) == jcommon.count_params(shapes) == (
        6_379_626_498)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def vlm(request):
    """The vlm smoke model with live gates in both dtypes: the JAX outputs
    (forward, loss, proxies, one SGD step) computed once for the module."""
    dtype = request.param
    jcfg, jp, tcfg, model = _pair(dtype)
    jb, tb = _batch(jcfg)
    h, (loss, metrics), proxy = jax.jit(lambda p, b: (
        jlm.forward(jcfg, p, b["tokens"], vision=b["vision"])[0],
        jlm.lm_loss(jcfg, p, b), jlm.selection_proxy(jcfg, p, b)))(jp, jb)
    opt = jax_sgd(jax_cosine(0.05, 10, 100), momentum=0.9)
    state = opt.init(jp)._replace(step=jnp.int32(LR_STEP))
    stepped, state, smetrics = jax.jit(jax_step_fn(jcfg, opt))(jp, state, jb)
    return dict(dtype=dtype, jcfg=jcfg, jp=jp, tcfg=tcfg, model=model, tb=tb,
                hidden=np.asarray(h, np.float32), loss=float(loss),
                ce=float(metrics["ce"]), proxy=np.asarray(proxy),
                stepped=stepped, slots=state.slots,
                step_loss=float(smetrics["loss"]))


def test_forward_loss_and_proxy_match_jax(vlm):
    lim = LIMITS[vlm["dtype"]]
    cfg, model, tb = vlm["tcfg"], vlm["model"], vlm["tb"]
    with torch.no_grad():
        h, states, aux = lm.forward(cfg, model, tb["tokens"],
                                    vision=tb["vision"])
        loss, metrics = lm.lm_loss(cfg, model, tb)
    assert h.dtype == common.dtype_of(cfg) and states == {}
    assert float(aux) == 0.0
    assert _rel(vlm["hidden"], h) <= lim["hidden"]
    assert abs(float(loss) - vlm["loss"]) <= lim["loss"] * vlm["loss"]
    assert abs(float(metrics["ce"]) - vlm["ce"]) <= lim["loss"] * vlm["ce"]
    proxy = lm.selection_proxy(cfg, model, tb)
    assert proxy.shape == (B, cfg.d_model) and proxy.dtype == torch.float32
    assert _rel(vlm["proxy"], proxy) <= lim["proxy"]


def test_train_step_matches_jax(vlm):
    """One SGD step (momentum 0.9, warmup + cosine at step 12) on the
    weighted loss: the loss, every parameter (the gates too) and every
    momentum slot (at bf16 not the gates': see the module's docstring)."""
    lim = LIMITS[vlm["dtype"]]
    cfg = vlm["tcfg"]
    _, _, _, model = _pair(vlm["dtype"])
    opt = sgd(model.parameters(), cosine_with_warmup(0.05, 10, 100),
              momentum=0.9)
    opt.step_count = LR_STEP
    metrics = lm_train_step_fn(cfg, model, opt)(vlm["tb"])
    assert abs(float(metrics["loss"]) - vlm["step_loss"]) <= (
        lim["loss"] * vlm["step_loss"])
    for name, p in model.named_parameters():
        f32 = name.endswith("scale") or "gate_" in name
        assert p.dtype == (torch.float32 if f32 else common.dtype_of(cfg)), \
            name
        assert _rel(_jax_leaf(vlm["stepped"], name), p) <= lim["params"], \
            name
        if "gate_" in name and vlm["dtype"] == "bfloat16":
            continue
        assert _rel(_jax_leaf(vlm["slots"], name),
                    opt.state[p]["momentum"]) <= lim["slots"], name


def test_gradients_at_zero_gates_match_jax():
    """At init the gates are 0: the cross-attention and its FFN add
    nothing, and their weights get no gradient, but the gates do
    (d tanh(g) / dg = 1).  Every gradient against ``jax.grad`` at f32, the
    gates' to 1e-5 of their own size."""
    jcfg, jp, tcfg, model = _pair(gates=None)
    jb, tb = _batch(jcfg, seed=3)
    grads = jax.jit(jax.grad(lambda p, b: jlm.lm_loss(jcfg, p, b)[0]))(jp, jb)
    loss, _ = lm.lm_loss(tcfg, model, tb)
    loss.backward()
    for name, p in model.named_parameters():
        want = _jax_leaf(grads, name)
        if f".{XSUB}.attn." in name or f".{XSUB}.mlp." in name:
            assert not np.any(want) and not torch.any(p.grad), name
            continue
        assert _rel(want, p.grad) <= 1e-5, name
    for gate in ("gate_attn", "gate_mlp"):
        g = model["blocks"][0][XSUB][gate].grad
        assert g.shape == () and abs(float(g)) > 0, gate


def test_vision_moves_the_logits():
    """Two vision inputs give logits apart by more than 1e-2 of max
    |logit| with live gates, and the same bits with the gates at 0."""
    outs = {}
    for gates in (GATES, None):
        _, _, cfg, model = _pair(gates=gates)
        _, tb = _batch(cfg, seed=7)
        _, other = _vision(cfg, B, seed=8)
        with torch.no_grad():
            lg = [lm._head_out(cfg, model, lm.forward(
                cfg, model, tb["tokens"], vision=v)[0])
                for v in (tb["vision"], other)]
        outs[gates] = lg
    a, b = outs[GATES]
    assert float((a - b).abs().max()) > 1e-2 * float(a.abs().max())
    a, b = outs[None]
    assert torch.equal(a, b)


def test_microbatches_chunk_vision_and_match_jax():
    """``microbatches=2`` splits ``vision`` with every other key: the same
    step as the reference's scan, and as one batch."""
    jcfg, jp, tcfg, model2 = _pair()
    model1 = lm.params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    jb, tb = _batch(jcfg, seed=4, b=4)
    out = {}
    for mb, model in ((1, model1), (2, model2)):
        out[mb] = lm_train_step_fn(tcfg, model, sgd(model.parameters(), 0.1),
                                   microbatches=mb)(tb)
    jopt = jax_sgd(0.1)
    jstepped, _, jm = jax.jit(jax_step_fn(jcfg, jopt, microbatches=2))(
        jp, jopt.init(jp), jb)
    for (name, p1), p2 in zip(model1.named_parameters(),
                              model2.parameters()):
        assert _rel(p1.detach().numpy(), p2) <= 1e-5, name
        assert _rel(_jax_leaf(jstepped, name), p2) <= 1e-5, name
    assert abs(float(out[2]["loss"]) - float(jm["loss"])) <= 1e-5 * float(
        jm["loss"])


def test_compressed_step_stacks_the_gates_and_matches_jax():
    """EF-TopK (fraction 0.05) over two super-blocks: the gates are one
    (2,) leaf each, as the reference stacks them; two steps' loss and
    parameters against the reference's to 1e-5, the residuals to 2e-4
    (the module's docstring)."""
    kw = dict(n_superblocks=2, n_layers=10)
    jcfg, jp, tcfg, model = _pair(**kw)
    jopt = jax_sgd(0.05, momentum=0.9)
    step = jax_make_step(jcfg, jopt, compress_frac=0.05)
    jstate, jcs = jopt.init(jp), jcomp.init_state(jp)
    opt = sgd(model.parameters(), 0.05, momentum=0.9)
    tstep = make_lm_train_step(tcfg, model, opt, compress_frac=0.05)
    cs = init_compression_state(model)
    for key in ("blocks.sub4.gate_attn", "blocks.sub4.gate_mlp"):
        assert cs.residual[key].shape == (2,)
    for seed in (1, 2):
        jb, tb = _batch(jcfg, seed=seed)
        jp, jstate, jcs, jm = step(jp, jstate, jcs, jb)
        m, cs = tstep(tb, cs)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * float(
            jm["loss"])
    for name, p in model.named_parameters():
        assert _rel(_jax_leaf(jp, name), p) <= 1e-5, name
    assert len(cs.residual) == len(jax.tree_util.tree_leaves(jcs.residual))
    for key, r in cs.residual.items():
        node = jcs.residual
        for part in key.split("."):
            node = node[part]
        assert r.shape == node.shape and _rel(node, r) <= 2e-4, key


def test_reference_tree_gives_jax_back_exactly():
    """``params_from_jax`` then ``reference_tree`` over two super-blocks
    with gates of other values each: the reference's tree, every leaf
    bit for bit (bf16 through its bits), the gates stacked to (2,)."""
    jcfg = jax_smoke(ARCH).replace(n_superblocks=2, n_layers=10)
    jp = jax.tree_util.tree_map(np.asarray, jlm.init_lm(
        jcfg, jax.random.PRNGKey(2)))
    jp["blocks"][XSUB]["gate_attn"] = np.array([0.25, -1.5], np.float32)
    jp["blocks"][XSUB]["gate_mlp"] = np.array([2.0, 0.125], np.float32)
    tcfg = get_smoke_config(ARCH).replace(n_superblocks=2, n_layers=10)
    model = lm.params_from_jax(tcfg, jp, device="cpu")
    assert model["blocks"][1][XSUB]["gate_attn"].shape == ()
    assert float(model["blocks"][1][XSUB]["gate_attn"].detach()) == -1.5
    back = reference_tree(model)
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


# ---------------------------------------------------------------------------
# prefill, decode, serving
# ---------------------------------------------------------------------------

def _xcaches(state):
    return [blk[XSUB] for blk in state["blocks"]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax_and_the_forward(dtype):
    """Prompt 6, decode to 12 with live gates, after
    ``tests/test_models.py``'s decode test: every logit row against the
    reference's loop and against the port's own teacher-forced forward;
    the xattn cache after prefill against the reference's, and bit for
    bit the same after every decode step."""
    lim = LIMITS[dtype]
    jcfg, jp, tcfg, model = _pair(dtype)
    rng = np.random.default_rng(11)
    tok = rng.integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    jv, tv = _vision(tcfg, 2, seed=12)
    v = tcfg.vocab_size
    # the reference's loop
    logits, jpre = jax.jit(lambda p, t, vis: jlm.prefill_step(
        jcfg, p, t, vision=vis))(jp, jnp.asarray(tok[:, :6]), jv)
    jstate = jax_seat(jlm.init_decode_state(jcfg, 2, 12), jpre)
    decode = jax.jit(lambda p, st, t, pos: jlm.decode_step(jcfg, p, st, t,
                                                           pos))
    want = [np.asarray(logits)[:, :v]]
    for t in range(6, 12):
        logits, jstate = decode(jp, jstate, jnp.asarray(tok[:, t:t + 1]),
                                jnp.int32(t))
        want.append(np.asarray(logits)[:, :v])
    # the port's
    logits, pstate = lm.prefill_step(tcfg, model, torch.from_numpy(tok[:, :6]),
                                     vision=tv)
    pre = [{k: c[k].clone() for k in ("k", "v")} for c in _xcaches(pstate)]
    for i, c in enumerate(_xcaches(pstate)):
        for key in ("k", "v"):
            assert c[key].dtype == common.dtype_of(tcfg)
            assert c[key].shape == (2, tcfg.vision.n_tokens, tcfg.n_kv_heads,
                                    tcfg.head_dim)
            assert _rel(np.asarray(jpre["blocks"][XSUB][key])[i],
                        c[key]) <= lim["cache"], key
    state = _seat(lm.init_decode_state(tcfg, 2, 12, "cpu"), pstate)
    got = [logits[:, :v]]
    for t in range(6, 12):
        logits, state = lm.decode_step(tcfg, model, state,
                                       torch.from_numpy(tok[:, t:t + 1]), t)
        got.append(logits[:, :v])
        for c, p in zip(_xcaches(state), pre):
            assert torch.equal(c["k"], p["k"]) and torch.equal(c["v"],
                                                               p["v"]), t
    for t, (w, g) in enumerate(zip(want, got)):
        assert _rel(w, g) <= lim["logits"], t
    with torch.no_grad():
        h, _, _ = lm.forward(tcfg, model, torch.from_numpy(tok), vision=tv)
        fwd = lm.mask_padded_logits(tcfg, lm._head_out(tcfg, model, h))
    for i, t in enumerate(range(5, 12)):
        assert _rel(fwd[:, t, :v].float().numpy(), got[i]) <= lim["logits"], t


def test_seat_keeps_the_vision_cache_and_generate_equals_the_forward():
    """``_seat`` into ``init_decode_state(cfg, B, s_max)``: the xattn leaf
    is the prefill's (B, n_img, kv, hd), not a sequence axis of s_max;
    ``generate`` with vision decodes through the seated state to the
    tokens the teacher-forced forward's argmax gives."""
    _, _, cfg, model = _pair()
    rng = np.random.default_rng(13)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 6))
                               .astype(np.int32))
    _, tv = _vision(cfg, 2, seed=14)
    _, pstate = lm.prefill_step(cfg, model, prompts, vision=tv)
    s_max = 12
    assert s_max != cfg.vision.n_tokens
    seated = _seat(lm.init_decode_state(cfg, 2, s_max, "cpu"), pstate)
    for c, p in zip(_xcaches(seated), _xcaches(pstate)):
        for key in ("k", "v"):
            assert c[key].shape == (2, cfg.vision.n_tokens, cfg.n_kv_heads,
                                    cfg.head_dim)
            assert torch.equal(c[key], p[key])
    assert seated["blocks"][0]["sub0"]["k"].shape[1] == s_max
    out = serve.generate(cfg, model, prompts, 6, vision=tv)
    seq = torch.cat([prompts, out[:, :6]], dim=1)
    with torch.no_grad():
        h, _, _ = lm.forward(cfg, model, seq, vision=tv)
        fwd = lm.mask_padded_logits(cfg, lm._head_out(cfg, model, h[:, 5:]))
    assert torch.equal(fwd.argmax(-1).to(torch.int32), out)


def test_serve_main_refuses_naming_the_vision_input():
    with pytest.raises(SystemExit, match="vision"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])

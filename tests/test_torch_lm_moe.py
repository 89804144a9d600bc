"""The port's Mixture-of-Experts (``repro_torch.models.moe`` and its wiring
in ``models/lm.py``) against the JAX package, on the CPU.

The same parameters (``repro.models.moe.init_moe`` / ``lm.init_lm``,
carried over by ``lm.params_from_jax``) and the same numpy inputs go
through both packages, on the smoke configs of qwen3-moe-30b-a3b (8
experts, top-2) and moonshot-v1-16b-a3b (the same, plus a shared expert).
Limits, relative to the largest magnitude of the reference's output:

- ``param_dtype="float32"``: 1e-5 for ``moe_apply``'s output, aux loss and
  gradients, and for the LM's hidden states, loss, proxies, the
  parameters after one SGD step and the decode logits (measured: up to
  1.5e-6);
- the published bf16: each package's hidden states and loss against an
  f32 forward on the same weights, the port's no further off than 1.25x
  the reference's (or the dense archs' 2e-2 / 1e-3 where wider);
- routing and dispatch index for index: the top-k ids with ties, the
  (E, C) token table with the dropped ranks, and EF-TopK's kept set, bit
  for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import load_checkpoint as j_load  # noqa: E402
from repro.checkpoint import save_checkpoint as j_save  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch.serve import _seat as jax_seat  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.optim import cosine_with_warmup as jax_cosine_warmup  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro.train.steps import lm_train_step_fn as jax_step_fn  # noqa: E402
from repro_torch.checkpoint import (load_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import common, lm, moe  # noqa: E402
from repro_torch.optim import cosine_with_warmup, sgd  # noqa: E402
from repro_torch.train import compression as comp  # noqa: E402
from repro_torch.train.steps import (_stacked, lm_train_step_fn,  # noqa: E402
                                     reference_leaves, reference_tree)

MOE = ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"]
B, S = 4, 16
LR_STEP = 12


def _rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _open(cfg, cf=8.0):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _pair(arch, dtype="float32", cf=None):
    jcfg = jax_smoke(arch).replace(param_dtype=dtype)
    tcfg = get_smoke_config(arch).replace(param_dtype=dtype)
    if cf is not None:
        jcfg, tcfg = _open(jcfg, cf), _open(tcfg, cf)
    jp = jlm.init_lm(jcfg, jax.random.PRNGKey(0))
    model = lm.params_from_jax(tcfg, _np(jp), device="cpu")
    return jcfg, jp, tcfg, model


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


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------

def _layer(arch, cf=None, seed=0, b=2, s=S):
    """(jax cfg, torch cfg, jax params, port params, x) for one MoE layer
    at f32."""
    jcfg = jax_smoke(arch).replace(param_dtype="float32")
    tcfg = get_smoke_config(arch).replace(param_dtype="float32")
    if cf is not None:
        jcfg, tcfg = _open(jcfg, cf), _open(tcfg, cf)
    jp = _np(jmoe.init_moe(jcfg, jax.random.PRNGKey(seed)))
    tp = jax.tree_util.tree_map(torch.from_numpy, jp)
    x = np.random.default_rng(seed).standard_normal(
        (b, s, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def test_route_and_dispatch_match_jax_with_ties_and_drops():
    """Tokens of all zeros route on equal probabilities (every expert
    tied): ``lax.top_k`` takes the lowest ids, and so must the port.  At
    capacity 4 some ranks are dropped; on the same ids and weights the
    (E, C) token table and the weights must equal the reference's entry
    for entry."""
    jcfg, tcfg, jp, tp, x = _layer("qwen3-moe-30b-a3b", cf=0.5, s=24)
    x[:, ::3] = 0.0
    m = jcfg.moe
    cap = jmoe.capacity_of(jcfg, x.shape[1])
    assert cap == moe.capacity_of(tcfg, x.shape[1]) == 4
    ji, jw, jaux = jmoe._route(jcfg, jp["router"], jnp.asarray(x))
    ti, tw, taux = moe._route(tcfg, tp["router"], torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(ti[:, ::3].numpy(),
                                  np.broadcast_to(np.arange(m.top_k),
                                                  (2, 8, m.top_k)))
    assert _rel(jw, tw) <= 1e-6
    assert abs(float(jaux) - float(taux)) <= 1e-6 * abs(float(jaux))
    dropped = 0
    for g in range(2):
        jidx, jcw = jmoe._dispatch_indices(ji[g], jw[g], m.n_experts, cap)
        # the same ids and weights into both (the two softmaxes part by an
        # ulp)
        tidx, tcw = moe._dispatch_indices(
            torch.from_numpy(np.array(ji[g])).long(),
            torch.from_numpy(np.array(jw[g])), m.n_experts, cap)
        np.testing.assert_array_equal(np.asarray(jidx), tidx.numpy())
        np.testing.assert_array_equal(np.asarray(jcw), tcw.numpy())
        dropped += x.shape[1] * m.top_k - int((tidx < x.shape[1]).sum())
    assert dropped > 0


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("cf", [1.25, 8.0], ids=["drops", "no-drops"])
def test_moe_apply_and_its_gradients_match_jax(arch, cf):
    """``moe_apply`` at f32 on a batch (2 x 16 tokens): its output and aux
    loss, and the gradients of ``sum(y * r) + aux`` with respect to x and
    every weight (the port's fixed-order backward of the dispatch gather
    against the reference's scatter-add), at the published capacity
    factor (some assignments dropped) and opened to 8.0 (none)."""
    jcfg, tcfg, jp, tp, x = _layer(arch, cf=cf)
    r = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jmoe.moe_apply(jcfg, p, xx)
        return jnp.sum(y * r) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    tp = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(), tp)
    tx = torch.from_numpy(x).requires_grad_()
    ty, taux = moe.moe_apply(tcfg, tp, tx)
    ((ty * torch.from_numpy(r)).sum() + taux).backward()
    assert _rel(jy, ty) <= 1e-5
    assert abs(float(jaux) - float(taux)) <= 1e-5 * abs(float(jaux))
    assert _rel(jgx, tx.grad) <= 1e-5
    for key, g in jax.tree_util.tree_leaves_with_path(jgp):
        node = tp
        for k in key:
            node = node[k.key]
        assert _rel(g, node.grad) <= 1e-5, key
    ti, tw, _ = moe._route(tcfg, tp["router"], tx.detach())
    cap = moe.capacity_of(tcfg, S)
    kept = sum(int((moe._dispatch_indices(ti[g], tw[g], tcfg.moe.n_experts,
                                          cap)[0] < S).sum())
               for g in range(2))
    assert (kept < 2 * S * tcfg.moe.top_k) == (cf == 1.25)


def test_moe_batch_group_matches_jax():
    """``group="batch"`` (decode's routing): the B tokens as one group."""
    jcfg, tcfg, jp, tp, x = _layer("moonshot-v1-16b-a3b", b=6, s=1)
    jy, jaux = jax.jit(lambda p, xx: jmoe.moe_apply(jcfg, p, xx,
                                                    group="batch"))(
        jp, jnp.asarray(x))
    ty, taux = moe.moe_apply(tcfg, tp, torch.from_numpy(x), group="batch")
    assert _rel(jy, ty) <= 1e-5
    assert abs(float(jaux) - float(taux)) <= 1e-5 * abs(float(jaux))


def test_dispatch_backward_is_the_gathers():
    """The fixed-order backward of ``_Dispatch`` equals autograd's own
    backward of the gather it replaces (f64: the two orders agree to the
    last bits that matter)."""
    _, tcfg, _, tp, x = _layer("qwen3-moe-30b-a3b", cf=1.25)
    xg = torch.from_numpy(x).double()
    ti, tw, _ = moe._route(tcfg, tp["router"], xg.float())
    idx, _, slots = moe._dispatch(ti, tw, tcfg.moe.n_experts,
                                  moe.capacity_of(tcfg, S))
    gout = torch.randn((2, *idx.shape[1:], x.shape[-1]), dtype=torch.float64)
    a = xg.clone().requires_grad_()
    moe._Dispatch.apply(a, idx, slots).mul(gout).sum().backward()
    bx = xg.clone().requires_grad_()
    pad = torch.cat([bx, bx.new_zeros((2, 1, x.shape[-1]))], 1)
    e, c = idx.shape[1:]
    pad.gather(1, idx.reshape(2, e * c, 1).expand(-1, -1, x.shape[-1])
               ).reshape(gout.shape).mul(gout).sum().backward()
    torch.testing.assert_close(a.grad, bx.grad, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# The LM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=MOE)
def moe_lm(request):
    """Each MoE smoke arch at f32: the JAX forward, loss, proxies and one
    SGD step, computed once."""
    arch = request.param
    jcfg, jp, tcfg, model = _pair(arch)
    jb, tb = _batch(jcfg)
    (h, _, aux), (loss, _), proxy = jax.jit(lambda p, b: (
        jlm.forward(jcfg, p, b["tokens"]), jlm.lm_loss(jcfg, p, b),
        jlm.selection_proxy(jcfg, p, b)))(jp, jb)
    opt = jax_sgd(jax_cosine_warmup(0.05, 10, 100), momentum=0.9)
    state = opt.init(jp)._replace(step=jnp.int32(LR_STEP))
    stepped, state, smetrics = jax.jit(jax_step_fn(jcfg, opt))(jp, state, jb)
    return dict(arch=arch, jcfg=jcfg, jp=jp, tcfg=tcfg, model=model, tb=tb,
                hidden=np.asarray(h), aux=float(aux), loss=float(loss),
                proxy=np.asarray(proxy), stepped=stepped, slots=state.slots,
                step_loss=float(smetrics["loss"]))


def test_moe_forward_loss_and_proxy_match_jax(moe_lm):
    cfg, model, tb = moe_lm["tcfg"], moe_lm["model"], moe_lm["tb"]
    with torch.no_grad():
        h, states, aux = lm.forward(cfg, model, tb["tokens"])
        loss, metrics = lm.lm_loss(cfg, model, tb)
    assert states == {}
    assert _rel(moe_lm["hidden"], h) <= 1e-5
    assert moe_lm["aux"] > 0
    assert abs(float(aux) - moe_lm["aux"]) <= 1e-5 * moe_lm["aux"]
    assert float(metrics["aux"]) == float(aux)
    assert abs(float(loss) - moe_lm["loss"]) <= 1e-5 * moe_lm["loss"]
    proxy = lm.selection_proxy(cfg, model, tb)
    assert _rel(moe_lm["proxy"], proxy) <= 1e-5


def test_moe_train_step_matches_jax(moe_lm):
    """One weighted SGD step (momentum 0.9, warmup + cosine at step 12):
    the loss (with the aux loss), every parameter and every momentum
    slot, the router and the stacked experts among them."""
    jcfg, jp, cfg, model = _pair(moe_lm["arch"])
    opt = sgd(model.parameters(), cosine_with_warmup(0.05, 10, 100),
              momentum=0.9)
    opt.step_count = LR_STEP
    metrics = lm_train_step_fn(cfg, model, opt)(moe_lm["tb"])
    assert abs(float(metrics["loss"]) - moe_lm["step_loss"]) <= (
        1e-5 * moe_lm["step_loss"])
    names = set()
    for name, p in model.named_parameters():
        names.add(name.split(".")[-1])
        assert _rel(_jax_leaf(moe_lm["stepped"], name), p) <= 1e-5, name
        assert _rel(_jax_leaf(moe_lm["slots"], name),
                    opt.state[p]["momentum"]) <= 1e-5, name
    assert {"router", "w_gate", "w_up", "w_down"} <= names


def test_remat_carries_the_aux_loss():
    """Remat on: the aux loss goes through ``torch.utils.checkpoint``
    beside the residual stream, and every gradient (the router's from the
    aux loss included) equals the one without remat, bit for bit."""
    _, _, tcfg, model = _pair("qwen3-moe-30b-a3b")
    _, tb = _batch(tcfg, seed=3)
    grads = {}
    for remat in (True, False):
        cfg = tcfg.replace(remat=remat)
        model.zero_grad(set_to_none=True)
        loss, metrics = lm.lm_loss(cfg, model, tb)
        loss.backward()
        grads[remat] = ({n: p.grad.clone()
                         for n, p in model.named_parameters()},
                        float(metrics["aux"]))
    assert grads[True][1] == grads[False][1] > 0
    for name, g in grads[True][0].items():
        assert torch.equal(g, grads[False][0][name]), name


@pytest.mark.parametrize("arch", MOE)
def test_moe_bf16_is_as_close_to_f32_as_jax(arch):
    """The published bf16: the port's hidden states and loss are no
    further from an f32 forward on the same (bf16-valued) weights than
    the reference's bf16 forward is (within 1.25x, or the dense archs'
    limits, hidden 2e-2 and loss 1e-3, where those are wider).  The two
    bf16 forwards are not held to each other: a router's near tie that
    bf16 rounding flips sends a token to another expert, a discrete step
    (measured on this batch: both bf16 forwards 0.24 of max |h| from f32
    on qwen3-moe; on moonshot JAX's 8.7e-2, the port's 1.1e-2)."""
    jcfg, jp, tcfg, model = _pair(arch, "bfloat16")
    cfg32 = tcfg.replace(param_dtype="float32")
    m32 = lm.params_from_jax(cfg32, jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), _np(jp)), device="cpu")
    jb, tb = _batch(jcfg, seed=5)
    h, _, _ = jax.jit(lambda p, t: jlm.forward(jcfg, p, t))(jp,
                                                            jb["tokens"])
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


@pytest.mark.parametrize("arch", MOE)
def test_moe_prefill_and_decode_match_jax(arch):
    """Prefill 6 tokens, seat into 12 slots, decode 6 (capacity opened to
    8.0, as the reference's own decode test does, so train-mode routing
    drops nothing): every step's logits against JAX's ``decode_step`` and
    against the port's own teacher-forced forward, within 1e-5."""
    jcfg, jp, tcfg, model = _pair(arch, cf=8.0)
    rng = np.random.default_rng(2)
    tok = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    v, s0 = jcfg.vocab_size, 6
    prefill = jax.jit(lambda p, t: jlm.prefill_step(jcfg, p, t))
    decode = jax.jit(lambda p, st, t, pos: jlm.decode_step(jcfg, p, st, t,
                                                           pos))
    jl, jst = prefill(jp, jnp.asarray(tok[:, :s0]))
    jst = jax_seat(jlm.init_decode_state(jcfg, 2, 12), jst)
    tl, tst = lm.prefill_step(tcfg, model, torch.from_numpy(tok[:, :s0]))
    tst = serve._seat(lm.init_decode_state(tcfg, 2, 12, "cpu"), tst)
    with torch.no_grad():
        h, _, _ = lm.forward(tcfg, model, torch.from_numpy(tok))
        fwd = lm._head_out(tcfg, model, h)[..., :v]
    assert _rel(np.asarray(jl)[:, :v], tl[:, :v]) <= 1e-5
    assert _rel(fwd[:, s0 - 1].numpy(), tl[:, :v]) <= 1e-5
    for t in range(s0, 12):
        jl, jst = decode(jp, jst, jnp.asarray(tok[:, t:t + 1]), jnp.int32(t))
        tl, tst = lm.decode_step(tcfg, model, tst,
                                 torch.from_numpy(tok[:, t:t + 1]), t)
        assert _rel(np.asarray(jl)[:, :v], tl[:, :v]) <= 1e-5, t
        assert _rel(fwd[:, t].numpy(), tl[:, :v]) <= 1e-5, t


# ---------------------------------------------------------------------------
# Init, options, snapshots, launchers (MoE and hybrid archs)
# ---------------------------------------------------------------------------

ARCHS = MOE + ["zamba2-7b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_jax_names_shapes_and_dtypes(arch):
    """The port's own init has the reference's tree (f32 routers, norms
    and SSM scalars; bf16 weights), one tensor per JAX leaf and
    super-block, and the full config's count (on the meta device)."""
    cfg = get_smoke_config(arch)
    jp = jlm.init_lm(jax_smoke(arch), jax.random.PRNGKey(0))
    model = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    for name, p in model.named_parameters():
        want = _jax_leaf(jp, name)
        assert tuple(p.shape) == want.shape, name
        node = jp
        for part in (name.split(".") if not name.startswith("blocks.")
                     else ["blocks", *name.split(".")[2:]]):
            node = node[part]
        assert str(p.dtype).split(".")[1] == str(node.dtype), name
    leaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(list(model.parameters())) == sum(
        cfg.n_superblocks if path[0].key == "blocks" else 1
        for path, _ in leaves)
    full = lm.init_lm(get_config(arch), device="meta")
    shapes = jax.eval_shape(lambda: jlm.init_lm(jax_config(arch),
                                                jax.random.PRNGKey(0)))
    assert common.count_params(full) == jcommon.count_params(shapes)


@pytest.mark.parametrize("arch", ARCHS)
def test_ef_topk_kept_set_bit_equal_to_jax(arch):
    """EF-TopK over the reference's leaves of a bf16 step's gradients
    (the stacked expert leaves ``blocks.sub0.mlp.w_*`` (L, E, d, ff), the
    router, moonshot's shared experts, zamba2's ``shared.*`` and
    ``prologue.*.mixer.*``): the dense kept gradient and the residual,
    two steps, bit for bit."""
    _, jp, tcfg, model = _pair(arch, "bfloat16")
    _, tb = _batch(tcfg, seed=6)
    named = dict(model.named_parameters())
    leaves = reference_leaves(named)
    jstate = jcomp.init_state(jp)
    jcompress = jax.jit(lambda g, st: jcomp.compress_with_feedback(g, st,
                                                                   0.05))
    tstate = comp.init_state(_stacked(named, leaves))
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        lm.lm_loss(tcfg, model, tb)[0].backward()
        grads = _stacked({n: p.grad for n, p in named.items()}, leaves)
        td, tstate = comp.compress_with_feedback(grads, tstate, 0.05)
        jg = jax.tree_util.tree_map(lambda x: x, jp)

        def put(tree, key, val):
            parts = key.split(".")
            node = tree
            for part in parts[:-1]:
                node = node[part]
            node[parts[-1]] = jnp.asarray(val.float().numpy())

        for key, g in grads.items():
            put(jg, key, g)
        jd, jstate = jcompress(jg, jstate)
        for key in grads:
            node, rnode = jd, jstate.residual
            for part in key.split("."):
                node, rnode = node[part], rnode[part]
            np.testing.assert_array_equal(np.asarray(node), td[key].numpy(),
                                          err_msg=key)
            np.testing.assert_array_equal(np.asarray(rnode),
                                          tstate.residual[key].numpy(),
                                          err_msg=key)
    assert any(".mlp.w_gate" in k or ".mixer." in k for k in grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_snapshot_restores_across_the_packages(arch, tmp_path):
    """An LM snapshot in the reference's format: JAX's (its pytree,
    stacked blocks) restored by the port (``params_from_jax`` on the
    loaded tensors) bit for bit; the port's (``steps.reference_tree``)
    restored by JAX, whose forward on it equals its forward on the
    original parameters bit for bit."""
    jcfg, jp, tcfg, model = _pair(arch, "bfloat16")
    j_save(str(tmp_path / "jax"), 3, {"params": jp})
    snap = load_checkpoint(str(tmp_path / "jax"))
    restored = lm.params_from_jax(tcfg, snap["params"], device="cpu")
    for (name, p), q in zip(model.named_parameters(), restored.parameters()):
        assert p.dtype == q.dtype and torch.equal(p, q), name
    save_checkpoint(str(tmp_path / "port"), 4,
                    {"params": reference_tree(model)})
    back = j_load(str(tmp_path / "port"))["params"]
    assert jax.tree_util.tree_structure(back) == (
        jax.tree_util.tree_structure(jp))
    tok = jnp.asarray(np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32))
    fwd = jax.jit(lambda p, t: jlm.forward(jcfg, p, t)[0])
    np.testing.assert_array_equal(
        np.asarray(fwd(jax.tree_util.tree_map(jnp.asarray, back), tok)
                   ).view(np.uint16),
        np.asarray(fwd(jp, tok)).view(np.uint16))


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_run_the_arch_on_the_cpu(arch):
    """``launch/train.main`` and ``launch/serve.main`` with ``--arch``,
    ``--smoke`` and ``--device cpu``, no other flag changed in kind."""
    rep = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--steps", "4", "--select-every", "2", "--window",
                      "4", "--micro-batch", "2", "--seq-len", "16"])
    assert rep["arch"] == arch and len(rep["losses"]) == 4
    assert all(np.isfinite(rep["losses"]))
    assert len(rep["selections"]) == 2
    for sel in rep["selections"]:
        assert abs(sum(sel["weights"]) - 1) < 1e-4
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--requests", "2", "--batch", "2", "--gen-len", "4"])
    assert out["requests"] == 2 and out["tokens"] == 8

"""xlstm-1.3b's smoke model through the port's LM assembly
(``repro_torch.models.lm`` with the ``mlstm`` and ``slstm`` sub-layers)
against the JAX package, on the CPU.

The same parameters (``repro.models.lm.init_lm``, carried over by
``lm.params_from_jax``) and the same numpy tokens go through both
packages, on xlstm-1.3b's smoke config (d 64, one super-block of seven
mLSTM and one sLSTM layer, chunk 16, vocabulary 96, tied head), at
``param_dtype="float32"``.  Limits, relative to the largest magnitude of
the reference's output:

- 1e-5 for the loss, the selection proxies, the loss of one SGD step and
  every decode step's logits, against JAX's ``decode_step`` and against
  the port's own teacher-forced forward;
- the hidden states, the prefill states and the gradients (the momentum
  slots of one SGD step) within the reference's own f32 error plus the
  port's, each the distance of an f32 result from an f64 recomputation of
  the same function (``_f64_lm``: the port's modules with their f32 casts
  made f64).  The exponential gates make this model's f32 arithmetic
  ill-conditioned: at these weights and tokens JAX's hidden states are
  6.4e-5 of max |h| from f64 and its gradients up to 1.2e-4 of a leaf's
  max |g|, the port's 3.1e-5 and 7.6e-5, and the two packages part by
  3.3e-5 and 1.5e-4 (measured), where 1e-5 would need better than f32
  gives.  So each package is held to f64 (the port no further from it
  than JAX, ``test_f32_is_as_close_to_f64_as_jax``), and the port to JAX
  within the sum of the two: for a gradient, JAX's error on that leaf
  plus the largest over the leaves.  The oracle runs the port's own
  sources, so JAX's distance from it is held under fixed ceilings
  (``H_CEILING``, ``G_CEILING``, every leaf): a fault the port shares
  with its f64 copy fails there, against JAX, rather than widening the
  limits;
- the gate biases ``b_i``: both cells are invariant to one shift of the
  input gate at every token (apart from the starting state and the
  floors), so their exact gradient is near 0 and its f32 value rounding;
  they are measured against the block's largest gate-bias gradient;
- the parameters after the step by the update: each is the JAX
  parameter within 1e-5 of its size plus the step's learning rate times
  its gradient's allowance;
- the published bf16 in ``test_torch_lm_xlstm.py``.

JAX compiles the smoke model's forward, loss and proxy once and its train
step once, in the module's fixture.
"""

import inspect
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch.serve import _seat as jax_seat  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import cosine_with_warmup as jax_cosine_warmup  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro.train.steps import lm_train_step_fn as jax_step_fn  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.serve import _seat  # noqa: E402
from repro_torch.configs.base import MLSTM, SLSTM  # noqa: E402
from repro_torch.models import common, lm, xlstm  # noqa: E402
from repro_torch.optim import cosine_with_warmup, sgd  # noqa: E402
from repro_torch.train.steps import lm_train_step_fn  # noqa: E402

ARCH = "xlstm-1.3b"
B = 2
LR_STEP = 12
MLSTM_KEYS = ("C", "n", "m", "conv")
SLSTM_KEYS = ("h", "c", "n", "m")
# ceilings on JAX's f32 distance from the f64 oracle, set from the readings
# (6.4e-5 of max |h|; up to 1.2e-4 of a gradient leaf's scale)
H_CEILING = 1.5e-4
G_CEILING = 3e-4


def _rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


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


def _f64(module):
    """A copy of a port module with its f32 casts made f64."""
    src = inspect.getsource(module).replace(".float()", ".double()")
    src = src.replace("torch.float32", "torch.float64")
    copy = types.ModuleType(module.__name__ + "_f64")
    exec(compile(src, copy.__name__, "exec"), copy.__dict__)
    return copy


def _f64_lm():
    """The port's LM with ``models/lm.py``, ``common.py`` and ``xlstm.py``
    computing in f64 (the oracle of the f32 runs' rounding)."""
    lm64, xl64 = _f64(lm), _f64(xlstm)
    lm64.common = _f64(common)
    for kind in (MLSTM, SLSTM):
        lm64._MIXERS[kind] = tuple(getattr(xl64, f.__name__)
                                   for f in lm._MIXERS[kind])
    return lm64


def _bias_scale(grads, name):
    """The scale a gradient is measured against: its own max |g|, and for
    a gate bias ``b_i`` the block's largest gate-bias gradient."""
    if not name.endswith("mixer.b_i"):
        return float(np.abs(grads[name]).max())
    blk = name.rsplit(".", 1)[0]
    gates = "zifo" if f"{blk}.b_z" in grads else "if"
    return max(float(np.abs(grads[f"{blk}.b_{g}"]).max()) for g in gates)


@pytest.fixture(scope="module")
def xl():
    """The smoke model at f32: the JAX forward, loss, proxies and one SGD
    step, computed once, on 4 x 32 tokens (two chunks); its parameters
    as numpy; the f64 oracle's hidden states and gradients; JAX's f32
    errors against it."""
    jcfg = jax_smoke(ARCH).replace(param_dtype="float32")
    tcfg = get_smoke_config(ARCH).replace(param_dtype="float32")
    jp = jlm.init_lm(jcfg, jax.random.PRNGKey(0))
    params = _np(jp)
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

    lm64 = _f64_lm()
    cfg64 = tcfg.replace(param_dtype="float64")
    m64 = lm64.params_from_jax(cfg64, jax.tree_util.tree_map(
        lambda a: a.astype(np.float64), params), device="cpu")
    h64, _, _ = lm64.forward(cfg64, m64, tb["tokens"])
    lm64.lm_loss(cfg64, m64, tb)[0].backward()
    h64 = h64.detach().numpy()
    g64 = {n: p.grad.numpy() for n, p in m64.named_parameters()}
    slots = _np(state.slots)
    jax_g = {n: float(np.abs(_leaf(slots, n) - g).max()) / _bias_scale(g64, n)
             for n, g in g64.items()}
    jax_h_err = float(np.abs(np.asarray(h) - h64).max() / np.abs(h64).max())
    # the oracle is the port's own code: held to JAX here, so that a fault
    # the two share cannot widen the limits the tests derive from it
    assert jax_h_err <= H_CEILING, f"JAX's hidden states {jax_h_err} from f64"
    far = {n: e for n, e in jax_g.items() if e > G_CEILING}
    assert not far, f"JAX's gradients from f64, over {G_CEILING}: {far}"
    return dict(jcfg=jcfg, jp=jp, params=params, tcfg=tcfg, tb=tb,
                hidden=np.asarray(h), loss=float(loss),
                proxy=np.asarray(proxy), stepped=_np(stepped), slots=slots,
                step_loss=float(sm["loss"]), h64=h64, g64=g64,
                jax_h_err=jax_h_err, jax_g=jax_g,
                jax_g_err=max(jax_g.values()))


def _model(xl, **changes):
    cfg = xl["tcfg"].replace(**changes)
    return cfg, lm.params_from_jax(cfg, xl["params"], device="cpu")


def test_tree_holds_the_reference_leaves(xl):
    """``params_from_jax`` gives one tensor per JAX leaf and super-block,
    bit for bit, in its dtype: the blocks' ``sub0``-``sub6`` mLSTM and
    ``sub7`` sLSTM mixers, the tied head (no ``lm_head``)."""
    cfg, model = _model(xl)
    names = [n for n, _ in model.named_parameters()]
    assert "lm_head" not in names and "embed" in names
    assert sorted(model["blocks"][0]._modules) == [f"sub{i}"
                                                   for i in range(8)]
    assert any(n.startswith("blocks.0.sub0.mixer.wq") for n in names)
    assert any(n.startswith("blocks.0.sub7.mixer.r_z") for n in names)
    for name, p in model.named_parameters():
        want = _leaf(xl["params"], name)
        assert p.dtype == torch.float32, name
        np.testing.assert_array_equal(p.detach().numpy(), want,
                                      err_msg=name)
    assert lm.head_weight(cfg, model).data_ptr() == (
        model["embed"].data_ptr())


def _h_limit(xl):
    """The port-to-JAX limit of the hidden states and what is computed
    from them: JAX's f32 error against f64 (at most ``H_CEILING``) plus
    the port's (no larger, ``test_f32_is_as_close_to_f64_as_jax``)."""
    return 2 * max(1e-5, xl["jax_h_err"])


def _g_limit(xl, name):
    """The port-to-JAX limit of leaf ``name``'s gradient, against its
    ``_bias_scale``: JAX's f32 error on that leaf plus the port's largest
    over the leaves (no larger than JAX's largest, itself at most
    ``G_CEILING``)."""
    return max(1e-5, xl["jax_g"][name]) + max(1e-5, xl["jax_g_err"])


def _port_grads(cfg, model, tb):
    model.zero_grad(set_to_none=True)
    lm.lm_loss(cfg, model, tb)[0].backward()
    return {n: p.grad.numpy() for n, p in model.named_parameters()}


def test_f32_is_as_close_to_f64_as_jax(xl):
    """The port's f32 hidden states and its largest gradient error (over
    the leaves, each against its ``_bias_scale``) are no further from the
    f64 recomputation than JAX's are (or within 1e-5)."""
    cfg, model = _model(xl)
    with torch.no_grad():
        h, _, _ = lm.forward(cfg, model, xl["tb"]["tokens"])
    h64 = xl["h64"]
    err_h = float(np.abs(h.numpy() - h64).max() / np.abs(h64).max())
    assert err_h <= max(1e-5, xl["jax_h_err"])
    g = _port_grads(cfg, model, xl["tb"])
    err_g = max(float(np.abs(g[n] - g64).max()) / _bias_scale(xl["g64"], n)
                for n, g64 in xl["g64"].items())
    assert err_g <= max(1e-5, xl["jax_g_err"])


def test_forward_loss_and_proxy_match_jax(xl):
    cfg, model = _model(xl)
    tb = xl["tb"]
    with torch.no_grad():
        h, states, aux = lm.forward(cfg, model, tb["tokens"])
        loss, _ = lm.lm_loss(cfg, model, tb)
    assert states == {} and float(aux) == 0.0
    assert _rel(xl["hidden"], h) <= _h_limit(xl)
    assert abs(float(loss) - xl["loss"]) <= 1e-5 * xl["loss"]
    assert _rel(xl["proxy"], lm.selection_proxy(cfg, model, tb)) <= 1e-5


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_train_step_matches_jax(xl, remat):
    """One weighted SGD step (momentum 0.9, the driver's schedule at step
    12), with the super-block recomputed in the backward (``checkpoint``)
    and without: the loss; each momentum slot (the gradient: the first
    step's momentum is 0) and each parameter against JAX's."""
    cfg, model = _model(xl, remat=remat)
    sched = cosine_with_warmup(0.05, 10, 100)
    opt = sgd(model.parameters(), sched, momentum=0.9)
    opt.step_count = LR_STEP
    metrics = lm_train_step_fn(cfg, model, opt)(xl["tb"])
    assert abs(float(metrics["loss"]) - xl["step_loss"]) <= (
        1e-5 * xl["step_loss"])
    for name, p in model.named_parameters():
        allow = _g_limit(xl, name)
        scale = _bias_scale(xl["g64"], name)
        slot = opt.state[p]["momentum"].numpy()
        assert np.abs(_leaf(xl["slots"], name) - slot).max() <= (
            allow * scale), name
        want = _leaf(xl["stepped"], name)
        assert np.abs(want - p.detach().numpy()).max() <= (
            1e-5 * np.abs(want).max() + sched(LR_STEP) * allow * scale), name


def test_prefill_and_decode_match_jax(xl):
    """Prefill 32 tokens (two chunks), seat into 48 slots, decode 16:
    every step's logits against JAX's ``decode_step`` and against the
    port's teacher-forced forward over the 48 tokens (chunk 16: three
    chunks), within 1e-5; the prefill states against JAX's (the hidden
    states' limit: they are computed from them); the seated state is the
    prefill's, its shapes and dtypes those of ``init_decode_state``."""
    jcfg, jp = xl["jcfg"], xl["jp"]
    cfg, model = _model(xl)
    v = cfg.vocab_size
    tok = np.random.default_rng(3).integers(0, v, (B, 48)).astype(np.int32)
    prefill = jax.jit(lambda p, t: jlm.prefill_step(jcfg, p, t))
    decode = jax.jit(lambda p, st, t, pos: jlm.decode_step(jcfg, p, st, t,
                                                           pos))
    jl, jps = prefill(jp, jnp.asarray(tok[:, :32]))
    jst = jax_seat(jlm.init_decode_state(jcfg, B, 48), jps)
    tl, tps = lm.prefill_step(cfg, model, torch.from_numpy(tok[:, :32]))
    empty = lm.init_decode_state(cfg, B, 48, "cpu")
    for si, keys in ((0, MLSTM_KEYS), (6, MLSTM_KEYS), (7, SLSTM_KEYS)):
        got, blank = tps["blocks"][0][f"sub{si}"], empty["blocks"][0][
            f"sub{si}"]
        assert sorted(got) == sorted(keys) == sorted(blank)
        for key in keys:
            assert got[key].shape == blank[key].shape, (si, key)
            assert got[key].dtype == blank[key].dtype, (si, key)
            assert _rel(jps["blocks"][f"sub{si}"][key][0], got[key]) <= (
                _h_limit(xl)), (si, key)
    tst = _seat(empty, tps)
    assert tst["blocks"][0]["sub7"]["c"] is tps["blocks"][0]["sub7"]["c"]
    steps = [(np.asarray(jl)[:, :v], tl[:, :v])]
    for t in range(32, 48):
        jl, jst = decode(jp, jst, jnp.asarray(tok[:, t:t + 1]), jnp.int32(t))
        tl, tst = lm.decode_step(cfg, model, tst,
                                 torch.from_numpy(tok[:, t:t + 1]), t)
        steps.append((np.asarray(jl)[:, :v], tl[:, :v]))
    with torch.no_grad():
        h, _, _ = lm.forward(cfg, model, torch.from_numpy(tok))
        fwd = lm._head_out(cfg, model, h)[..., :v]
    for i, (jlg, tlg) in enumerate(steps):
        assert _rel(jlg, tlg) <= 1e-5, i
        assert _rel(fwd[:, 31 + i].numpy(), tlg) <= 1e-5, i

"""The port's LM training options against the JAX package, on the CPU:
AdamW, global-norm clipping (also on SGD), ``exponential_decay``, EF-TopK
compression and the compressed LM step, and AdamW's state through a
checkpoint.

Limits, relative to the largest magnitude of the reference's output:

- f32 parameters and slots after each step: 1e-5 (measured: up to
  7e-7);
- bf16 parameters: one bf16 rounding of the largest, 2^-8 (an f32 update
  a few ulps apart can round to the neighbouring bf16 value);
- ``global_norm``: 1e-5 (measured: 1.4e-6; the two packages add in other
  orders, and the port holds one tensor a super-block where the reference
  stacks a leaf);
- the schedule: two f32 roundings (numpy's and XLA's ``pow`` differ by
  one);
- EF-TopK's ``dense`` and ``residual``: bit for bit, on bf16 gradients
  with ties at the k-th magnitude (the lowest indices win, as in
  ``lax.top_k``).
"""

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import load_checkpoint as j_load  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import apply_updates  # noqa: E402
from repro.optim import exponential_decay as jax_exp  # noqa: E402
from repro.optim import global_norm as jax_global_norm  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro.train.steps import lm_train_step_fn as jax_step_fn  # noqa: E402
from repro.train.steps import make_lm_train_step as jax_make_step  # noqa: E402
from repro_torch.checkpoint import (load_checkpoint, restore_to,  # noqa: E402
                                    save_checkpoint)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import (AdamW, adamw, exponential_decay,  # noqa: E402
                               global_norm, sgd)
from repro_torch.train import compression as comp  # noqa: E402
from repro_torch.train.steps import (init_compression_state,  # noqa: E402
                                     lm_train_step_fn, make_lm_train_step)

SHAPES = {"w": (32, 16), "b": (16,), "e": (64, 8)}
GRAD_SCALES = (3.0, 0.02, 1.0, 8.0, 0.005)   # norms above and below clip


def _rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


def _t(a) -> torch.Tensor:
    """A torch tensor of a numpy array (bf16 through its bits)."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view(
            ml_dtypes.bfloat16)
    return t.numpy()


def _trees(dtype, seed=0):
    """Parameters and one gradient tree a step, as numpy."""
    rng = np.random.default_rng(seed)
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    params = {k: rng.standard_normal(s).astype(np_dt)
              for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * scale / 10).astype(np_dt)
              for k, s in SHAPES.items()} for scale in GRAD_SCALES]
    return params, grads


def _jax_run(opt, params, grads):
    """Each step's parameters and optimizer state, on the reference."""
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p)
    out = []
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, p)
        p = apply_updates(p, upd)
        out.append((p, state))
    return out


def _port_run(make, params, grads):
    ps = {k: _t(v) for k, v in params.items()}
    opt = make(list(ps.values()))
    out = []
    for g in grads:
        opt.step(grads={ps[k]: _t(v) for k, v in g.items()})
        out.append(({k: p.clone() for k, p in ps.items()},
                    {k: {s: t.clone() for s, t in opt.state[p].items()}
                     for k, p in ps.items()}))
    return out, opt


def _param_limit(dtype):
    return 2.0 ** -8 if dtype == "bfloat16" else 1e-5


@pytest.mark.parametrize("clip", [1.0, None])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax(dtype, clip):
    """Five AdamW steps (b1 0.9, b2 0.95, eps 1e-8, wd 0.1) under
    ``exponential_decay(0.01, 3)``, gradients whose norm is above and
    below the clip: every parameter and both f32 slots after each step."""
    params, grads = _trees(dtype)
    want = _jax_run(jax_adamw(jax_exp(0.01, 3), clip_norm=clip), params,
                    grads)
    got, opt = _port_run(lambda ps: adamw(ps, exponential_decay(0.01, 3),
                                          clip_norm=clip), params, grads)
    assert opt.step_count == len(grads)
    for step, ((jp, js), (tp, ts)) in enumerate(zip(want, got)):
        assert int(js.step) == step + 1
        for k in SHAPES:
            assert tp[k].dtype == _t(params[k]).dtype
            assert _rel(jp[k], tp[k]) <= _param_limit(dtype), (step, k)
            for slot in ("m", "v"):
                assert ts[k][slot].dtype == torch.float32
                assert _rel(js.slots[slot][k], ts[k][slot]) <= 1e-5, (
                    step, k, slot)


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_clip_norm_matches_jax(nesterov):
    """SGD (momentum 0.9, weight decay 5e-4) with ``clip_norm`` 0.5 over
    the same five steps, f32."""
    params, grads = _trees("float32", seed=1)
    want = _jax_run(jax_sgd(0.05, momentum=0.9, weight_decay=5e-4,
                            nesterov=nesterov, clip_norm=0.5), params, grads)
    got, _ = _port_run(lambda ps: sgd(ps, 0.05, momentum=0.9,
                                      weight_decay=5e-4, nesterov=nesterov,
                                      clip_norm=0.5), params, grads)
    for step, ((jp, js), (tp, ts)) in enumerate(zip(want, got)):
        for k in SHAPES:
            assert _rel(jp[k], tp[k]) <= 1e-5, (step, k)
            assert _rel(js.slots[k], ts[k]["momentum"]) <= 1e-5, (step, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_matches_jax(dtype):
    """gemma-2b smoke's parameters: the reference's stacked block leaves
    against the port's tensor a super-block."""
    jcfg = jax_smoke("gemma-2b").replace(param_dtype=dtype)
    jp = jlm.init_lm(jcfg, jax.random.PRNGKey(0))
    model = lm.params_from_jax(
        get_smoke_config("gemma-2b").replace(param_dtype=dtype),
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    want = float(jax_global_norm(jp))
    got = global_norm(p.detach() for p in model.parameters())
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-5 * want


def test_exponential_decay_matches_jax():
    for args in ((0.01, 3), (0.1, 7, 0.9), (3e-4, 100, 0.25)):
        port, ref = exponential_decay(*args), jax_exp(*args)
        for step in range(0, 40):
            want = float(ref(jnp.int32(step)))
            assert port(step) == pytest.approx(want, rel=2.4e-7, abs=0), (
                args, step)


def _bf16_grid(rng, shape):
    """bf16 gradients on a 1/16 grid in [-1, 1]: many equal magnitudes."""
    return (rng.integers(-16, 17, shape) / 16).astype(ml_dtypes.bfloat16)


@pytest.mark.parametrize("frac", [0.01, 0.05, 0.3])
def test_compress_with_feedback_bit_equal_to_jax(frac):
    """Four EF-TopK steps over three bf16 leaves with ties at the k-th
    magnitude: ``dense`` and ``residual`` bit for bit, and ``topk_sparsify``'s
    values and indices in the reference's order."""
    rng = np.random.default_rng(7)
    shapes = {"a": (64, 33), "b": (257,), "c": (8, 8, 8)}
    jstate = jcomp.init_state({k: jnp.zeros(s) for k, s in shapes.items()})
    tstate = comp.init_state({k: torch.zeros(s) for k, s in shapes.items()})
    ties_split = 0
    for _ in range(4):
        g = {k: _bf16_grid(rng, s) for k, s in shapes.items()}
        jd, jstate = jcomp.compress_with_feedback(
            {k: jnp.asarray(v) for k, v in g.items()}, jstate, frac)
        td, tstate = comp.compress_with_feedback(
            {k: _t(v) for k, v in g.items()}, tstate, frac)
        for k in shapes:
            assert td[k].dtype == tstate.residual[k].dtype == torch.float32
            np.testing.assert_array_equal(np.asarray(jd[k]), td[k].numpy())
            np.testing.assert_array_equal(np.asarray(jstate.residual[k]),
                                          tstate.residual[k].numpy())
            acc = np.asarray(jd[k]) + np.asarray(jstate.residual[k])
            mag = np.sort(np.abs(acc).ravel())[::-1]
            kk = max(int(acc.size * frac), 1)
            ties_split += int(kk < acc.size and mag[kk - 1] == mag[kk])
            _, jv, ji = jcomp.topk_sparsify(jnp.asarray(acc), frac)
            _, tv, ti = comp.topk_sparsify(torch.from_numpy(acc), frac)
            np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
            np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    assert ties_split > 0      # the tie-break decided some kept sets
    assert comp.compression_ratio(frac) == jcomp.compression_ratio(frac)


def _lm_pair(dtype="float32"):
    jcfg = jax_smoke("gemma-2b").replace(param_dtype=dtype)
    tcfg = get_smoke_config("gemma-2b").replace(param_dtype=dtype)
    jp = jlm.init_lm(jcfg, jax.random.PRNGKey(0))
    npp = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, jp, tcfg, lambda: lm.params_from_jax(tcfg, npp,
                                                      device="cpu")


def _lm_batches(cfg, n, b=4, s=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tok = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        tgt = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        w = rng.random(b).astype(np.float32)
        out.append({"tokens": tok, "targets": tgt, "weights": w / w.sum()})
    return out


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


def test_adamw_lm_steps_match_jax():
    """Three weighted AdamW steps of gemma-2b smoke at f32 (clip 1.0),
    after each step: the loss to 1e-5; both slots of every parameter to
    1e-5 after the first step and 2e-4 after the later ones (measured:
    1.3e-6, 5.7e-5); the parameters to 0.1 of the learning rates summed
    (measured: 0.02-0.04 of one step's).  Adam divides by ``sqrt(v̂) +
    eps``, so an element whose gradient is near eps (1e-8) takes a part of
    its whole normalized step from the gradient's f32 noise (6e-7 of the
    largest), and the next step's gradients follow those parameters.
    ``test_adamw_matches_jax`` holds the arithmetic itself to 1e-5."""
    jcfg, jp, tcfg, fresh = _lm_pair()
    batches = _lm_batches(tcfg, 3)
    sched = exponential_decay(3e-3, 2)
    jopt = jax_adamw(jax_exp(3e-3, 2))
    step = jax.jit(jax_step_fn(jcfg, jopt))
    jstate = jopt.init(jp)
    model = fresh()
    opt = adamw(model.parameters(), sched)
    tstep = lm_train_step_fn(tcfg, model, opt)
    for t, b in enumerate(batches):
        jp, jstate, jm = step(jp, jstate, {k: jnp.asarray(v)
                                           for k, v in b.items()})
        tm = tstep({k: torch.from_numpy(v) for k, v in b.items()})
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * float(
            jm["loss"])
        lr_sum = sum(sched(i) for i in range(t + 1))
        for name, p in model.named_parameters():
            err = np.abs(_jax_leaf(jp, name) - p.detach().numpy()).max()
            assert err <= 0.1 * lr_sum, (t, name)
            for slot in ("m", "v"):
                assert _rel(_jax_leaf(jstate.slots[slot], name),
                            opt.state[p][slot]) <= (1e-5 if t == 0
                                                    else 2e-4), (t, name,
                                                                 slot)


def test_compressed_step_matches_jax():
    """``make_lm_train_step(compress_frac=0.05)`` with SGD (momentum 0.9)
    for three steps of gemma-2b smoke at f32: loss, parameters and
    residuals against the reference's; with ``microbatches=4`` the port's
    step is the same, bit for bit (one full-batch gradient, as the
    reference takes)."""
    jcfg, jp, tcfg, fresh = _lm_pair()
    batches = _lm_batches(tcfg, 3, seed=1)
    jopt = jax_sgd(0.05, momentum=0.9)
    step = jax_make_step(jcfg, jopt, compress_frac=0.05)
    jstate, jcs = jopt.init(jp), jcomp.init_state(jp)
    runs = {}
    for mb in (1, 4):
        model = fresh()
        opt = sgd(model.parameters(), 0.05, momentum=0.9)
        tstep = make_lm_train_step(tcfg, model, opt, microbatches=mb,
                                   compress_frac=0.05)
        cs = init_compression_state(model)
        losses = []
        for b in batches:
            m, cs = tstep({k: torch.from_numpy(v) for k, v in b.items()}, cs)
            losses.append(float(m["loss"]))
        runs[mb] = (model, cs, losses)
    for b, loss in zip(batches, runs[1][2]):
        jp, jstate, jcs, jm = step(jp, jstate, jcs,
                                   {k: jnp.asarray(v) for k, v in b.items()})
        assert abs(loss - float(jm["loss"])) <= 1e-5 * float(jm["loss"])
    model, cs, _ = runs[1]
    for name, p in model.named_parameters():
        assert _rel(_jax_leaf(jp, name), p) <= 1e-5, name
    # one residual a reference leaf, the block leaves stacked as there
    assert len(cs.residual) == len(jax.tree_util.tree_leaves(jcs.residual))
    for key, r in cs.residual.items():
        node = jcs.residual
        for part in key.split("."):
            node = node[part]
        assert r.shape == node.shape
        assert _rel(node, r) <= 1e-5, key
    for (name, p), p4 in zip(model.named_parameters(),
                             runs[4][0].parameters()):
        assert torch.equal(p, p4), name
    for key, r in cs.residual.items():
        assert torch.equal(r, runs[4][1].residual[key]), key


def _adamw_run(tcfg, model, opt, batches):
    step = lm_train_step_fn(tcfg, model, opt)
    for b in batches:
        step({k: torch.from_numpy(v) for k, v in b.items()})


def test_adamw_resume_through_a_checkpoint(tmp_path):
    """gemma-2b smoke at bf16: four AdamW steps never killed against two,
    a snapshot (parameters and ``state_tree``) in the reference's format,
    and two more from it on a fresh model: every parameter and slot bit
    for bit.  The snapshot loads in the JAX package: ``step`` an int32 2,
    the slots f32 with the port's bits, under the reference's
    ``OptState`` layout (``slots/m/<name>``, ``slots/v/<name>``)."""
    _, _, tcfg, fresh = _lm_pair("bfloat16")
    batches = _lm_batches(tcfg, 4, seed=2)
    sched = exponential_decay(3e-3, 2)
    whole = fresh()
    wopt = adamw(whole.parameters(), sched)
    _adamw_run(tcfg, whole, wopt, batches)

    first = fresh()
    fopt = adamw(first.parameters(), sched)
    _adamw_run(tcfg, first, fopt, batches[:2])
    named = dict(first.named_parameters())
    save_checkpoint(str(tmp_path), 2, {"params": named,
                                       "opt_state": fopt.state_tree(named)})
    snap = load_checkpoint(str(tmp_path))
    resumed = fresh()
    rnamed = dict(resumed.named_parameters())
    ropt = AdamW(resumed.parameters(), sched)
    with torch.no_grad():
        for name, val in restore_to(snap["params"], "cpu").items():
            rnamed[name].copy_(val)
    ropt.load_state_tree(restore_to(snap["opt_state"], "cpu"), rnamed)
    assert ropt.step_count == 2
    _adamw_run(tcfg, resumed, ropt, batches[2:])
    for (name, p), q in zip(whole.named_parameters(), resumed.parameters()):
        assert torch.equal(p, q), name
        for slot in ("m", "v"):
            assert torch.equal(wopt.state[p][slot], ropt.state[q][slot])

    got = j_load(str(tmp_path))["opt_state"]
    assert got["step"].dtype == np.int32 and int(got["step"]) == 2
    assert set(got["slots"]) == {"m", "v"}
    for slot in ("m", "v"):
        assert set(got["slots"][slot]) == set(named)
        for name, p in named.items():
            arr = got["slots"][slot][name]
            assert arr.dtype == np.float32
            np.testing.assert_array_equal(arr, _np(fopt.state[p][slot]))
    params = j_load(str(tmp_path))["params"]
    for name, p in named.items():
        assert np.asarray(params[name]).dtype == _np(p.detach()).dtype
        np.testing.assert_array_equal(
            np.asarray(params[name]).view(np.uint16)
            if p.dtype == torch.bfloat16 else params[name],
            _np(p.detach()).view(np.uint16)
            if p.dtype == torch.bfloat16 else _np(p.detach()))

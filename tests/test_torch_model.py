"""The port's classifier, weighted SGD step and proxies against the JAX
package, on the CPU, from the same parameters (``params_from_jax``) and the
same numpy batches."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.paper import ClassifierConfig as JConfig  # noqa: E402
from repro.configs.paper import mlp as jmlp  # noqa: E402
from repro.core import proxies as jproxies  # noqa: E402
from repro.models.classifier import apply_classifier, init_classifier  # noqa: E402,E501
from repro.optim import cosine_annealing as jcosine  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.configs.paper import ClassifierConfig, mlp  # noqa: E402
from repro_torch.core import proxies as tproxies  # noqa: E402
from repro_torch.models.classifier import (ClassifierNet,  # noqa: E402
                                           classifier_loss, params_from_jax)
from repro_torch.optim import constant, cosine_annealing, sgd  # noqa: E402
from repro_torch.train import steps  # noqa: E402

CNN = dict(name="small-cnn", kind="cnn", image_shape=(20, 20, 2),
           hidden=(24, 12), num_classes=5)


def _jax_params(cfg, seed=0):
    p = init_classifier(cfg, jax.random.PRNGKey(seed))
    # non-zero biases, so the bias transfer is checked too
    p = jax.tree_util.tree_map(np.asarray, p)
    rng = np.random.default_rng(seed)
    for name, leaf in p.items():
        if isinstance(leaf, dict):
            leaf["b"] = (0.1 * rng.standard_normal(leaf["b"].shape)).astype(
                np.float32)
    return p


def _inputs(cfg, n, seed):
    rng = np.random.default_rng(seed)
    shape = (n, cfg.in_dim) if cfg.kind == "mlp" else (n, *cfg.image_shape)
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, n).astype(np.int32)
    return x, y


@pytest.mark.parametrize("kind,rtol,atol", [("mlp", 1e-5, 1e-6),
                                            ("cnn", 1e-4, 1e-5)])
def test_forward_matches_jax(kind, rtol, atol):
    """MLP at the paper's widths; the CNN sums its convolutions in another
    order, hence rtol 1e-4."""
    jcfg = jmlp() if kind == "mlp" else JConfig(**CNN)
    cfg = mlp() if kind == "mlp" else ClassifierConfig(**CNN)
    p = _jax_params(jcfg)
    x, _ = _inputs(cfg, 33, 1)
    jl, jh = apply_classifier(jcfg, p, jnp.asarray(x))
    with torch.no_grad():
        tl, th = params_from_jax(cfg, p, "cpu")(torch.from_numpy(x))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=rtol,
                               atol=atol)


def test_init_shapes_and_truncation():
    """A fresh net has the reference's shapes; dense weights lie in the
    +-2 std band of the truncated-normal fan-in init, biases are zero."""
    for cfg in (mlp(), ClassifierConfig(**CNN)):
        net = ClassifierNet(cfg, generator=torch.Generator().manual_seed(0))
        jp = init_classifier(JConfig(**{f: getattr(cfg, f) for f in (
            "name", "kind", "in_dim", "image_shape", "hidden",
            "num_classes", "act")}), jax.random.PRNGKey(0))
        for i, fc in enumerate(net.fcs):
            assert tuple(fc.weight.shape[::-1]) == jp[f"fc{i}"]["w"].shape
            bound = 2.0 / np.sqrt(fc.weight.shape[1])
            assert float(fc.weight.detach().abs().max()) <= bound + 1e-7
            assert float(fc.bias.detach().abs().max()) == 0.0
        assert tuple(net.head.weight.shape[::-1]) == jp["head"]["w"].shape


def _batches(cfg, n_steps, bs, seed):
    out = []
    for s in range(n_steps):
        x, y = _inputs(cfg, bs, seed + s)
        w = np.random.default_rng(seed + 100 + s).random(bs).astype(
            np.float32)
        out.append((x, y, w / w.sum()))
    return out


def test_weighted_sgd_steps_match_jax():
    """Three weighted steps, momentum 0.9, weight decay 5e-4, cosine
    schedule over the three steps (the lr is read before the increment)."""
    jcfg, cfg = jmlp(in_dim=24, num_classes=8), mlp(in_dim=24, num_classes=8)
    p = _jax_params(jcfg, seed=3)
    opt = jsgd(jcosine(0.05, 3), momentum=0.9, weight_decay=5e-4)
    jstep = jsteps.make_classifier_step(jcfg, opt)
    jp, jstate = p, opt.init(p)
    model = params_from_jax(cfg, p, "cpu")
    topt = sgd(model.parameters(), cosine_annealing(0.05, 3), momentum=0.9,
               weight_decay=5e-4)
    tstep = steps.make_classifier_step(model, topt)
    for x, y, w in _batches(cfg, 3, 16, 7):
        jp, jstate, jm = jstep(jp, jstate, {"x": jnp.asarray(x),
                                            "y": jnp.asarray(y),
                                            "weights": jnp.asarray(w)})
        tm = tstep({"x": torch.from_numpy(x),
                    "y": torch.from_numpy(y).long(),
                    "weights": torch.from_numpy(w)})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, atol=1e-6)
    assert topt.step_count == 3
    for i, fc in enumerate(model.fcs):
        np.testing.assert_allclose(fc.weight.detach().numpy().T,
                                   np.asarray(jp[f"fc{i}"]["w"]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(fc.bias.detach().numpy(),
                                   np.asarray(jp[f"fc{i}"]["b"]), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(model.head.weight.detach().numpy().T,
                               np.asarray(jp["head"]["w"]), rtol=1e-5,
                               atol=1e-6)


def test_schedule_matches_jax():
    f, jf = cosine_annealing(0.01, 7, 0.1), jcosine(0.01, 7, 0.1)
    for step in range(10):
        assert f(step) == float(jf(jnp.int32(step)))
    assert constant(0.3)(5) == float(np.float32(0.3))


def test_loss_unweighted_is_mean_ce():
    cfg = mlp(in_dim=8, num_classes=3)
    model = ClassifierNet(cfg, generator=torch.Generator().manual_seed(1))
    x, y = _inputs(cfg, 10, 2)
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()}
    loss, m = classifier_loss(model, batch)
    np.testing.assert_allclose(float(loss.detach()), float(m["ce"].detach()),
                               rtol=1e-6)


def test_proxies_match_jax():
    jcfg, cfg = jmlp(), mlp()
    p = _jax_params(jcfg, seed=4)
    x, y = _inputs(cfg, 257, 5)
    jpcg, jbias = jsteps.make_proxy_fn(jcfg)(p, jnp.asarray(x),
                                             jnp.asarray(y))
    tpcg, tbias = steps.make_proxy_fn(params_from_jax(cfg, p, "cpu"))(
        torch.from_numpy(x), torch.from_numpy(y).long())
    assert tpcg.shape == (257, 65) and tbias.shape == (257, 10)
    np.testing.assert_allclose(tpcg.numpy(), np.asarray(jpcg), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tbias.numpy(), np.asarray(jbias), rtol=1e-5,
                               atol=1e-6)


def test_proxy_functions_match_jax():
    """The standalone proxy functions and mini-batch grouping, including a
    ragged tail that ``per_batch`` drops."""
    rng = np.random.default_rng(6)
    h = rng.standard_normal((70, 12)).astype(np.float32)
    z = (2 * rng.standard_normal((70, 5))).astype(np.float32)
    y = rng.integers(0, 5, 70).astype(np.int32)
    th, tz, ty = (torch.from_numpy(a) for a in (h, z, y))
    np.testing.assert_allclose(
        tproxies.per_class_grad_proxy(th, tz, ty.long()).numpy(),
        np.asarray(jproxies.per_class_grad_proxy(h, z, y)), rtol=1e-5,
        atol=1e-6)
    np.testing.assert_allclose(
        tproxies.bias_grad_proxy(tz, ty).numpy(),
        np.asarray(jproxies.bias_grad_proxy(z, y)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tproxies.per_batch(th, 16).numpy(),
        np.asarray(jproxies.per_batch(jnp.asarray(h), 16)), rtol=1e-5,
        atol=1e-6)

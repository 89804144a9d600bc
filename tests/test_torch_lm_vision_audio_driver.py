"""The port's LM training driver (``repro_torch.launch.train.main``) on
the two stub-input families, against the JAX driver's loop on the CPU:
llama-3.2-vision-90b with ``vision`` states beside its tokens and
hubert-xlarge with frame ``embeds`` in place of them.

Neither driver draws such inputs: the reference's ``TokenStream`` has
tokens only and the port's driver refuses these families without a
``stream=``.  So the reference's loop (``repro.launch.train.main`` at
``--smoke``) runs with its ``TokenStream`` given the stub inputs (seeded
normals, bf16, a pure function of (step, shard), as ``tests/
test_models.py`` makes them), and the port's ``main`` gets the same
batches through its ``stream`` seam and the same parameters through its
``model`` seam (``lm.params_from_jax``), both at
``param_dtype="float32"``: six steps over two selections, the
micro-batch picks index-exact, the weights within rtol 1e-4 / atol 1e-5
and every step's loss within 1e-5 relative, as
``tests/test_torch_lm_train.py`` holds gemma-2b's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.launch.train as jax_train  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data.tokens import TokenStream as JaxTokenStream  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import lm  # noqa: E402

ARCHS = ["llama-3.2-vision-90b", "hubert-xlarge"]


def _args(arch):
    return ["--arch", arch, "--smoke", "--steps", "6", "--select-every", "3",
            "--window", "8", "--budget", "0.5", "--micro-batch", "2",
            "--seq-len", "16", "--seed", "0"]


def _stub_stream(cfg):
    """The JAX ``TokenStream`` with ``cfg``'s stub inputs: ``vision``
    (B, n_img, d_embed) added for a vlm, ``embeds`` (B, S, d_model) in
    place of ``tokens`` for audio."""

    class Stream(JaxTokenStream):
        def batch(self, step, shard=0):
            out = dict(super().batch(step, shard))
            rng = np.random.default_rng(1000 * step + shard)
            b, s = out["targets"].shape
            if cfg.family == "vlm":
                shape = (b, cfg.vision.n_tokens, cfg.vision.d_embed)
                key = "vision"
            else:
                shape = (b, s, cfg.d_model)
                key = "embeds"
                del out["tokens"]
            out[key] = jnp.asarray(rng.standard_normal(shape).astype(
                np.float32)).astype(jnp.bfloat16)
            return out

    return Stream


class _PortStream:
    """The same batches as tensors (bf16 stays bf16), for the port's
    ``stream`` seam."""

    def __init__(self, stream):
        self.stream = stream

    def batch(self, step, shard=0):
        out = {}
        for k, v in self.stream.batch(step, shard).items():
            if v.dtype == jnp.bfloat16:
                out[k] = torch.from_numpy(np.array(
                    v.astype(jnp.float32))).bfloat16()
            else:
                out[k] = torch.from_numpy(np.array(v))
        return out


@pytest.mark.parametrize("arch", ARCHS)
def test_driver_with_a_stub_stream_matches_the_jax_loop(arch):
    cfg = jax_smoke(arch).replace(param_dtype="float32")
    stream_cls = _stub_stream(cfg)
    picks, losses = [], []
    gradmatch = jax_train.gm_lib.gradmatch
    step_fn = jax_train.lm_train_step_fn

    def recording_gradmatch(*a, **kw):
        sel = gradmatch(*a, **kw)
        m = np.asarray(sel.mask)
        picks.append((np.asarray(sel.indices)[m], np.asarray(sel.weights)[m]))
        return sel

    def recording_step_fn(*a, **kw):
        step = step_fn(*a, **kw)

        def wrapped(params, opt_state, batch):
            out = step(params, opt_state, batch)
            jax.debug.callback(lambda x: losses.append(float(x)),
                               out[2]["loss"])
            return out
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_train, "get_smoke_config", lambda _: cfg)
        mp.setattr(jax_train, "TokenStream", stream_cls)
        mp.setattr(jax_train.gm_lib, "gradmatch", recording_gradmatch)
        mp.setattr(jax_train, "lm_train_step_fn", recording_step_fn)
        jrep = jax_train.main(_args(arch))
    jax.effects_barrier()
    jp = jax.tree_util.tree_map(np.asarray,
                                jlm.init_lm(cfg, jax.random.PRNGKey(0)))
    tcfg = get_smoke_config(arch).replace(param_dtype="float32")
    model = lm.params_from_jax(tcfg, jp, device="cpu")
    stream = _PortStream(stream_cls(seed=0, batch_per_shard=2, seq_len=16,
                                    vocab=cfg.vocab_size, n_shards=8))
    rep = train.main(_args(arch) + ["--device", "cpu"], stream=stream,
                     model=model)
    assert len(rep["selections"]) == len(picks) == 2
    for sel, (idx, w) in zip(rep["selections"], picks):
        np.testing.assert_array_equal(sel["indices"], idx)
        np.testing.assert_allclose(sel["weights"], w, rtol=1e-4, atol=1e-5)
    assert len(losses) == len(rep["losses"]) == 6
    np.testing.assert_allclose(rep["losses"], losses, rtol=1e-5)
    assert rep["loss_last"] == pytest.approx(jrep["loss_last"], rel=1e-5)
    if cfg.family == "vlm":
        # the gates start at 0; the steps open them, so the later steps
        # and the second selection attend to the vision states
        gate = model["blocks"][0]["sub4"]["gate_attn"].detach()
        assert float(gate) != 0.0
    else:
        assert "embed" not in model

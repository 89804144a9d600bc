"""xlstm-1.3b through the port's entry points (``launch/train.main``,
``launch/serve.main``), on the CPU.

- The driver: the port's ``train.main --arch xlstm-1.3b --smoke`` against
  the JAX driver's loop (``repro.launch.train.main``) for six steps across
  two selections, on the same tokens (the JAX stream's batches through
  the ``stream`` seam) and the same parameters (``model`` seam,
  ``lm.params_from_jax``), at ``param_dtype="float32"`` and on the smoke
  config cut to one super-block of one mLSTM and one sLSTM layer (the
  driver's loop is the same at any depth; the full smoke model is held
  in ``test_torch_lm_xlstm_model.py``).  The micro-batch picks must be
  index-exact, the weights within rtol 1e-4 / atol 1e-5 and every step's
  loss within 1e-5 relative, as ``test_torch_lm_train.py`` holds
  gemma-2b.
- The launchers at ``--smoke --device cpu`` (bf16): ``train.main`` from
  its own init, and ``serve.main``, each greedy token equal to the
  argmax of the port's own forward over the prompt and the tokens fed
  back, unless its top-2 gap is under the reference's decode test's 5e-2
  of max |logit| (``tests/test_models.py:104-109``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.launch.train as jax_train  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data.tokens import TokenStream as JaxTokenStream  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import MLSTM, SLSTM  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import lm  # noqa: E402

ARCH = "xlstm-1.3b"
ARGS = ["--arch", ARCH, "--smoke", "--steps", "6", "--select-every", "3",
        "--window", "8", "--budget", "0.5", "--micro-batch", "2",
        "--seq-len", "16", "--seed", "0"]
DECODE_LIMIT = 5e-2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cut(cfg):
    """One super-block of (mLSTM, sLSTM), f32."""
    return cfg.replace(param_dtype="float32", layer_pattern=(MLSTM, SLSTM),
                       n_layers=2, n_superblocks=1)


class _JaxTokens:
    """The JAX driver's token stream, its batches handed over as tensors."""

    def __init__(self, cfg):
        self.stream = JaxTokenStream(seed=0, batch_per_shard=2, seq_len=16,
                                     vocab=cfg.vocab_size, n_shards=8)

    def batch(self, step, shard=0):
        return {k: torch.from_numpy(np.array(v))
                for k, v in self.stream.batch(step, shard).items()}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX driver on the cut config, recording each selection
    (through its ``gradmatch``) and each step's loss (through a debug
    callback)."""
    mp = pytest.MonkeyPatch()
    cfg = _cut(jax_smoke(ARCH))
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

    try:
        mp.setattr(jax_train, "get_smoke_config", lambda arch: cfg)
        mp.setattr(jax_train.gm_lib, "gradmatch", recording_gradmatch)
        mp.setattr(jax_train, "lm_train_step_fn", recording_step_fn)
        report = jax_train.main(ARGS)
    finally:
        mp.undo()
    jax.effects_barrier()
    params = jlm.init_lm(cfg, jax.random.PRNGKey(0))
    return dict(cfg=cfg, picks=picks, losses=losses, report=report,
                params=_np(params))


def test_driver_matches_the_jax_loop(jax_run):
    tcfg = _cut(get_smoke_config(ARCH))
    model = lm.params_from_jax(tcfg, jax_run["params"], device="cpu")
    ops.reset_launch_counts()
    rep = train.main(ARGS + ["--device", "cpu"],
                     stream=_JaxTokens(jax_run["cfg"]), model=model)
    assert ops.launch_counts()["hidden_grad"] == 0     # CPU: plain versions
    assert rep["arch"] == ARCH
    assert len(rep["selections"]) == len(jax_run["picks"]) == 2
    for sel, (idx, w) in zip(rep["selections"], jax_run["picks"]):
        np.testing.assert_array_equal(sel["indices"], idx)
        np.testing.assert_allclose(sel["weights"], w, rtol=1e-4, atol=1e-5)
    assert len(jax_run["losses"]) == len(rep["losses"]) == 6
    np.testing.assert_allclose(rep["losses"], jax_run["losses"], rtol=1e-5)
    for key in ("loss_first", "loss_last"):
        assert rep[key] == pytest.approx(jax_run["report"][key], rel=1e-5)
    assert rep["params"] == sum(int(np.asarray(a).size) for a in
                                jax.tree_util.tree_leaves(jax_run["params"]))


def test_launchers_run_the_arch_on_the_cpu(monkeypatch):
    """``train.main`` and ``serve.main`` with ``--arch xlstm-1.3b
    --smoke --device cpu`` (bf16, their own init from ``--seed``): finite
    losses and a selection every R steps; every request served, each
    greedy token the argmax of the port's own forward over the prompt and
    the tokens fed back (unless its top-2 gap is under ``DECODE_LIMIT`` of
    max |logit|): prompts of 12 and 4 tokens, so that the forward over the
    16 is one mLSTM chunk."""
    rep = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--steps", "4", "--select-every", "2", "--window",
                      "4", "--micro-batch", "2", "--seq-len", "16"])
    assert rep["arch"] == ARCH and len(rep["losses"]) == 4
    assert all(np.isfinite(rep["losses"]))
    assert len(rep["selections"]) == 2
    for sel in rep["selections"]:
        assert abs(sum(sel["weights"]) - 1) < 1e-4

    runs = []
    generate = serve.generate

    def recording(cfg, model, prompts, gen_len):
        out = generate(cfg, model, prompts, gen_len)
        runs.append((cfg, model, prompts, out))
        return out

    monkeypatch.setattr(serve, "generate", recording)
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--requests", "3", "--batch", "2", "--prompt-len",
                      "12", "--gen-len", "4"])
    assert out["requests"] == 3 and out["tokens"] == 12
    assert len(runs) == 2
    for cfg, model, prompts, got in runs:
        plen = prompts.shape[1]
        seq = torch.cat([prompts, got[:, :-1]], dim=1)
        with torch.no_grad():
            h, _, _ = lm.forward(cfg, model, seq)
            fwd = lm.mask_padded_logits(cfg, lm._head_out(
                cfg, model, h[:, plen - 1:])).float()
        top2 = fwd.topk(2, dim=-1).values
        gap = (top2[..., 0] - top2[..., 1]) / float(fwd.abs().max())
        differ = fwd.argmax(-1) != got.long()
        assert not bool((differ & (gap >= DECODE_LIMIT)).any())

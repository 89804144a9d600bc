"""The port's LM training driver (``repro_torch.launch.train.main``) and its
token stream, on the CPU.

The slice as a whole: the port's driver against the JAX driver's loop
(``repro.launch.train.main`` at ``--smoke``) for six steps across two
selections, on the same tokens (the JAX stream's batches handed to the
port through its ``stream`` seam) and the same parameters (``model``
seam, ``lm.params_from_jax``), both at ``param_dtype="float32"``.  The
micro-batch picks must be index-exact, the weights within rtol 1e-4 /
atol 1e-5, and every step's loss within 1e-5 relative (measured: 1e-7).
"""

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.launch.train as jax_train  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data.tokens import TokenStream as JaxTokenStream  # noqa: E402
from repro.data.tokens import token_batch as jax_token_batch  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.tokens import (TokenStream, latent_logits,  # noqa: E402
                                     stream_seed, token_batch)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import lm  # noqa: E402

ARGS = ["--arch", "gemma-2b", "--smoke", "--steps", "6", "--select-every",
        "3", "--window", "8", "--budget", "0.5", "--micro-batch", "2",
        "--seq-len", "16", "--seed", "0"]


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
    """The JAX driver at f32, recording each selection (through its
    ``gradmatch``) and each step's loss (through a debug callback)."""
    mp = pytest.MonkeyPatch()
    cfg = jax_smoke("gemma-2b").replace(param_dtype="float32")
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
                params=jax.tree_util.tree_map(np.asarray, params))


def test_driver_matches_the_jax_loop(jax_run):
    tcfg = get_smoke_config("gemma-2b").replace(param_dtype="float32")
    model = lm.params_from_jax(tcfg, jax_run["params"], device="cpu")
    ops.reset_launch_counts()
    rep = train.main(ARGS + ["--device", "cpu"],
                     stream=_JaxTokens(jax_run["cfg"]), model=model)
    assert ops.launch_counts()["hidden_grad"] == 0     # CPU: plain versions
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


@pytest.mark.parametrize("strategy", ["gradmatch-pb", "random", "full"])
def test_driver_runs_each_strategy_on_its_own_stream(strategy):
    """The driver's defaults apart from size: its own TokenStream and init
    from --seed, on the CPU; finite losses, one selection every R steps."""
    rep = train.main(["--smoke", "--device", "cpu", "--steps", "4",
                      "--select-every", "2", "--window", "4",
                      "--micro-batch", "2", "--seq-len", "8",
                      "--strategy", strategy])
    assert rep["strategy"] == strategy and rep["device"] == "cpu"
    assert len(rep["losses"]) == 4 and np.isfinite(rep["losses"]).all()
    assert len(rep["selections"]) == (0 if strategy == "full" else 2)
    for sel in rep["selections"]:
        assert len(sel["indices"]) == 1 and 0 <= sel["indices"][0] < 4
        assert sum(sel["weights"]) == pytest.approx(1.0, rel=1e-5)


SMALL = ["--smoke", "--device", "cpu", "--window", "4", "--micro-batch",
         "2", "--seq-len", "8", "--select-every", "3"]


def test_driver_writes_a_snapshot_and_resumes_from_it(tmp_path, capsys):
    """``--checkpoint-dir``: snapshots every ``--checkpoint-every`` steps
    in the reference's format (bf16 parameters under the dtype name
    ``bfloat16``), and a second call resumes from the latest, saying
    so."""
    argv = [*SMALL, "--steps", "4", "--checkpoint-dir", str(tmp_path),
            "--checkpoint-every", "2"]
    rep = train.main(argv)
    assert rep["start_step"] == 0 and len(rep["losses"]) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_0000000002",
                                            "step_0000000004"]
    with open(tmp_path / "step_0000000004" / "manifest.json") as f:
        man = json.load(f)
    assert man["step"] == 4
    assert "bfloat16" in man["dtypes"].values()
    assert {"meta/step", "meta/seed", "opt_state/step", "selection/batches",
            "selection/weights"} <= set(man["keys"])
    snap = load_checkpoint(str(tmp_path))
    assert int(snap["meta"]["step"]) == 4 and int(
        snap["opt_state"]["step"]) == 4
    capsys.readouterr()
    again = train.main([*SMALL, "--steps", "6", "--checkpoint-dir",
                        str(tmp_path), "--checkpoint-every", "2"])
    assert "[resume] from step 4" in capsys.readouterr().out
    assert again["start_step"] == 4 and len(again["losses"]) == 2


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else (
        torch.from_numpy(np.asarray(t)))


def test_driver_killed_and_resumed_equals_never_killed(tmp_path):
    """The driver at ``--smoke``, killed after step 4 (its step-8 snapshot
    lost) and resumed in the middle of a selection window: the resumed
    steps' losses, the later selection, and the final parameters and SGD
    state equal the never-killed run's, bit for bit (the selection in
    force is part of the snapshot)."""
    argv = [*SMALL, "--steps", "8", "--checkpoint-dir", str(tmp_path),
            "--checkpoint-every", "4"]
    full = train.main(argv)
    want = load_checkpoint(str(tmp_path), 8)
    shutil.rmtree(tmp_path / "step_0000000008")
    resumed = train.main(argv)
    got = load_checkpoint(str(tmp_path), 8)
    assert resumed["start_step"] == 4
    assert resumed["losses"] == full["losses"][4:]
    assert resumed["selections"] == [s for s in full["selections"]
                                     if s["round"] == 2]
    assert sorted(got["params"]) == sorted(want["params"])
    for part in ("params", "opt_state/slots"):
        a, b = got, want
        for key in part.split("/"):
            a, b = a[key], b[key]
        for name in b:
            assert torch.equal(_bits(a[name]), _bits(b[name])), (part, name)
    assert int(got["opt_state"]["step"]) == int(want["opt_state"]["step"])


def test_token_stream_is_a_pure_function_of_seed_step_shard():
    s = TokenStream(seed=3, batch_per_shard=4, seq_len=32, vocab=96,
                    n_shards=2, device="cpu")
    a, b = s.batch(5, 1), s.batch(5, 1)
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["targets"], b["targets"])
    assert a["tokens"].dtype == torch.int32 and a["tokens"].shape == (4, 32)
    # targets are the tokens shifted by one
    assert torch.equal(a["tokens"][:, 1:], a["targets"][:, :-1])
    for other in (s.batch(6, 1), s.batch(5, 0),
                  TokenStream(4, 4, 32, 96, device="cpu").batch(5, 1)):
        assert not torch.equal(a["tokens"], other["tokens"])
    assert len({stream_seed(0, st, sh) for st in range(20)
                for sh in range(20)}) == 400


def test_token_stream_in_range_and_structured_like_the_reference():
    """Tokens lie in [0, V).  The port draws the reference's construction
    from other random bits, so its histograms (of tokens, and of latent
    slices) differ from the reference's by no more than the reference's
    own from one seed to another (times 1.5).  With flat marginals
    (alpha = 0) the latent chain shows: consecutive tokens share a slice
    far more often than tokens of unrelated positions, as often as in the
    reference."""
    vocab, n_latent = 1600, 16
    slice_w = vocab // n_latent

    def port(seed, alpha=1.1):
        return torch.cat([token_batch(seed, st, 0, 64, 64, vocab,
                                      alpha=alpha, device="cpu")["tokens"]
                          for st in range(4)]).numpy()

    def ref(seed, alpha=1.1):
        return np.concatenate([np.asarray(jax_token_batch(
            seed, st, 0, 64, 64, vocab, alpha=alpha)["tokens"])
            for st in range(4)])

    p0, r0, r1 = port(0), ref(0), ref(1)
    assert p0.min() >= 0 and p0.max() < vocab

    def tv(a, b, width):
        n = -(-vocab // width)
        ha = np.bincount(a.ravel() // width, minlength=n) / a.size
        hb = np.bincount(b.ravel() // width, minlength=n) / b.size
        return 0.5 * np.abs(ha - hb).sum()

    for width in (1, slice_w):
        assert tv(p0, r0, width) <= 1.5 * tv(r1, r0, width), width

    def same_slice(t):
        s = t // slice_w
        return float((s[:, 1:] == s[:, :-1]).mean())

    def unrelated(t):
        s = (t // slice_w).ravel()
        return float((s == np.roll(s, 997)).mean())

    flat_p, flat_r = port(0, alpha=0.0), ref(0, alpha=0.0)
    assert same_slice(flat_p) > 3 * unrelated(flat_p)
    assert same_slice(flat_p) == pytest.approx(same_slice(flat_r), rel=0.1)
    assert same_slice(p0) == pytest.approx(same_slice(r0), rel=0.1)
    # the latent logits: Zipf marginals, +3 on each latent's slice
    lg = latent_logits(vocab, n_latent).numpy()
    assert lg.shape == (n_latent, vocab)
    np.testing.assert_allclose(lg[2, 2 * slice_w] - lg[1, 2 * slice_w], 3.0)
    np.testing.assert_allclose(lg[0, 9] - lg[0, 19], 1.1 * np.log(20 / 10),
                               rtol=1e-5)

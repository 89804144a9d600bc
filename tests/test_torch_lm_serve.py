"""The port's serving driver (``repro_torch.launch.serve``) against the
JAX package's (``repro.launch.serve``), on the CPU.

``generate`` (prefill, ``_seat``, greedy decode) is held token for token
against the reference's loop (``prefill_step``, ``_seat``,
``decode_step``, argmax) on the same parameters (``lm.params_from_jax``)
and prompts, at ``param_dtype="float32"``; ``main --smoke --device cpu``
reports the reference's keys; and a last batch shorter than ``--batch``
is padded, where the reference raises ``IndexError``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.launch.serve as jax_serve  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402

SMOKE = ["--smoke", "--requests", "4", "--batch", "2", "--prompt-len", "8",
         "--gen-len", "4"]


def _pair(arch, dtype="float32"):
    jcfg = jax_smoke(arch).replace(param_dtype=dtype)
    tcfg = get_smoke_config(arch).replace(param_dtype=dtype)
    jp = jlm.init_lm(jcfg, jax.random.PRNGKey(0))
    model = lm.params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
    return jcfg, jp, tcfg, model


def _jax_generate(jcfg, jp, prompts, gen_len):
    """The reference's ``main`` loop for one batch."""
    b, plen = prompts.shape
    prefill = jax.jit(lambda p, t: jlm.prefill_step(jcfg, p, t))
    decode = jax.jit(lambda p, st, t, pos: jlm.decode_step(jcfg, p, st, t,
                                                           pos))
    logits, pstate = prefill(jp, jnp.asarray(prompts))
    state = jax_serve._seat(jlm.init_decode_state(jcfg, b, plen + gen_len),
                            pstate)
    cur = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    out = [np.asarray(cur)]
    for i in range(gen_len):
        logits, state = decode(jp, state, cur, jnp.int32(plen + i))
        cur = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        out.append(np.asarray(cur))
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("arch,plen,gen_len", [
    ("gemma-2b", 8, 6), ("starcoder2-3b", 8, 6),
    ("gemma2-9b", 20, 16)])      # the ring (window 32) wraps at 32
def test_generate_matches_the_jax_loop(arch, plen, gen_len):
    jcfg, jp, tcfg, model = _pair(arch)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, tcfg.vocab_size, (3, plen)).astype(np.int32)
    want = _jax_generate(jcfg, jp, prompts, gen_len)
    got = serve.generate(tcfg, model, torch.from_numpy(prompts), gen_len)
    assert got.shape == (3, gen_len + 1) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_main_smoke_reports_the_reference_keys(capsys):
    """Both drivers at ``--smoke`` (4 requests in batches of 2, 8 + 4
    tokens): the same report keys and counts."""
    want = jax_serve.main(SMOKE)
    got = serve.main(SMOKE + ["--device", "cpu"])
    assert list(got) == list(want)
    for key in ("arch", "requests", "tokens"):
        assert got[key] == want[key], key
    assert got["tokens"] == 4 * 4 and got["tok_per_s"] > 0
    assert "'tok_per_s'" in capsys.readouterr().out


def test_main_takes_a_model_through_its_seam():
    """``model=``: the caller's parameters and config (a bf16 gemma2-9b
    smoke model under ``--arch gemma-2b``'s defaults is served as it
    is)."""
    cfg = get_smoke_config("gemma2-9b")
    model = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    rep = serve.main(["--requests", "2", "--batch", "2", "--prompt-len",
                      "4", "--gen-len", "2", "--device", "cpu"],
                     model=model)
    assert rep["requests"] == 2 and rep["tokens"] == 4


def test_padded_last_batch():
    """5 requests in batches of 4: the reference's comprehension pops past
    its queue and raises; the port pads the last batch with copies of its
    one prompt, counts 5 requests, and the real row's tokens are what that
    prompt gets alone."""
    argv = ["--smoke", "--requests", "5", "--batch", "4", "--prompt-len",
            "6", "--gen-len", "3"]
    with pytest.raises(IndexError):
        jax_serve.main(argv)
    calls = []
    generate = serve.generate

    def recording(cfg, model, prompts, gen_len):
        out = generate(cfg, model, prompts, gen_len)
        calls.append((prompts.clone(), out, cfg, model))
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(serve, "generate", recording)
    try:
        rep = serve.main(argv + ["--device", "cpu"])
    finally:
        mp.undo()
    assert rep["requests"] == 5 and rep["tokens"] == 5 * 3
    assert [c[0].shape for c in calls] == [(4, 6), (4, 6)]
    last, out, cfg, model = calls[1]
    rng = np.random.default_rng(0)
    queue = [rng.integers(0, cfg.vocab_size, (6,)) for _ in range(5)]
    assert (last.numpy() == queue[4]).all()
    alone = generate(cfg, model, last[:1], 3)
    assert torch.equal(out[:1], alone)


def test_serving_driver_refuses_the_cpu_without_being_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(SMOKE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_decode_state(get_smoke_config("gemma-2b"), 1, 4)

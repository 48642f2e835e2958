"""The port's serving engine and launcher vs the JAX functions that are right.

``repro.serving.engine.Engine.generate`` prefills into caches exactly S
long and its first decode write lands on slot S-1, so generation is held
against JAX's ``forward`` + ``logits_fn`` on the growing sequence and its
pure-decode loop from ``init_decode_state``.  f32, reduced configs,
tolerance ``_torch_parity.MODEL_TOL`` (1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import logits_fn as jax_logits_fn
from repro.models.transformer import embed_tokens as jax_embed
from repro.models.transformer import forward as jax_forward
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import GenerationConfig as JaxGenerationConfig
from repro_torch.launch import serve
from repro_torch.serving.engine import Engine, GenerationConfig

from _torch_parity import MODEL_TOL, models, np32

ARCHS = ["smollm-360m", "llama3.2-1b", "granite-moe-3b-a800m", "mamba2-130m", "hymba-1.5b"]


def close(got, want, tol=MODEL_TOL):
    np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol)


def jax_all_logits(japi, jparams, toks):
    """JAX forward + logits_fn at every position (causal: position t sees tokens <= t)."""
    B, S = toks.shape
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    h, _ = jax_forward(jparams, jax_embed(jparams, jnp.asarray(toks), japi.cfg), pos, japi.cfg, None)
    return jax_logits_fn(jparams, h, japi.cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_jax(arch):
    japi, jparams, tapi, tparams = models(arch, weight_mult=5.0)
    B, S, new = 2, 8, 6
    prompt = np.random.default_rng(3).integers(0, japi.cfg.vocab_size, size=(B, S))
    engine = Engine(tapi, tparams, GenerationConfig(max_new_tokens=new, cache_len=S + new))
    out = engine.generate({"tokens": torch.as_tensor(prompt)})
    assert out.tokens.shape == (B, new) and out.logits.shape == (B, new, japi.cfg.vocab_size)

    # step 0 is the prefill's logits
    want_pf, _ = japi.prefill(jparams, {"tokens": jnp.asarray(prompt)})
    close(out.logits[:, 0], want_pf)
    # every step: JAX forward over the prompt and the tokens generated so far
    seq = np.concatenate([prompt, out.tokens[:, :-1].numpy()], axis=1)
    close(out.logits, jax_all_logits(japi, jparams, seq)[:, S - 1 :])
    # the tokens: JAX's greedy loop over pure decode_step from init_decode_state
    state = japi.init_decode_state(B, S + new)
    step = jax.jit(lambda p, s, t: japi.decode_step(p, s, t))
    for t in range(S):
        logits, state = step(jparams, state, jnp.asarray(prompt[:, t : t + 1], jnp.int32))
    want_toks = []
    for _ in range(new):
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        want_toks.append(np.asarray(tok))
        logits, state = step(jparams, state, tok)
    want_toks = np.concatenate(want_toks, axis=1)
    np.testing.assert_array_equal(out.tokens.numpy(), want_toks)
    assert len(set(want_toks[0].tolist())) > 1, "weights too flat: every step picks one token"
    # log-probs of the chosen tokens
    logp = torch.log_softmax(out.logits, dim=-1).gather(-1, out.tokens[..., None])[..., 0]
    assert torch.equal(out.logprobs, logp)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("masked", [False, True])
def test_score_matches_jax(arch, masked):
    japi, jparams, tapi, tparams = models(arch, weight_mult=5.0)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, japi.cfg.vocab_size, size=(3, 16))
    mask = (rng.random((3, 15)) < 0.7).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(toks)}
    tbatch = {"tokens": torch.as_tensor(toks)}
    if masked:
        jbatch["mask"], tbatch["mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    want = JaxEngine(japi, jparams, JaxGenerationConfig()).score(jbatch)
    got = Engine(tapi, tparams, GenerationConfig()).score(tbatch)
    assert got.shape == (3,)
    close(got, want, 1e-3)  # a sum of 15 f32 log-probs of magnitude ~10


def test_sampling_shape_range_and_seed():
    _, _, tapi, tparams = models("smollm-360m", weight_mult=5.0)
    V = tapi.cfg.vocab_size
    engine = Engine(tapi, tparams, GenerationConfig(max_new_tokens=5, temperature=1.0, cache_len=16))
    batch = {"tokens": torch.as_tensor(np.random.default_rng(5).integers(0, V, size=(3, 6)))}
    a = engine.generate(batch, torch.Generator().manual_seed(11))
    b = engine.generate(batch, torch.Generator().manual_seed(11))
    c = engine.generate(batch, torch.Generator().manual_seed(12))
    assert a.tokens.shape == (3, 5) and a.tokens.dtype == torch.int64
    assert int(a.tokens.min()) >= 0 and int(a.tokens.max()) < V
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.logprobs, b.logprobs)
    assert not torch.equal(a.tokens, c.tokens)
    assert bool(torch.all(a.logprobs <= 0))


def test_generate_refuses_to_overrun_the_cache():
    _, _, tapi, tparams = models("smollm-360m")
    engine = Engine(tapi, tparams, GenerationConfig(max_new_tokens=5, cache_len=10))
    with pytest.raises(ValueError, match="cache_len"):
        engine.generate({"tokens": torch.zeros(1, 6, dtype=torch.int64)})


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_on_cpu(arch, capsys):
    serve.main(["--arch", arch, "--device", "cpu", "--requests", "2", "--prompt-len", "5", "--new", "3"])
    out = capsys.readouterr().out
    assert f"{arch}-smoke on cpu: generated (2, 3)" in out and "tok/s" in out

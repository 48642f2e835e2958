"""The port's encoder-decoder (``whisper-medium``, reduced) vs ``repro.models.encdec``, in f32.

Weights cross from JAX through the checkpoint path keys
(``enc_layers/...``, ``dec_layers/...``; ``convert.params_from_flat``);
frames and tokens come from numpy seeds.  Tolerances: ``MODEL_TOL``
(1e-4) for whole-model outputs, 1e-5 for losses, gradients within 1e-4
of each leaf's largest reference magnitude.

JAX's ``encdec.prefill`` returns self-attention caches exactly the prompt
long, so its first decode write clamps onto the prompt's last slot
(ROADMAP C).  The port honours ``cache_len``; its decoding is held
against a JAX decode loop started from caches padded to ``cache_len``
and against teacher-forced ``decode_train`` + ``logits_fn``.  The frames
run shorter than ``encoder_seq`` (16 reduced) as well as at it, and, for
generation, longer: the port's decode attends every frame, as
``decode_train`` does, where JAX's decode masks the frames past
``encoder_seq`` (ROADMAP C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import encdec as jed
from repro.models.layers import logits_fn as jax_logits_fn
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config
from repro_torch.models import encdec as ted
from repro_torch.models.layers import logits_fn
from repro_torch.serving.engine import Engine, GenerationConfig

from _torch_parity import MODEL_TOL, assert_grads_close_to_max, models, np32, trainable

ARCH = "whisper-medium"


def close(got, want, tol=MODEL_TOL):
    np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol)


def batch(cfg, B, Se, S, seed):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, Se, cfg.d_model), dtype=np.float32)
    return frames, rng.integers(0, cfg.vocab_size, size=(B, S))


def both(frames, toks):
    return ({"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks, jnp.int32)},
            {"frames": torch.from_numpy(frames), "tokens": torch.as_tensor(toks)})


def test_config_matches_jax_registry():
    assert get_config(ARCH) == type(get_config(ARCH))(**jax_get_config(ARCH).__dict__)
    assert get_config(ARCH).reduced().encoder_seq == 16


def test_schema_keys_and_param_count():
    japi, jparams, tapi, tparams = models(ARCH)
    assert set(tparams.state_dict()) == {k.replace("/", ".") for k in _flatten(jparams)}
    assert tapi.param_count() == japi.param_count()
    assert {k.split("/")[0] for k in _flatten(jparams)} == {
        "embed", "enc_layers", "enc_norm", "dec_layers", "final_norm", "lm_head"}


@pytest.mark.parametrize("Se", [16, 10])
def test_encode_matches(Se):
    japi, jparams, tapi, tparams = models(ARCH, weight_mult=5.0)
    frames, _ = batch(japi.cfg, 2, Se, 4, seed=Se)
    want = jed.encode(jparams, jnp.asarray(frames), japi.cfg)
    close(ted.encode(tparams, torch.from_numpy(frames), tapi.cfg), want)


@pytest.mark.parametrize("Se", [16, 10])
def test_lm_loss_matches(Se):
    japi, jparams, tapi, tparams = models(ARCH, weight_mult=5.0)
    jb, tb = both(*batch(japi.cfg, 2, Se, 12, seed=1))
    want, jm = japi.loss_fn(jparams, jb)
    got, m = tapi.loss_fn(tparams, tb)
    assert m.keys() == jm.keys() == {"lm_loss"}
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)


def test_loss_grads_match_jax_grad():
    japi, jparams, tapi, params = trainable(ARCH)
    jb, tb = both(*batch(japi.cfg, 2, 12, 10, seed=2))
    want, jg = jax.value_and_grad(lambda p: japi.loss_fn(p, jb)[0])(jparams)
    loss, _ = tapi.loss_fn(params, tb)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5, atol=1e-5)
    assert_grads_close_to_max(loss, params, jg)


@pytest.mark.parametrize("Se", [16, 10])
@pytest.mark.parametrize("cache_len", [None, 20])
def test_prefill_logits_and_caches_match(Se, cache_len):
    japi, jparams, tapi, tparams = models(ARCH, weight_mult=5.0)
    S = 8
    jb, tb = both(*batch(japi.cfg, 2, Se, S, seed=3))
    want_logits, jstate = japi.prefill(jparams, jb)
    got_logits, state = tapi.prefill(tparams, tb, cache_len=cache_len)
    close(got_logits, want_logits)
    assert state.pos == int(jstate.pos) == S
    assert state.self_k.shape[2] == (cache_len or S) and state.cross_k.shape[2] == Se
    close(state.self_k[:, :, :S], jstate.self_k)
    close(state.self_v[:, :, :S], jstate.self_v)
    assert not state.self_k[:, :, S:].any() and not state.self_v[:, :, S:].any()
    close(state.cross_k, jstate.cross_k)
    close(state.cross_v, jstate.cross_v)


@pytest.mark.parametrize("Se", [16, 10])
def test_decode_steps_match_jax_from_padded_caches(Se):
    """Prefill, then every decode step against JAX's, its self caches padded to cache_len.

    The frames stay within ``encoder_seq``, where JAX's decode agrees with its own
    teacher forcing; past it JAX masks the extra frames and the port does not."""
    japi, jparams, tapi, tparams = models(ARCH, weight_mult=5.0)
    S, new = 6, 8
    frames, toks = batch(japi.cfg, 2, Se, S + new, seed=4)
    jb, tb = both(frames, toks[:, :S])
    jlogits, jstate = japi.prefill(jparams, jb)
    pad = ((0, 0), (0, 0), (0, new), (0, 0))
    jstate = jstate._replace(self_k=jnp.pad(jstate.self_k, pad), self_v=jnp.pad(jstate.self_v, pad))
    logits, state = tapi.prefill(tparams, tb, cache_len=S + new)
    close(logits, jlogits)
    jstep = jax.jit(lambda p, s, t: japi.decode_step(p, s, t))
    for i in range(new):
        tok = toks[:, S + i : S + i + 1]
        jlogits, jstate = jstep(jparams, jstate, jnp.asarray(tok, jnp.int32))
        logits, state = tapi.decode_step(tparams, state, torch.as_tensor(tok))
        close(logits, jlogits)
    assert state.pos == int(jstate.pos) == S + new
    close(state.self_k, jstate.self_k)
    close(state.self_v, jstate.self_v)


@pytest.mark.parametrize("Se", [16, 10, 32])
def test_generation_matches_teacher_forcing(Se):
    """Greedy generation's step logits against JAX's decode_train + logits_fn over the
    prompt and the generated tokens, at every generated position; Se = 32 gives more
    frames than the reduced encoder_seq (16), all of which decode attends."""
    japi, jparams, tapi, tparams = models(ARCH, weight_mult=5.0)
    S, new = 6, 7
    frames, toks = batch(japi.cfg, 2, Se, S, seed=5)
    _, tb = both(frames, toks)
    gen = Engine(tapi, tparams, GenerationConfig(max_new_tokens=new, cache_len=S + new)).generate(tb)
    seq = np.concatenate([toks, gen.tokens.numpy()[:, :-1]], axis=1)
    enc = jed.encode(jparams, jnp.asarray(frames), japi.cfg)
    h = jed.decode_train(jparams, jnp.asarray(seq, jnp.int32), enc, japi.cfg)
    want = jax_logits_fn(jparams, h, japi.cfg)
    close(gen.logits, want[:, S - 1 :])
    # and the port's own teacher forcing
    th = ted.decode_train(tparams, torch.as_tensor(seq), ted.encode(tparams, tb["frames"], tapi.cfg),
                          tapi.cfg)
    close(gen.logits, logits_fn(tparams, th, tapi.cfg)[:, S - 1 :])


def test_decode_from_init_state_matches_jax():
    """Pure decode from init_decode_state (zero cross caches encoder_seq long), as JAX's."""
    japi, jparams, tapi, tparams = models(ARCH, weight_mult=5.0)
    B, S = 2, 6
    toks = np.random.default_rng(6).integers(0, japi.cfg.vocab_size, size=(B, S))
    jstate = japi.init_decode_state(B, S)
    state = tapi.init_decode_state(B, S, device="cpu")
    assert state.cross_k.shape == jstate.cross_k.shape
    for t in range(S):
        want, jstate = japi.decode_step(jparams, jstate, jnp.asarray(toks[:, t : t + 1], jnp.int32))
        got, state = tapi.decode_step(tparams, state, torch.as_tensor(toks[:, t : t + 1]))
        close(got, want)


def test_score_raises_as_the_reference_cannot_score():
    """JAX's token_logprobs reads params["layers"], which the encoder-decoder lacks."""
    japi, jparams, tapi, tparams = models(ARCH)
    toks = jnp.zeros((1, 4), jnp.int32)
    from repro.training.grpo import token_logprobs as jax_token_logprobs

    with pytest.raises(KeyError):
        jax_token_logprobs(jparams, toks, japi)
    with pytest.raises(ValueError, match="encoder-decoder"):
        Engine(tapi, tparams, GenerationConfig()).score({"tokens": torch.zeros(1, 4, dtype=torch.long)})

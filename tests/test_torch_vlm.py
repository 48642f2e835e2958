"""The port's vlm family (``internvl2-1b``, reduced) vs ``repro.models.transformer``, in f32.

A vlm is the dense decoder with a stub prefix of patch embeddings
``[B, P, D]`` ahead of the text: the loss covers the text positions only,
prefill fills P + S cache rows and decoding continues at position P + S,
and scoring reads the text alone (JAX's ``token_logprobs`` never sees the
patches).  Weights cross from JAX through the checkpoint path keys.
Tolerances: ``MODEL_TOL`` (1e-4) for whole-model outputs, 1e-5 for
losses, gradients within 1e-4 of each leaf's largest reference magnitude.
Also the launchers on the reduced vlm and audio configs, on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.layers import logits_fn as jax_logits_fn
from repro.models.transformer import embed_tokens as jax_embed
from repro.models.transformer import forward as jax_forward
from repro.training import data as jax_data
from repro.training.grpo import token_logprobs as jax_token_logprobs
from repro_torch.configs import InputShape, get_config
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.serving.engine import Engine, GenerationConfig
from repro_torch.training import batch_for

from _torch_parity import MODEL_TOL, assert_grads_close_to_max, models, np32, trainable

ARCH = "internvl2-1b"


def close(got, want, tol=MODEL_TOL):
    np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol)


def batch(cfg, B, S, seed, P=None):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S))
    patches = rng.standard_normal((B, P or cfg.num_patches, cfg.d_model), dtype=np.float32)
    return toks, patches


def both(toks, patches):
    return ({"tokens": jnp.asarray(toks, jnp.int32), "patch_embeds": jnp.asarray(patches)},
            {"tokens": torch.as_tensor(toks), "patch_embeds": torch.from_numpy(patches)})


def jax_full_logits(japi, jparams, toks, patches):
    """JAX's forward over [patches, tokens] -> logits at every position."""
    cfg = japi.cfg
    x = jnp.concatenate([jnp.asarray(patches), jax_embed(jparams, jnp.asarray(toks, jnp.int32), cfg)], 1)
    B, S = x.shape[:2]
    h, _ = jax_forward(jparams, x, jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S)), cfg, None)
    return jax_logits_fn(jparams, h, cfg)


@pytest.mark.parametrize("arch", [ARCH, "whisper-medium", "llama3-8b", "glm4-9b"])
def test_config_matches_jax_registry(arch):
    ours, theirs = get_config(arch), jax_get_config(arch)
    assert ours.__dict__ == theirs.__dict__
    assert ours.reduced().__dict__ == theirs.reduced().__dict__


@pytest.mark.parametrize("P", [None, 5])
def test_lm_loss_matches(P):
    japi, jparams, tapi, tparams = models(ARCH, weight_mult=5.0)
    jb, tb = both(*batch(japi.cfg, 2, 12, seed=1, P=P))
    want, jm = japi.loss_fn(jparams, jb)
    got, m = tapi.loss_fn(tparams, tb)
    assert m.keys() == jm.keys()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(KeyError, match="patch_embeds"):
        tapi.loss_fn(tparams, {"tokens": tb["tokens"]})


def test_loss_grads_match_jax_grad():
    japi, jparams, tapi, params = trainable(ARCH)
    jb, tb = both(*batch(japi.cfg, 2, 10, seed=2))
    want, jg = jax.value_and_grad(lambda p: japi.loss_fn(p, jb)[0])(jparams)
    loss, _ = tapi.loss_fn(params, tb)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5, atol=1e-5)
    assert_grads_close_to_max(loss, params, jg)


@pytest.mark.parametrize("cache_len", [None, 24])
def test_prefill_with_patches_matches(cache_len):
    japi, jparams, tapi, tparams = models(ARCH, weight_mult=5.0)
    S, P = 8, japi.cfg.num_patches
    jb, tb = both(*batch(japi.cfg, 2, S, seed=3))
    want_logits, jstate = japi.prefill(jparams, jb)
    got_logits, state = tapi.prefill(tparams, tb, cache_len=cache_len)
    close(got_logits, want_logits)
    assert state.pos == int(jstate.pos) == P + S
    assert state.k_cache.shape[2] == (cache_len or P + S)
    close(state.k_cache[:, :, : P + S], jstate.k_cache)
    close(state.v_cache[:, :, : P + S], jstate.v_cache)
    # without patches the vlm prefill is the dense one over the text
    want_logits, _ = japi.prefill(jparams, {"tokens": jb["tokens"]})
    got_logits, state = tapi.prefill(tparams, {"tokens": tb["tokens"]})
    close(got_logits, want_logits)
    assert state.pos == S


def test_decode_continues_at_p_plus_s():
    """Generation after a patch prefix: each step against JAX's decode loop (caches
    padded to cache_len) and against JAX's full forward over [patches, prompt, tokens]."""
    japi, jparams, tapi, tparams = models(ARCH, weight_mult=5.0)
    S, new, P = 6, 6, japi.cfg.num_patches
    toks, patches = batch(japi.cfg, 2, S, seed=4)
    jb, tb = both(toks, patches)
    gen = Engine(tapi, tparams, GenerationConfig(max_new_tokens=new, cache_len=P + S + new)).generate(tb)
    seq = np.concatenate([toks, gen.tokens.numpy()[:, :-1]], axis=1)
    close(gen.logits, jax_full_logits(japi, jparams, seq, patches)[:, P + S - 1 :])

    jlogits, jstate = japi.prefill(jparams, jb)
    pad = ((0, 0), (0, 0), (0, new), (0, 0))
    jstate = jstate._replace(k_cache=jnp.pad(jstate.k_cache, pad), v_cache=jnp.pad(jstate.v_cache, pad))
    logits, state = tapi.prefill(tparams, tb, cache_len=P + S + new)
    assert state.pos == P + S
    for i in range(new - 1):
        tok = gen.tokens[:, i : i + 1]
        jlogits, jstate = japi.decode_step(jparams, jstate, jnp.asarray(tok.numpy(), jnp.int32))
        logits, state = tapi.decode_step(tparams, state, tok)
        close(logits, jlogits)
        close(logits, gen.logits[:, i + 1])
    assert state.pos == int(jstate.pos) == P + S + new - 1


def test_generate_counts_the_patches_in_the_cache():
    _, _, tapi, tparams = models(ARCH)
    toks, patches = batch(tapi.cfg, 1, 4, seed=5)
    engine = Engine(tapi, tparams, GenerationConfig(max_new_tokens=2, cache_len=4 + 2))
    with pytest.raises(ValueError, match="cache_len"):
        engine.generate(both(toks, patches)[1])


def test_score_is_text_only_as_jax():
    japi, jparams, tapi, tparams = models(ARCH, weight_mult=5.0)
    toks, patches = batch(japi.cfg, 3, 10, seed=6)
    want = np.asarray(jax_token_logprobs(jparams, jnp.asarray(toks, jnp.int32), japi)).sum(-1)
    engine = Engine(tapi, tparams, GenerationConfig())
    got = engine.score({"tokens": torch.as_tensor(toks), "patch_embeds": torch.from_numpy(patches)})
    close(got, want)


@pytest.mark.parametrize("arch", [ARCH, "whisper-medium"])
def test_batch_for_matches_jax(arch):
    cfg = get_config(arch)
    shape = InputShape("t", 300 if cfg.family == "vlm" else 40, 2, "train")
    got = batch_for(cfg, shape, seed=7)
    want = jax_data.batch_for(jax_get_config(arch), shape, seed=7)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])


@pytest.mark.parametrize("arch", [ARCH, "whisper-medium"])
def test_serve_launcher_on_the_cpu(arch, capsys):
    serve_mod.main(["--arch", arch, "--device", "cpu", "--requests", "2", "--prompt-len", "6",
                    "--new", "4", "--frames", "12", "--patches", "3"])
    assert "generated (2, 4)" in capsys.readouterr().out
    server = serve_mod.build_server(arch, requests=2, prompt_len=6, new=4, device="cpu",
                                    frames=12, patches=3)
    extra = {"vlm": ("patch_embeds", 3), "audio": ("frames", 12)}[server.cfg.family]
    assert set(server.batch) == {"tokens", extra[0]}
    assert server.batch[extra[0]].shape == (2, extra[1], server.cfg.d_model)
    assert server.engine.gen.cache_len == 6 + 4 + (3 if extra[0] == "patch_embeds" else 0)
    out, _ = serve_mod.timed_generate(server)
    assert out.tokens.shape == (2, 4) and bool(torch.isfinite(out.logits).all())


@pytest.mark.parametrize("arch", [ARCH, "whisper-medium"])
def test_train_launcher_on_the_cpu(arch):
    trainer, metrics = train_mod.main(["--arch", arch, "--steps", "3", "--batch", "2",
                                       "--seq", "12", "--device", "cpu", "--frames", "10"])
    batch_ = train_mod.next_batch(trainer)
    if trainer.cfg.family == "vlm":
        assert batch_["patch_embeds"].shape == (2, trainer.cfg.num_patches, trainer.cfg.d_model)
    else:
        assert batch_["frames"].shape == (2, 10, trainer.cfg.d_model)
    assert batch_["tokens"].shape == (2, 12)
    assert len(metrics) == 3 and all(np.isfinite(m["loss"]) for m in metrics)

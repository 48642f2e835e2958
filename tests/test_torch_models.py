"""The port's transformer (dense, MoE, SSM, hybrid) vs ``repro.models`` on reduced configs, in f32.

The dense ``llama3-8b`` and ``glm4-9b`` (head dim 128 at full width; GQA
g 4 and 16) join the forward and loss cases reduced; the vlm and audio
families have test_torch_vlm.py and test_torch_encdec.py, and join the
weight conversion cases here.

Weights cross from JAX through the checkpoint path keys
(``convert.params_from_flat``).  Tolerance: ``_torch_parity.MODEL_TOL``
(1e-4, f32 with a different summation order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import logits_fn as jax_logits_fn
from repro.models.transformer import embed_tokens as jax_embed
from repro.models.transformer import forward as jax_forward
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import transformer as tt
from repro_torch.models.convert import flat_from_params, params_from_flat
from repro_torch.models.layers import logits_fn

from _torch_parity import MODEL_TOL, models, np32

ARCHS = ["smollm-360m", "llama3.2-1b", "granite-moe-3b-a800m", "mamba2-130m", "hymba-1.5b"]
LARGE_DENSE = ["llama3-8b", "glm4-9b"]


def close(got, want, tol=MODEL_TOL):
    np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol)


def tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, S))


@pytest.mark.parametrize("arch", ARCHS + LARGE_DENSE + ["internvl2-1b", "whisper-medium"])
def test_convert_round_trip_keeps_keys_shapes_dtypes(arch):
    japi, jparams, tapi, tparams = models(arch)
    flat = _flatten(jparams)
    back = flat_from_params(tparams)
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        assert back[k].shape == v.shape and back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v)
    assert sum(v.size for v in flat.values()) == tapi.param_count() == japi.param_count()
    assert set(tparams.state_dict()) == {k.replace("/", ".") for k in flat}


def test_convert_round_trip_bf16():
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(), dtype="bfloat16")
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    again = params_from_flat(flat_from_params(params), cfg, "cpu")
    for k, v in params.state_dict().items():
        assert again.state_dict()[k].dtype == torch.bfloat16
        assert torch.equal(again.state_dict()[k], v), k


@pytest.mark.parametrize("mutate", ["missing", "extra", "shape"])
def test_params_from_flat_rejects_mismatch(mutate):
    _, jparams, tapi, _ = models("smollm-360m")
    flat = _flatten(jparams)
    if mutate == "missing":
        flat.pop("layers/attn/wq")
    elif mutate == "extra":
        flat["layers/attn/bias"] = np.zeros(3, np.float32)
    else:
        flat["final_norm"] = np.ones(7, np.float32)
    with pytest.raises(KeyError if mutate != "shape" else ValueError):
        params_from_flat(flat, tapi.cfg, "cpu")


def test_layer_views_are_kept_and_follow_moved_storage():
    cfg = get_config("smollm-360m").reduced()
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    views = tt.layer_params(params["layers"])
    assert len(views) == cfg.num_layers
    assert tt.layer_params(params["layers"]) is views
    wq = params["layers"]["attn"]["wq"]
    assert torch.equal(views[1]["attn"]["wq"], wq[1])
    wq.data = wq.data * 2  # new storage: the kept views are stale
    again = tt.layer_params(params["layers"])
    assert again is not views and torch.equal(again[1]["attn"]["wq"], wq[1])


def test_non_dense_family_raises():
    """Every family of the repository builds; the decoder-only functions refuse the
    encoder-decoder (it is ``models.encdec``'s) and a family no model has."""
    for family in ("vlm", "audio"):
        build_model(dataclasses.replace(get_config("smollm-360m").reduced(), family=family,
                                        encoder_layers=2))
    with pytest.raises(ValueError, match="models.encdec"):
        tt.model_schema(get_config("whisper-medium").reduced())
    with pytest.raises(ValueError, match="not a decoder-only family"):
        build_model(dataclasses.replace(get_config("smollm-360m").reduced(), family="conv"))


@pytest.mark.parametrize("arch", ARCHS + LARGE_DENSE)
def test_forward_logits_match(arch):
    japi, jparams, tapi, tparams = models(arch, weight_mult=5.0)
    B, S = 2, 24
    toks = tokens(japi.cfg, B, S)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    h, jaux = jax_forward(jparams, jax_embed(jparams, jnp.asarray(toks), japi.cfg), pos, japi.cfg, None)
    want = jax_logits_fn(jparams, h, japi.cfg)
    t = torch.as_tensor(toks)
    th, aux = tt.forward(tparams, tt.embed_tokens(tparams, t, tapi.cfg), tt.arange_positions(B, S, "cpu"), tapi.cfg)
    close(logits_fn(tparams, th, tapi.cfg), want)
    # the MoE aux losses, averaged over layers (zeros for the other families)
    assert aux.keys() == jaux.keys() == {"load_balance", "router_z"}
    for k in aux:
        assert aux[k].shape == () and aux[k].dtype == torch.float32
        close(aux[k], jaux[k])
    assert (float(aux["load_balance"]) > 0) == (japi.cfg.family == "moe")


@pytest.mark.parametrize("arch", ARCHS + LARGE_DENSE)
def test_lm_loss_matches(arch):
    """``ModelApi.loss_fn`` (lm_loss: CE plus the weighted MoE aux terms) against JAX's."""
    japi, jparams, tapi, tparams = models(arch, weight_mult=5.0)
    toks = tokens(japi.cfg, 2, 32, seed=4)
    want, jm = japi.loss_fn(jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    got, m = tapi.loss_fn(tparams, {"tokens": torch.as_tensor(toks)})
    assert m.keys() == jm.keys() == {"lm_loss", "load_balance", "router_z"}
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-5)


def test_loss_fn_of_unported_families_names_a8():
    """The vlm and audio families train since A8: a batch without the input they
    read first (the patches; the frames) raises a KeyError naming it, as in JAX."""
    for arch, key in (("internvl2-1b", "patch_embeds"), ("whisper-medium", "frames")):
        _, _, tapi, tparams = models(arch)
        with pytest.raises(KeyError, match=key):
            tapi.loss_fn(tparams, {"tokens": torch.zeros(1, 4, dtype=torch.long)})


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cache_len", [None, 20])
def test_prefill_logits_and_caches_match(arch, cache_len):
    japi, jparams, tapi, tparams = models(arch, weight_mult=5.0)
    B, S = 2, 12
    toks = tokens(japi.cfg, B, S, seed=1)
    want_logits, want_state = japi.prefill(jparams, {"tokens": jnp.asarray(toks)})
    got_logits, state = tapi.prefill(tparams, {"tokens": torch.as_tensor(toks)}, cache_len=cache_len)
    close(got_logits, want_logits)
    assert state.pos == int(want_state.pos) == S
    # ssm and hybrid: each layer's final SSD state
    assert (state.ssm_state is None) == (want_state.ssm_state is None) == (japi.cfg.family not in ("ssm", "hybrid"))
    if state.ssm_state is not None:
        close(state.ssm_state, want_state.ssm_state)
    if japi.cfg.family == "ssm":  # no cache
        assert state.k_cache is None and want_state.k_cache is None
        return
    assert state.k_cache.shape[2] == (cache_len or S)
    close(state.k_cache[:, :, :S], want_state.k_cache)
    close(state.v_cache[:, :, :S], want_state.v_cache)
    assert not state.k_cache[:, :, S:].any() and not state.v_cache[:, :, S:].any()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("window", [0, 6])
def test_decode_steps_match_jax_decode(arch, window):
    """Pure decode from init_decode_state(B, cache_len), token by token."""
    japi, jparams, tapi, tparams = models(arch, weight_mult=5.0)
    B, S = 2, 10
    toks = tokens(japi.cfg, B, S, seed=2)
    jstate = japi.init_decode_state(B, S)
    jstep = jax.jit(lambda p, s, t: japi.decode_step(p, s, t, sliding_window=window))
    state = tapi.init_decode_state(B, S, device="cpu")
    for t in range(S):
        want, jstate = jstep(jparams, jstate, jnp.asarray(toks[:, t : t + 1], jnp.int32))
        got, state = tapi.decode_step(
            tparams, state, torch.as_tensor(toks[:, t : t + 1]), sliding_window=window
        )
        close(got, want)
    assert state.pos == S
    for field in ("k_cache", "v_cache", "ssm_state"):
        mine, theirs = getattr(state, field), getattr(jstate, field)
        assert (mine is None) == (theirs is None), field
        if mine is not None:
            close(mine, theirs)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """tests/test_models.py:68-94 across frameworks: the port's decode steps
    against JAX's full forward over the same tokens, at every position."""
    japi, jparams, tapi, tparams = models(arch, weight_mult=5.0)
    B, S = 2, 16
    toks = tokens(japi.cfg, B, S, seed=3)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    h, _ = jax_forward(jparams, jax_embed(jparams, jnp.asarray(toks), japi.cfg), pos, japi.cfg, None)
    want = jax_logits_fn(jparams, h, japi.cfg)
    state = tapi.init_decode_state(B, S, device="cpu")
    for t in range(S):
        got, state = tapi.decode_step(tparams, state, torch.as_tensor(toks[:, t : t + 1]))
        close(got, want[:, t])


@pytest.mark.parametrize("arch", ["smollm-360m", "hymba-1.5b"])
def test_prefill_then_decode_consistency(arch):
    """tests/test_models.py:97-113 across frameworks: prefill(prompt) and one
    decode step on its caches, held against JAX's full forward over the
    prompt and the greedy token (the port's caches are cache_len long, so
    the step lands on slot S and not on the prompt's last)."""
    japi, jparams, tapi, tparams = models(arch, weight_mult=5.0)
    B, S = 2, 8
    toks = tokens(japi.cfg, B, S, seed=5)
    pf_logits, state = tapi.prefill(tparams, {"tokens": torch.as_tensor(toks)}, cache_len=S + 1)
    assert bool(torch.isfinite(pf_logits).all())
    tok = torch.argmax(pf_logits, -1)[:, None]
    logits, state2 = tapi.decode_step(tparams, state, tok)
    assert bool(torch.isfinite(logits).all())
    assert state2.pos == state.pos + 1 == S + 1
    seq = np.concatenate([toks, tok.numpy()], axis=1)
    pos = jnp.broadcast_to(jnp.arange(S + 1, dtype=jnp.int32), (B, S + 1))
    h, _ = jax_forward(jparams, jax_embed(jparams, jnp.asarray(seq), japi.cfg), pos, japi.cfg, None)
    want = jax_logits_fn(jparams, h, japi.cfg)
    close(pf_logits, want[:, S - 1])
    close(logits, want[:, S])

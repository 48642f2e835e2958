"""The port's layer functions vs ``repro.models.layers`` on the CPU, in f32.

Same numpy inputs and weights on both sides.  Tolerance 1e-5 (f32,
different summation order), except where stated.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.models import layers as jl
from repro_torch.models import layers as tl

from _torch_parity import np32, torch_cfg

TOL = 1e-5


def cfg_pair(heads=6, kv=2, head_dim=64, d_model=128, **kw):
    jcfg = JaxModelConfig(
        name="parity", family="dense", num_layers=1, d_model=d_model, num_heads=heads,
        num_kv_heads=kv, d_ff=96, vocab_size=100, head_dim=head_dim, dtype="float32",
        rope_theta=10_000.0, **kw,
    )
    return jcfg, torch_cfg(jcfg)


def attn_params(rng, cfg, scale=0.1):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    shapes = {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd), "wo": (h * hd, d)}
    p = {k: rng.standard_normal(s, dtype=np.float32) * scale for k, s in shapes.items()}
    return {k: jnp.asarray(v) for k, v in p.items()}, {k: torch.from_numpy(v) for k, v in p.items()}


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_apply_rope(theta):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 3, 64), dtype=np.float32)
    pos = rng.integers(0, 4000, size=(2, 9)).astype(np.int32)
    close(
        tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
        jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
        1e-4,  # angles up to 4000 rad: the two sin/cos libraries differ by ~1e-5
    )


@pytest.mark.parametrize("heads,kv", [(4, 4), (4, 2), (6, 2), (8, 2)])
@pytest.mark.parametrize("S", [24, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_multihead_attention(heads, kv, S, causal):
    jcfg, tcfg = cfg_pair(heads=heads, kv=kv)
    rng = np.random.default_rng(heads * 10 + S)
    jp, tp = attn_params(rng, jcfg)
    x = rng.standard_normal((2, S, jcfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    want = jax.jit(lambda *a: jl.multihead_attention(*a, jcfg, causal=causal))(
        jp, jnp.asarray(x), jnp.asarray(pos)
    )
    got = tl.multihead_attention(
        tp, torch.from_numpy(x), torch.from_numpy(pos.copy()), tcfg, causal=causal
    )
    close(got, want)


def test_multihead_attention_matches_the_q_chunk_path():
    """At S >= 2*Q_CHUNK JAX scans query blocks; the port's one kernel covers both."""
    jcfg, tcfg = cfg_pair(heads=2, kv=1, head_dim=64, d_model=64)
    S = 2 * jl.Q_CHUNK
    rng = np.random.default_rng(3)
    jp, tp = attn_params(rng, jcfg)
    x = rng.standard_normal((1, S, jcfg.d_model), dtype=np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    want = jax.jit(lambda *a: jl.multihead_attention(*a, jcfg))(jp, jnp.asarray(x), jnp.asarray(pos))
    got = tl.multihead_attention(tp, torch.from_numpy(x), torch.from_numpy(pos), tcfg)
    close(got, want)


def test_multihead_attention_fills_a_longer_cache():
    jcfg, tcfg = cfg_pair()
    rng = np.random.default_rng(4)
    _, tp = attn_params(rng, jcfg)
    B, S, W = 2, 10, tcfg.num_kv_heads * tcfg.resolved_head_dim
    x = torch.from_numpy(rng.standard_normal((B, S, tcfg.d_model), dtype=np.float32))
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    kc, vc = torch.zeros(B, 16, W), torch.zeros(B, 16, W)
    tl.multihead_attention(tp, x, pos, tcfg, cache=(kc, vc))
    k = tl.apply_rope((x @ tp["wk"]).view(B, S, -1, tcfg.resolved_head_dim), pos, tcfg.rope_theta)
    assert torch.equal(kc[:, :S], k.reshape(B, S, W))
    assert torch.equal(vc[:, :S], x @ tp["wv"])
    assert not kc[:, S:].any() and not vc[:, S:].any()


@pytest.mark.parametrize(
    "kw", [dict(mask=torch.ones(1)),
           dict(kv_override=(torch.zeros(1, 3, 2, 64), torch.zeros(1, 3, 2, 64)),
                cache=(torch.zeros(1, 4, 128), torch.zeros(1, 4, 128))),
           dict(sliding_window=4)]
)
def test_multihead_attention_options_not_ported_raise(kw):
    """No entry point of the reference passes a mask or a full-sequence window;
    cross-attention (``kv_override``) writes no cache."""
    _, tcfg = cfg_pair()
    _, tp = attn_params(np.random.default_rng(0), tcfg)
    x = torch.zeros(1, 4, tcfg.d_model)
    exc, match = {"mask": (NotImplementedError, "no entry point"),
                  "kv_override": (ValueError, "writes no cache"),
                  "sliding_window": (NotImplementedError, "decode_attention only")}[next(iter(kw))]
    with pytest.raises(exc, match=match):
        tl.multihead_attention(tp, x, torch.zeros(1, 4, dtype=torch.int32), tcfg, **kw)


@pytest.mark.parametrize("heads,kv", [(4, 4), (6, 2)])
@pytest.mark.parametrize("S,Sk", [(8, 20), (24, 5)])
@pytest.mark.parametrize("use_rope", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_multihead_attention_kv_override(heads, kv, S, Sk, use_rope, causal):
    """Cross-attention: keys of their own length Sk, q roped only if ``use_rope`` (2e-5)."""
    jcfg, tcfg = cfg_pair(heads=heads, kv=kv)
    rng = np.random.default_rng(heads + S + Sk)
    jp, tp = attn_params(rng, jcfg)
    hd = jcfg.resolved_head_dim
    x = rng.standard_normal((2, S, jcfg.d_model), dtype=np.float32)
    k = rng.standard_normal((2, Sk, kv, hd), dtype=np.float32)
    v = rng.standard_normal((2, Sk, kv, hd), dtype=np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    want = jl.multihead_attention(jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                                  kv_override=(jnp.asarray(k), jnp.asarray(v)), causal=causal,
                                  use_rope=use_rope)
    got = tl.multihead_attention(tp, torch.from_numpy(x), torch.from_numpy(pos), tcfg,
                                 kv_override=(torch.from_numpy(k), torch.from_numpy(v)),
                                 causal=causal, use_rope=use_rope)
    close(got, want, 2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_multihead_attention_without_rope(causal):
    """Self-attention with ``use_rope=False`` (no entry point uses it; the option is JAX's)."""
    jcfg, tcfg = cfg_pair()
    rng = np.random.default_rng(9)
    jp, tp = attn_params(rng, jcfg)
    x = rng.standard_normal((2, 12, jcfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    want = jl.multihead_attention(jp, jnp.asarray(x), jnp.asarray(pos), jcfg, causal=causal,
                                  use_rope=False)
    got = tl.multihead_attention(tp, torch.from_numpy(x), torch.from_numpy(pos), tcfg,
                                 causal=causal, use_rope=False)
    close(got, want, 2e-5)


@pytest.mark.parametrize("pos", [3, 7, 15, 1499])
@pytest.mark.parametrize("use_rope", [False, True])
def test_decode_attention_reads_a_cache_it_does_not_update(pos, use_rope):
    """``update_cache=False`` (the decoder's cross-attention): nothing written, and a
    position at or past the cache length (Whisper's encoder_seq - 1) masks nothing (2e-5)."""
    jcfg, tcfg = cfg_pair()
    rng = np.random.default_rng(pos)
    jp, tp = attn_params(rng, jcfg)
    B, Sk, W = 2, 8, jcfg.num_kv_heads * jcfg.resolved_head_dim
    x = rng.standard_normal((B, 1, jcfg.d_model), dtype=np.float32)
    kc = rng.standard_normal((B, Sk, W), dtype=np.float32)
    vc = rng.standard_normal((B, Sk, W), dtype=np.float32)
    want, want_k, want_v = jl.decode_attention(
        jp, jnp.asarray(x), jnp.asarray(pos, jnp.int32), jnp.asarray(kc), jnp.asarray(vc), jcfg,
        update_cache=False, use_rope=use_rope)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = tl.decode_attention(tp, torch.from_numpy(x), pos, tk, tv, tcfg, update_cache=False,
                              use_rope=use_rope)
    close(got, want, 2e-5)
    assert np.array_equal(tk.numpy(), kc) and np.array_equal(tv.numpy(), vc)
    np.testing.assert_array_equal(np.asarray(want_k), kc)


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("pos", [0, 3, 11])
def test_decode_attention(window, pos):
    jcfg, tcfg = cfg_pair()
    rng = np.random.default_rng(pos + 7 * window)
    jp, tp = attn_params(rng, jcfg)
    B, S_max, W = 2, 12, jcfg.num_kv_heads * jcfg.resolved_head_dim
    x = rng.standard_normal((B, 1, jcfg.d_model), dtype=np.float32)
    kc = rng.standard_normal((B, S_max, W), dtype=np.float32)
    vc = rng.standard_normal((B, S_max, W), dtype=np.float32)
    want, want_k, want_v = jax.jit(
        lambda *a: jl.decode_attention(*a, jcfg, sliding_window=window)
    )(jp, jnp.asarray(x), jnp.asarray(pos, jnp.int32), jnp.asarray(kc), jnp.asarray(vc))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = tl.decode_attention(tp, torch.from_numpy(x), pos, tk, tv, tcfg, sliding_window=window)
    close(got, want)
    close(tk, want_k)  # written in place
    close(tv, want_v)


def test_decode_attention_refuses_a_position_past_the_cache():
    """JAX clamps such a write onto the last slot; the port raises."""
    _, tcfg = cfg_pair()
    _, tp = attn_params(np.random.default_rng(0), tcfg)
    W = tcfg.num_kv_heads * tcfg.resolved_head_dim
    kc = torch.zeros(1, 4, W)
    with pytest.raises(IndexError):
        tl.decode_attention(tp, torch.zeros(1, 1, tcfg.d_model), 4, kc, kc.clone(), tcfg)


def test_swiglu_ffn():
    rng = np.random.default_rng(8)
    p = {
        "w_gate": rng.standard_normal((32, 48), dtype=np.float32) * 0.3,
        "w_up": rng.standard_normal((32, 48), dtype=np.float32) * 0.3,
        "w_down": rng.standard_normal((48, 32), dtype=np.float32) * 0.3,
    }
    x = rng.standard_normal((2, 5, 32), dtype=np.float32)
    close(
        tl.swiglu_ffn({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x)),
        jl.swiglu_ffn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)),
    )


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_fn(tied, dtype):
    jcfg, _ = cfg_pair(tie_embeddings=tied)
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    tcfg = torch_cfg(jcfg)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 3, jcfg.d_model), dtype=np.float32)
    w = rng.standard_normal(
        (jcfg.vocab_size, jcfg.d_model) if tied else (jcfg.d_model, jcfg.vocab_size),
        dtype=np.float32,
    )
    name = "embed" if tied else "lm_head"
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    want = jl.logits_fn({name: jnp.asarray(w, jd)}, jnp.asarray(x, jd), jcfg)
    got = tl.logits_fn({name: torch.from_numpy(w).to(td)}, torch.from_numpy(x).to(td), tcfg)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    # f32 result of exact bf16 products: only the summation order differs
    close(got, want, 1e-4)


@pytest.mark.parametrize("init", ["normal", "zeros", "ones"])
def test_init_from_schema(init):
    schema = {"a": tl.ParamDef((3, 4), init=init, scale=0.5), "b": {"c": tl.stacked(tl.ParamDef((5,), init=init), 2)}}
    gen = torch.Generator().manual_seed(0)
    tree = tl.init_from_schema(schema, torch.bfloat16, gen, "cpu")
    assert set(tree.state_dict()) == {"a", "b.c"}
    assert tree["b"]["c"].shape == (2, 5) and tree["a"].dtype == torch.bfloat16
    again = tl.init_from_schema(schema, torch.bfloat16, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(tree["a"], again["a"])
    if init == "zeros":
        assert not tree["a"].any()
    elif init == "ones":
        assert torch.all(tree["a"] == 1)
    else:
        assert 0.2 < tree["a"].float().std() < 1.0

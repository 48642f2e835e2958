"""Whisper-style encoder-decoder backbone (audio family), as functions over a ParamTree.

Torch twin of ``repro.models.encdec``.  The mel-spectrogram and conv
front end is a stub, as in the JAX package: inputs are precomputed frame
embeddings ``[B, S_enc, D]``.  The encoder is a non-causal transformer
(RoPE on its self-attention, through the flash kernel's non-causal mode);
the decoder adds cross-attention to the encoder output
(``layers.cross_attention``: B11, the flash kernels with keys of their own
length).  Decoding runs one token against a self-attention cache and the
fixed cross-attention caches that prefill fills (B11's decode kernel reads
those in place).

In training each encoder and decoder layer is rematerialised as JAX's
``cfg.remat`` does it (``layers.remat_layer``).

Departures, as in ``models.transformer``: depth is a Python loop;
caches are updated in place; prefill's self-attention caches honour
``cache_len`` (JAX's are exactly the prompt long,
repro/models/encdec.py:281-288, so its first decode write clamps onto
the prompt's last slot), and its cross caches are as long as the frames.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    CacheBlock,
    ParamDef,
    attention_schema,
    cache_blocks,
    cross_entropy,
    decode_attention,
    embed_schema,
    ffn_schema,
    lm_head_schema,
    logits_fn,
    multihead_attention,
    remat_layer,
    rms_norm,
    rope_cos_sin,
    sharded_lm_head_loss,
    stacked,
    swiglu_ffn,
    torch_dtype,
)
from repro_torch.models.transformer import (
    arange_positions,
    cache_dims,
    distribute_batch,
    embed_tokens,
    layer_params,
)
from repro_torch.sharding.rules import is_dtensor


def _norm(cfg: ModelConfig) -> ParamDef:
    return ParamDef((cfg.d_model,), (None,), init="ones")


def encoder_layer_schema(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "attn": attention_schema(cfg),
        "norm_attn": _norm(cfg),
        "ffn": ffn_schema(cfg),
        "norm_ffn": _norm(cfg),
    }


def decoder_layer_schema(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "self_attn": attention_schema(cfg),
        "norm_self": _norm(cfg),
        "cross_attn": attention_schema(cfg),
        "norm_cross": _norm(cfg),
        "ffn": ffn_schema(cfg),
        "norm_ffn": _norm(cfg),
    }


def model_schema(cfg: ModelConfig) -> Dict[str, Any]:
    def stack(node, layers):
        if isinstance(node, dict):
            return {k: stack(v, layers) for k, v in node.items()}
        return stacked(node, layers)

    s: Dict[str, Any] = {
        "embed": embed_schema(cfg),
        "enc_layers": stack(encoder_layer_schema(cfg), cfg.encoder_layers),
        "enc_norm": _norm(cfg),
        "dec_layers": stack(decoder_layer_schema(cfg), cfg.num_layers),
        "final_norm": _norm(cfg),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = lm_head_schema(cfg)
    return s


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def encoder_layer(lp, x: torch.Tensor, positions, cfg: ModelConfig, rope=None, rules=None):
    """One pre-norm encoder layer: non-causal self-attention, then the FFN."""
    hn = rms_norm(x, lp["norm_attn"], cfg.norm_eps)
    x = x + multihead_attention(lp["attn"], hn, positions, cfg, causal=False, rope=rope,
                                rules=rules)
    return x + swiglu_ffn(lp["ffn"], rms_norm(x, lp["norm_ffn"], cfg.norm_eps), rules)


def encode(params, frames: torch.Tensor, cfg: ModelConfig, rules=None) -> torch.Tensor:
    """frames [B, S_enc, D] (stub embeddings) -> the final-normed encoder output."""
    B, S, _ = frames.shape
    x = frames.to(torch_dtype(cfg))
    if rules is not None:
        x = rules.constrain(x, ("batch", None, None))
    positions = arange_positions(B, S, x.device)
    rope = None if is_dtensor(x) else rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)
    for lp in layer_params(params["enc_layers"]):
        x = remat_layer(cfg, encoder_layer, lp, x, positions, cfg, rope, rules)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


def cross_kv(lp, enc_out: torch.Tensor, cfg: ModelConfig, rules=None):
    """The cross-attention's K and V of the encoder output, each [B, S_enc, KV, hd] (no RoPE).

    A DTensor encoder output: each rank projects its batch block whole (the
    cross-attention is repeated over the model axis); DTensors laid out as it."""
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    ca = lp["cross_attn"]
    if rules is not None and is_dtensor(enc_out):
        ds = rules.batch_sharded(enc_out)
        el = rules.enter(enc_out, ("batch", None, None))
        B, Se, _ = el.shape
        return tuple(rules.leave((el @ rules.param(ca[n], split=False, data_sharded=ds))
                                 .view(B, Se, kv, hd), enc_out) for n in ("wk", "wv"))
    B, Se, _ = enc_out.shape
    return (enc_out @ ca["wk"]).view(B, Se, kv, hd), (enc_out @ ca["wv"]).view(B, Se, kv, hd)


def _write_rows(block: CacheBlock, k: torch.Tensor, v: torch.Tensor) -> None:
    """A rank's block of FLAT caches from whole-row K/V [B_l, S, KV*hd] (its rows and columns)."""
    r1 = min(k.shape[1], block.s_lo + block.k.shape[1])
    if r1 > block.s_lo:
        cols = slice(block.c_lo, block.c_lo + block.k.shape[2])
        block.k[:, : r1 - block.s_lo] = k[:, block.s_lo:r1, cols]
        block.v[:, : r1 - block.s_lo] = v[:, block.s_lo:r1, cols]


def decoder_layer(lp, x: torch.Tensor, enc_out: torch.Tensor, positions, cfg: ModelConfig,
                  rope=None, rules=None, cache=None, cross_cache=None):
    """One pre-norm decoder layer: causal self-attention, cross-attention to the encoder
    output, then the FFN.  ``cache`` (prefill) receives the roped self-attention K/V and
    ``cross_cache`` the cross K/V: a (k, v) pair of FLAT caches, or with a DTensor x the
    rank's ``CacheBlock``s."""
    hn = rms_norm(x, lp["norm_self"], cfg.norm_eps)
    x = x + multihead_attention(lp["self_attn"], hn, positions, cfg, cache=cache, rope=rope,
                                rules=rules)
    ck, cv = cross_kv(lp, enc_out, cfg, rules)
    if isinstance(cross_cache, CacheBlock):
        _write_rows(cross_cache, *(rules.enter(t, ("batch", None, None, None)).flatten(2)
                                   for t in (ck, cv)))
    elif cross_cache is not None:
        cross_cache[0].copy_(ck.flatten(2))
        cross_cache[1].copy_(cv.flatten(2))
    hn = rms_norm(x, lp["norm_cross"], cfg.norm_eps)
    x = x + multihead_attention(lp["cross_attn"], hn, positions, cfg, kv_override=(ck, cv),
                                causal=False, use_rope=False, rules=rules)
    return x + swiglu_ffn(lp["ffn"], rms_norm(x, lp["norm_ffn"], cfg.norm_eps), rules)


def _decoder(params, tokens: torch.Tensor, enc_out: torch.Tensor, cfg: ModelConfig, state=None,
             rules=None):
    """The decoder layers over the whole text -> hidden [B, S, D], before the final norm.

    With ``state`` (prefill), each layer's roped self-attention K/V and its
    cross K/V are written into the state's caches in place (with live
    ``rules``, the rank's blocks of them); without it (``decode_train``) each
    layer is a rematerialised region in training.
    """
    B, S = tokens.shape
    x = embed_tokens(params, tokens, cfg, rules)
    live = is_dtensor(x)
    positions = arange_positions(B, S, tokens.device)
    rope = None if live else rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)
    if state is None:
        for lp in layer_params(params["dec_layers"]):
            x = remat_layer(cfg, decoder_layer, lp, x, enc_out, positions, cfg, rope, rules)
        return x
    if live:
        caches = list(zip(cache_blocks(state.self_k, state.self_v, rules),
                          cache_blocks(state.cross_k, state.cross_v, rules)))
    else:
        caches = [((state.self_k[i], state.self_v[i]), (state.cross_k[i], state.cross_v[i]))
                  for i in range(cfg.num_layers)]
    for lp, (cache, cross_cache) in zip(layer_params(params["dec_layers"]), caches):
        x = decoder_layer(lp, x, enc_out, positions, cfg, rope, rules, cache, cross_cache)
    return x


def decode_train(params, tokens: torch.Tensor, enc_out: torch.Tensor, cfg: ModelConfig,
                 rules=None):
    """Teacher-forced decoder over tokens [B, S] given the encoder output -> final-normed [B, S, D]."""
    x = _decoder(params, tokens, enc_out, cfg, rules=rules)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def lm_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, rules=None):
    """Next-token loss of the text given the frames -> (loss, {"lm_loss"})."""
    batch = distribute_batch(batch, rules)
    enc_out = encode(params, batch["frames"], cfg, rules)
    h = decode_train(params, batch["tokens"], enc_out, cfg, rules)
    if is_dtensor(h):
        loss = sharded_lm_head_loss(params, h[:, :-1, :], batch["tokens"][:, 1:], cfg, rules)
    else:
        loss = cross_entropy(logits_fn(params, h[:, :-1, :], cfg), batch["tokens"][:, 1:])
    return loss, {"lm_loss": loss}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


class EncDecState(NamedTuple):
    self_k: torch.Tensor  # FLAT [L, B, S_max, KV*hd] (see layers.decode_attention)
    self_v: torch.Tensor
    cross_k: torch.Tensor  # FLAT [L, B, S_enc, KV*hd]
    cross_v: torch.Tensor
    pos: int  # next position to write (kept on the host)


def init_decode_state(
    cfg: ModelConfig,
    batch: int,
    cache_len: int,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cuda",
    enc_len: Optional[int] = None,
    rules=None,
) -> EncDecState:
    """Zero caches: self-attention ``cache_len`` long, cross-attention ``enc_len``
    (None: ``cfg.encoder_seq``, as JAX's) long; with live ``rules``, DTensors placed
    by ``decode_state_specs``."""
    L, width = cfg.num_layers, cfg.num_kv_heads * cfg.resolved_head_dim
    Se = cfg.encoder_seq if enc_len is None else enc_len
    live = rules is not None and rules.live
    specs = decode_state_specs(cfg, rules, batch, cache_len, Se) if live else None

    def zeros(n, spec):
        if not live:
            return torch.zeros((L, batch, n, width), dtype=dtype, device=device)
        return rules.zeros((L, batch, n, width), dtype, device, spec)

    return EncDecState(zeros(cache_len, specs and specs.self_k), zeros(cache_len, specs and specs.self_v),
                       zeros(Se, specs and specs.cross_k), zeros(Se, specs and specs.cross_v), 0)


def decode_state_specs(cfg: ModelConfig, rules, batch: int, cache_len: int,
                       enc_len: Optional[int] = None) -> EncDecState:
    """The specs of ``init_decode_state``'s tree (repro/models/encdec.py:188-200)."""
    L, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    Se = cfg.encoder_seq if enc_len is None else enc_len
    self_spec = rules.spec((L, batch, cache_len, kv * hd), cache_dims(cfg, rules, batch))
    cross_spec = rules.spec((L, batch, Se, kv * hd), ("layers", "batch", "cache_seq", None))
    return EncDecState(self_spec, self_spec, cross_spec, cross_spec, ())


def decode_step(params, state: EncDecState, token: torch.Tensor, cfg: ModelConfig,
                sliding_window: int = 0, rules=None):
    """One decode step: (logits [B, V] f32, new state); the self caches are written in place.

    The cross-attention attends every entry of its caches (``pos`` = their
    length - 1), as ``prefill`` and ``decode_train`` attend every frame.
    Departure from JAX, which decodes at ``encoder_seq - 1`` and so masks
    the frames past ``encoder_seq``: the two agree wherever the frames are
    no more than ``encoder_seq``.  Live ``rules``: each rank decodes its batch
    block against its blocks of the caches (``decode_attention`` on ``CacheBlock``s).
    """
    if rules is not None and rules.live:
        return _sharded_decode_step(params, state, token, cfg, sliding_window, rules)
    h = embed_tokens(params, token, cfg)
    positions = torch.full(token.shape, state.pos, dtype=torch.int32, device=token.device)
    rope = rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)
    caches = zip(layer_params(params["dec_layers"]), state.self_k.unbind(0),
                 state.self_v.unbind(0), state.cross_k.unbind(0), state.cross_v.unbind(0))
    for lp, sk, sv, ck, cv in caches:
        hn = rms_norm(h, lp["norm_self"], cfg.norm_eps)
        h = h + decode_attention(lp["self_attn"], hn, state.pos, (sk, sv), cfg,
                                 sliding_window=sliding_window, rope=rope)
        hn = rms_norm(h, lp["norm_cross"], cfg.norm_eps)
        h = h + decode_attention(lp["cross_attn"], hn, ck.shape[1] - 1, (ck, cv), cfg,
                                 update_cache=False, use_rope=False)
        h = h + swiglu_ffn(lp["ffn"], rms_norm(h, lp["norm_ffn"], cfg.norm_eps))
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return logits_fn(params, h, cfg)[:, 0, :], state._replace(pos=state.pos + 1)


def _sharded_decode_step(params, state: EncDecState, token, cfg: ModelConfig, sliding_window,
                         rules):
    token = rules.distribute(token, ("batch", None))
    h = embed_tokens(params, token, cfg, rules)
    selfs = cache_blocks(state.self_k, state.self_v, rules)
    crosses = cache_blocks(state.cross_k, state.cross_v, rules)
    Se = state.cross_k.shape[2]
    for lp, sb, cb in zip(layer_params(params["dec_layers"]), selfs, crosses):
        hn = rms_norm(h, lp["norm_self"], cfg.norm_eps)
        h = h + decode_attention(lp["self_attn"], hn, state.pos, sb, cfg,
                                 sliding_window=sliding_window, rules=rules)
        hn = rms_norm(h, lp["norm_cross"], cfg.norm_eps)
        h = h + decode_attention(lp["cross_attn"], hn, Se - 1, cb, cfg,
                                 update_cache=False, use_rope=False, rules=rules)
        h = h + swiglu_ffn(lp["ffn"], rms_norm(h, lp["norm_ffn"], cfg.norm_eps), rules)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return logits_fn(params, h, cfg, rules)[:, 0, :], state._replace(pos=state.pos + 1)


def prefill(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            cache_len: Optional[int] = None, rules=None):
    """Encode the frames, fill the cross caches, teacher-force the prompt.

    -> (last-token logits [B, V] f32, state at position S).  The self
    caches are ``cache_len`` long (None: the prompt length S, as in JAX).
    """
    batch = distribute_batch(batch, rules)
    frames, tokens = batch["frames"], batch["tokens"]
    B, S = tokens.shape
    cache_len = S if cache_len is None else cache_len
    if cache_len < S:
        raise ValueError(f"cache_len {cache_len} is shorter than the prompt ({S})")
    enc_out = encode(params, frames, cfg, rules)
    state = init_decode_state(cfg, B, cache_len, torch_dtype(cfg), tokens.device,
                              enc_len=enc_out.shape[1], rules=rules)
    x = _decoder(params, tokens, enc_out, cfg, state, rules)
    h = rms_norm(x[:, -1:, :], params["final_norm"], cfg.norm_eps)
    logits = logits_fn(params, h, cfg, rules)[:, 0, :]
    return logits, state._replace(pos=S)

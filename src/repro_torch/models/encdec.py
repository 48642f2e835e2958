"""Whisper-style encoder-decoder backbone (audio family), as functions over a ParamTree.

Torch twin of ``repro.models.encdec``.  The mel-spectrogram and conv
front end is a stub, as in the JAX package: inputs are precomputed frame
embeddings ``[B, S_enc, D]``.  The encoder is a non-causal transformer
(RoPE on its self-attention, through the flash kernel's non-causal mode);
the decoder adds cross-attention to the encoder output
(``layers.cross_attention``, plain PyTorch: no kernel of the repository
takes keys of their own length).  Decoding runs one token against a
self-attention cache and the fixed cross-attention caches that prefill
fills.

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
    ParamDef,
    attention_schema,
    cross_entropy,
    decode_attention,
    embed_schema,
    ffn_schema,
    lm_head_schema,
    logits_fn,
    multihead_attention,
    rms_norm,
    rope_cos_sin,
    stacked,
    swiglu_ffn,
    torch_dtype,
)
from repro_torch.models.transformer import arange_positions, embed_tokens, layer_params


def _norm(cfg: ModelConfig) -> ParamDef:
    return ParamDef((cfg.d_model,), init="ones")


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


def encode(params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames [B, S_enc, D] (stub embeddings) -> the final-normed encoder output."""
    B, S, _ = frames.shape
    x = frames.to(torch_dtype(cfg))
    positions = arange_positions(B, S, x.device)
    rope = rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)
    for lp in layer_params(params["enc_layers"]):
        hn = rms_norm(x, lp["norm_attn"], cfg.norm_eps)
        x = x + multihead_attention(lp["attn"], hn, positions, cfg, causal=False, rope=rope)
        x = x + swiglu_ffn(lp["ffn"], rms_norm(x, lp["norm_ffn"], cfg.norm_eps))
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


def cross_kv(lp, enc_out: torch.Tensor, cfg: ModelConfig):
    """The cross-attention's K and V of the encoder output, each [B, S_enc, KV, hd] (no RoPE)."""
    B, Se, _ = enc_out.shape
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    ca = lp["cross_attn"]
    return (enc_out @ ca["wk"]).view(B, Se, kv, hd), (enc_out @ ca["wv"]).view(B, Se, kv, hd)


def _decoder(params, tokens: torch.Tensor, enc_out: torch.Tensor, cfg: ModelConfig, state=None):
    """The decoder layers over the whole text -> hidden [B, S, D], before the final norm.

    With ``state`` (prefill), each layer's roped self-attention K/V and its
    cross K/V are written into the state's caches in place.
    """
    B, S = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    positions = arange_positions(B, S, tokens.device)
    rope = rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)
    for i, lp in enumerate(layer_params(params["dec_layers"])):
        cache = None if state is None else (state.self_k[i], state.self_v[i])
        hn = rms_norm(x, lp["norm_self"], cfg.norm_eps)
        x = x + multihead_attention(lp["self_attn"], hn, positions, cfg, cache=cache, rope=rope)
        ck, cv = cross_kv(lp, enc_out, cfg)
        if state is not None:
            state.cross_k[i].copy_(ck.flatten(2))
            state.cross_v[i].copy_(cv.flatten(2))
        hn = rms_norm(x, lp["norm_cross"], cfg.norm_eps)
        x = x + multihead_attention(lp["cross_attn"], hn, positions, cfg, kv_override=(ck, cv),
                                    causal=False, use_rope=False)
        x = x + swiglu_ffn(lp["ffn"], rms_norm(x, lp["norm_ffn"], cfg.norm_eps))
    return x


def decode_train(params, tokens: torch.Tensor, enc_out: torch.Tensor, cfg: ModelConfig):
    """Teacher-forced decoder over tokens [B, S] given the encoder output -> final-normed [B, S, D]."""
    return rms_norm(_decoder(params, tokens, enc_out, cfg), params["final_norm"], cfg.norm_eps)


def lm_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Next-token loss of the text given the frames -> (loss, {"lm_loss"})."""
    enc_out = encode(params, batch["frames"], cfg)
    h = decode_train(params, batch["tokens"], enc_out, cfg)
    logits = logits_fn(params, h[:, :-1, :], cfg)
    loss = cross_entropy(logits, batch["tokens"][:, 1:])
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
) -> EncDecState:
    """Zero caches: self-attention ``cache_len`` long, cross-attention ``enc_len``
    (None: ``cfg.encoder_seq``, as JAX's) long."""
    L, width = cfg.num_layers, cfg.num_kv_heads * cfg.resolved_head_dim
    Se = cfg.encoder_seq if enc_len is None else enc_len

    def zeros(n):
        return torch.zeros((L, batch, n, width), dtype=dtype, device=device)

    return EncDecState(zeros(cache_len), zeros(cache_len), zeros(Se), zeros(Se), 0)


def decode_step(params, state: EncDecState, token: torch.Tensor, cfg: ModelConfig,
                sliding_window: int = 0):
    """One decode step: (logits [B, V] f32, new state); the self caches are written in place.

    The cross-attention attends every entry of its caches (``pos`` = their
    length - 1), as ``prefill`` and ``decode_train`` attend every frame.
    Departure from JAX, which decodes at ``encoder_seq - 1`` and so masks
    the frames past ``encoder_seq``: the two agree wherever the frames are
    no more than ``encoder_seq``.
    """
    h = embed_tokens(params, token, cfg)
    positions = torch.full(token.shape, state.pos, dtype=torch.int32, device=token.device)
    rope = rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)
    caches = zip(layer_params(params["dec_layers"]), state.self_k.unbind(0),
                 state.self_v.unbind(0), state.cross_k.unbind(0), state.cross_v.unbind(0))
    for lp, sk, sv, ck, cv in caches:
        hn = rms_norm(h, lp["norm_self"], cfg.norm_eps)
        h = h + decode_attention(lp["self_attn"], hn, state.pos, sk, sv, cfg,
                                 sliding_window=sliding_window, rope=rope)
        hn = rms_norm(h, lp["norm_cross"], cfg.norm_eps)
        h = h + decode_attention(lp["cross_attn"], hn, ck.shape[1] - 1, ck, cv, cfg,
                                 update_cache=False, use_rope=False)
        h = h + swiglu_ffn(lp["ffn"], rms_norm(h, lp["norm_ffn"], cfg.norm_eps))
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return logits_fn(params, h, cfg)[:, 0, :], state._replace(pos=state.pos + 1)


def prefill(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            cache_len: Optional[int] = None):
    """Encode the frames, fill the cross caches, teacher-force the prompt.

    -> (last-token logits [B, V] f32, state at position S).  The self
    caches are ``cache_len`` long (None: the prompt length S, as in JAX).
    """
    frames, tokens = batch["frames"], batch["tokens"]
    B, S = tokens.shape
    cache_len = S if cache_len is None else cache_len
    if cache_len < S:
        raise ValueError(f"cache_len {cache_len} is shorter than the prompt ({S})")
    enc_out = encode(params, frames, cfg)
    state = init_decode_state(cfg, B, cache_len, torch_dtype(cfg), tokens.device,
                              enc_len=enc_out.shape[1])
    x = _decoder(params, tokens, enc_out, cfg, state)
    h = rms_norm(x[:, -1:, :], params["final_norm"], cfg.norm_eps)
    logits = logits_fn(params, h, cfg)[:, 0, :]
    return logits, state._replace(pos=S)

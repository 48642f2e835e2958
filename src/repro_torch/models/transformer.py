"""Decoder-only transformer, dense / moe / ssm / hybrid / vlm families, as functions over a ParamTree.

Torch twin of ``repro.models.transformer``.  Depth is a Python loop over
the layer-stacked ``[L, ...]`` parameters (the JAX package scans over
them).  The vlm family is the dense one with a stub prefix of patch
embeddings ahead of the text; the audio family (an encoder-decoder) is
``models.encdec``'s.

Departure: JAX rematerialises the layer body in training
(``jax.checkpoint``, repro/models/transformer.py:155-158), which changes
memory and not values; here autograd keeps every layer's activations.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
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


AUX_LB_COEF = 0.01
AUX_Z_COEF = 0.001

DECODER_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")
SSM_FAMILIES = ("ssm", "hybrid")  # the families whose layers hold a Mamba-2 mixer


def _require_decoder(cfg: ModelConfig) -> None:
    if cfg.family not in DECODER_FAMILIES:
        where = "models.encdec" if cfg.family == "audio" else "no model of the repository"
        raise ValueError(
            f"{cfg.name}: family {cfg.family!r} is not a decoder-only family ({where})"
        )


# ---------------------------------------------------------------------------
# schemas
# ---------------------------------------------------------------------------


def layer_schema(cfg: ModelConfig) -> Dict[str, Any]:
    """Schema of ONE layer (unstacked); the vlm family's is the dense one."""
    _require_decoder(cfg)
    norm = ParamDef((cfg.d_model,), init="ones")
    if cfg.family == "ssm":
        return {"ssm": ssm_mod.ssm_schema(cfg), "norm_ssm": norm}
    s: Dict[str, Any] = {"attn": attention_schema(cfg), "norm_attn": norm}
    if cfg.family == "hybrid":
        # the SSM heads beside attention, and per-branch output norms (Hymba's fusion)
        s.update(ssm=ssm_mod.ssm_schema(cfg), norm_ssm=norm, norm_attn_out=norm, norm_ssm_out=norm)
    if cfg.family == "moe":
        s["moe"] = moe_mod.moe_schema(cfg)
    else:
        s["ffn"] = ffn_schema(cfg)
    s["norm_ffn"] = norm
    return s


def model_schema(cfg: ModelConfig) -> Dict[str, Any]:
    def stack(node):
        if isinstance(node, dict):
            return {k: stack(v) for k, v in node.items()}
        return stacked(node, cfg.num_layers)

    s: Dict[str, Any] = {
        "embed": embed_schema(cfg),
        "layers": stack(layer_schema(cfg)),
        "final_norm": ParamDef((cfg.d_model,), init="ones"),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = lm_head_schema(cfg)
    return s


def layer_params(layers) -> List[Dict[str, Any]]:
    """Every layer of the stacked ``params["layers"]`` as a nested dict of views.

    Without gradients the views are built once and kept on the tree, so a
    decode step does not make them anew; they are rebuilt if a
    parameter's storage moved or the inference mode changed (views made
    under ``inference_mode`` cannot enter an autograd graph).  When a
    gradient is wanted they are made anew on every call, so each forward
    records its own path from the views to the stacked parameters.
    """
    named = list(layers.named_parameters())
    grad = torch.is_grad_enabled() and any(p.requires_grad for _, p in named)
    key = (torch.is_inference_mode_enabled(), *(p.data_ptr() for _, p in named))
    cached = getattr(layers, "_layer_views", None)
    if not grad and cached is not None and cached[0] == key:
        return cached[1]
    views: List[Dict[str, Any]] = [{} for _ in range(named[0][1].shape[0])]
    for name, p in named:
        *path, leaf = name.split(".")
        for view, node in zip(p.unbind(0), views):
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = view
    if not grad:
        layers._layer_views = (key, views)
    return views


# ---------------------------------------------------------------------------
# layer body and full forward (prefill / scoring trunk)
# ---------------------------------------------------------------------------


def _ffn(lp, x: torch.Tensor, cfg: ModelConfig):
    """The FFN half of an attention layer -> (y, aux): SwiGLU and None, or the MoE FFN and its aux losses."""
    h = rms_norm(x, lp["norm_ffn"], cfg.norm_eps)
    if cfg.family == "moe":
        return moe_mod.moe_ffn(lp["moe"], h, cfg)
    return swiglu_ffn(lp["ffn"], h), None


def _fuse(lp, a: torch.Tensor, s: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The hybrid's parallel-head fusion: the mean of the normed attention and SSM outputs."""
    return 0.5 * (
        rms_norm(a, lp["norm_attn_out"], cfg.norm_eps)
        + rms_norm(s, lp["norm_ssm_out"], cfg.norm_eps)
    )


def layer_forward(
    lp,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    sliding_window: int = 0,
    cache=None,
    rope=None,
):
    """One pre-norm layer -> (x, aux, ssm_state); ``cache`` (FLAT k, v caches) receives this layer's K/V.

    ``rope`` is ``rope_cos_sin(positions, ...)``, computed once for all layers.
    ``aux`` holds the layer's MoE aux losses (None for the other families);
    ``ssm_state`` its final SSD state [B,H,hd,N] f32 (None without an SSM).
    The hybrid runs attention and the SSM in parallel on the same input and
    adds their fused outputs, then the FFN.
    """
    st = None
    if cfg.family in SSM_FAMILIES:
        s, st = ssm_mod.ssd_scan_with_state(lp["ssm"], rms_norm(x, lp["norm_ssm"], cfg.norm_eps), cfg)
        if cfg.family == "ssm":
            return x + s, None, st
    h = rms_norm(x, lp["norm_attn"], cfg.norm_eps)
    a = multihead_attention(
        lp["attn"], h, positions, cfg, sliding_window=sliding_window, cache=cache, rope=rope
    )
    x = x + (_fuse(lp, a, s, cfg) if cfg.family == "hybrid" else a)
    y, aux = _ffn(lp, x, cfg)
    return x + y, aux, st


def forward(
    params,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    sliding_window: int = 0,
):
    """Trunk over embedded inputs x [B,S,D] -> (final-normed hidden [B,S,D], aux).

    ``aux``: ``load_balance`` and ``router_z`` averaged over the layers, f32
    scalars (zeros outside the moe family), as the JAX forward returns them.
    """
    _require_decoder(cfg)
    rope = None
    if not cfg.attention_free:
        rope = rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)
    auxes = []
    for lp in layer_params(params["layers"]):
        x, aux, _ = layer_forward(lp, x, positions, cfg, sliding_window, rope=rope)
        if aux is not None:
            auxes.append(aux)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if not auxes:  # no MoE layer: one zero for both, no per-layer device work
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return h, {"load_balance": zero, "router_z": zero}
    denom = max(cfg.num_layers, 1)
    return h, {k: sum(a[k] for a in auxes) / denom for k in ("load_balance", "router_z")}


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"][tokens].to(torch_dtype(cfg))


def arange_positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def with_patches(x: torch.Tensor, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """The vlm family's input: the stub patch embeddings [B, P, D] ahead of the text -> (x, P).

    Every other family, or a vlm batch without ``patch_embeds``, keeps x (P = 0).
    """
    if cfg.family != "vlm" or "patch_embeds" not in batch:
        return x, 0
    patches = batch["patch_embeds"].to(device=x.device, dtype=x.dtype)
    return torch.cat([patches, x], dim=1), patches.shape[1]


def lm_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Next-token LM loss -> (loss + aux terms, {"lm_loss", "load_balance", "router_z"}).

    vlm: ``batch["patch_embeds"]`` [B, P, D] comes first (positions 0..P-1)
    and the loss covers the text positions only, as in JAX.
    """
    tokens = batch["tokens"]  # [B, S_text]
    if cfg.family == "vlm" and "patch_embeds" not in batch:
        raise KeyError(f"{cfg.name}: a vlm training batch needs 'patch_embeds' [B, P, D]")
    x, prefix = with_patches(embed_tokens(params, tokens, cfg), batch, cfg)
    B, S = x.shape[:2]
    h, aux = forward(params, x, arange_positions(B, S, tokens.device), cfg)
    logits = logits_fn(params, h[:, prefix:-1, :], cfg)
    loss = cross_entropy(logits, tokens[:, 1:])
    total = loss + AUX_LB_COEF * aux["load_balance"] + AUX_Z_COEF * aux["router_z"]
    return total, {"lm_loss": loss, **aux}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


class DecodeState(NamedTuple):
    k_cache: Optional[torch.Tensor]  # FLAT [L, B, S_max, KV*hd] (see layers.decode_attention)
    v_cache: Optional[torch.Tensor]  # None where the family has no attention
    ssm_state: Optional[torch.Tensor]  # [L, B, H, hd, N] f32; None where it has no SSM
    pos: int  # next position to write (kept on the host: no device sync per step)


def init_decode_state(
    cfg: ModelConfig,
    batch: int,
    cache_len: int,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cuda",
) -> DecodeState:
    _require_decoder(cfg)
    L = cfg.num_layers
    kc = vc = st = None
    if not cfg.attention_free:
        shape = (L, batch, cache_len, cfg.num_kv_heads * cfg.resolved_head_dim)
        kc = torch.zeros(shape, dtype=dtype, device=device)
        vc = torch.zeros(shape, dtype=dtype, device=device)
    if cfg.family in SSM_FAMILIES:
        st = torch.zeros(
            (L, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), device=device
        )
    return DecodeState(kc, vc, st, 0)


def decode_step(
    params,
    state: DecodeState,
    token: torch.Tensor,  # [B, 1] int
    cfg: ModelConfig,
    sliding_window: int = 0,
):
    """One decode step: returns (logits [B, V] f32, new state).

    The caches and SSM states of ``state`` are updated in place (JAX
    returns updated copies); the new state shares them.  The hybrid runs
    ``decode_attention`` and ``ssd_decode_step`` on the same input, then
    the fusion and the FFN, as its full-sequence layer does.
    """
    _require_decoder(cfg)
    h = embed_tokens(params, token, cfg)  # [B,1,D]
    layers = layer_params(params["layers"])
    none = [None] * len(layers)
    k_caches = none if state.k_cache is None else state.k_cache.unbind(0)
    v_caches = none if state.v_cache is None else state.v_cache.unbind(0)
    ssm_states = none if state.ssm_state is None else state.ssm_state.unbind(0)
    rope = None
    if not cfg.attention_free:
        positions = torch.full(token.shape, state.pos, dtype=torch.int32, device=token.device)
        rope = rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)
    for lp, k_cache, v_cache, st in zip(layers, k_caches, v_caches, ssm_states):
        if st is not None:
            s, new_st = ssm_mod.ssd_decode_step(
                lp["ssm"], rms_norm(h, lp["norm_ssm"], cfg.norm_eps), st, cfg
            )
            st.copy_(new_st)
            if cfg.family == "ssm":
                h = h + s
                continue
        hn = rms_norm(h, lp["norm_attn"], cfg.norm_eps)
        a = decode_attention(
            lp["attn"], hn, state.pos, k_cache, v_cache, cfg,
            sliding_window=sliding_window, rope=rope,
        )
        h = h + (_fuse(lp, a, s, cfg) if cfg.family == "hybrid" else a)
        h = h + _ffn(lp, h, cfg)[0]
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = logits_fn(params, h, cfg)[:, 0, :]
    return logits, state._replace(pos=state.pos + 1)


def prefill(
    params,
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    cache_len: Optional[int] = None,
):
    """Full forward over the prompt -> (last-token logits [B, V] f32, decode state).

    The caches are ``cache_len`` long (None: the prompt length S, as in
    JAX), so decoding continues at position S without overwriting the
    prompt.  Each layer writes its roped K/V into them from inside its
    attention (JAX projects K and V a second time beside the layer,
    repro/models/transformer.py:354-360 and :383-392, to the same values).
    The ssm family keeps no cache; it and the hybrid keep each layer's
    final SSD state.  vlm: ``batch["patch_embeds"]`` (if given) is the
    prompt's prefix, so S counts the patches and decoding continues at P + S.
    """
    _require_decoder(cfg)
    tokens = batch["tokens"]
    x, _ = with_patches(embed_tokens(params, tokens, cfg), batch, cfg)
    B, S = x.shape[:2]
    cache_len = S if cache_len is None else cache_len
    if cache_len < S:
        raise ValueError(f"cache_len {cache_len} is shorter than the prompt ({S})")
    state = init_decode_state(cfg, B, cache_len, torch_dtype(cfg), tokens.device)
    positions = arange_positions(B, S, tokens.device)
    rope = None
    if not cfg.attention_free:
        rope = rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)
    for i, lp in enumerate(layer_params(params["layers"])):
        cache = None if cfg.attention_free else (state.k_cache[i], state.v_cache[i])
        x, _, st = layer_forward(lp, x, positions, cfg, cache=cache, rope=rope)
        if st is not None:
            state.ssm_state[i].copy_(st)
    h = rms_norm(x[:, -1:, :], params["final_norm"], cfg.norm_eps)
    logits = logits_fn(params, h, cfg)[:, 0, :]
    return logits, state._replace(pos=S)

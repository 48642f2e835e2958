"""Decoder-only transformer, dense / moe / ssm / hybrid / vlm families, as functions over a ParamTree.

Torch twin of ``repro.models.transformer``.  Depth is a Python loop over
the layer-stacked ``[L, ...]`` parameters (the JAX package scans over
them).  The vlm family is the dense one with a stub prefix of patch
embeddings ahead of the text; the audio family (an encoder-decoder) is
``models.encdec``'s.  In training each layer is rematerialised as JAX's
``cfg.remat`` does it (``layers.remat_layer``).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
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
from repro_torch.sharding.rules import block_of, is_dtensor


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
    norm = ParamDef((cfg.d_model,), (None,), init="ones")
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
        "final_norm": ParamDef((cfg.d_model,), (None,), init="ones"),
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
    key = (torch.is_inference_mode_enabled(),
           *((p.to_local() if is_dtensor(p) else p).data_ptr() for _, p in named))
    cached = getattr(layers, "_layer_views", None)
    if not grad and cached is not None and cached[0] == key:
        return cached[1]
    views: List[Dict[str, Any]] = [{} for _ in range(named[0][1].shape[0])]
    for name, p in named:
        *path, leaf = name.split(".")
        for view, node in zip(_unbind_layers(p), views):
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = view
    if not grad:
        layers._layer_views = (key, views)
    return views


def _unbind_layers(p: torch.Tensor):
    """The [L, ...] parameter's layers; a DTensor's (never sharded on L) as DTensors made
    from its local block's layers (DTensor's own unbind fails under inference mode)."""
    if not is_dtensor(p):
        return p.unbind(0)
    from torch.distributed.tensor import DTensor, Shard

    placements = [Shard(q.dim - 1) if isinstance(q, Shard) else q for q in p.placements]
    return [DTensor.from_local(t, p.device_mesh, placements, run_check=False)
            for t in p.to_local().unbind(0)]


# ---------------------------------------------------------------------------
# layer body and full forward (prefill / scoring trunk)
# ---------------------------------------------------------------------------


def _ffn(lp, x: torch.Tensor, cfg: ModelConfig, rules=None):
    """The FFN half of an attention layer -> (y, aux): SwiGLU and None, or the MoE FFN and its aux losses."""
    h = rms_norm(x, lp["norm_ffn"], cfg.norm_eps)
    if cfg.family == "moe":
        return moe_mod.moe_ffn(lp["moe"], h, cfg, rules)
    return swiglu_ffn(lp["ffn"], h, rules), None


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
    rules=None,
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
        s, st = ssm_mod.ssd_scan_with_state(
            lp["ssm"], rms_norm(x, lp["norm_ssm"], cfg.norm_eps), cfg, rules
        )
        if cfg.family == "ssm":
            return x + s, None, st
    h = rms_norm(x, lp["norm_attn"], cfg.norm_eps)
    a = multihead_attention(
        lp["attn"], h, positions, cfg, sliding_window=sliding_window, cache=cache, rope=rope,
        rules=rules,
    )
    x = x + (_fuse(lp, a, s, cfg) if cfg.family == "hybrid" else a)
    y, aux = _ffn(lp, x, cfg, rules)
    return x + y, aux, st


def forward(
    params,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    sliding_window: int = 0,
    rules=None,
):
    """Trunk over embedded inputs x [B,S,D] -> (final-normed hidden [B,S,D], aux).

    ``aux``: ``load_balance`` and ``router_z`` averaged over the layers, f32
    scalars (zeros outside the moe family), as the JAX forward returns them.
    Each layer is a rematerialised region in training (``remat_layer``); the
    final norm stays outside, as in JAX.
    """
    _require_decoder(cfg)
    rope = None
    if not cfg.attention_free and not is_dtensor(x):
        rope = rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)
    auxes = []
    for lp in layer_params(params["layers"]):
        x, aux, _ = remat_layer(cfg, layer_forward, lp, x, positions, cfg, sliding_window,
                                rope=rope, rules=rules)
        if aux is not None:
            auxes.append(aux)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if not auxes:  # no MoE layer: one zero for both, no per-layer device work
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return h, {"load_balance": zero, "router_z": zero}
    denom = max(cfg.num_layers, 1)
    return h, {k: sum(a[k] for a in auxes) / denom for k in ("load_balance", "router_z")}


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig, rules=None) -> torch.Tensor:
    """Token embeddings in the working type.  ``rules`` and DTensor tokens: each model rank
    looks up the rows of its own block of the vocabulary where it is sharded (the others
    give zeros) and the blocks are summed; else every rank looks up all rows."""
    if rules is None or not is_dtensor(tokens):
        return params["embed"][tokens].to(torch_dtype(cfg))
    ds = rules.batch_sharded(tokens)
    rng = rules.kept_range(params["embed"], 0)
    table = rules.param(params["embed"], split=rng is not None, data_sharded=ds,
                        keep_dim=0 if rng else None)
    tl = tokens.to_local()
    if rng is None:
        out = table[tl]
    else:
        mine = (tl >= rng[0]) & (tl < rng[1])
        out = F.embedding((tl - rng[0]).clamp(0, table.shape[0] - 1), table) * mine[..., None]
    return rules.leave(out.to(torch_dtype(cfg)), tokens, split=rng is not None)


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


def distribute_batch(batch: Dict[str, torch.Tensor], rules) -> Dict[str, torch.Tensor]:
    """The batch's tensors placed on the mesh, batch dim on the data axes (replicated
    where it does not divide them), as ``launch.specs.input_shardings``; as it is where
    the rules are None or not live."""
    if rules is None or not rules.live:
        return batch
    return {k: rules.distribute(v, ("batch",) + (None,) * (v.dim() - 1)) for k, v in batch.items()}


def lm_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, rules=None):
    """Next-token LM loss -> (loss + aux terms, {"lm_loss", "load_balance", "router_z"}).

    vlm: ``batch["patch_embeds"]`` [B, P, D] comes first (positions 0..P-1)
    and the loss covers the text positions only, as in JAX.  Live ``rules``:
    the batch is placed on the mesh (``distribute_batch``) and the loss is a
    plain scalar, equal on every rank, over the global batch.
    """
    batch = distribute_batch(batch, rules)
    tokens = batch["tokens"]  # [B, S_text]
    if cfg.family == "vlm" and "patch_embeds" not in batch:
        raise KeyError(f"{cfg.name}: a vlm training batch needs 'patch_embeds' [B, P, D]")
    x, prefix = with_patches(embed_tokens(params, tokens, cfg, rules), batch, cfg)
    B, S = x.shape[:2]
    if rules is not None:
        x = rules.constrain(x, ("batch", None, None))
    h, aux = forward(params, x, arange_positions(B, S, tokens.device), cfg, rules=rules)
    if is_dtensor(h):
        loss = sharded_lm_head_loss(params, h[:, prefix:-1, :], tokens[:, 1:], cfg, rules)
    else:
        loss = cross_entropy(logits_fn(params, h[:, prefix:-1, :], cfg), tokens[:, 1:])
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
    rules=None,
) -> DecodeState:
    """Zero caches and SSM states; with live ``rules``, DTensors placed by
    ``decode_state_specs`` (each rank allocates its block only)."""
    _require_decoder(cfg)
    L = cfg.num_layers
    kc = vc = st = None
    specs = None if rules is None or not rules.live else decode_state_specs(cfg, rules, batch, cache_len)

    def zeros(shape, dt, spec):
        if specs is None:
            return torch.zeros(shape, dtype=dt, device=device)
        return rules.zeros(shape, dt, device, spec)

    if not cfg.attention_free:
        shape = (L, batch, cache_len, cfg.num_kv_heads * cfg.resolved_head_dim)
        kc = zeros(shape, dtype, specs and specs.k_cache)
        vc = zeros(shape, dtype, specs and specs.v_cache)
    if cfg.family in SSM_FAMILIES:
        st = zeros((L, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), torch.float32,
                   specs and specs.ssm_state)
    return DecodeState(kc, vc, st, 0)


def cache_dims(cfg: ModelConfig, rules, batch: int):
    """Logical dims of a FLAT [L, B, S, KV*hd] cache: the sequence on the model axis and
    the batch on data, or, where the batch does not fill the data axes (long-context
    decode), the sequence on data and the columns on the model axis (JAX's)."""
    if batch >= rules.data_extent and batch % rules.data_extent == 0:
        return ("layers", "batch", "cache_seq", None)
    return ("layers", None, "kv_seq", "qkv")


def decode_state_specs(cfg: ModelConfig, rules, batch: int, cache_len: int) -> DecodeState:
    """The specs of ``init_decode_state``'s tree (repro/models/transformer.py:233-256)."""
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    L = cfg.num_layers
    kc_spec = st_spec = None
    if not cfg.attention_free:
        kc_spec = rules.spec((L, batch, cache_len, kv * hd), cache_dims(cfg, rules, batch))
    if cfg.family in SSM_FAMILIES:
        st_spec = rules.spec(
            (L, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
            ("layers", "batch", "ssm_inner", None, None),
        )
    return DecodeState(kc_spec, kc_spec, st_spec, ())


def state_blocks(state: DecodeState, rules):
    """Per layer, the rank's (cache block or None, (SSM state block, first head, head
    mesh dims) or None) of a DecodeState of DTensors."""
    L = len(state.k_cache if state.k_cache is not None else state.ssm_state)
    caches = [None] * L if state.k_cache is None else cache_blocks(state.k_cache, state.v_cache, rules)
    ssm = [None] * L
    if state.ssm_state is not None:
        from torch.distributed.tensor import Shard

        st = state.ssm_state
        _, off = block_of(st.shape, rules.mesh, st.placements)
        dims = tuple(i for i, p in enumerate(st.placements) if p == Shard(2))
        ssm = [(b, off[2], dims) for b in st.to_local().unbind(0)]
    return caches, ssm


def decode_step(
    params,
    state: DecodeState,
    token: torch.Tensor,  # [B, 1] int
    cfg: ModelConfig,
    sliding_window: int = 0,
    rules=None,
):
    """One decode step: returns (logits [B, V] f32, new state).

    The caches and SSM states of ``state`` are updated in place (JAX
    returns updated copies); the new state shares them.  The hybrid runs
    ``decode_attention`` and ``ssd_decode_step`` on the same input, then
    the fusion and the FFN, as its full-sequence layer does.  Live
    ``rules`` and a state of DTensors (``prefill`` or ``init_decode_state``
    with the rules): each rank decodes its batch block against its blocks
    of the caches and states; the logits are a DTensor, whole on every rank
    of a batch block.
    """
    _require_decoder(cfg)
    if rules is not None and rules.live:
        return _sharded_decode_step(params, state, token, cfg, sliding_window, rules)
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
            lp["attn"], hn, state.pos, (k_cache, v_cache), cfg,
            sliding_window=sliding_window, rope=rope,
        )
        h = h + (_fuse(lp, a, s, cfg) if cfg.family == "hybrid" else a)
        h = h + _ffn(lp, h, cfg)[0]
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = logits_fn(params, h, cfg)[:, 0, :]
    return logits, state._replace(pos=state.pos + 1)


def _sharded_decode_step(params, state: DecodeState, token, cfg: ModelConfig, sliding_window, rules):
    token = rules.distribute(token, ("batch", None))
    h = embed_tokens(params, token, cfg, rules)  # [B,1,D]
    caches, ssms = state_blocks(state, rules)
    for lp, cache, ssm in zip(layer_params(params["layers"]), caches, ssms):
        if ssm is not None:
            s = ssm_mod.sharded_ssd_decode_step(
                lp["ssm"], rms_norm(h, lp["norm_ssm"], cfg.norm_eps), *ssm, cfg, rules
            )
            if cfg.family == "ssm":
                h = h + s
                continue
        hn = rms_norm(h, lp["norm_attn"], cfg.norm_eps)
        a = decode_attention(lp["attn"], hn, state.pos, cache, cfg,
                             sliding_window=sliding_window, rules=rules)
        h = h + (_fuse(lp, a, s, cfg) if cfg.family == "hybrid" else a)
        h = h + _ffn(lp, h, cfg, rules)[0]
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = logits_fn(params, h, cfg, rules)[:, 0, :]
    return logits, state._replace(pos=state.pos + 1)


def prefill(
    params,
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    cache_len: Optional[int] = None,
    rules=None,
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
    Live ``rules``: the batch is placed on the mesh, the state's tensors are
    DTensors placed by ``decode_state_specs`` (each rank writes its blocks)
    and the logits a DTensor, whole on every rank of a batch block.
    """
    _require_decoder(cfg)
    live = rules is not None and rules.live
    batch = distribute_batch(batch, rules)
    tokens = batch["tokens"]
    x, _ = with_patches(embed_tokens(params, tokens, cfg, rules), batch, cfg)
    B, S = x.shape[:2]
    if rules is not None:
        x = rules.constrain(x, ("batch", None, None))
    cache_len = S if cache_len is None else cache_len
    if cache_len < S:
        raise ValueError(f"cache_len {cache_len} is shorter than the prompt ({S})")
    state = init_decode_state(cfg, B, cache_len, torch_dtype(cfg), tokens.device, rules)
    positions = arange_positions(B, S, tokens.device)
    rope = None
    if not cfg.attention_free and not live:
        rope = rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)
    if live:
        caches, ssms = state_blocks(state, rules)
    elif cfg.attention_free:
        caches, ssms = [None] * cfg.num_layers, None
    else:
        caches, ssms = list(zip(state.k_cache.unbind(0), state.v_cache.unbind(0))), None
    for i, lp in enumerate(layer_params(params["layers"])):
        x, _, st = layer_forward(lp, x, positions, cfg, cache=caches[i], rope=rope, rules=rules)
        if st is None:
            continue
        if live:  # the rank's block of the states: its batch block's, of its own heads where split
            ssms[i][0].copy_(st)
        else:
            state.ssm_state[i].copy_(st)
    h = rms_norm(x[:, -1:, :], params["final_norm"], cfg.norm_eps)
    logits = logits_fn(params, h, cfg, rules)[:, 0, :]
    return logits, state._replace(pos=S)

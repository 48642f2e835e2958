"""Shared model building blocks: params schema, RMSNorm, RoPE, GQA attention.

Torch twins of ``repro.models.layers`` as plain functions on tensors.
Parameters are described by :class:`ParamDef` schemas and held in a
:class:`ParamTree` module whose ``state_dict`` keys are the JAX path keys
with ``/`` replaced by ``.``.  RMSNorm and full-sequence attention go
through ``kernels.ops``: the hand-written CUDA kernels on the card, the
plain versions on the CPU.  Cross-attention (keys of their own length)
and one-token decode are plain PyTorch, as the JAX package computes them
in XLA.
"""

from __future__ import annotations

import math
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.sharding.rules import block_of, is_dtensor

# torch.profiler range around the cross-attention's own work (scores, softmax, P.V; not its
# projections), so that a trace can tell its device time apart
CROSS_ATTENTION_RANGE = "cross_attention"


def profiler_range(name: str):
    """A ``torch.profiler`` range named ``name`` while the profiler records, else nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return nullcontext()


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    dims: Optional[Tuple[Optional[str], ...]] = None  # logical axis labels; None: unlabelled
    init: str = "normal"  # normal | zeros | ones
    scale: float = 0.02

    def __post_init__(self) -> None:
        if self.dims is None:
            object.__setattr__(self, "dims", (None,) * len(self.shape))
        assert len(self.shape) == len(self.dims), (self.shape, self.dims)


def stacked(pdef: ParamDef, layers: int) -> ParamDef:
    """Layer-stacked parameter: a leading [L] dim, as the JAX scan over depth."""
    return ParamDef((layers, *pdef.shape), ("layers", *pdef.dims), pdef.init, pdef.scale)


def map_schema(fn, node):
    """``fn`` over every ParamDef of a nested schema, keeping its structure."""
    if isinstance(node, Mapping):
        return {k: map_schema(fn, v) for k, v in node.items()}
    return fn(node)


def abstract_from_schema(schema, dtype: torch.dtype) -> Dict[str, Any]:
    """Tensors on the ``meta`` device (the dry-run's stand-ins: nothing is allocated)."""
    return map_schema(lambda p: torch.empty(p.shape, dtype=dtype, device="meta"), schema)


def specs_from_schema(schema, rules) -> Dict[str, Any]:
    return map_schema(lambda p: rules.spec(p.shape, p.dims), schema)


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class ParamTree(nn.Module):
    """Nested parameters; ``tree["attn"]["wq"]`` reads like the JAX dict.

    Serving needs no gradients, so parameters are created frozen unless
    ``trainable``.
    """

    def __init__(self, tree: Mapping[str, Any], trainable: bool = False):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, Mapping):
                self.add_module(name, ParamTree(value, trainable))
            else:
                self.register_parameter(name, nn.Parameter(value, requires_grad=trainable))

    def __getitem__(self, name: str):
        return getattr(self, name)


def init_from_schema(
    schema: Mapping[str, Any],
    dtype: torch.dtype,
    generator: torch.Generator,
    device: torch.device | str = "cuda",
    trainable: bool = False,
    rules=None,
) -> ParamTree:
    """normal(0, 1) * scale (drawn in f32 on the generator's device), zeros or ones.

    With live ``rules`` each leaf is placed on the mesh by its dims as soon as
    it is drawn (every rank draws the same values and keeps its block), so
    no rank holds more than one whole leaf at a time.
    """

    def build(node):
        if isinstance(node, Mapping):
            return {k: build(v) for k, v in node.items()}
        if node.init == "zeros":
            w = torch.zeros(node.shape, dtype=dtype, device=device)
        elif node.init == "ones":
            w = torch.ones(node.shape, dtype=dtype, device=device)
        else:
            w = torch.randn(node.shape, generator=generator, device=generator.device)
            w = (w * node.scale).to(device=device, dtype=dtype)
        return w if rules is None else rules.distribute(w, node.dims)

    return ParamTree(build(schema), trainable)


# ---------------------------------------------------------------------------
# norms / positional encodings
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm through ``ops``; a DTensor x (rows sharded over any mesh dims, the last dim
    whole) is normed on each rank's own rows."""
    if is_dtensor(x):
        return local_rows(lambda xl, wl: ops.rmsnorm_op(xl, wl, eps=eps), x, weight)
    return ops.rmsnorm_op(x, weight, eps=eps)


def local_rows(fn, x, *weights):
    """``fn(x_local, *weights_whole)`` on a DTensor x whose leading dims alone are sharded:
    a row-wise function repeated on every rank of x's replicated mesh dims.  The
    weights' gradients are summed over the mesh dims that shard x."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh, pl = x.device_mesh, x.placements
    grad = [Partial() if isinstance(p, Shard) else Replicate() for p in pl]
    whole = [Replicate()] * len(pl)
    ws = [w.redistribute(mesh, whole).to_local(grad_placements=grad) if is_dtensor(w) else w
          for w in weights]
    return DTensor.from_local(fn(x.to_local(), *ws), mesh, pl, run_check=False)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 (cos, sin) [B, S, 1, hd/2] of ``positions`` [B, S], shared by every layer."""
    freqs = rope_frequencies(head_dim, theta, positions.device)  # [hd/2]
    angles = positions[..., None].float() * freqs  # [B, S, hd/2]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def rotate(x: torch.Tensor, cos_sin: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """RoPE of x [B, S, N, head_dim] by ``rope_cos_sin``'s tables; f32 math, cast back."""
    cos, sin = cos_sin
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, N, head_dim]; positions: [B, S] (int).  f32 math, cast back."""
    return rotate(x, rope_cos_sin(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# attention (GQA: causal full-sequence and one-token decode)
# ---------------------------------------------------------------------------


def attention_schema(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "wq": ParamDef((d, h * hd), ("embed", "qkv")),
        "wk": ParamDef((d, kv * hd), ("embed", "qkv")),
        "wv": ParamDef((d, kv * hd), ("embed", "qkv")),
        "wo": ParamDef((h * hd, d), ("qkv", "embed")),
    }


def multihead_attention(
    params,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    *,
    mask: Optional[torch.Tensor] = None,
    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    causal: bool = True,
    sliding_window: int = 0,
    cache=None,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    use_rope: bool = True,
    rules=None,
) -> torch.Tensor:
    """Full (non-incremental) GQA attention: self-attention through the flash kernel.

    ``positions`` feed RoPE (``rope``: their ``rope_cos_sin``, if the
    caller has it); the causal mask follows the sequence index, which is
    what every caller passes as positions.  ``cache`` is an optional pair
    of FLAT [B, S_max, KV*hd] caches (S_max >= S): this call's roped K and
    V are written in place into their rows [0, S).

    ``kv_override`` = (k, v), each [B, Sk, KV, hd], supplies the keys and
    values (cross-attention; Sk need not be S): q alone is projected, and
    roped only if ``use_rope``; see ``cross_attention``.

    ``rules``: where the head count does not divide the model axis, the
    heads are padded group-interleaved as in JAX (``_pad_plan``;
    repro/models/layers.py:150-172): real head i keeps its KV group, dead q
    columns and dead KV rows are zero, and zero ``wo`` rows cancel the dead
    heads, so the result is GQA(h, kv).  Where the rules are live and x is a
    DTensor, each model rank attends with its own block of the padded heads
    (``_sharded_attention``); ``cache`` is then the rank's ``CacheBlock``.
    Cross-attention is never padded, as in JAX.
    """
    if mask is not None:
        # No entry point of the reference passes a mask: every call site in its
        # models, training, serving and rl leaves it unset.
        raise NotImplementedError("attention masks: no entry point of the reference passes one")
    if sliding_window > 0:
        # No entry point of the reference passes a window to full-sequence
        # attention: serving windows only decode (decode_attention below).
        raise NotImplementedError(
            "sliding_window applies to decode_attention only; full-sequence attention has no window"
        )
    if rules is not None and is_dtensor(x):
        return _sharded_attention(params, x, positions, cfg, rules, kv_override=kv_override,
                                  causal=causal, cache=cache, use_rope=use_rope)
    B, S, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    wq, wk, wv, wo = params["wq"], params["wk"], params["wv"], params["wo"]
    if rules is not None and kv_override is None:
        kv_p, g_p = head_plan(cfg, rules)
        wq, wk, wv, wo = pad_heads(wq, wk, wv, wo, kv, h // kv, kv_p, g_p, hd)
        h, kv = kv_p * g_p, kv_p
        params = {"wq": wq, "wk": wk, "wv": wv, "wo": wo}
    q = (x @ wq).view(B, S, h, hd)
    if use_rope and rope is None:
        rope = rope_cos_sin(positions, hd, cfg.rope_theta)
    if kv_override is not None:
        if cache is not None:
            raise ValueError("cross-attention writes no cache: its K/V are the caller's")
        q = rotate(q, rope) if use_rope else q
        return cross_attention(q, *kv_override, positions, causal) @ params["wo"]
    k = (x @ wk).view(B, S, kv, hd)
    v = (x @ wv).view(B, S, kv, hd)
    if use_rope:
        q, k = rotate(q, rope), rotate(k, rope)
    if cache is not None:
        # Departure from JAX: its prefill recomputes K/V beside the layer
        # into caches exactly S long (repro/models/transformer.py:354-372),
        # so the first decode write clamps onto slot S-1.  Here the
        # attention's own K/V are written in place into caches that honour
        # cache_len (S_max >= S), and decoding continues at slot S.
        cache[0][:, :S] = k.reshape(B, S, kv * hd)
        cache[1][:, :S] = v.reshape(B, S, kv * hd)
    # One kernel covers both JAX paths, the short einsum one and the
    # Q_CHUNK scan (repro/models/layers.py:190-209).  In bf16 the kernel
    # rounds the unnormalised softmax weights to bf16 before P.V, as JAX
    # rounds the weights to x.dtype (repro/models/layers.py:208); in f32,
    # P stays f32.
    out = ops.flash_attention_op(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal
    )
    return out.transpose(1, 2).reshape(B, S, h * hd) @ wo


def _pad_plan(kv: int, g: int, ext: int) -> Tuple[int, int]:
    """Smallest (kv_p >= kv, g_p >= g) with kv_p*g_p % ext == 0 (JAX's, verbatim)."""
    best = None
    for kv_p in range(kv, kv + ext):
        for g_p in range(g, g + ext):
            if (kv_p * g_p) % ext == 0:
                cand = (kv_p * g_p, kv_p, g_p)
                if best is None or cand < best:
                    best = cand
    assert best is not None
    return best[1], best[2]


def head_plan(cfg: ModelConfig, rules) -> Tuple[int, int]:
    """(KV heads, group size) after padding: the config's where the heads divide the model axis."""
    h, kv = cfg.num_heads, cfg.num_kv_heads
    ext = rules.extent("heads")
    if ext > 1 and h % ext:
        return _pad_plan(kv, h // kv, ext)
    return kv, h // kv


def pad_heads(wq, wk, wv, wo, kv: int, g: int, kv_p: int, g_p: int, hd: int):
    """The projections of GQA(kv*g, kv) padded group-interleaved to GQA(kv_p*g_p, kv_p):
    dead q columns, dead k/v columns and dead ``wo`` rows are zero."""
    if (kv_p, g_p) == (kv, g):
        return wq, wk, wv, wo
    D = wq.shape[0]
    wq = F.pad(wq.reshape(D, kv, g, hd), (0, 0, 0, g_p - g, 0, kv_p - kv)).reshape(D, -1)
    wk = F.pad(wk.reshape(D, kv, hd), (0, 0, 0, kv_p - kv)).reshape(D, -1)
    wv = F.pad(wv.reshape(D, kv, hd), (0, 0, 0, kv_p - kv)).reshape(D, -1)
    wo = F.pad(wo.reshape(kv, g, hd, -1), (0, 0, 0, 0, 0, g_p - g, 0, kv_p - kv))
    return wq, wk, wv, wo.reshape(kv_p * g_p * hd, -1)


class CacheBlock(NamedTuple):
    """One rank's block [B_l, S_l, C_l] of a layer's FLAT [B, S_max, KV*hd] caches."""

    k: torch.Tensor
    v: torch.Tensor
    s_lo: int  # the first cache row it holds
    c_lo: int  # its first column
    seq_dims: Tuple[int, ...]  # mesh dims the rows are sharded over
    col_dims: Tuple[int, ...]  # mesh dims the columns are sharded over


def cache_blocks(k_cache, v_cache, rules) -> List[CacheBlock]:
    """Each layer's ``CacheBlock`` of DTensor caches [L, B, S_max, KV*hd] (views: writes land)."""
    from torch.distributed.tensor import Shard

    _, offset = block_of(k_cache.shape, rules.mesh, k_cache.placements)
    seq = tuple(i for i, p in enumerate(k_cache.placements) if p == Shard(2))
    col = tuple(i for i, p in enumerate(k_cache.placements) if p == Shard(3))
    return [CacheBlock(k, v, offset[2], offset[3], seq, col)
            for k, v in zip(k_cache.to_local().unbind(0), v_cache.to_local().unbind(0))]


def _local_gqa(q, k, v, g_p: int, h0: int, kv_lo: int):
    """k, v [.., KVl, ..] for the local q heads [h0, h0 + Hl) of a GQA with groups of
    g_p: as they are where the local heads form whole groups (or lie in one), else
    repeated to one KV head per q head."""
    hl = q.shape[1]
    if k.shape[1] == 1 or (hl % g_p == 0 and h0 % g_p == 0):
        return k, v
    idx = torch.div(torch.arange(h0, h0 + hl, device=q.device), g_p, rounding_mode="floor") - kv_lo
    return k.index_select(1, idx), v.index_select(1, idx)


def _sharded_attention(params, x, positions, cfg: ModelConfig, rules, *, kv_override, causal,
                       cache, use_rope):
    """Attention of a DTensor ``x`` [B, S, D] on the mesh, each rank on its batch block.

    Self-attention is split over the model axis: each model rank projects its
    own block of the padded heads (``head_plan``) and the KV heads they read,
    attends through the flash kernel and projects out; the partial outputs
    are summed.  The projections are read whole (``Rules.param``) unless the
    rank's block of a sharded one is exactly what it needs.  ``cache``
    (prefill): the rank writes its ``CacheBlock`` from K/V projected whole,
    as JAX's prefill projects them beside the layer.  Cross-attention
    (``kv_override``, DTensors [B, Sk, KV, hd]) is repeated on every model rank.
    """
    ds = rules.batch_sharded(x)
    xl = rules.enter(x, ("batch", None, None), split=kv_override is None)
    B, S, D = xl.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    rope = rope_cos_sin(positions[:1], hd, cfg.rope_theta) if use_rope else None
    if kv_override is not None:
        wq = rules.param(params["wq"], split=False, data_sharded=ds)
        wo = rules.param(params["wo"], split=False, data_sharded=ds)
        k, v = (rules.enter(t, ("batch", None, None, None)) for t in kv_override)
        q = xl @ wq
        q = q.view(B, S, h, hd)
        q = rotate(q, rope) if use_rope else q
        return rules.leave(cross_attention(q, k, v, positions[:B], causal) @ wo, x)
    kv_p, g_p = head_plan(cfg, rules)
    hl = kv_p * g_p // rules.model_size
    h0 = rules.model_rank * hl
    kv_lo, kv_hi = h0 // g_p, (h0 + hl - 1) // g_p + 1
    if (kv_p, g_p) == (kv, h // kv):  # unpadded: a sharded projection may hold just our block
        wq = _param_cols(params["wq"], rules, ds, h0 * hd, (h0 + hl) * hd)
        wk = _param_cols(params["wk"], rules, ds, kv_lo * hd, kv_hi * hd)
        wv = _param_cols(params["wv"], rules, ds, kv_lo * hd, kv_hi * hd)
        wo = _param_rows(params["wo"], rules, ds, h0 * hd, (h0 + hl) * hd)
    else:
        full = [rules.param(params[n], split=True, data_sharded=ds) for n in ("wq", "wk", "wv", "wo")]
        wq, wk, wv, wo = pad_heads(*full, kv, h // kv, kv_p, g_p, hd)
        wq, wo = wq[:, h0 * hd:(h0 + hl) * hd], wo[h0 * hd:(h0 + hl) * hd]
        wk, wv = wk[:, kv_lo * hd:kv_hi * hd], wv[:, kv_lo * hd:kv_hi * hd]
    q = (xl @ wq).view(B, S, hl, hd)
    k = (xl @ wk).view(B, S, kv_hi - kv_lo, hd)
    v = (xl @ wv).view(B, S, kv_hi - kv_lo, hd)
    if use_rope:
        q, k = rotate(q, rope), rotate(k, rope)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    kt, vt = _local_gqa(qt, kt, vt, g_p, h0, kv_lo)
    out = ops.flash_attention_op(qt, kt, vt, causal=causal)
    # the partial outputs stay f32 until they are summed, as one product accumulates them
    y = _f32_product(out.transpose(1, 2).reshape(B, S, hl * hd), wo)
    if cache is not None:
        _write_prefill_cache(k, v, kv_lo, hl, g_p, kv, rules, cache)
    return rules.leave(y, x, split=True).to(x.dtype)


def _param_cols(w, rules, ds, lo, hi):
    kept = rules.kept_range(w, 1)
    if kept == (lo, hi):
        return rules.param(w, split=True, data_sharded=ds, keep_dim=1)
    return rules.param(w, split=True, data_sharded=ds)[:, lo:hi]


def _param_rows(w, rules, ds, lo, hi):
    kept = rules.kept_range(w, 0)
    if kept == (lo, hi):
        return rules.param(w, split=True, data_sharded=ds, keep_dim=0)
    return rules.param(w, split=True, data_sharded=ds)[lo:hi]


@torch.no_grad()
def _write_prefill_cache(k, v, kv_lo: int, hl: int, g_p: int, kv: int, rules, cache) -> None:
    """Write this call's roped K and V [B, S, KV_l, hd] (the rank's KV heads ``kv_lo``...)
    into its ``CacheBlock``: each real KV head comes from the model rank that holds its
    first q head, the heads gathered over the model axis (padded to one count a rank)."""
    B, S, _, hd = k.shape
    M = rules.model_size
    owner = [(j * g_p) // hl for j in range(kv)]
    counts = [owner.count(r) for r in range(M)]
    n = max(counts)
    lo = owner.index(rules.model_rank) if counts[rules.model_rank] else kv
    mine = torch.stack([k, v])[:, :, :, lo - kv_lo:lo - kv_lo + counts[rules.model_rank]]
    mine = F.pad(mine, (0, 0, 0, n - mine.shape[3])).movedim(3, 0)  # [n, 2, B, S, hd]
    heads = rules.gather(mine, 0, [rules.model_dim])  # [M * n, 2, B, S, hd]
    real = [r * n + i for r in range(M) for i in range(counts[r])]
    whole = heads[real].permute(1, 2, 3, 0, 4).reshape(2, B, S, kv * hd)
    r0, r1 = cache.s_lo, min(S, cache.s_lo + cache.k.shape[1])
    if r1 > r0:
        cols = slice(cache.c_lo, cache.c_lo + cache.k.shape[2])
        cache.k[:, : r1 - r0] = whole[0, :, r0:r1, cols]
        cache.v[:, : r1 - r0] = whole[1, :, r0:r1, cols]


def cross_attention(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, Sk, KV, hd]
    v: torch.Tensor,  # [B, Sk, KV, hd]
    positions: torch.Tensor,  # [B, S]: the causal mask's query positions
    causal: bool = False,
) -> torch.Tensor:
    """GQA attention over keys of their own length -> [B, S, H*hd], in plain PyTorch.

    As the JAX package computes it (repro/models/layers.py:190-209, in XLA):
    f32 scores, f32 softmax, weights rounded to q's type before P.V.  No
    kernel of the repository computes it: the TPU flash kernel reads K and
    V of q's own length (ROADMAP B queues a flash variant with a key
    length of its own).
    """
    B, S, h, hd = q.shape
    kv = k.shape[2]
    with profiler_range(CROSS_ATTENTION_RANGE):
        qg = q.reshape(B, S, kv, h // kv, hd)
        scores = torch.einsum("bqngd,bknd->bngqk", qg.float(), k.float()) / math.sqrt(hd)
        if causal:
            kpos = torch.arange(k.shape[1], device=q.device)
            scores = scores.masked_fill((kpos > positions[:, :, None])[:, None, None], NEG_INF)
        w = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.einsum("bngqk,bknd->bqngd", w, v).reshape(B, S, h * hd)


def decode_attention(
    params,
    x: torch.Tensor,
    pos: int,
    cache,
    cfg: ModelConfig,
    *,
    sliding_window: int = 0,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    update_cache: bool = True,
    use_rope: bool = True,
    rules=None,
) -> torch.Tensor:
    """One-token decode against a layer's FLAT [B, S_max, KV*hd] caches -> out [B, 1, D].

    ``cache`` is the (k, v) pair, or a ``CacheBlock``: with ``rules`` and a
    DTensor x, the rank's block of them.  ``pos`` is the current position,
    the same for the whole batch; ``rope`` is its ``rope_cos_sin``, if the
    caller has it.  Cache entries past ``pos`` are masked.
    ``update_cache=False`` (cross-attention) writes nothing, reads the caches
    as given and attends inside the ``CROSS_ATTENTION_RANGE`` profiler range;
    ``use_rope=False`` leaves q (and the new K row) unrotated.
    Departure from JAX: the new K/V row is written into the caches IN PLACE
    (JAX returns updated copies, repro/models/layers.py:306-311), and a
    write at a ``pos`` outside the cache raises where JAX clamps it.

    On the mesh every model rank projects all heads (``_whole_projection``)
    and writes the new row where its block holds row ``pos``; a block whose
    columns are sharded is gathered over them, and where its rows are
    sharded the ranks combine the softmax over them (``_combine_rows``).
    """
    sharded = rules is not None and is_dtensor(x)
    blk = cache if isinstance(cache, CacheBlock) else CacheBlock(*cache, 0, 0, (), ())
    if sharded:
        ds = rules.batch_sharded(x)
        xl = rules.enter(x, ("batch", None, None))
        grad = torch.no_grad()  # serving only: the gathers are not differentiable

        def project(w):
            return _whole_projection(xl, w, rules, ds)
    else:
        xl, grad = x, nullcontext()

        def project(w):
            return x @ w
    B = xl.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    g = h // kv
    S_l, C_l = blk.k.shape[1:]
    S_max = S_l * math.prod(rules.mesh.size(d) for d in blk.seq_dims) if blk.seq_dims else S_l
    if pos < 0 or (update_cache and pos >= S_max):
        raise IndexError(f"decode position {pos} outside a cache of {S_max}")
    with grad:
        if use_rope and rope is None:
            positions = torch.full((B, 1), pos, dtype=torch.int32, device=xl.device)
            rope = rope_cos_sin(positions, hd, cfg.rope_theta)
        q = project(params["wq"]).view(B, 1, h, hd)
        q = rotate(q, rope) if use_rope else q
        if update_cache:
            k_new = project(params["wk"]).view(B, 1, kv, hd)
            k_new = (rotate(k_new, rope) if use_rope else k_new).reshape(B, kv * hd)
            v_new = project(params["wv"]).reshape(B, kv * hd)
            if blk.s_lo <= pos < blk.s_lo + S_l:
                cols = slice(blk.c_lo, blk.c_lo + C_l)
                blk.k[:, pos - blk.s_lo] = k_new[:, cols]
                blk.v[:, pos - blk.s_lo] = v_new[:, cols]

        with nullcontext() if update_cache else profiler_range(CROSS_ATTENTION_RANGE):
            k_att, v_att, r0 = blk.k, blk.v, blk.s_lo
            if blk.col_dims:  # whole rows of the columns
                k_att, v_att = (rules.gather(t, 2, blk.col_dims) for t in (k_att, v_att))
            window = 0 < sliding_window < S_max
            if window:  # attend to the last W entries of the cache
                start = min(max(pos - sliding_window + 1, 0), S_max - sliding_window)
                if not blk.seq_dims:  # whole rows: read the window alone
                    k_att = k_att[:, start : start + sliding_window]
                    v_att = v_att[:, start : start + sliding_window]
                    r0 = start
            n = k_att.shape[1]
            kpos = r0 + torch.arange(n, device=xl.device)
            masked = kpos > pos
            if window and blk.seq_dims:
                masked |= (kpos < start) | (kpos >= start + sliding_window)
            qg = q.reshape(B, 1, kv, g, hd)
            k_att, v_att = k_att.reshape(B, n, kv, hd), v_att.reshape(B, n, kv, hd)
            scores = torch.einsum("bqngd,bknd->bngqk", qg.float(), k_att.float()) / math.sqrt(hd)
            scores = scores.masked_fill(masked, NEG_INF)
            if blk.seq_dims:
                out = _combine_rows(scores, v_att, blk.seq_dims, rules, xl.dtype)
            else:
                w = torch.softmax(scores, dim=-1).to(xl.dtype)
                out = torch.einsum("bngqk,bknd->bqngd", w, v_att)
            out = out.reshape(B, 1, h * hd)
        if not sharded:
            return out @ params["wo"]
        rows = rules.kept_range(params["wo"], 0)
        if rows is None:
            return rules.leave(out @ rules.param(params["wo"], split=False, data_sharded=ds), x)
        # wo's rows are sharded on the model axis: each rank projects its heads, the parts summed
        wo = rules.param(params["wo"], split=True, data_sharded=ds, keep_dim=0)
        return rules.leave(_f32_product(out[..., rows[0]:rows[1]], wo), x, split=True).to(x.dtype)


def _combine_rows(scores, v, dims, rules, dtype) -> torch.Tensor:
    """softmax(scores) . v where the keys' rows are sharded over the mesh dims ``dims``, as
    flash decoding combines them (JAX's GSPMD reduces over a sharded sequence the same
    way): the maximum, the sum and the weighted values are reduced over ``dims``.  The
    weights are rounded to ``dtype`` after the global normalisation, as in the unsharded
    path, and the partial P.V stay f32 until they are summed."""
    import torch.distributed._functional_collectives as funcol

    m = scores.amax(dim=-1, keepdim=True)
    for d in dims:
        m = funcol.all_reduce(m, "max", (rules.mesh, d))
    p = torch.exp(scores - m)
    denom = p.sum(dim=-1, keepdim=True)
    for d in dims:
        denom = funcol.all_reduce(denom, "sum", (rules.mesh, d))
    wts = (p / denom).to(dtype)
    out = torch.einsum("bngqk,bknd->bqngd", wts.float(), v.float())
    for d in dims:
        out = funcol.all_reduce(out, "sum", (rules.mesh, d))
    return out.to(dtype)


def _whole_projection(xl: torch.Tensor, w, rules, ds: bool) -> torch.Tensor:
    """xl @ w with every output column (no gradient): where w's columns are sharded on the
    model axis, each rank projects its own and the products are gathered (KB of activations,
    not the MB of w)."""
    if rules.kept_range(w, 1) is None:
        return xl @ rules.param(w, split=False, data_sharded=ds)
    part = xl @ rules.param(w, split=True, data_sharded=ds, keep_dim=1)
    return rules.gather(part, part.dim() - 1, [rules.model_dim])


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


def ffn_schema(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, ParamDef]:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "w_gate": ParamDef((d, f), ("embed", "mlp")),
        "w_up": ParamDef((d, f), ("embed", "mlp")),
        "w_down": ParamDef((f, d), ("mlp", "embed")),
    }


def swiglu_ffn(params, x: torch.Tensor, rules=None) -> torch.Tensor:
    """SwiGLU.  ``rules`` and a DTensor x: split over the model axis where the FFN
    width is sharded on it (each rank its own columns of w_gate and w_up and rows of
    w_down, the partial outputs summed), else repeated on every model rank."""
    if rules is None or not is_dtensor(x):
        return (F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) @ params["w_down"]
    ds = rules.batch_sharded(x)
    split = rules.kept_range(params["w_gate"], 1) is not None
    xl = rules.enter(x, ("batch", None, None), split=split)
    wg, wu = (rules.param(params[n], split=split, data_sharded=ds, keep_dim=1 if split else None)
              for n in ("w_gate", "w_up"))
    wd = rules.param(params["w_down"], split=split, data_sharded=ds, keep_dim=0 if split else None)
    h = F.silu(xl @ wg) * (xl @ wu)
    if not split:
        return rules.leave(h @ wd, x)
    # the partial outputs stay f32 until they are summed, as one product accumulates them
    return rules.leave(_f32_product(h, wd), x, split=True).to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / heads
# ---------------------------------------------------------------------------


def embed_schema(cfg: ModelConfig) -> ParamDef:
    # vocab-sharded only, as in JAX (FSDP on D would make the token gather unpartitionable)
    return ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", None), scale=0.02)


def lm_head_schema(cfg: ModelConfig) -> ParamDef:
    return ParamDef((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))


class _MixedMM(torch.autograd.Function):
    """x [T, D] @ w [D, V] in the working type -> f32, through cuBLAS's f32 accumulator.

    Autograd has no derivative for ``torch.mm(..., out_dtype=)``, so the
    backward is written out: two working-type products of the f32
    gradient rounded to the working type, each accumulated in f32.
    """

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = g @ w.T if ctx.needs_input_grad[0] else None
        dw = x.T @ g if ctx.needs_input_grad[1] else None
        return dx, dw


def logits_fn(params, x: torch.Tensor, cfg: ModelConfig, rules=None) -> torch.Tensor:
    """[..., D] -> f32 logits [..., V]: the working-type product, accumulated in f32.

    The f32 result is never rounded to the working type: on the card
    ``torch.mm(..., out_dtype=float32)`` keeps cuBLAS's f32 accumulator;
    on the CPU the operands are widened (bf16 products are exact in f32).
    ``rules`` and a DTensor x [B, S, D]: each model rank computes its own
    vocabulary rows where the vocabulary is sharded, and the logits are
    gathered whole (a DTensor with x's batch layout).
    """
    if rules is not None and is_dtensor(x):
        return _sharded_logits(params, x, cfg, rules)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]  # [D, V]
    return _f32_product(x, w)


def _f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., D] @ w [D, V] -> f32 (see ``logits_fn``)."""
    x2 = x.reshape(-1, x.shape[-1])
    if x2.dtype == torch.float32:
        out = x2 @ w
    elif not x2.is_cuda:
        out = x2.float() @ w.float()
    elif torch.is_grad_enabled() and (x2.requires_grad or w.requires_grad):
        out = _MixedMM.apply(x2, w)
    else:
        out = torch.mm(x2, w, out_dtype=torch.float32)
    return out.reshape(*x.shape[:-1], out.shape[-1])


def _vocab_block(params, cfg: ModelConfig, rules, ds: bool):
    """(w [D, V_l] this rank reads, its first vocabulary row, split): the rank's own rows
    where the vocabulary is sharded on the model axis, else all of them."""
    if cfg.tie_embeddings:
        rng = rules.kept_range(params["embed"], 0)
        w = rules.param(params["embed"], split=rng is not None, data_sharded=ds,
                        keep_dim=0 if rng else None).T
    else:
        rng = rules.kept_range(params["lm_head"], 1)
        w = rules.param(params["lm_head"], split=rng is not None, data_sharded=ds,
                        keep_dim=1 if rng else None)
    return w, (rng or (0,))[0], rng is not None


def _sharded_logits(params, x, cfg: ModelConfig, rules) -> torch.Tensor:
    """Serving's logits (no gradient): the vocabulary blocks gathered over the model axis."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("sharded logits are gathered without a gradient: train through "
                           "sharded_lm_head_loss")
    ds = rules.batch_sharded(x)
    w, _, split = _vocab_block(params, cfg, rules, ds)
    out = _f32_product(rules.enter(x, ("batch", None, None)), w)
    if split:
        out = rules.gather(out, out.dim() - 1, [rules.model_dim])
    return rules.leave(out, x)


def sharded_lm_head_loss(params, x, labels, cfg: ModelConfig, rules) -> torch.Tensor:
    """``cross_entropy(logits_fn(x), labels)`` of a DTensor x [B, S, D] without gathering
    the logits: each model rank holds its vocabulary rows' logits, and the log-sum-exp
    and the gold logit are summed over the model axis (the mean covers the global
    batch).  Returns a plain scalar, equal on every rank."""
    import torch.distributed._functional_collectives as funcol

    ds = rules.batch_sharded(x)
    w, v0, split = _vocab_block(params, cfg, rules, ds)
    xl = rules.enter(x, ("batch", None, None), split=split)
    lab = rules.enter(labels, ("batch", None)).long()
    lg = _f32_product(xl, w)  # [B_l, S, V_l]
    m = lg.detach().amax(dim=-1, keepdim=True)
    if split:
        m = funcol.all_reduce(m, "max", (rules.mesh, rules.model_dim))
    se = torch.exp(lg - m).sum(dim=-1)
    local = (lab >= v0) & (lab < v0 + lg.shape[-1])
    gold = lg.gather(-1, (lab - v0).clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
    gold = torch.where(local, gold, torch.zeros_like(gold))
    if split:
        se, gold = rules.sum_model(se, ds), rules.sum_model(gold, ds)
    nll_sum = (m[..., 0] + torch.log(se) - gold).sum()
    return rules.sum_data(nll_sum, ds) / labels.numel()


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Mean next-token CE; logits [B,S,V] (f32), labels [B,S]."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)

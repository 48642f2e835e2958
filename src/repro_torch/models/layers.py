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
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF

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
    init: str = "normal"  # normal | zeros | ones
    scale: float = 0.02


def stacked(pdef: ParamDef, layers: int) -> ParamDef:
    """Layer-stacked parameter: a leading [L] dim, as the JAX scan over depth."""
    return ParamDef((layers, *pdef.shape), pdef.init, pdef.scale)


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
) -> ParamTree:
    """normal(0, 1) * scale (drawn in f32 on the generator's device), zeros or ones."""

    def build(node):
        if isinstance(node, Mapping):
            return {k: build(v) for k, v in node.items()}
        if node.init == "zeros":
            return torch.zeros(node.shape, dtype=dtype, device=device)
        if node.init == "ones":
            return torch.ones(node.shape, dtype=dtype, device=device)
        w = torch.randn(node.shape, generator=generator, device=generator.device)
        return (w * node.scale).to(device=device, dtype=dtype)

    return ParamTree(build(schema), trainable)


# ---------------------------------------------------------------------------
# norms / positional encodings
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return ops.rmsnorm_op(x, weight, eps=eps)


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
        "wq": ParamDef((d, h * hd)),
        "wk": ParamDef((d, kv * hd)),
        "wv": ParamDef((d, kv * hd)),
        "wo": ParamDef((h * hd, d)),
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
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    use_rope: bool = True,
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
    B, S, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ params["wq"]).view(B, S, h, hd)
    if use_rope and rope is None:
        rope = rope_cos_sin(positions, hd, cfg.rope_theta)
    if kv_override is not None:
        if cache is not None:
            raise ValueError("cross-attention writes no cache: its K/V are the caller's")
        q = rotate(q, rope) if use_rope else q
        return cross_attention(q, *kv_override, positions, causal) @ params["wo"]
    k = (x @ params["wk"]).view(B, S, kv, hd)
    v = (x @ params["wv"]).view(B, S, kv, hd)
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
    return out.transpose(1, 2).reshape(B, S, h * hd) @ params["wo"]


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
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cfg: ModelConfig,
    *,
    sliding_window: int = 0,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    update_cache: bool = True,
    use_rope: bool = True,
) -> torch.Tensor:
    """One-token decode against FLAT [B, S_max, KV*hd] caches -> out [B, 1, D].

    ``pos`` is the current position, the same for the whole batch; ``rope``
    is its ``rope_cos_sin``, if the caller has it.  Cache entries past
    ``pos`` are masked.  ``update_cache=False`` (cross-attention) writes
    nothing, reads the caches as given and attends inside the
    ``CROSS_ATTENTION_RANGE`` profiler range; ``use_rope=False`` leaves q
    (and the new K row) unrotated.
    Departure from JAX: the new K/V row is written into the caches IN PLACE
    (JAX returns updated copies, repro/models/layers.py:306-311), and a
    write at a ``pos`` outside the cache raises where JAX clamps it.
    """
    B = x.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    g = h // kv
    S_max = k_cache.shape[1]
    if pos < 0 or (update_cache and pos >= S_max):
        raise IndexError(f"decode position {pos} outside a cache of {S_max}")
    if use_rope and rope is None:
        positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        rope = rope_cos_sin(positions, hd, cfg.rope_theta)
    q = (x @ params["wq"]).view(B, 1, h, hd)
    q = rotate(q, rope) if use_rope else q
    if update_cache:
        k_new = (x @ params["wk"]).view(B, 1, kv, hd)
        k_cache[:, pos] = (rotate(k_new, rope) if use_rope else k_new).reshape(B, kv * hd)
        v_cache[:, pos] = (x @ params["wv"]).reshape(B, kv * hd)

    with nullcontext() if update_cache else profiler_range(CROSS_ATTENTION_RANGE):
        if 0 < sliding_window < S_max:
            # attend to the last W entries of the cache
            start = min(max(pos - sliding_window + 1, 0), S_max - sliding_window)
            k_att = k_cache[:, start : start + sliding_window].view(B, sliding_window, kv, hd)
            v_att = v_cache[:, start : start + sliding_window].view(B, sliding_window, kv, hd)
            kpos = start + torch.arange(sliding_window, device=x.device)
        else:
            k_att = k_cache.view(B, S_max, kv, hd)
            v_att = v_cache.view(B, S_max, kv, hd)
            kpos = torch.arange(S_max, device=x.device)
        qg = q.reshape(B, 1, kv, g, hd)
        scores = torch.einsum("bqngd,bknd->bngqk", qg.float(), k_att.float()) / math.sqrt(hd)
        scores = scores.masked_fill(kpos > pos, NEG_INF)
        w = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bngqk,bknd->bqngd", w, v_att).reshape(B, 1, h * hd)
    return out @ params["wo"]


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


def ffn_schema(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, ParamDef]:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "w_gate": ParamDef((d, f)),
        "w_up": ParamDef((d, f)),
        "w_down": ParamDef((f, d)),
    }


def swiglu_ffn(params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) @ params["w_down"]


# ---------------------------------------------------------------------------
# embeddings / heads
# ---------------------------------------------------------------------------


def embed_schema(cfg: ModelConfig) -> ParamDef:
    return ParamDef((cfg.vocab_size, cfg.d_model), scale=0.02)


def lm_head_schema(cfg: ModelConfig) -> ParamDef:
    return ParamDef((cfg.d_model, cfg.vocab_size))


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


def logits_fn(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """[..., D] -> f32 logits [..., V]: the working-type product, accumulated in f32.

    The f32 result is never rounded to the working type: on the card
    ``torch.mm(..., out_dtype=float32)`` keeps cuBLAS's f32 accumulator;
    on the CPU the operands are widened (bf16 products are exact in f32).
    """
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]  # [D, V]
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

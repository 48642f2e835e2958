"""Mixture-of-Experts FFN with sort-based static-capacity dispatch.

Torch twin of ``repro.models.moe``'s global path (``_moe_ffn_global``):
token-choice top-k routing, a static per-expert capacity
``C = ceil(T * k / E * capacity_factor)`` (rounded up to 128, or to 8 below
128), dispatch by a stable argsort over expert ids into an ``[E, C, D]``
buffer, the three expert products through ``ops.moe_matmul_op`` (the
hand-written kernel on the card), and a combine weighted by the
renormalised router probabilities.  Assignments past an expert's capacity
are dropped.  The sharded dispatch (``_moe_ffn_sharded``) is not ported.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import ParamDef


def moe_schema(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    return {
        "router": ParamDef((d, e)),
        "w_gate": ParamDef((e, d, f)),
        "w_up": ParamDef((e, d, f)),
        "w_down": ParamDef((e, f, d)),
    }


def expert_capacity(tokens: int, cfg: ModelConfig) -> int:
    c = math.ceil(tokens * cfg.experts_per_token / cfg.num_experts * cfg.capacity_factor)
    if c >= 128:
        return ((c + 127) // 128) * 128
    return max(8, ((c + 7) // 8) * 8)


def moe_ffn(params, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, S, D] -> (y [B, S, D], {"load_balance", "router_z"} f32 scalars)."""
    B, S, D = x.shape
    T = B * S
    E, K = cfg.num_experts, cfg.experts_per_token
    C = expert_capacity(T, cfg)
    xt = x.reshape(T, D)

    # ---- routing: f32 softmax over the router logits, top-k, renormalise
    logits = (xt @ params["router"]).float()  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)  # [T, K], descending as lax.top_k
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    # ---- dispatch: sort (token, slot) pairs by expert.  The sort must be
    # stable: an assignment's rank within its expert (first come, first
    # served) decides which ones the capacity drops.
    flat_e = top_e.reshape(T * K)
    flat_p = top_p.reshape(T * K)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    sorted_tok = order // K  # flat token ids are repeat(arange(T), K)
    sorted_p = flat_p[order]
    counts = torch.zeros(E, dtype=torch.int64, device=x.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))  # bincount without a host sync

    # ---- aux losses
    density = counts.float() / T
    lb_loss = E * torch.sum(density * probs.mean(dim=0)) / K
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()

    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * K, device=x.device) - starts[sorted_e]
    keep = rank < C
    # Slots are unique, so the scatter is a copy; dropped assignments all
    # land on a spill row E*C that is cut off.
    slot = torch.where(keep, sorted_e * C + rank, E * C)
    buf = x.new_zeros(E * C + 1, D)
    buf.index_copy_(0, slot, xt[sorted_tok])
    buf = buf[: E * C].view(E, C, D)

    # ---- expert FFNs, batched over E
    h = F.silu(ops.moe_matmul_op(buf, params["w_gate"])) * ops.moe_matmul_op(buf, params["w_up"])
    out = ops.moe_matmul_op(h, params["w_down"]).view(E * C, D)

    # ---- combine without atomics: gather each assignment's output, weight
    # it, undo the sort and sum the K contributions of each token in f32
    # (XLA's CPU scatter-add sums bf16 in f32 too), rounding once.
    gathered = torch.where(keep[:, None], out[slot.clamp(max=E * C - 1)], 0)
    contrib = gathered * sorted_p[:, None].to(x.dtype)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * K, device=x.device)
    y = contrib[inv].view(T, K, D).sum(dim=1, dtype=torch.float32).to(x.dtype)
    return y.view(B, S, D), {"load_balance": lb_loss, "router_z": z_loss}

"""Plain PyTorch versions of the port's kernels (the correctness ground truth).

Each function has its CUDA kernel's contract (same arguments, same output
shapes and dtypes).  They are torch twins of ``repro.kernels.ref``:
``ops`` calls them for tensors on the CPU, and ``chip_smoke.py`` holds
each kernel against them on the card.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,  # [B, H, S, d]
    k: torch.Tensor,  # [B, KV, S, d]
    v: torch.Tensor,  # [B, KV, S, d]
    causal: bool = True,
) -> torch.Tensor:
    """GQA attention: query head h reads kv head h // (H // KV).

    Scores and softmax are f32 (the products of two bf16 values are exact
    in f32); the weights are cast to ``v.dtype`` before P·V, as the JAX
    reference does.
    """
    B, H, S, d = q.shape
    KV = k.shape[1]
    g = H // KV
    qg = q.reshape(B, KV, g, S, d).float()
    scores = torch.einsum("bngqd,bnkd->bngqk", qg, k.float()) / math.sqrt(d)
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngqk,bnkd->bngqd", w.to(v.dtype), v)
    return out.reshape(B, H, S, d).to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Row RMSNorm: f32 statistics, rounded to ``x.dtype`` before the weight."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight

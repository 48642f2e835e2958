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


def moe_matmul_ref(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-expert product buf [E, C, D] x w [E, D, F] -> [E, C, F] in ``buf.dtype``.

    f32 accumulation (the products of two bf16 values are exact in f32),
    one rounding to the working type at the end.
    """
    return torch.einsum("ecd,edf->ecf", buf.float(), w.float()).to(buf.dtype)


def ssd_intra_chunk_ref(
    x: torch.Tensor,  # [BNC, H, Q, hd] dt-weighted inputs of every (chunk, head)
    b: torch.Tensor,  # [BNC, Q, N]
    c: torch.Tensor,  # [BNC, Q, N]
    cum: torch.Tensor,  # [BNC, H, Q] inclusive cumsum of dA within the chunk
):
    """Intra-chunk SSD of every (chunk, head) -> (y [BNC,H,Q,hd] in x.dtype, state [BNC,H,hd,N] f32).

    Per (chunk, head): y = ((C Bᵀ) ∘ L) x with L[i, j] = exp(cum_i - cum_j)
    for i >= j and 0 above the diagonal (the exponent there is positive,
    so it is masked before ``exp``); state = (x ∘ exp(cum_last - cum))ᵀ B.
    B and C are shared across heads.
    """
    Q = x.shape[2]
    xf, bf, cf, cumf = x.float(), b.float(), c.float(), cum.float()
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    diff = cumf[..., :, None] - cumf[..., None, :]  # [BNC, H, Q, Q]
    L = torch.where(tri, torch.exp(diff.masked_fill(~tri, 0.0)), 0.0)
    cb = torch.einsum("iqn,ikn->iqk", cf, bf)  # [BNC, Q, Q]
    y = ((cb[:, None] * L) @ xf).to(x.dtype)
    decay_to_end = torch.exp(cumf[..., -1:] - cumf)  # [BNC, H, Q]
    state = torch.einsum("ihqd,iqn->ihdn", xf * decay_to_end[..., None], bf)
    return y, state

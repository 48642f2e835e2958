"""Plain PyTorch versions of the port's kernels (the correctness ground truth).

Each function has its CUDA kernel's contract (same arguments, same output
shapes and dtypes).  They are torch twins of ``repro.kernels.ref``:
``ops`` calls them for tensors on the CPU, and ``chip_smoke.py`` holds
each kernel against them on the card.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,  # [B, H, S, d]
    k: torch.Tensor,  # [B, KV, Sk, d]
    v: torch.Tensor,  # [B, KV, Sk, d]
    causal: bool = True,
) -> torch.Tensor:
    """GQA attention: query head h reads kv head h // (H // KV); the keys may have
    a length of their own (B11, cross-attention), non-causal.

    Scores and softmax are f32 (the products of two bf16 values are exact
    in f32); the weights are cast to ``v.dtype`` before P·V, as the JAX
    reference does.
    """
    B, H, S, d = q.shape
    KV = k.shape[1]
    g = H // KV
    if causal and k.shape[2] != S:
        raise ValueError(f"causal attention masks by the sequence index: keys {k.shape[2]} must be q's {S}")
    qg = q.reshape(B, KV, g, S, d).float()
    scores = torch.einsum("bngqd,bnkd->bngqk", qg, k.float()) / math.sqrt(d)
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngqk,bnkd->bngqd", w.to(v.dtype), v)
    return out.reshape(B, H, S, d).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,  # [B, H, 1, d]
    k_cache: torch.Tensor,  # FLAT [B, Sk, KV*d]
    v_cache: torch.Tensor,  # FLAT [B, Sk, KV*d]
    n: int,
) -> torch.Tensor:
    """One query a row against the first ``n`` keys of the FLAT caches -> [B, 1, H*d]:
    what ``layers.decode_attention`` computes over a cache it does not update (f32
    scores and softmax, the weights rounded to q's type before P·V)."""
    B, H, _, d = q.shape
    KV = k_cache.shape[2] // d
    k = k_cache[:, :n].reshape(B, n, KV, d)
    v = v_cache[:, :n].reshape(B, n, KV, d)
    qg = q.reshape(B, KV, H // KV, 1, d)
    scores = torch.einsum("bngqd,bknd->bngqk", qg.float(), k.float()) / math.sqrt(d)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bngqk,bknd->bqngd", w, v).reshape(B, 1, H * d)


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


# ---- backward closed forms (the gradients the backward kernels compute) ----


def moe_matmul_bwd_ref(buf: torch.Tensor, w: torch.Tensor, dout: torch.Tensor):
    """(dbuf [E,C,D], dw [E,D,F]) of ``moe_matmul_ref(buf, w)`` for the gradient dout [E,C,F].

    dbuf = dout · wᵀ and dw = bufᵀ · dout per expert, f32 accumulation, one
    rounding to the working type (what autograd gives through the f32 einsum).
    """
    df = dout.float()
    dbuf = torch.einsum("ecf,edf->ecd", df, w.float()).to(buf.dtype)
    dw = torch.einsum("ecd,ecf->edf", buf.float(), df).to(w.dtype)
    return dbuf, dw


def ssd_intra_chunk_bwd_ref(x, b, c, cum, dy, dstate=None):
    """(dx, db, dc, dcum) of ``ssd_intra_chunk_ref`` for the gradients dy of y and dstate of
    the state (None: zero).  dx in x.dtype; db, dc and dcum in f32 (in f64 for f64 inputs,
    so that a test can hold the f32 result against the same closed form in float64).

    Per (chunk, head), with G = C Bᵀ, L[q, k] = exp(cum_q - cum_k) for q >= k (masked before
    ``exp``), M = G ∘ L and w_k = exp(cum_last - cum_k):
    dM = dy xᵀ (lower triangle); dx = Mᵀ dy + w ∘ (B dstateᵀ);
    dC = Σ_h (dM ∘ L) B; dB = Σ_h (dM ∘ L)ᵀ C + Σ_h (x ∘ w) dstate;
    dcum_q = Σ_k (dM ∘ M)[q, k] - Σ_k (dM ∘ M)[k, q] - w_q x_q · (dstate B_q),
    and dcum_last also gets Σ_k w_k x_k · (dstate B_k).
    """
    Q = x.shape[2]
    ft = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf, bf, cf, cumf, dyf = (t.to(ft) for t in (x, b, c, cum, dy))
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    diff = cumf[..., :, None] - cumf[..., None, :]  # [BNC, H, Q, Q]
    L = torch.where(tri, torch.exp(diff.masked_fill(~tri, 0.0)), 0.0)
    G = torch.einsum("iqn,ikn->iqk", cf, bf)[:, None]  # [BNC, 1, Q, Q], shared by the heads
    dML = (dyf @ xf.transpose(-1, -2)) * L  # dM ∘ L, zero above the diagonal
    P = dML * G  # dM ∘ M
    dx = (G * L).transpose(-1, -2) @ dyf
    dc = torch.einsum("ihqk,ikn->iqn", dML, bf)
    db = torch.einsum("ihqk,iqn->ikn", dML, cf)
    dcum = P.sum(-1) - P.sum(-2)
    if dstate is not None:
        ds = dstate.to(ft)
        w = torch.exp(cumf[..., -1:] - cumf)  # [BNC, H, Q]
        bds = torch.einsum("ikn,ihdn->ihkd", bf, ds)  # B dstateᵀ per head [BNC, H, Q, hd]
        dx = dx + w[..., None] * bds
        db = db + torch.einsum("ihkd,ihdn->ikn", xf * w[..., None], ds)
        tw = w * (xf * bds).sum(-1)  # w_k x_k · (dstate B_k)
        dcum = dcum - tw
        dcum[..., -1] += tw.sum(-1)
    return dx.to(x.dtype), db, dc, dcum


# ---- AdamW (B9): the update the optimizer makes, leaf by leaf, in place ----


def adamw_leaf_ref(p, g, m, v, scale, lr, bc1, bc2, *, beta1, beta2, eps, weight_decay):
    """One leaf's AdamW update in place (p, and the f32 moments m and v), given the clip
    ``scale``, ``lr`` and the bias corrections ``bc1``, ``bc2`` as f32 scalars: the torch
    ops of ``repro.training.optimizer.adamw_update``'s ``upd``, in its order, each
    rounded to f32 as the kernel rounds it."""
    g = g.to(torch.float32) * scale
    m.mul_(beta1).add_((1 - beta1) * g)
    v.mul_(beta2).add_((1 - beta2) * g.square())
    delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p.to(torch.float32)
    p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))


def adamw_update_ref(
    params: Sequence[torch.Tensor],
    grads: Sequence[torch.Tensor],
    ms: Sequence[torch.Tensor],
    vs: Sequence[torch.Tensor],
    lr: torch.Tensor,
    bc1: torch.Tensor,
    bc2: torch.Tensor,
    *,
    beta1: float,
    beta2: float,
    eps: float,
    weight_decay: float,
    grad_clip: float,
    counted: Optional[Sequence[bool]] = None,
    reduce: Optional[Callable[[torch.Tensor], object]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``adamw.adamw_update_``'s contract: one AdamW step in place over the leaves;
    -> (gnorm, scale).  The norm is the sum of each counted leaf's f32 sum of squares
    (``reduce`` sums it over the ranks, in place), then its square root."""
    counted = [True] * len(params) if counted is None else counted
    total = torch.zeros((), dtype=torch.float32, device=params[0].device)
    for g, c in zip(grads, counted):
        if c:
            total = total + g.to(torch.float32).square().sum()
    if reduce is not None:
        reduce(total)
    gnorm = torch.sqrt(total)
    scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
    for p, g, m, v in zip(params, grads, ms, vs):
        adamw_leaf_ref(p, g, m, v, scale, lr, bc1, bc2, beta1=beta1, beta2=beta2, eps=eps,
                       weight_decay=weight_decay)
    return gnorm, scale

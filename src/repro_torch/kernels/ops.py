"""Public entry points of the port's kernels.

A CPU tensor goes to the plain version in ``ref``, which autograd
differentiates; a CUDA tensor goes to the hand-written kernel, which runs
or raises (there is no fallback).  On CUDA, when a gradient is wanted,
each entry point goes through a ``torch.autograd.Function`` whose backward
is the kernel's backward kernels (rmsnorm: dx and dweight; flash
attention: dq and dk/dv; moe_matmul: dbuf and dw; ssd_intra_chunk: dx and
f32 partials, then their reduce).  ``adamw_update_`` is the optimizer's step
over every leaf, in place (B9: the norm's partials, their finish, the update).
``cross_attention_op`` and ``decode_attention_op`` are B11: attention over
keys of their own length (forward and backward) and its one-token decode
over FLAT caches.  Each kernel module counts its launches; ``launch_counts``
reads them, and ``route_launch_counts`` those of the f32 routes counted apart.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import adamw as _adamw
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import moe_matmul as _moe
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rmsnorm
from repro_torch.kernels import ssd_scan as _ssd


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, weight, eps):
        ctx.save_for_backward(x2, weight)
        ctx.eps = eps
        return _rmsnorm.rmsnorm(x2, weight, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x2, weight = ctx.saved_tensors
        dx, dw = _rmsnorm.rmsnorm_bwd(x2, weight, dy, eps=ctx.eps,
                                      dweight=ctx.needs_input_grad[1])
        return dx, dw, None


class _MoeMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf, w):
        ctx.save_for_backward(buf, w)
        return _moe.moe_matmul(buf, w)

    @staticmethod
    def backward(ctx, dout):
        buf, w = ctx.saved_tensors
        # the model's gather and views hand the gradient over strided
        return _moe.moe_matmul_bwd(buf, w, dout.contiguous(), dbuf=ctx.needs_input_grad[0],
                                   dw=ctx.needs_input_grad[1])


class _SsdIntraChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, b, c, cum):
        ctx.set_materialize_grads(False)  # a state nobody reads (one chunk) gives no gradient
        ctx.save_for_backward(x, b, c, cum)
        return _ssd.ssd_intra_chunk(x, b, c, cum)

    @staticmethod
    def backward(ctx, dy, dstate):
        x, b, c, cum = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        return _ssd.ssd_intra_chunk_bwd(x, b, c, cum, dy,
                                        None if dstate is None else dstate.contiguous())


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _flash.flash_attention(q, k, v, causal=causal, lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_flash.flash_attention_bwd(q, k, v, out, lse, dout, causal=ctx.causal), None)


class _CrossAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = _flash.cross_attention(q, k, v, lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        return _flash.cross_attention_bwd(*ctx.saved_tensors, dout)


def rmsnorm_op(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim; leading dims are flattened into rows."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if x.device.type == "cpu":
        out = ref.rmsnorm_ref(x2, weight, eps)
    elif _wants_grad(x, weight):
        out = _RMSNorm.apply(x2, weight, eps)
    else:
        out = _rmsnorm.rmsnorm(x2, weight, eps=eps)
    return out.reshape(shape)


def flash_attention_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """q [B,H,S,d], k/v [B,KV,S,d] -> [B,H,S,d]; on CUDA any strides with a contiguous d."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal)
    if _wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal)
    return _flash.flash_attention(q, k, v, causal=causal)


def cross_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal GQA attention over keys of their own length (B11): q [B,H,S,d],
    k/v [B,KV,Sk,d] -> [B,H,S,d]; on CUDA any strides with a contiguous d."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=False)
    if _wants_grad(q, k, v):
        return _CrossAttention.apply(q, k, v)
    return _flash.cross_attention(q, k, v)


def decode_attention_op(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                        n: int) -> torch.Tensor:
    """One query a row, q [B,H,1,d], against the first ``n`` keys of the FLAT caches
    [B,Sk,KV*d] -> [B,1,H*d] (B11's decode; no gradient on CUDA: serving only)."""
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, n)
    if _wants_grad(q, k_cache, v_cache):
        raise NotImplementedError("the decode kernel has no backward: decode_attention serves only")
    return _flash.flash_decode(q, k_cache, v_cache, n)


def moe_matmul_op(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-expert product buf [E,C,D] x w [E,D,F] -> [E,C,F] in buf.dtype.

    On CUDA the route is ``moe_matmul.launch_plan``'s: bf16 on wgmma fed by
    TMA (transposed at decode's small capacities), f32 on CUDA-core FMAs.
    """
    if buf.device.type == "cpu":
        return ref.moe_matmul_ref(buf, w)
    if _wants_grad(buf, w):
        return _MoeMatmul.apply(buf, w)
    return _moe.moe_matmul(buf, w)


def ssd_intra_chunk_op(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor, cum: torch.Tensor):
    """Intra-chunk SSD: x [BNC,H,Q,hd], b/c [BNC,Q,N], cum [BNC,H,Q] -> (y, state f32)."""
    if x.device.type == "cpu":
        return ref.ssd_intra_chunk_ref(x, b, c, cum)
    if _wants_grad(x, b, c, cum):
        return _SsdIntraChunk.apply(x, b, c, cum)
    return _ssd.ssd_intra_chunk(x, b, c, cum)


def adamw_update_(
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
    """One AdamW step over the leaves: the params and the f32 moments ``ms``, ``vs``
    are updated in place; -> (gnorm, clip scale), f32 scalars on the params' device.

    ``lr``, ``bc1`` and ``bc2`` are f32 scalars on that device.  ``counted``: the
    leaves whose squares count in the norm (on a mesh, the blocks this rank holds
    first); ``reduce``: sums the norm's partial sums over the ranks, in place."""
    fn = ref.adamw_update_ref if params[0].device.type == "cpu" else _adamw.adamw_update_
    return fn(params, grads, ms, vs, lr, bc1, bc2, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, grad_clip=grad_clip, counted=counted, reduce=reduce)


# kernel name -> (module, its launch counter)
_COUNTERS = {
    "rmsnorm": (_rmsnorm, "launches"),
    "rmsnorm_bwd": (_rmsnorm, "bwd_launches"),
    "rmsnorm_bwd_wide": (_rmsnorm, "bwd_wide_launches"),
    "rmsnorm_bwd_dweight": (_rmsnorm, "dweight_launches"),
    "flash_attention": (_flash, "launches"),
    "flash_attention_bwd_dq": (_flash, "bwd_dq_launches"),
    "flash_attention_bwd_dkdv": (_flash, "bwd_dkdv_launches"),
    "cross_attention": (_flash, "cross_launches"),
    "cross_attention_bwd_stats": (_flash, "cross_bwd_stats_launches"),  # bf16; f32 runs B5's two
    "cross_attention_bwd_fused": (_flash, "cross_bwd_fused_launches"),
    "flash_decode": (_flash, "decode_launches"),
    "moe_matmul": (_moe, "launches"),
    "moe_matmul_bwd_dbuf": (_moe, "bwd_dbuf_launches"),
    "moe_matmul_bwd_dw": (_moe, "bwd_dw_launches"),
    "ssd_intra_chunk": (_ssd, "launches"),
    "ssd_intra_chunk_bwd": (_ssd, "bwd_launches"),
    "ssd_intra_chunk_bwd_reduce": (_ssd, "bwd_reduce_launches"),
    "adamw_norm": (_adamw, "norm_launches"),
    "adamw_norm_finish": (_adamw, "finish_launches"),
    "adamw_update": (_adamw, "launches"),
}


# the f32 routes' kernels on the tensor cores, counted again apart from the counts above
_ROUTE_COUNTERS = {
    "flash_attention_tf32x3": (_flash, "tf32x3_launches"),
    "flash_attention_bwd_dq_tf32x3": (_flash, "tf32x3_bwd_dq_launches"),
    "flash_attention_bwd_dkdv_tf32x3": (_flash, "tf32x3_bwd_dkdv_launches"),
    "moe_matmul_tf32x3": (_moe, "tf32x3_launches"),
    "moe_matmul_bwd_dbuf_tf32x3": (_moe, "tf32x3_dbuf_launches"),
    "moe_matmul_bwd_dw_tf32x3": (_moe, "tf32x3_dw_launches"),
    "ssd_intra_chunk_mma3": (_ssd, "mma3_launches"),
}


def launch_counts() -> Dict[str, int]:
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}


def route_launch_counts() -> Dict[str, int]:
    """Launches of the f32 routes' kernels: attention's, moe_matmul's forward and backward and
    ssd_intra_chunk's forward (within ``launch_counts``'s)."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _ROUTE_COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in (*_COUNTERS.values(), *_ROUTE_COUNTERS.values()):
        setattr(mod, attr, 0)

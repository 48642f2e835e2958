"""Public entry points of the port's kernels.

A CPU tensor goes to the plain version in ``ref``; a CUDA tensor goes to
the hand-written kernel, which runs or raises (there is no fallback).
Each kernel module counts its launches; ``launch_counts`` reads them.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import moe_matmul as _moe
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rmsnorm
from repro_torch.kernels import ssd_scan as _ssd


def rmsnorm_op(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim; leading dims are flattened into rows."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if x.device.type == "cpu":
        out = ref.rmsnorm_ref(x2, weight, eps)
    else:
        out = _rmsnorm.rmsnorm(x2, weight, eps=eps)
    return out.reshape(shape)


def flash_attention_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """q [B,H,S,d], k/v [B,KV,S,d] -> [B,H,S,d]; on CUDA any strides with a contiguous d."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal)
    return _flash.flash_attention(q, k, v, causal=causal)


def moe_matmul_op(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-expert product buf [E,C,D] x w [E,D,F] -> [E,C,F] in buf.dtype."""
    if buf.device.type == "cpu":
        return ref.moe_matmul_ref(buf, w)
    return _moe.moe_matmul(buf, w)


def ssd_intra_chunk_op(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor, cum: torch.Tensor):
    """Intra-chunk SSD: x [BNC,H,Q,hd], b/c [BNC,Q,N], cum [BNC,H,Q] -> (y, state f32)."""
    if x.device.type == "cpu":
        return ref.ssd_intra_chunk_ref(x, b, c, cum)
    return _ssd.ssd_intra_chunk(x, b, c, cum)


_MODULES = {
    "rmsnorm": _rmsnorm,
    "flash_attention": _flash,
    "moe_matmul": _moe,
    "ssd_intra_chunk": _ssd,
}


def launch_counts() -> Dict[str, int]:
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0

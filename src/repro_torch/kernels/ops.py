"""Public entry points of the port's kernels.

A CPU tensor goes to the plain version in ``ref``; a CUDA tensor goes to
the hand-written kernel, which runs or raises (there is no fallback).
Each kernel module counts its launches; ``launch_counts`` reads them.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rmsnorm


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


def launch_counts() -> Dict[str, int]:
    return {"rmsnorm": _rmsnorm.launches, "flash_attention": _flash.launches}


def reset_launch_counts() -> None:
    _rmsnorm.launches = 0
    _flash.launches = 0

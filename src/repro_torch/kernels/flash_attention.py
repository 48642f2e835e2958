"""Flash-attention CUDA kernel (``csrc/flash_attention.cu``) bound with ctypes.

``flash_attention`` keeps the TPU kernel's ``[B, H, S, d]`` signature but
takes any strides with a contiguous last dimension, so the model passes
``[B, S, H, d]`` tensors as transposed views and no copy is made.  It
launches the kernel on CUDA tensors and raises on anything the kernel does
not take; ``ops.flash_attention_op`` also serves CPU tensors through the
plain version.  ``launch_plan`` decides the template's tiles, grid and
shared memory in Python, where the CPU tests reach it; the kernel refuses
a plan that is not its own.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Tuple

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)

launches = 0  # kernel launches since the last ops.reset_launch_counts()

BLOCK_Q = 64  # query rows per block, both templates


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call is launched; ``csrc/flash_attention.cu`` refuses any other."""

    route: str  # "mma": bf16 tensor cores; "fma": f32 CUDA-core FMAs
    block_q: int  # query rows per block
    block_k: int  # keys per shared-memory tile
    threads: int
    grid: Tuple[int, int, int]  # bf16 (H, row tiles, B): a KV head's g query heads adjacent
    smem_bytes: int


def launch_plan(B: int, H: int, S: int, d: int, dtype: torch.dtype) -> LaunchPlan:
    """The launch plan of the template ``dtype`` selects (no CUDA needed)."""
    row_tiles = -(-S // BLOCK_Q)
    if dtype == torch.bfloat16:
        # Q, then K and V double-buffered: five 64-row tiles, rows padded by 16 bytes
        return LaunchPlan("mma", BLOCK_Q, 64, 128, (H, row_tiles, B), 2 * 5 * BLOCK_Q * (d + 8))
    # Q (rows d+4), one 32-key K tile (rows d+1) and V tile, P (rows 36), all f32
    smem = 4 * (BLOCK_Q * (d + 4) + 32 * (d + 1) + 32 * d + BLOCK_Q * 36)
    return LaunchPlan("fma", BLOCK_Q, 32, 128, (row_tiles, H, B), smem)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("flash_attention").flash_attention_fwd
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [i, i, p, p, p, p, i, i, i, i] + [i64] * 12 + [ctypes.c_float, i, i, i, i, i64, p]
    fn.restype = ctypes.c_int
    return fn


def _check_layout(name: str, t: torch.Tensor) -> None:
    """The kernel loads 16 bytes at a time from each row of the head dim."""
    per16 = 16 // t.element_size()
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name} needs a contiguous head dim")
    if t.data_ptr() % 16 or any(s % per16 for s in t.stride()[:3]):
        raise ValueError(
            f"flash_attention: {name} rows must start 16-byte aligned "
            f"(strides {t.stride()}, {t.dtype})"
        )


def flash_attention(
    q: torch.Tensor,  # [B, H, S, d]
    k: torch.Tensor,  # [B, KV, S, d]
    v: torch.Tensor,  # [B, KV, S, d]
    *,
    causal: bool = True,
) -> torch.Tensor:
    """GQA attention forward; out [B, H, S, d] in q.dtype, laid out like q."""
    global launches
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q [B,H,S,d] and k, v [B,KV,S,d]")
    B, H, S, d = q.shape
    KV = k.shape[1]
    if tuple(k.shape) != (B, KV, S, d) or tuple(v.shape) != (B, KV, S, d):
        raise ValueError(f"k, v must be [{B},KV,{S},{d}], got {tuple(k.shape)}, {tuple(v.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"query heads {H} must be a multiple of kv heads {KV}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dim {HEAD_DIMS}, got {d}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes one of {list(DTYPES)}: {q.dtype}/{k.dtype}/{v.dtype}")
    if B > 65535 or H > 65535 or -(-S // BLOCK_Q) > 65535:
        raise ValueError(f"grid limit: B={B}, H={H}, ceil(S/{BLOCK_Q}) must be <= 65535")
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention kernel needs CUDA tensors on one device, got {q.device}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"flash_attention: {q.device} is not the current CUDA device")
    out = torch.empty_like(q)  # keeps q's layout: a [B,S,H,d] view gives a [B,S,H,d] buffer
    if B * H * S == 0:
        return out
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        _check_layout(name, t)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    plan = launch_plan(B, H, S, d, q.dtype)
    err = _entry()(DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   B, H, KV, S, *strides, 1.0 / math.sqrt(d), int(causal), *plan.grid,
                   plan.smem_bytes, torch.cuda.current_stream().cuda_stream)
    launches += 1
    _build.check("flash_attention", err)
    return out

"""RMSNorm CUDA kernel (``csrc/rmsnorm.cu``) bound with ctypes.

``rmsnorm`` launches the kernel on CUDA tensors and raises on anything it
does not take; ``ops.rmsnorm_op`` is the entry point that also serves CPU
tensors through the plain version.  ``rmsnorm_bwd`` is its gradient (two
kernels: dx, a warp per row up to D 2048 and a block of 256 threads per
row up to D 8192, with per-block f32 column sums of dweight, then a column
reduce), laid out by ``bwd_plan``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last ops.reset_launch_counts()
launches = 0  # forward
bwd_launches = 0  # dx, warp route
bwd_wide_launches = 0  # dx, block route
dweight_launches = 0

BWD_WARP_MAX_DIM = 2048  # warp route: the row lives in one warp's registers, 64 elements a lane
BWD_MAX_DIM = 8192  # block route: the row lives in 256 threads' registers, 32 elements each
WIDE_THREADS = 256


def bwd_warps(D: int, dtype: torch.dtype) -> int:
    """Rows in flight per block, a warp each: 16 where two rows fit a lane's registers."""
    return 16 if D * torch.finfo(dtype).bits // 8 <= 2048 else 8


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How ``rmsnorm_bwd`` is launched; ``csrc/rmsnorm.cu`` refuses any other."""

    rows_per_block: int  # consecutive rows, walked by the block's warps in turn (block: one at a time)
    blocks: int  # also the rows of the f32 dweight partials
    smem_bytes: int  # warp route: each warp's f32 column sums (0 without dweight); block route: 0
    threads: int
    route: str  # "warp": a warp per row, D <= BWD_WARP_MAX_DIM; "block": a block per row


def bwd_plan(T: int, D: int, dtype: torch.dtype = torch.bfloat16, dweight: bool = True) -> BwdPlan:
    """A persistent grid: at most one block per SM, whatever T.  Rows past
    ``BWD_WARP_MAX_DIM`` take the block route, up to ``BWD_MAX_DIM``; wider raise."""
    if D > BWD_MAX_DIM:
        raise ValueError(f"rmsnorm backward kernel keeps a row in one block's registers: "
                         f"D <= {BWD_MAX_DIM}, got {D}")
    if D > BWD_WARP_MAX_DIM:
        blocks = max(1, min(_build.NUM_SMS, T))
        rows_per_block = max(1, -(-T // blocks))
        return BwdPlan(rows_per_block, -(-T // rows_per_block), 0, WIDE_THREADS, "block")
    warps = bwd_warps(D, dtype)
    blocks = max(1, min(_build.NUM_SMS, -(-T // warps)))
    rows_per_block = max(1, -(-T // blocks))
    return BwdPlan(rows_per_block, -(-T // rows_per_block), 4 * warps * D if dweight else 0,
                   32 * warps, "warp")


@functools.lru_cache(maxsize=None)
def _entries():
    lib = _build.load("rmsnorm")
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    fwd, bwd, dweight = lib.rmsnorm_fwd, lib.rmsnorm_bwd, lib.rmsnorm_bwd_dweight
    fwd.argtypes = [i, p, p, p, i64, i64, i64, f, p]
    bwd.argtypes = [i, p, p, p, p, p, i64, i64, i64, i, i, i64, f, p]
    dweight.argtypes = [i, p, p, i, i64, p]
    for fn in (fwd, bwd, dweight):
        fn.restype = ctypes.c_int
    return fwd, bwd, dweight


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """x [T, D] (rows may be strided), weight [D], one dtype (f32 or bf16), on one CUDA device."""
    global launches
    _check_args(x, weight)
    T, D = x.shape
    out = torch.empty((T, D), dtype=x.dtype, device=x.device)
    if T == 0:
        return out
    err = _entries()[0](DTYPES[x.dtype], x.data_ptr(), weight.data_ptr(), out.data_ptr(), T, D,
                        x.stride(0), eps, torch.cuda.current_stream().cuda_stream)
    launches += 1
    _build.check("rmsnorm", err)
    return out


def rmsnorm_bwd(
    x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor, *, eps: float = 1e-5,
    dweight: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dx [T, D], dweight [D] or None) of ``rmsnorm(x, weight)`` for the gradient dy [T, D]."""
    dx, part = rmsnorm_bwd_dx(x, weight, dy, eps=eps, dweight=dweight)
    return dx, rmsnorm_bwd_dweight(part, x.dtype) if dweight else None


def rmsnorm_bwd_dx(
    x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor, *, eps: float = 1e-5,
    dweight: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The first kernel: (dx, f32 dweight partials [blocks, D] or None)."""
    global bwd_launches, bwd_wide_launches
    T, D = x.shape[0], x.shape[-1]
    plan = bwd_plan(T, D, x.dtype, dweight)  # raises past BWD_MAX_DIM
    _check_args(x, weight)
    if tuple(dy.shape) != (T, D) or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must be [{T}, {D}] {x.dtype} on {x.device}")
    dy = dy.contiguous()
    dx = torch.empty((T, D), dtype=x.dtype, device=x.device)
    part = torch.empty((plan.blocks, D), dtype=torch.float32, device=x.device) if dweight else None
    if T == 0:
        return dx, part
    err = _entries()[1](DTYPES[x.dtype], x.data_ptr(), weight.data_ptr(), dy.data_ptr(),
                        dx.data_ptr(), part.data_ptr() if dweight else None, T, D, x.stride(0),
                        plan.rows_per_block, plan.blocks, plan.smem_bytes, eps,
                        torch.cuda.current_stream().cuda_stream)
    if plan.route == "warp":
        bwd_launches += 1
    else:
        bwd_wide_launches += 1
    _build.check("rmsnorm", err)
    return dx, part


def rmsnorm_bwd_dweight(part: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The second kernel: dweight [D] in ``dtype``, the column sums of the partials [blocks, D]."""
    global dweight_launches
    if part.dim() != 2 or part.dtype != torch.float32 or not part.is_contiguous():
        raise ValueError("the partials must be a contiguous [blocks, D] float32 tensor")
    if dtype not in DTYPES:
        raise TypeError(f"rmsnorm takes float32 or bfloat16, got {dtype}")
    if part.device.type != "cuda" or part.device.index != torch.cuda.current_device():
        raise ValueError(f"rmsnorm kernel needs a tensor on the current CUDA device, got {part.device}")
    nparts, D = part.shape
    dw = torch.empty(D, dtype=dtype, device=part.device)
    if nparts == 0 or D == 0:
        return dw
    err = _entries()[2](DTYPES[dtype], part.data_ptr(), dw.data_ptr(), nparts, D,
                        torch.cuda.current_stream().cuda_stream)
    dweight_launches += 1
    _build.check("rmsnorm", err)
    return dw


def _check_args(x: torch.Tensor, weight: torch.Tensor) -> None:
    """Raise on anything the kernels do not take."""
    if x.dim() != 2:
        raise ValueError(f"rmsnorm takes x [T, D], got shape {tuple(x.shape)}")
    T, D = x.shape
    if x.dtype not in DTYPES:
        raise TypeError(f"rmsnorm takes float32 or bfloat16, got {x.dtype}")
    if tuple(weight.shape) != (D,) or weight.dtype != x.dtype:
        raise ValueError(
            f"weight must be [{D}] {x.dtype}, got {tuple(weight.shape)} {weight.dtype}"
        )
    if x.stride(1) != 1 or not weight.is_contiguous():
        raise ValueError("rmsnorm takes x with contiguous rows and a contiguous weight")
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError(f"rmsnorm kernel needs CUDA tensors on one device, got {x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"rmsnorm: {x.device} is not the current CUDA device")

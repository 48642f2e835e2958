"""RMSNorm CUDA kernel (``csrc/rmsnorm.cu``) bound with ctypes.

``rmsnorm`` launches the kernel on CUDA tensors and raises on anything it
does not take; ``ops.rmsnorm_op`` is the entry point that also serves CPU
tensors through the plain version.  ``rmsnorm_bwd`` is its gradient (two
kernels: dx, with per-block f32 column sums of dweight, then a column
reduce), laid out by ``bwd_plan``.  Routes of the dx kernel: ``"warp"``, a
warp per row up to D 2048; past it up to D 8192, ``"ring"``, a block per
row fed by a ring of rows in shared memory, where every row is 16-byte
aligned, else ``"block"``, a block of 256 threads per row through
registers.  The wrappers read the stream raw:
``torch.cuda.current_stream()`` builds an object on every call.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last ops.reset_launch_counts()
launches = 0  # forward
bwd_launches = 0  # dx, warp route
bwd_wide_launches = 0  # dx, past D 2048 (ring and block routes)
dweight_launches = 0
_count_lock = threading.Lock()  # live mode launches the forward from a thread per pool

BWD_WARP_MAX_DIM = 2048  # warp route: the row lives in one warp's registers, 64 elements a lane
BWD_MAX_DIM = 8192  # wider routes: up to 4 16-byte chunks of a row a thread (block: 32 elements)
WIDE_THREADS = 256  # block route
RING_BYTES = 192 * 1024  # ring route: shared memory for the stages (x and dy rows) of one block


def bwd_warps(D: int, dtype: torch.dtype) -> int:
    """Rows in flight per block, a warp each: 16 where two rows fit a lane's registers."""
    return 16 if D * torch.finfo(dtype).bits // 8 <= 2048 else 8


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How ``rmsnorm_bwd`` is launched; ``csrc/rmsnorm.cu`` refuses any other."""

    rows_per_block: int  # consecutive rows, walked by the block's warps in turn (wider: one at a time)
    blocks: int  # also the rows of the f32 dweight partials
    smem_bytes: int  # warp: each warp's f32 column sums (0 without dweight); ring: the stages
    threads: int  # ring: teams x the threads a team gives a row
    route: str  # "warp" (D <= BWD_WARP_MAX_DIM), "ring" or "block": a block per row
    stages: int = 1  # ring: rows (x and dy) in flight in shared memory, a multiple of teams
    ring_chunks: int = 1  # ring: 16-byte chunks of a row each thread takes
    teams: int = 1  # ring: teams of threads taking alternate rows, each a row at a time


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)  # every backward call of the model path asks again
def bwd_plan(T: int, D: int, dtype: torch.dtype = torch.bfloat16, dweight: bool = True,
             aligned: bool = True) -> BwdPlan:
    """A persistent grid: at most one block per SM, whatever T.  Rows past
    ``BWD_WARP_MAX_DIM`` take the ring route up to ``BWD_MAX_DIM`` where every row is
    16-byte aligned (``aligned``: x, w and dy start 16-byte aligned and x's row stride is a
    multiple of 16 bytes; D too), else the block route; wider raise."""
    if D > BWD_MAX_DIM:
        raise ValueError(f"rmsnorm backward kernel keeps a row in one block's registers: "
                         f"D <= {BWD_MAX_DIM}, got {D}")
    if D > BWD_WARP_MAX_DIM:
        blocks = max(1, min(_build.NUM_SMS, T))
        rows_per_block = max(1, _cdiv(T, blocks))
        blocks = _cdiv(T, rows_per_block)
        elem = torch.finfo(dtype).bits // 8
        if not (aligned and D * elem % 16 == 0):
            return BwdPlan(rows_per_block, blocks, 0, WIDE_THREADS, "block")
        # two teams on alternate rows where the block has two; in a team a thread per 16-byte
        # chunk of the row (two past 512 chunks, four past 1024 with one team of 512); as many
        # rows in flight as the ring's bytes hold, at most the block's, a multiple of the teams
        chunks = D * elem // 16
        per_thread = 1 if chunks <= 512 else 2 if chunks <= 1024 else 4
        teams = 2 if per_thread < 4 and rows_per_block >= 2 else 1
        threads = teams * 32 * _cdiv(_cdiv(chunks, per_thread), 32)
        pair = 2 * D * elem
        stages = max(teams, min(rows_per_block, RING_BYTES // pair) // teams * teams)
        return BwdPlan(rows_per_block, blocks, stages * (pair + 8), threads, "ring", stages,
                       per_thread, teams)
    warps = bwd_warps(D, dtype)
    blocks = max(1, min(_build.NUM_SMS, _cdiv(T, warps)))
    rows_per_block = max(1, _cdiv(T, blocks))
    return BwdPlan(rows_per_block, _cdiv(T, rows_per_block), 4 * warps * D if dweight else 0,
                   32 * warps, "warp")


@functools.lru_cache(maxsize=None)
def _entries():
    lib = _build.load("rmsnorm")
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    fwd, bwd, dweight = lib.rmsnorm_fwd, lib.rmsnorm_bwd, lib.rmsnorm_bwd_dweight
    fwd.argtypes = [i, p, p, p, i64, i64, i64, f, p]
    bwd.argtypes = [i, p, p, p, p, p, i64, i64, i64, i, i, i64, i, i, i, i, f, p]
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
                        x.stride(0), eps, torch._C._cuda_getCurrentRawStream(x.device.index))
    with _count_lock:
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
    bwd_plan(T, D, x.dtype, dweight)  # raises past BWD_MAX_DIM
    _check_args(x, weight)
    if tuple(dy.shape) != (T, D) or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must be [{T}, {D}] {x.dtype} on {x.device}")
    dy = dy.contiguous()
    # the route follows the operands, as the kernel's own check does (dx is PyTorch's, aligned)
    aligned = ((x.data_ptr() | weight.data_ptr() | dy.data_ptr()) % 16 == 0
               and x.stride(0) * x.element_size() % 16 == 0)
    plan = bwd_plan(T, D, x.dtype, dweight, aligned)
    dx = torch.empty((T, D), dtype=x.dtype, device=x.device)
    part = torch.empty((plan.blocks, D), dtype=torch.float32, device=x.device) if dweight else None
    if T == 0:
        return dx, part
    err = _entries()[1](DTYPES[x.dtype], x.data_ptr(), weight.data_ptr(), dy.data_ptr(),
                        dx.data_ptr(), part.data_ptr() if dweight else None, T, D, x.stride(0),
                        plan.rows_per_block, plan.blocks, plan.smem_bytes, plan.threads,
                        plan.stages, plan.ring_chunks, plan.teams, eps,
                        torch._C._cuda_getCurrentRawStream(x.device.index))
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
                        torch._C._cuda_getCurrentRawStream(part.device.index))
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

"""Mamba-2 SSD intra-chunk CUDA kernel (``csrc/ssd_scan.cu``) bound with ctypes.

``ssd_intra_chunk`` keeps the TPU kernel's batched contract: x
[BNC, H, Q, hd] (the dt-weighted inputs of every chunk and head), b and c
[BNC, Q, N] (shared by the heads), cum [BNC, H, Q] -> (y [BNC, H, Q, hd]
in x.dtype, state [BNC, H, hd, N] f32).  It launches the kernel on CUDA
tensors and raises on anything it does not take; ``ops.ssd_intra_chunk_op``
also serves CPU tensors through the plain version.  ``launch_plan`` decides
heads per block, grid and shared memory in Python, where the CPU tests
reach it; the kernel refuses a plan that is not its own.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64)  # mamba2-130m's 64 and its reduced config's 32
BLOCK_Q = 64  # rows q per y block and columns j per C·Bᵀ tile

launches = 0  # kernel launches since the last ops.reset_launch_counts()


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call is launched; ``csrc/ssd_scan.cu`` refuses any other."""

    route: str  # "mma": bf16 x, tensor cores; "fma": f32 x, CUDA-core FMAs
    heads_per_block: int  # heads of one y block, which share its C·Bᵀ tiles
    y_blocks: int  # per chunk: row tiles x head groups
    state_blocks: int  # per chunk: heads x column tiles of N
    grid: tuple  # (y_blocks + state_blocks, BNC)
    threads: int
    smem_bytes: int


def launch_plan(BNC: int, H: int, Q: int, hd: int, N: int, dtype: torch.dtype) -> LaunchPlan:
    """The launch plan of the route ``dtype`` selects (no CUDA needed).

    A y block computes each C·Bᵀ tile of its 64 rows once for its group of
    heads.  The group is as large as the route allows (2 heads on the
    tensor cores, 4 on the CUDA cores, whose accumulators sit in
    registers) while the y blocks still fill the card (two per SM on the
    tensor-core route, one on the FMA route); below that it halves,
    trading C·Bᵀ reuse for blocks.
    """
    row_tiles = -(-Q // BLOCK_Q)
    if dtype == torch.bfloat16:
        route, threads, max_heads, per_sm, block_ns = "mma", 128, 2, 2, 128
        # y: C and B slices in bf16 halves [4][64][72], the group's x tiles
        # [2][64][hd+8] and cum [2][64]; state: x·decay and B slices in bf16
        # halves [2][32][hd+8] and [2][32][136]
        smem = max(2 * (4 * 64 * 72 + 2 * 64 * (hd + 8)) + 4 * 2 * 64,
                   2 * (2 * 32 * (hd + 8) + 2 * 32 * 136))
    else:
        route, threads, max_heads, per_sm, block_ns = "fma", 256, 4, 1, 64
        # y: C and B slices transposed [2][32][68], C·Bᵀ [64][65], Sᵀ [64][68],
        # x [64][hd+4], cum [2][64]; state: x·decay [64][hd] and B [64][64], all f32
        smem = max(4 * (2 * 32 * 68 + 64 * 65 + 64 * 68 + 64 * (hd + 4) + 2 * 64),
                   4 * (64 * hd + 64 * 64))
    g = min(max_heads, H)
    while g > 1 and BNC * row_tiles * -(-H // g) < per_sm * _build.NUM_SMS:
        g //= 2
    y_blocks = row_tiles * -(-H // g)
    state_blocks = H * -(-N // block_ns)
    return LaunchPlan(route, g, y_blocks, state_blocks, (y_blocks + state_blocks, BNC), threads,
                      smem)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("ssd_scan").ssd_intra_chunk_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, i, p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_int64, p]
    fn.restype = ctypes.c_int
    return fn


def ssd_intra_chunk(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor, cum: torch.Tensor):
    """Intra-chunk SSD of every (chunk, head); b, c and cum f32, x f32 or bf16, all contiguous."""
    global launches
    if x.dim() != 4 or b.dim() != 3 or c.dim() != 3 or cum.dim() != 3:
        raise ValueError("ssd_intra_chunk takes x [BNC,H,Q,hd], b, c [BNC,Q,N], cum [BNC,H,Q]")
    BNC, H, Q, hd = x.shape
    N = b.shape[2]
    if tuple(b.shape) != (BNC, Q, N) or tuple(c.shape) != (BNC, Q, N):
        raise ValueError(f"b, c must be [{BNC}, {Q}, N], got {tuple(b.shape)}, {tuple(c.shape)}")
    if tuple(cum.shape) != (BNC, H, Q):
        raise ValueError(f"cum must be [{BNC}, {H}, {Q}], got {tuple(cum.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"ssd_intra_chunk kernel takes head dim {HEAD_DIMS}, got {hd}")
    if x.dtype not in DTYPES or any(t.dtype != torch.float32 for t in (b, c, cum)):
        raise TypeError(f"ssd_intra_chunk takes x in {list(DTYPES)} and f32 b, c, cum: "
                        f"{x.dtype}/{b.dtype}/{c.dtype}/{cum.dtype}")
    if BNC > 65535 or H > 65535 or Q >= 2**31 or N >= 2**31:
        raise ValueError(f"grid limit: BNC={BNC}, H={H} must be <= 65535")
    devices = {t.device for t in (x, b, c, cum)}
    if x.device.type != "cuda" or len(devices) != 1:
        raise ValueError(f"ssd_intra_chunk kernel needs CUDA tensors on one device, got {devices}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"ssd_intra_chunk: {x.device} is not the current CUDA device")
    if not all(t.is_contiguous() for t in (x, b, c, cum)):
        raise ValueError("ssd_intra_chunk takes contiguous x, b, c and cum")
    y = torch.empty_like(x)
    state = torch.empty((BNC, H, hd, N), dtype=torch.float32, device=x.device)
    if y.numel() == 0 or N == 0:
        return y.zero_(), state.zero_()
    plan = launch_plan(BNC, H, Q, hd, N, x.dtype)
    if plan.grid[0] >= 2**31:
        raise ValueError(f"grid limit: {plan.grid[0]} blocks per chunk for H={H}, N={N}")
    err = _entry()(DTYPES[x.dtype], hd, x.data_ptr(), b.data_ptr(), c.data_ptr(), cum.data_ptr(),
                   y.data_ptr(), state.data_ptr(), BNC, H, Q, N, plan.heads_per_block,
                   plan.grid[0], plan.smem_bytes, torch.cuda.current_stream().cuda_stream)
    launches += 1
    _build.check("ssd_scan", err)
    return y, state

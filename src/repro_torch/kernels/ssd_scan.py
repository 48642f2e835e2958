"""Mamba-2 SSD intra-chunk CUDA kernel (``csrc/ssd_scan.cu``) bound with ctypes.

``ssd_intra_chunk`` keeps the TPU kernel's batched contract: x
[BNC, H, Q, hd] (the dt-weighted inputs of every chunk and head), b and c
[BNC, Q, N] (shared by the heads), cum [BNC, H, Q] -> (y [BNC, H, Q, hd]
in x.dtype, state [BNC, H, hd, N] f32).  It launches the kernel on CUDA
tensors and raises on anything it does not take; ``ops.ssd_intra_chunk_op``
also serves CPU tensors through the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64)  # mamba2-130m's 64 and its reduced config's 32
MAX_SMEM_BYTES = 232_448  # a Hopper block's dynamic shared memory

launches = 0  # kernel launches since the last ops.reset_launch_counts()


@functools.lru_cache(maxsize=None)
def _entries():
    lib = _build.load("ssd_scan")
    fn = lib.ssd_intra_chunk_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, i, p, p, p, p, p, p, i, i, i, i, p]
    fn.restype = ctypes.c_int
    smem = lib.ssd_intra_chunk_smem_bytes
    smem.argtypes = [i, i]
    smem.restype = ctypes.c_int64
    return fn, smem


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
    fn, smem = _entries()
    if smem(hd, N) > MAX_SMEM_BYTES:
        raise ValueError(f"ssd_intra_chunk: state size N={N} needs {smem(hd, N)} bytes of "
                         f"shared memory, more than {MAX_SMEM_BYTES}")
    err = fn(DTYPES[x.dtype], hd, x.data_ptr(), b.data_ptr(), c.data_ptr(), cum.data_ptr(),
             y.data_ptr(), state.data_ptr(), BNC, H, Q, N, torch.cuda.current_stream().cuda_stream)
    launches += 1
    _build.check("ssd_scan", err)
    return y, state

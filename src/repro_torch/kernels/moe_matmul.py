"""Grouped per-expert matmul CUDA kernel (``csrc/moe_matmul.cu``) bound with ctypes.

``moe_matmul`` launches the kernel on CUDA tensors and raises on anything
it does not take; ``ops.moe_matmul_op`` is the entry point that also
serves CPU tensors through the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches since the last ops.reset_launch_counts()


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("moe_matmul").moe_matmul_fwd
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [ctypes.c_int, p, p, p, i64, i64, i64, i64, p]
    fn.restype = ctypes.c_int
    return fn


def moe_matmul(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """buf [E, C, D] x w [E, D, F] -> [E, C, F] in buf.dtype (f32 or bf16), contiguous, on CUDA."""
    global launches
    if buf.dim() != 3 or w.dim() != 3:
        raise ValueError(f"moe_matmul takes buf [E,C,D] and w [E,D,F], got "
                         f"{tuple(buf.shape)} and {tuple(w.shape)}")
    E, C, D = buf.shape
    F = w.shape[2]
    if tuple(w.shape[:2]) != (E, D):
        raise ValueError(f"w must be [{E}, {D}, F], got {tuple(w.shape)}")
    if buf.dtype not in DTYPES or w.dtype != buf.dtype:
        raise TypeError(f"moe_matmul takes one of {list(DTYPES)}: {buf.dtype}/{w.dtype}")
    if E > 65535 or (C + 63) // 64 > 65535 or max(C, D, F) >= 2**31:
        raise ValueError(f"grid limit: E={E}, C={C}, D={D}, F={F}")
    if buf.device.type != "cuda" or w.device != buf.device:
        raise ValueError(f"moe_matmul kernel needs CUDA tensors on one device, got {buf.device}")
    if buf.device.index != torch.cuda.current_device():
        raise ValueError(f"moe_matmul: {buf.device} is not the current CUDA device")
    if not buf.is_contiguous() or not w.is_contiguous():
        raise ValueError("moe_matmul takes contiguous buf and w")
    out = torch.empty((E, C, F), dtype=buf.dtype, device=buf.device)
    if out.numel() == 0:
        return out
    err = _entry()(DTYPES[buf.dtype], buf.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, D, F,
                   torch.cuda.current_stream().cuda_stream)
    launches += 1
    _build.check("moe_matmul", err)
    return out

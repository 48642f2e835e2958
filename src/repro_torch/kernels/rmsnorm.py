"""RMSNorm CUDA kernel (``csrc/rmsnorm.cu``) bound with ctypes.

``rmsnorm`` launches the kernel on CUDA tensors and raises on anything it
does not take; ``ops.rmsnorm_op`` is the entry point that also serves CPU
tensors through the plain version.
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
    fn = _build.load("rmsnorm").rmsnorm_fwd
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [ctypes.c_int, p, p, p, i64, i64, i64, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """x [T, D] (rows may be strided), weight [D], one dtype (f32 or bf16), on one CUDA device."""
    global launches
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
    out = torch.empty((T, D), dtype=x.dtype, device=x.device)
    if T == 0:
        return out
    err = _entry()(DTYPES[x.dtype], x.data_ptr(), weight.data_ptr(), out.data_ptr(), T, D,
                   x.stride(0), eps, torch.cuda.current_stream().cuda_stream)
    launches += 1
    _build.check("rmsnorm", err)
    return out

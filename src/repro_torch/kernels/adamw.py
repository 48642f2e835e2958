"""The AdamW CUDA kernels (``csrc/adamw.cu``, B9) bound with ctypes.

``adamw_update_`` takes one optimizer step over lists of leaves on one CUDA device:
the global norm of the gradients (``adamw_norm``: per-block f64 partials of the
sum of squares; ``adamw_norm_finish``: their sum in a fixed order, gnorm and the
clip scale into device memory), then the update of every leaf with its moments in
place (``adamw_update``).  Tables of at most ``MAX_LEAVES`` leaves go into a
launch, so a step launches ``step_launches(n)``.  On a mesh the caller passes
each rank's local blocks, which of them count in the norm, and ``reduce``, the sum
over the ranks of the partials, applied between the two norm kernels.
``ops.adamw_update_`` is the entry point that also serves CPU tensors through the
plain version.  Nothing waits for the host.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_LEAVES = 32  # csrc/adamw.cu kMaxLeaves: the leaves of one launch's table
NORM_BLOCKS = 8 * _build.NUM_SMS  # the norm's f64 partials: adamw_norm's grid, one a block

# kernel launches since the last ops.reset_launch_counts()
launches = 0  # the update
norm_launches = 0
finish_launches = 0


def step_launches(leaves: int) -> Dict[str, int]:
    """The launches of one ``adamw_update_`` over ``leaves`` leaves, by counter name."""
    tables = max(1, -(-leaves // MAX_LEAVES))
    return {"adamw_norm": tables, "adamw_norm_finish": 1, "adamw_update": tables}


@functools.lru_cache(maxsize=None)
def _entries():
    lib = _build.load("adamw")
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    ptrs, ints = ctypes.POINTER(p), ctypes.POINTER(i)
    norm, finish, update = lib.adamw_norm, lib.adamw_norm_finish, lib.adamw_update
    norm.argtypes = [i, ptrs, ctypes.POINTER(i64), ints, i, i, p, p]
    finish.argtypes = [p, i, f, p, p]
    update.argtypes = [i, ptrs, ptrs, ptrs, ptrs, ctypes.POINTER(i64), ints, ints, p, p, p, p,
                       f, f, f, f, f, f, p]
    for fn in (norm, finish, update):
        fn.restype = ctypes.c_int
    return norm, finish, update


def _array(ctype, values):
    return (ctype * max(1, len(values)))(*values)


def _check(params, grads, ms, vs, scalars) -> torch.device:
    """Raise on anything the kernels do not take; the device of the step."""
    if not params or not (len(params) == len(grads) == len(ms) == len(vs)):
        raise ValueError("adamw takes equal, non-empty lists of params, grads, m and v")
    dev = params[0].device
    if dev.type != "cuda" or dev.index != torch.cuda.current_device():
        raise ValueError(f"adamw kernel needs tensors on the current CUDA device, got {dev}")
    for p, g, m, v in zip(params, grads, ms, vs):
        if p.dtype not in DTYPES or g.dtype not in DTYPES:
            raise TypeError(f"adamw takes float32 or bfloat16 params and grads, got {p.dtype}, {g.dtype}")
        if m.dtype != torch.float32 or v.dtype != torch.float32:
            raise TypeError("adamw keeps float32 moments")
        if not (p.shape == g.shape == m.shape == v.shape):
            raise ValueError(f"adamw: shapes differ: {p.shape}, {g.shape}, {m.shape}, {v.shape}")
        if any(t.device != dev for t in (g, m, v)):
            raise ValueError("adamw kernel needs every tensor on one device")
        if not (p.is_contiguous() and m.is_contiguous() and v.is_contiguous()):
            raise ValueError("adamw updates contiguous params and moments in place")
    for s in scalars:
        if s.dtype != torch.float32 or s.numel() != 1 or s.device != dev:
            raise ValueError("lr, bc1 and bc2 must be float32 scalars on the step's device")
    return dev


def norm_partials(grads: Sequence[torch.Tensor], counted: Sequence[bool]) -> torch.Tensor:
    """The first kernel: f64 partials [NORM_BLOCKS] of the sum of squares of the counted
    contiguous gradients (a launch a table of MAX_LEAVES leaves, each adding to the last)."""
    global norm_launches
    dev = grads[0].device
    partials = torch.empty(NORM_BLOCKS, dtype=torch.float64, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    for t0 in range(0, len(grads), MAX_LEAVES):
        leaves = [g for g, c in zip(grads[t0:t0 + MAX_LEAVES], counted[t0:t0 + MAX_LEAVES]) if c]
        err = _entries()[0](len(leaves), _array(ctypes.c_void_p, [g.data_ptr() for g in leaves]),
                            _array(ctypes.c_int64, [g.numel() for g in leaves]),
                            _array(ctypes.c_int, [DTYPES[g.dtype] for g in leaves]), int(t0 > 0),
                            NORM_BLOCKS, partials.data_ptr(), stream)
        norm_launches += 1
        _build.check("adamw", err)
    return partials


def norm_finish(partials: torch.Tensor, grad_clip: float) -> torch.Tensor:
    """The second kernel: [gnorm, clip scale] f32 from the partials."""
    global finish_launches
    if partials.dtype != torch.float64 or tuple(partials.shape) != (NORM_BLOCKS,):
        raise ValueError(f"the norm's partials are [{NORM_BLOCKS}] float64")
    out = torch.empty(2, dtype=torch.float32, device=partials.device)
    err = _entries()[1](partials.data_ptr(), NORM_BLOCKS, grad_clip, out.data_ptr(),
                        torch._C._cuda_getCurrentRawStream(partials.device.index))
    finish_launches += 1
    _build.check("adamw", err)
    return out


def update(params, grads, ms, vs, scale: torch.Tensor, lr: torch.Tensor, bc1: torch.Tensor,
           bc2: torch.Tensor, *, beta1: float, beta2: float, eps: float,
           weight_decay: float) -> None:
    """The third kernel: every leaf updated in place, given the f32 device scalars (a launch
    a table of MAX_LEAVES leaves; grads contiguous)."""
    global launches
    stream = torch._C._cuda_getCurrentRawStream(params[0].device.index)
    for t0 in range(0, len(params), MAX_LEAVES):
        table = list(zip(params, grads, ms, vs))[t0:t0 + MAX_LEAVES]
        err = _entries()[2](len(table), *(_array(ctypes.c_void_p, [t[j].data_ptr() for t in table])
                                          for j in range(4)),
                            _array(ctypes.c_int64, [t[0].numel() for t in table]),
                            _array(ctypes.c_int, [DTYPES[t[0].dtype] for t in table]),
                            _array(ctypes.c_int, [DTYPES[t[1].dtype] for t in table]),
                            scale.data_ptr(), lr.data_ptr(), bc1.data_ptr(), bc2.data_ptr(),
                            beta1, 1 - beta1, beta2, 1 - beta2, eps, weight_decay, stream)
        launches += 1
        _build.check("adamw", err)


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
    """One AdamW step in place; -> (gnorm, scale), f32 device scalars.

    ``counted``: the leaves whose squares count in the norm (all by default);
    ``reduce``: sums the f64 partials over the ranks, in place."""
    _check(params, grads, ms, vs, (lr, bc1, bc2))
    grads = [g.contiguous() for g in grads]  # a transposed use hands a strided gradient
    partials = norm_partials(grads, [True] * len(grads) if counted is None else counted)
    if reduce is not None:
        reduce(partials)
    out = norm_finish(partials, grad_clip)
    update(params, grads, ms, vs, out[1:], lr, bc1, bc2, beta1=beta1, beta2=beta2, eps=eps,
           weight_decay=weight_decay)
    return out[0], out[1]

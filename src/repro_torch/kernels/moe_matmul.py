"""Grouped per-expert matmul CUDA kernel (``csrc/moe_matmul.cu``) bound with ctypes.

``moe_matmul`` launches the kernel on CUDA tensors and raises on anything
it does not take; ``ops.moe_matmul_op`` is the entry point that also
serves CPU tensors through the plain version.  ``launch_plan`` decides the
route, tiles, grid and shared memory in Python, where the CPU tests reach
it; the kernel refuses a plan that is not its own.  Routes:

- ``"wgmma"``: bf16 with 16-byte aligned rows and C > 32 (prefill, score):
  128 x 256 tiles where D > F (gate, up), else 128 x 128 (down), on wgmma
  fed by TMA, one persistent block per SM walking the tiles C-tile fastest;
- ``"wgmma_t"``: the same with C <= 32 (decode): the transposed product on
  wgmma, 64 columns of F by 8 rows of C per unit, up to three persistent
  blocks per SM streaming the weights;
- ``"tf32x3"``: f32 with 16-byte aligned rows (D and F multiples of 4): the
  tensor cores in split TF32, three TF32 products of each product's hi / lo
  halves on ``wgmma``, each staged f32 tile split once by its block; 128 x
  128 tiles, 64 x 64 for C <= 64; its launches are also counted apart
  (``tf32x3_launches``);
- ``"masked"``: rows that are not 16-byte aligned, either dtype (f32 on
  CUDA-core FMAs).

``moe_matmul_bwd`` is the gradient: dbuf = dout · wᵀ and dw = bufᵀ · dout,
one launch each, each laid out by ``bwd_plan`` (``"wgmma"``: bf16 on the
forward's TMA conditions, 128-row tiles 64, 128 or 256 columns wide as
``_bwd_tile_n`` weighs the launch, with the operands' major-ness changed;
``"tf32x3"``: f32 on the forward's tf32x3 conditions, its split-TF32
arithmetic on 128 x 128 tiles (64 x 64 where the launch's M <= 64 or 128 x 128
tiles would not fill the SMs) walked by persistent blocks, counted apart
(``tf32x3_dbuf_launches``, ``tf32x3_dw_launches``); ``"fma"``: rows that are
not 16-byte aligned, either dtype, register-blocked CUDA-core FMAs on 128 x 128
tiles, 64 x 64 where those would not fill the SMs).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# index = the C entry points' route id; "fma" is the backward's only
ROUTES = ("wgmma", "wgmma_t", "fma", "masked", "tf32x3")
SMALL_C = 32  # bf16 capacities up to this take the transposed route

# kernel launches since the last ops.reset_launch_counts()
launches = 0  # forward
tf32x3_launches = 0  # the f32 route's forward, within launches
bwd_dbuf_launches = 0
bwd_dw_launches = 0
tf32x3_dbuf_launches = 0  # the f32 route's backward, within bwd_dbuf_launches
tf32x3_dw_launches = 0  # ... and within bwd_dw_launches
last_plan: Optional["LaunchPlan"] = None  # the plan of the last launch, for reports and tests


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call is launched; ``csrc/moe_matmul.cu`` refuses any other."""

    route: str  # one of ROUTES
    block_m: int  # rows of C per output tile
    block_n: int  # columns of F per output tile
    block_k: int  # depth of D per shared-memory stage
    stages: int  # stages in the ring (1: one tile at a time through registers)
    threads: int
    grid: Tuple[int, int, int]  # TMA routes: (persistent blocks, 1, 1); else (F tiles, C tiles, E)
    smem_bytes: int  # per block: dynamic for the TMA routes and tf32x3, the static tiles otherwise
    tiles: int  # output tiles (expert, C tile, F tile) of the call


def _tma_plan(route: str, E: int, C: int, F: int, block_n: int) -> LaunchPlan:
    """A TMA route's plan (``csrc/moe_matmul.cu`` ``WgSmem`` / ``TSmem``)."""
    block_k = 64  # one 128-byte swizzled row of bf16
    if route == "wgmma":
        # as many stages of [128][64] buf and [64][block_n] w tiles as 192 KB
        # hold; two 64 x 64 bf16 staging tiles per consumer warpgroup; barriers
        bm, threads = 128, 3 * 128
        stages = 192 * 1024 // (2 * block_k * (bm + block_n))
        smem = 1024 + stages * 2 * block_k * (bm + block_n) + 2 * 2 * 64 * 64 * 2 + 16 * stages
        grid = min(E * _cdiv(C, bm) * _cdiv(F, block_n), _build.NUM_SMS)  # a persistent block per SM
    else:  # wgmma_t: a ring of [64][64] w and [8][64] buf tiles, two [8][64] staging tiles
        bm, block_n, stages, threads = 8, 64, 7, 128 + 32
        smem = 1024 + stages * 2 * 64 * (block_n + bm) + 2 * bm * block_n * 2 + 16 * stages
        grid = min(E * _cdiv(C, bm) * _cdiv(F, block_n), 3 * _build.NUM_SMS)  # three blocks per SM
    tiles = E * _cdiv(C, bm) * _cdiv(F, block_n)
    return LaunchPlan(route, bm, block_n, block_k, stages, threads, (grid, 1, 1), smem, tiles)


TF_WIDE_N = 128  # the tf32x3 tiles' columns for C > 64 (128 x 64 ran slower)
TF_SMALL_C = 64  # f32 capacities up to this take one warpgroup's 64-row tiles


def _tf_plan(E: int, C: int, F: int) -> LaunchPlan:
    """The tf32x3 route's plan (``csrc/moe_matmul.cu`` ``tf::Shape``): 128 x 128 tiles on two
    warpgroups, 64 x 64 (C <= 64) on one, 32-deep stages loaded two stages ahead into
    registers (``stages`` 2); shared memory holds two sets of hi / lo planes, 4 4 32 (bm + bn)
    bytes, and 1024 to align them."""
    bm, bn = (64, 64) if C <= TF_SMALL_C else (128, TF_WIDE_N)
    smem = 1024 + 4 * 4 * 32 * (bm + bn)
    return LaunchPlan("tf32x3", bm, bn, 32, 2, 2 * bm, (_cdiv(F, bn), _cdiv(C, bm), E),
                      smem, E * _cdiv(C, bm) * _cdiv(F, bn))


@functools.lru_cache(maxsize=None)  # every call of the model path asks again
def launch_plan(E: int, C: int, D: int, F: int, dtype: torch.dtype,
                aligned: bool = True) -> LaunchPlan:
    """The launch plan for buf [E, C, D] x w [E, D, F] (no CUDA needed);
    ValueError past the kernel's grid limits.

    ``aligned``: buf, w and out start 16-byte aligned (contiguous tensors
    from PyTorch's allocator do).  bf16 goes to the TMA routes where every
    row is 16-byte aligned, since TMA needs 16-byte strides; f32 to ``"tf32x3"`` where
    every row is 16-byte aligned.
    """
    if (E > 65535 or _cdiv(C, 64) > 65535 or max(C, D, F) >= 2**31
            or E * _cdiv(C, 8) * _cdiv(F, 64) >= 2**31):
        raise ValueError(f"grid limit: E={E}, C={C}, D={D}, F={F}")
    if dtype == torch.bfloat16 and aligned and D > 0 and D % 8 == 0 and F % 8 == 0:
        if C <= SMALL_C:
            return _tma_plan("wgmma_t", E, C, F, 64)
        # Where buf's rows are longer than w's (D > F: gate and up), 256-column
        # tiles halve how often each buf tile is read; otherwise (down) the
        # weights dominate, and 128-column tiles spread more, finer tiles.
        return _tma_plan("wgmma", E, C, F, 256 if D > F else 128)
    if dtype == torch.float32 and aligned and D % 4 == 0 and F % 4 == 0:
        return _tf_plan(E, C, F)
    elem = 4 if dtype == torch.float32 else 2
    pad = 16 // elem  # [64][32 + pad] buf and [32][64 + pad] w tiles, rows padded by 16 bytes
    smem = (64 * (32 + pad) + 32 * (64 + pad)) * elem
    return LaunchPlan("masked", 64, 64, 32, 1, 128, (_cdiv(F, 64), _cdiv(C, 64), E), smem,
                      E * _cdiv(C, 64) * _cdiv(F, 64))


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How ``moe_matmul_bwd`` launches its two kernels; ``csrc/moe_matmul.cu`` refuses any other.

    Each launch is a ``LaunchPlan`` of out M x N over K: dbuf (C, D, F), dw (D, F, C);
    ``block_m`` / ``block_n`` are its tile's rows and columns, ``block_k`` the depth of a
    stage; the wgmma and tf32x3 routes' grid is (persistent blocks, 1, 1), the fma route's
    (N tiles, M tiles, E) with the static shared memory of its two stages."""

    dbuf: LaunchPlan
    dw: LaunchPlan

    @property
    def route(self) -> str:
        return self.dbuf.route


FMA_BWD_K = 16  # the fma route's stage depth
# blocks an SM that the tf32x3 backward's persistent grid counts on, by tile rows (csrc
# kBwdWideBlocks, kBwdSmallBlocks): 128 x 128 tiles' planes, staging and registers hold one,
# 64 x 64 two
TF_BWD_BLOCKS = {128: 1, 64: 2}
# a 64-deep stage's time on the wgmma route by tile width, in 1/100 us, read on the card at
# granite's four LM products (csrc bwd_tile_n)
BWD_STAGE_COST = {64: 52, 128: 70, 256: 135}


def _bwd_tile_n(E: int, M: int, N: int, K: int) -> int:
    """The wgmma tile width of one backward launch: of 256, 128 and 64 columns, the one
    whose rounds of tiles over the persistent blocks, each weighed by a tile's time
    (K / 64 stages at ``BWD_STAGE_COST``), are least; ties to the wider.  ``bwd_tile_n``
    in the source."""
    nk = _cdiv(K, 64)
    best = None
    for bn in (256, 128, 64):
        rounds = _cdiv(E * _cdiv(M, 128) * _cdiv(N, bn), _build.NUM_SMS)
        cost = rounds * nk * BWD_STAGE_COST[bn]
        if best is None or cost < best[0]:
            best = (cost, bn)
    return best[1]


def _tf_bwd_small(E: int, M: int, N: int) -> bool:
    """The tf32x3 backward's 64 x 64 tiles: where M <= 64 or 128 x 128 tiles would not fill the
    SMs once (the reduced configs).  ``tf_bwd_small`` in the source."""
    return M <= TF_SMALL_C or E * _cdiv(M, 128) * _cdiv(N, TF_WIDE_N) < _build.NUM_SMS


def _bwd_launch(route: str, E: int, M: int, N: int, K: int) -> LaunchPlan:
    """One launch, out M x N over K."""
    if route == "wgmma":  # the forward's kernel shape, over M x N
        return _tma_plan("wgmma", E, M, N, _bwd_tile_n(E, M, N, K))
    if route == "tf32x3":  # the forward's tiles and planes (``_tf_plan``) walked by persistent
        # blocks, and an f32 staging tile for the TMA-stored epilogue
        bm, bn = (64, 64) if _tf_bwd_small(E, M, N) else (128, TF_WIDE_N)
        tiles = E * _cdiv(M, bm) * _cdiv(N, bn)
        return LaunchPlan("tf32x3", bm, bn, 32, 2, 2 * bm,
                          (min(tiles, TF_BWD_BLOCKS[bm] * _build.NUM_SMS), 1, 1),
                          1024 + 4 * 4 * 32 * (bm + bn) + 4 * bm * bn, tiles)
    bm = 128 if E * _cdiv(M, 128) * _cdiv(N, 128) >= _build.NUM_SMS else 64
    # two stages of [16 k][bm + 4] f32 for each operand
    return LaunchPlan("fma", bm, bm, FMA_BWD_K, 2, 256, (_cdiv(N, bm), _cdiv(M, bm), E),
                      2 * 2 * FMA_BWD_K * (bm + 4) * 4, E * _cdiv(M, bm) * _cdiv(N, bm))


@functools.lru_cache(maxsize=None)
def bwd_plan(E: int, C: int, D: int, F: int, dtype: torch.dtype, aligned: bool = True) -> BwdPlan:
    """The backward's plan for buf [E, C, D], w [E, D, F] (no CUDA needed): ``"wgmma"``
    where the forward's TMA conditions hold (bf16, 16-byte aligned bases, D and F multiples
    of 8), ``"tf32x3"`` where its f32 route's hold (16-byte aligned bases, D and F multiples
    of 4), else ``"fma"``.  ``aligned`` is one launch's: dbuf's reads dout and w, dw's buf
    and dout, and each writes its own output, so the two launches of one call may differ."""
    if E > 65535 or _cdiv(C, 64) > 65535 or _cdiv(D, 64) > 65535 or max(C, D, F) >= 2**31:
        raise ValueError(f"grid limit: E={E}, C={C}, D={D}, F={F}")
    route = "fma"
    if aligned and dtype == torch.bfloat16 and D % 8 == 0 and F % 8 == 0:
        route = "wgmma"
    elif aligned and dtype == torch.float32 and D % 4 == 0 and F % 4 == 0:
        route = "tf32x3"
    return BwdPlan(_bwd_launch(route, E, C, D, F), _bwd_launch(route, E, D, F, C))


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("moe_matmul").moe_matmul_fwd
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(i64), p, p, p, i64, i64, i64, i64, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _plan_args(plan: LaunchPlan):
    """``plan`` as the C entry point reads it: route id, block_n, block_k, stages,
    threads, grid x, y, z, shared-memory bytes; built once per plan."""
    return (ctypes.c_int64 * 9)(ROUTES.index(plan.route), plan.block_n, plan.block_k, plan.stages,
                                plan.threads, *plan.grid, plan.smem_bytes)


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    fn = _build.load("moe_matmul").moe_matmul_bwd
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(i64), p, p, p, i64, i64, i64, i64, p]
    fn.restype = ctypes.c_int
    return fn


def _launch(entry, plan: LaunchPlan, buf: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> int:
    """Call a ``moe_matmul_fwd`` entry point with ``plan``; returns its CUDA error code."""
    E, C, D = buf.shape
    return entry(DTYPES[buf.dtype], _plan_args(plan), buf.data_ptr(), w.data_ptr(), out.data_ptr(),
                 E, C, D, w.shape[2], torch._C._cuda_getCurrentRawStream(buf.device.index))


def moe_matmul(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """buf [E, C, D] x w [E, D, F] -> [E, C, F] in buf.dtype (f32 or bf16), contiguous, on CUDA.

    The host work of a call is kept small, as the decode step makes 96 of
    them: the plan and its C arguments are built once per shape, and the
    stream is read raw (``torch.cuda.current_stream()`` builds an object).
    """
    global launches, tf32x3_launches, last_plan
    if buf.dim() != 3 or w.dim() != 3:
        raise ValueError(f"moe_matmul takes buf [E,C,D] and w [E,D,F], got "
                         f"{tuple(buf.shape)} and {tuple(w.shape)}")
    E, C, D = buf.shape
    F = w.shape[2]
    if tuple(w.shape[:2]) != (E, D):
        raise ValueError(f"w must be [{E}, {D}, F], got {tuple(w.shape)}")
    if buf.dtype not in DTYPES or w.dtype != buf.dtype:
        raise TypeError(f"moe_matmul takes one of {list(DTYPES)}: {buf.dtype}/{w.dtype}")
    if not buf.is_cuda or w.device != buf.device:
        raise ValueError(f"moe_matmul kernel needs CUDA tensors on one device, got {buf.device}")
    if buf.device.index != torch.cuda.current_device():
        raise ValueError(f"moe_matmul: {buf.device} is not the current CUDA device")
    if not buf.is_contiguous() or not w.is_contiguous():
        raise ValueError("moe_matmul takes contiguous buf and w")
    # out comes from PyTorch's allocator, 512-byte aligned; the kernel checks all three
    plan = launch_plan(E, C, D, F, buf.dtype, (buf.data_ptr() | w.data_ptr()) % 16 == 0)
    out = torch.empty((E, C, F), dtype=buf.dtype, device=buf.device)
    if out.numel() == 0:
        return out
    err = _launch(_entry(), plan, buf, w, out)
    launches += 1
    tf32x3_launches += plan.route == "tf32x3"
    last_plan = plan
    _build.check("moe_matmul", err)
    return out


def moe_matmul_bwd(
    buf: torch.Tensor, w: torch.Tensor, dout: torch.Tensor, *, dbuf: bool = True, dw: bool = True,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(dbuf [E, C, D] or None, dw [E, D, F] or None) of ``moe_matmul(buf, w)`` for the
    gradient dout [E, C, F]; one kernel launch for each gradient asked for.  All three
    contiguous, of one dtype, on the current CUDA device."""
    global bwd_dbuf_launches, bwd_dw_launches, tf32x3_dbuf_launches, tf32x3_dw_launches
    if buf.dim() != 3 or w.dim() != 3 or dout.dim() != 3:
        raise ValueError("moe_matmul_bwd takes buf [E,C,D], w [E,D,F] and dout [E,C,F]")
    E, C, D = buf.shape
    F = w.shape[2]
    if tuple(w.shape[:2]) != (E, D) or tuple(dout.shape) != (E, C, F):
        raise ValueError(f"w must be [{E}, {D}, F] and dout [{E}, {C}, F], got "
                         f"{tuple(w.shape)} and {tuple(dout.shape)}")
    if buf.dtype not in DTYPES or w.dtype != buf.dtype or dout.dtype != buf.dtype:
        raise TypeError(f"moe_matmul_bwd takes one of {list(DTYPES)}: "
                        f"{buf.dtype}/{w.dtype}/{dout.dtype}")
    if not buf.is_cuda or w.device != buf.device or dout.device != buf.device:
        raise ValueError(f"moe_matmul_bwd kernel needs CUDA tensors on one device, got {buf.device}")
    if buf.device.index != torch.cuda.current_device():
        raise ValueError(f"moe_matmul_bwd: {buf.device} is not the current CUDA device")
    if not (buf.is_contiguous() and w.is_contiguous() and dout.is_contiguous()):
        raise ValueError("moe_matmul_bwd takes contiguous buf, w and dout")
    stream = torch._C._cuda_getCurrentRawStream(buf.device.index)
    outs = []
    for which, want, (a, b), shape in ((0, dbuf, (dout, w), (E, C, D)),
                                       (1, dw, (buf, dout), (E, D, F))):
        if not want:
            outs.append(None)
            continue
        out = torch.empty(shape, dtype=buf.dtype, device=buf.device)
        # each launch's route follows its own operands and output, as the kernel's check does
        plan = bwd_plan(E, C, D, F, buf.dtype,
                        (a.data_ptr() | b.data_ptr() | out.data_ptr()) % 16 == 0)
        if out.numel() and C and F and D:
            lp = plan.dw if which else plan.dbuf
            err = _bwd_entry()(which, DTYPES[buf.dtype], _plan_args(lp), a.data_ptr(), b.data_ptr(),
                               out.data_ptr(), E, C, D, F, stream)
            if which:
                bwd_dw_launches += 1
                tf32x3_dw_launches += lp.route == "tf32x3"
            else:
                bwd_dbuf_launches += 1
                tf32x3_dbuf_launches += lp.route == "tf32x3"
            _build.check("moe_matmul", err)
        else:
            out.zero_()  # an empty reduction
        outs.append(out)
    return outs[0], outs[1]

"""Flash-attention CUDA kernel (``csrc/flash_attention.cu``) bound with ctypes.

``flash_attention`` keeps the TPU kernel's ``[B, H, S, d]`` signature but
takes any strides with a contiguous last dimension, so the model passes
``[B, S, H, d]`` tensors as transposed views and no copy is made.  It
launches the kernel on CUDA tensors and raises on anything the kernel does
not take; ``ops.flash_attention_op`` also serves CPU tensors through the
plain version.  ``launch_plan`` decides the template's tiles, grid and
shared memory in Python, where the CPU tests reach it; the kernel refuses
a plan that is not its own.

The backward (``flash_attention_bwd``, two kernels: dQ, then dK and dV;
bf16 on wgmma fed by TMA) takes the forward's output and its row
log-sum-exp (``lse=True``) and returns the gradients laid out like q, k
and v; ``bwd_plans`` are its launch plans.  ``ops.flash_attention_op``
wires both into autograd.

Port-only B11 is attention over keys of a length of their own (k, v
[B, KV, Sk, d], non-causal): what ``repro/models/layers.py``'s
cross-attention computes for whisper's decoder over its encoder's 1500
frames, which no TPU kernel does (JAX runs it in XLA).  ``cross_attention``
launches an entry of its own, planned by ``cross_plan``: in bf16 a kernel
on wgmma fed by TMA whose blocks split each (batch, head, row tile)'s keys
over a thread-block cluster and combine them in block 0 in a fixed order.
At whisper's prefill the K and V bytes bound it, at its LM shape the
tensor cores' operations (and as many exp2 on the SFUs); B2's template
walked all 1500 keys in one block of 4 warps with mma.sync, and this one
keeps the products asynchronous behind the softmax and splits the keys
where the grid would leave SMs idle.  Its
f32 route is B2's f32 kernel with the key loop over Sk.
``cross_attention_bwd`` in bf16 launches B11's own two kernels, planned by
``cross_bwd_plan``: the row statistics, then one pass of the five products
whose blocks hold key tiles and sum dQ across blocks in a fixed order; in
f32 it launches B5's entry points at Sk (counted as B5's).

Every f32 call of B2, B5 and B11 (but the decode) runs the route ``"tf32x3"``:
kernels of their own on the tensor cores, each f32 product as three TF32
``mma.sync`` products of the operands' hi and lo halves (hi hi + hi lo + lo
hi), which meets the f32 limits that one TF32 product cannot.  Its launches
are also counted apart (``tf32x3_*``), within the counts above.
``flash_decode`` (one query a row against the FLAT [B, Sk, KV*d] caches,
read in place, the keys split over a cluster) is B11's decode form,
planned by ``decode_plan``; all count apart from B2's.
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

# kernel launches since the last ops.reset_launch_counts()
launches = 0  # forward
bwd_dq_launches = 0
bwd_dkdv_launches = 0
cross_launches = 0  # B11: the same kernels at keys of their own length
# the f32 route's kernels ("tf32x3"), within the counts above: forward (B2's and B11's
# entries), dq and dkdv (B5's, B11's f32 backward among them)
tf32x3_launches = 0
tf32x3_bwd_dq_launches = 0
tf32x3_bwd_dkdv_launches = 0
cross_bwd_stats_launches = 0  # B11's bf16 backward: the row statistics, then the one pass
cross_bwd_fused_launches = 0
decode_launches = 0  # B11's decode

BLOCK_Q = 64  # query rows per block, every template


def f32_tile(d: int) -> int:
    """The tf32x3 route's K/V tile keys (forward, dq) and streamed query rows (dkdv):
    64 at d = 64, 32 at d = 128, where two forward blocks still share an SM."""
    return 64 if d == 64 else 32


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call is launched; ``csrc/flash_attention.cu`` refuses any other."""

    route: str  # "mma": bf16 mma.sync; "wgmma": bf16 wgmma fed by TMA; "tf32x3": f32 split-TF32 mma.sync
    block_q: int  # query rows per block (dkdv: per streamed tile)
    block_k: int  # keys per shared-memory tile (dkdv: per block)
    threads: int
    grid: Tuple[int, int, int]  # (H, row tiles, B): a KV head's g query heads adjacent
    smem_bytes: int
    stages: int = 2  # tiles in flight: the cp.async double buffer, or the TMA ring
    splits: int = 1  # B11: blocks (one cluster) sharing a (batch, head, row tile)'s keys
    chunk: int = 0  # B11: keys a split takes (bf16: whole 64-key tiles)


def launch_plan(B: int, H: int, S: int, d: int, dtype: torch.dtype) -> LaunchPlan:
    """The launch plan of the template ``dtype`` selects (no CUDA needed).

    bf16: mma.sync; f32: split-TF32 mma.sync (``"tf32x3"``) at every shape, Q and the K/V
    tiles of ``f32_tile(d)`` keys double-buffered, f32 rows padded so that the fragment loads
    meet no bank conflict.  Both: 4 warps of 16 query rows, grid (H, row tiles, B).
    """
    row_tiles = -(-S // BLOCK_Q)
    if dtype == torch.bfloat16:
        # Q, then K and V double-buffered: five 64-row tiles, rows padded by 16 bytes
        return LaunchPlan("mma", BLOCK_Q, 64, 128, (H, row_tiles, B), 2 * 5 * BLOCK_Q * (d + 8))
    bk = f32_tile(d)
    # f32 rows padded: d + 8 floats where read by rows (Q, K), d + 4 where read by columns (V)
    smem = 4 * (BLOCK_Q * (d + 8) + 2 * bk * (2 * d + 12))
    return LaunchPlan("tf32x3", BLOCK_Q, bk, 128, (H, row_tiles, B), smem)


CROSS_MAX_SPLITS = 8  # the portable thread-block cluster size
CROSS_BLOCKS_PER_SM = 2  # B11 blocks an SM (xa::kBlocksPerSM)


def cross_key_tile(d: int) -> int:
    """Keys of a B11 K/V tile (xa::key_tile): 128 at d = 64, 64 at d = 128."""
    return 128 if d == 64 else 64


def cross_smem(d: int) -> int:
    """Shared memory of a B11 bf16 block (xa::Smem): Q's 64 rows, the ring of K and V
    tiles (later the partials: d/2 + 4 floats a consumer thread), the mbarriers, and
    1024 bytes of alignment slack."""
    stages = 3 if d == 64 else 2
    ring = max(stages * 2 * 2 * cross_key_tile(d) * d, 128 * (d // 2 + 4) * 4)
    return 1024 + 2 * BLOCK_Q * d + ring + 8 * (1 + 2 * stages)


def cross_plan(B: int, H: int, KV: int, S: int, Sk: int, d: int, dtype: torch.dtype) -> LaunchPlan:
    """B11's forward plan (no CUDA needed).

    bf16: a block is one consumer warpgroup of 64 query rows and a producer
    warp; the keys of each (batch, head, row tile) split over a cluster of
    1-8 blocks, each taking whole key tiles and none empty, as many as fit
    one wave of two blocks an SM (a second wave cost more than the splits
    saved, PERF.md); grid (splits, row tiles x H, B), the heads fastest so
    that a KV head's g query heads meet its tiles in L2.
    f32: B2's tf32x3 plan, one block's key loop over all Sk keys.
    """
    if dtype != torch.bfloat16:
        return dataclasses.replace(launch_plan(B, H, S, d, dtype), chunk=Sk)
    bk = cross_key_tile(d)
    row_tiles, key_tiles = -(-S // BLOCK_Q), -(-Sk // bk)
    splits = max(1, min(CROSS_MAX_SPLITS, key_tiles, CROSS_BLOCKS_PER_SM * _build.NUM_SMS // (B * H * row_tiles)))
    tiles = -(-key_tiles // splits)
    splits = -(-key_tiles // tiles)  # no split without a key
    return LaunchPlan("wgmma", BLOCK_Q, bk, 160, (splits, row_tiles * H, B), cross_smem(d),
                      3 if d == 64 else 2, splits, bk * tiles)


CROSS_BWD_STAGES = 2  # Q and dO tiles in flight (xa::BwdSmem::ST)
CROSS_BWD_STATS_THREADS = 256  # xa::kStatsThreads


@dataclasses.dataclass(frozen=True)
class CrossBwdPlan:
    """How B11's bf16 backward is launched; ``csrc/flash_attention.cu`` refuses any other."""

    warpgroups: int  # consumer warpgroups a block, 64 keys each
    block_k: int  # keys a block holds at a time (one key tile)
    key_tiles: int
    splits: int  # blocks sharing a (batch, KV head)'s key tiles, block r taking r, r + splits, ...
    tiles_per_block: int  # the most key tiles a block walks
    rows: int  # dQ partial rows a block keeps: g query heads of S padded to 64
    region: str  # where a block's partials live: "smem", or "global" (its slice of the scratch)
    threads: int
    grid: Tuple[int, int, int]  # (splits, KV, B)
    smem_bytes: int
    stats_blocks: int  # the statistics pass: 256 threads, 32 / (d / 8) rows a warp


def cross_bwd_smem(d: int, rows: int = 0) -> int:
    """Shared memory of a B11 backward block (xa::BwdSmem) without the dQ partials, plus
    ``rows`` of them: K and V of the key tile, the ring of Q and dO tiles, the dS^T tile,
    at two warpgroups two slots of the f32 dQ partial one hands the other, the ring's lse and D rows,
    the mbarriers and a flag, 1024 bytes of alignment slack."""
    bk, st = (128 if d == 64 else 64), CROSS_BWD_STAGES
    passed = 2 * 4 * 64 * d if bk == 128 else 0  # two slots of one warpgroup's f32 dQ partial
    return (1024 + 2 * 2 * bk * d + st * 2 * 2 * 64 * d + 2 * bk * 64 + passed + st * 2 * 4 * 64
            + 8 * (6 + 2 * st) + 16 + 4 * d * rows)


def cross_bwd_plan(B: int, H: int, KV: int, S: int, Sk: int, d: int) -> CrossBwdPlan:
    """B11's bf16 backward plan (no CUDA needed).

    Blocks hold keys: 128 at d = 64 (two consumer warpgroups), 64 at d = 128 (one: its dK
    and dV alone are 128 f32 registers a thread), one block an SM.  A (batch, KV head)'s
    key tiles are shared by ``splits`` <= 8 blocks, block r taking tiles r, r + splits,
    ...; splits is the count that least multiplies the waves of the grid (splits KV B
    blocks over the SMs) by the tiles a block walks, the smallest of equals.  Each block
    keeps the f32 dQ partials of every query row of the KV head's g heads: in shared
    memory where they fit beside the tiles, else in its slice of a global scratch of
    ``splits`` rows a query row (its size does not grow with Sk), where blocks also leave
    them for the last one to sum past one split.  Every bf16 shape takes this plan.
    """
    wgs = 2 if d == 64 else 1
    bk = 64 * wgs
    key_tiles = -(-Sk // bk)
    pairs = B * KV

    def cost(n):
        return -(-n * pairs // _build.NUM_SMS) * -(-key_tiles // n)

    splits = min(range(1, min(CROSS_MAX_SPLITS, key_tiles) + 1), key=lambda n: (cost(n), n))
    rows = H // KV * -(-S // BLOCK_Q) * BLOCK_Q
    smem = cross_bwd_smem(d, rows)
    region = "smem" if smem <= _build.MAX_SMEM_BYTES else "global"
    if region == "global":
        smem = cross_bwd_smem(d)
    rows_per_block = CROSS_BWD_STATS_THREADS // 32 * (32 // (d // 8))
    return CrossBwdPlan(wgs, bk, key_tiles, splits, -(-key_tiles // splits), rows, region,
                        128 * wgs + (128 if wgs == 2 else 32), (splits, KV, B), smem,
                        -(-(B * H * S) // rows_per_block))


def dq_warpgroups(S: int) -> int:
    """Consumer warpgroups (64 rows each) of a bf16 dq block."""
    return 2 if S > 256 else 1


def dkdv_warpgroups(Sk: int, d: int) -> int:
    """Consumer warpgroups (64 keys each) of a bf16 dkdv block, by the key length it
    tiles; one at d = 128, where the dK and dV accumulators alone are 128 f32
    registers a thread."""
    return 2 if Sk > 256 and d == 64 else 1


def bwd_plans(B: int, H: int, KV: int, S: int, d: int, dtype: torch.dtype, Sk: int | None = None):
    """(dq plan, dkdv plan) of the backward kernels (no CUDA needed); ``Sk``: the
    keys' length (None: S).

    dq: one block per (query head, row tile of S), grid (H, row tiles, B).
    dkdv: one block per (KV head, key tile of Sk), grid (key tiles, KV, B).
    bf16 blocks are 64-row consumer warpgroups plus one producer warp:
    two warpgroups (128-row dq tiles past S = 256; 128-key dkdv tiles at d
    = 64 past Sk = 256), one below, so that the GRPO shape still fills the card.
    f32 (``"tf32x3"``, every shape): 4 warps; dq holds 64 query rows (Q, dO), 16 a warp,
    and streams K/V tiles of ``f32_tile(d)`` keys; dkdv holds 64 keys (K, V), 16 a warp, or
    32 where 64-key blocks would leave SMs idle (``f32_dkdv_keys``), and streams query
    tiles of ``f32_tile(d)`` rows with their lse log2(e) and D rows; both double-buffered.
    """
    Sk = S if Sk is None else Sk
    if dtype == torch.bfloat16:
        stages = 3 if d == 64 else 2
        bars = 8 * (1 + 2 * stages)  # mbarriers: resident tiles, full[stages], empty[stages]
        wq, wk = dq_warpgroups(S), dkdv_warpgroups(Sk, d)
        bq, bk = 64 * wq, 64 * wk
        # 1024 bytes of alignment slack; swizzled bf16 tiles of d columns (2 bytes each).
        # dq: Q and dO of bq rows, a ring of 64-key K and V tiles, 16 f32 D values per warp.
        dq = 1024 + 2 * 2 * bq * d + stages * 2 * 2 * 64 * d + bars + 4 * 64 * wq
        # dkdv: K and V of bk keys, a ring of 64-row Q and dO tiles with their f32 lse and D.
        dkdv = 1024 + 2 * 2 * bk * d + stages * (2 * 2 * 64 * d + 2 * 4 * 64) + bars
        return (LaunchPlan("wgmma", bq, 64, 128 * wq + 32, (H, -(-S // bq), B), dq, stages),
                LaunchPlan("wgmma", 64, bk, 128 * wk + 32, (-(-Sk // bk), KV, B), dkdv, stages))
    bt, kb = f32_tile(d), f32_dkdv_keys(Sk, KV, B)
    dq = 4 * (d + 8) * (2 * BLOCK_Q + 4 * bt)  # rows of d + 8 floats
    dkdv = 4 * (2 * kb * (d + 8) + 4 * bt * (d + 9))
    return (LaunchPlan("tf32x3", BLOCK_Q, bt, 128, (H, -(-S // BLOCK_Q), B), dq),
            LaunchPlan("tf32x3", bt, kb, 128, (-(-Sk // kb), KV, B), dkdv))


def f32_dkdv_keys(Sk: int, KV: int, B: int) -> int:
    """Keys a tf32x3 dkdv block owns: 64, or 32 where 64-key blocks would leave SMs without
    one (two warps then share 16 keys, each taking half of every query tile)."""
    return 64 if -(-Sk // 64) * KV * B >= _build.NUM_SMS else 32


DECODE_WARPS = 4
DECODE_MAX_SPLITS = 8  # the portable thread-block cluster size
DECODE_KEYS_PER_SPLIT = 128  # fewest keys worth a block of their own


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """How one ``flash_decode`` call is launched; the kernel refuses any other."""

    rows: int  # query rows a block takes: g where it is 1 or 2, else tiles of 4
    splits: int  # blocks (one cluster) sharing a (row, KV head, row tile)'s keys
    chunk: int  # keys a split takes
    threads: int
    grid: Tuple[int, int, int]  # (splits, KV x row tiles, B)
    smem_bytes: int  # static: each warp's partial max, sum and P V per row


def decode_plan(B: int, H: int, KV: int, n: int, d: int) -> DecodePlan:
    """The decode kernel's plan over ``n`` keys (no CUDA needed): as many splits as
    give four blocks an SM, at most a cluster's 8 and no fewer than 128 keys each."""
    g = H // KV
    rows = 1 if g == 1 else 2 if g == 2 else 4
    tiles = -(-g // rows)
    pairs = B * KV * tiles
    splits = max(1, min(DECODE_MAX_SPLITS, -(-n // DECODE_KEYS_PER_SPLIT),
                        -(-DECODE_WARPS * _build.NUM_SMS // pairs)))
    chunk = -(-n // splits)
    splits = -(-n // chunk)  # no split without a key
    return DecodePlan(rows, splits, chunk, 32 * DECODE_WARPS, (splits, KV * tiles, B),
                      4 * DECODE_WARPS * rows * (2 + d))


@functools.lru_cache(maxsize=None)
def _entries():
    lib = _build.load("flash_attention")
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    fwd = lib.flash_attention_fwd
    fwd.argtypes = [i, i, p, p, p, p, p, i, i, i, i, i] + [i64] * 12 + [f, i, i, i, i, i64, p]
    # dq: q k v o dout lse delta dq; dkdv: q k v dout lse delta dk dv
    bwd = (lib.flash_attention_bwd_dq, lib.flash_attention_bwd_dkdv)
    for fn in bwd:
        fn.argtypes = [i, i] + [p] * 8 + [i, i, i, i, i, p, f, i, i, i, i, i64, p]
    dec = lib.flash_attention_decode
    dec.argtypes = [i, i, p, p, p, p, i, i, i, i] + [i64] * 6 + [f, i, i, i, i, i, p]
    cross = lib.flash_attention_cross_fwd
    cross.argtypes = [i, i, p, p, p, p, p, i, i, i, i, i] + [i64] * 12 + [f] + [i] * 6 + [i64, p]
    stats = lib.flash_attention_cross_bwd_stats  # o dout lse stats counters
    stats.argtypes = [i] + [p] * 5 + [i, i, i, i] + [i64] * 6 + [i, p]
    fused = lib.flash_attention_cross_bwd  # q k v dout stats dq dk dv scratch counters
    fused.argtypes = [i] + [p] * 10 + [i, i, i, i, i, p, f, i, i, i, i, i, i64, p]
    for fn in (fwd, *bwd, dec, cross, stats, fused):
        fn.restype = ctypes.c_int
    return fwd, *bwd, dec, cross, stats, fused


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
    k: torch.Tensor,  # [B, KV, Sk, d]
    v: torch.Tensor,  # [B, KV, Sk, d]
    *,
    causal: bool = True,
    lse: bool = False,
):
    """GQA attention forward (B2); out [B, H, S, d] in q.dtype, laid out like q.

    With ``lse`` it returns (out, lse [B, H, S] f32), the natural-log
    log-sum-exp of each row's scaled scores, which the backward needs.
    bf16 keys of another length than q's go to ``cross_attention``; f32
    ones are taken non-causal.
    """
    global launches
    if q.dim() == 4 and k.dim() == 4 and q.dtype == torch.bfloat16 and k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention: bf16 keys of their own length ({k.shape[2]}, q has "
                         f"{q.shape[2]}) are cross_attention's")
    out, row_lse, launched = _forward(q, k, v, causal, lse, cross=False)
    launches += launched
    return (out, row_lse) if lse else out


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, lse: bool = False):
    """B11: non-causal attention of q [B, H, S, d] over k, v [B, KV, Sk, d] of any
    length, through its own entry point and ``cross_plan``, counted apart from B2's
    launches; returns as ``flash_attention`` does."""
    global cross_launches
    out, row_lse, launched = _forward(q, k, v, False, lse, cross=True)
    cross_launches += launched
    return (out, row_lse) if lse else out


def _forward(q, k, v, causal: bool, lse: bool, cross: bool):
    """-> (out, lse or None, 1 if the kernel launched else 0), by B2's entry or (``cross``)
    B11's."""
    global tf32x3_launches
    _check_args(q, k, v, causal)
    B, H, S, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)  # keeps q's layout: a [B,S,H,d] view gives a [B,S,H,d] buffer
    row_lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if lse else None
    if B * H * S == 0:
        return out, row_lse, 0
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        _check_layout(name, t)
    args = [DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            row_lse.data_ptr() if lse else None, B, H, KV, S, Sk,
            *[s for t in (q, k, v, out) for s in t.stride()[:3]], 1.0 / math.sqrt(d)]
    if cross:
        plan = cross_plan(B, H, KV, S, Sk, d, q.dtype)
        args += [plan.block_q, plan.splits, plan.chunk]
    else:
        plan = launch_plan(B, H, S, d, q.dtype)
        args.append(int(causal))
    err = _entries()[4 if cross else 0](*args, *plan.grid, plan.smem_bytes,
                                        torch._C._cuda_getCurrentRawStream(q.device.index))
    tf32x3_launches += plan.route == "tf32x3"
    _build.check("flash_attention", err)
    return out, row_lse, 1


def flash_attention_bwd(
    q: torch.Tensor,  # [B, H, S, d]
    k: torch.Tensor,  # [B, KV, Sk, d]
    v: torch.Tensor,  # [B, KV, Sk, d]
    out: torch.Tensor,  # [B, H, S, d], the forward's
    lse: torch.Tensor,  # [B, H, S] f32, the forward's
    dout: torch.Tensor,  # [B, H, S, d]
    *,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv), each laid out like q, k and v: the dq kernel, then the dkdv kernel."""
    dout = _kernel_dout(dout)
    dq, delta = flash_attention_bwd_dq(q, k, v, out, lse, dout, causal=causal)
    return (dq, *flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, causal=causal))


def _kernel_dout(dout: torch.Tensor) -> torch.Tensor:
    """dout as the kernels read it: 16-byte rows, no zero stride (no tensor map takes one)."""
    try:
        _check_layout("dout", dout)
        if 0 in dout.stride():  # a broadcast gradient
            dout = dout.contiguous()
    except ValueError:
        dout = dout.contiguous()
    return dout


def cross_attention_bwd(q, k, v, out, lse, dout):
    """B11's backward -> (dq, dk, dv) laid out like q, k and v.

    bf16: ``cross_attention_bwd_stats`` then ``cross_attention_bwd_fused``, B11's own
    kernels.  f32: B5's dq and dkdv kernels at Sk (the tf32x3 route), counted as B5's.
    """
    dout = _kernel_dout(dout)
    if q.dtype != torch.bfloat16:
        return flash_attention_bwd(q, k, v, out, lse, dout, causal=False)
    stats, counters = cross_attention_bwd_stats(q, k, v, out, lse, dout)
    return cross_attention_bwd_fused(q, k, v, dout, stats, counters)


def _check_b5_keys(q, k) -> None:
    """B5's bf16 kernels take keys of q's own length; others are cross_attention_bwd's."""
    if q.dim() == 4 and k.dim() == 4 and q.dtype == torch.bfloat16 and k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention_bwd: bf16 keys of their own length ({k.shape[2]}, q has "
                         f"{q.shape[2]}) are cross_attention_bwd's")


def _check_bwd_inputs(q, k, v, out, lse, dout, causal: bool) -> None:
    _check_args(q, k, v, causal)
    if tuple(out.shape) != tuple(q.shape) or tuple(dout.shape) != tuple(q.shape):
        raise ValueError(f"out and dout must be {tuple(q.shape)}: {tuple(out.shape)}, {tuple(dout.shape)}")
    if out.dtype != q.dtype or dout.dtype != q.dtype or out.device != q.device or dout.device != q.device:
        raise TypeError("out and dout must have q's dtype and device")
    _check_lse(lse, *q.shape[:3])


def cross_attention_bwd_stats(q, k, v, out, lse, dout):
    """B11's bf16 backward, first kernel -> (stats [2, B, H, stats_row(S)] f32: D =
    rowsum(dout * out), then the lse times log2(e), of every query row; the second
    kernel's counters, [B, KV, splits] int32 zeroed here, or None at one split)."""
    global cross_bwd_stats_launches
    _check_bwd_inputs(q, k, v, out, lse, dout, False)
    if q.dtype != torch.bfloat16:
        raise TypeError("cross_attention_bwd_stats is the bf16 route's (f32 runs B5's kernels)")
    B, H, S, d = q.shape
    KV = k.shape[1]
    stats = torch.empty((2, B, H, stats_row(S)), dtype=torch.float32, device=q.device)
    if B * H * S == 0:
        return stats, None
    for name, t in (("out", out), ("dout", dout)):
        _check_layout(name, t)
    plan = cross_bwd_plan(B, H, KV, S, k.shape[2], d)
    counters = (torch.empty((B, KV, plan.splits), dtype=torch.int32, device=q.device)
                if plan.splits > 1 else None)
    err = _entries()[5](d, out.data_ptr(), dout.data_ptr(), lse.data_ptr(), stats.data_ptr(),
                        None if counters is None else counters.data_ptr(),
                        0 if counters is None else counters.numel(), B, H, S,
                        *out.stride()[:3], *dout.stride()[:3], plan.stats_blocks,
                        torch._C._cuda_getCurrentRawStream(q.device.index))
    cross_bwd_stats_launches += 1
    _build.check("flash_attention", err)
    return stats, counters


def cross_attention_bwd_fused(q, k, v, dout, stats, counters):
    """B11's bf16 backward, second kernel: dq, dk and dv in one pass over the scored pairs
    (``cross_bwd_plan``), reading the stats and counters of ``cross_attention_bwd_stats``
    -> (dq, dk, dv) laid out like q, k and v."""
    global cross_bwd_fused_launches
    _check_args(q, k, v, False)
    if q.dtype != torch.bfloat16:
        raise TypeError("cross_attention_bwd_fused is the bf16 route's (f32 runs B5's kernels)")
    B, H, S, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if tuple(dout.shape) != tuple(q.shape) or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError(f"dout must be {tuple(q.shape)} {q.dtype} on {q.device}")
    if tuple(stats.shape) != (2, B, H, stats_row(S)) or stats.dtype != torch.float32 \
            or not stats.is_contiguous() or stats.device != q.device:
        raise ValueError(f"stats must be cross_attention_bwd_stats' [2,{B},{H},{stats_row(S)}] float32")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if B * H * S == 0:
        return dq, dk, dv
    for name, t in (("q", q), ("k", k), ("v", v), ("dout", dout), ("dq", dq), ("dk", dk), ("dv", dv)):
        _check_layout(name, t)
    plan = cross_bwd_plan(B, H, KV, S, Sk, d)
    if plan.splits > 1 and (counters is None or tuple(counters.shape) != (B, KV, plan.splits)
                            or counters.dtype != torch.int32 or counters.device != q.device):
        raise ValueError(f"counters must be cross_attention_bwd_stats' [{B},{KV},{plan.splits}] int32")
    scratch = (torch.empty((plan.splits, B, KV, plan.rows, d), dtype=torch.float32, device=q.device)
               if plan.splits > 1 or plan.region == "global" else None)
    err = _entries()[6](d, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), stats.data_ptr(),
                        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                        None if scratch is None else scratch.data_ptr(),
                        counters.data_ptr() if plan.splits > 1 else None, B, H, KV, S, Sk,
                        _strides(q, k, v, dout, dout, dq, dk, dv), 1.0 / math.sqrt(d), plan.rows,
                        int(plan.region == "smem"), *plan.grid, plan.smem_bytes,
                        torch._C._cuda_getCurrentRawStream(q.device.index))
    cross_bwd_fused_launches += 1
    _build.check("flash_attention", err)
    return dq, dk, dv


def stats_row(S: int) -> int:
    """The backward's per-row statistics rows, padded to 16 bytes for TMA."""
    return -(-S // 4) * 4


def flash_attention_bwd_dq(q, k, v, out, lse, dout, *, causal: bool = True):
    """-> (dq laid out like q, stats [2, B, H, stats_row(S)] f32).

    stats[0, ..., :S] is delta = rowsum(dout * out); stats[1] holds the lse
    times log2(e), which the dkdv kernel reads.
    """
    global bwd_dq_launches, tf32x3_bwd_dq_launches
    B, H, S, d = q.shape
    _check_b5_keys(q, k)
    _check_bwd_inputs(q, k, v, out, lse, dout, causal)
    dq = torch.empty_like(q)
    delta = torch.empty((2, B, H, stats_row(S)), dtype=torch.float32, device=q.device)
    if B * H * S == 0:
        return dq, delta
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout), ("dq", dq)):
        _check_layout(name, t)
    plan = bwd_plans(B, H, k.shape[1], S, d, q.dtype, k.shape[2])[0]
    err = _entries()[1](DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        dq.data_ptr(), B, H, k.shape[1], S, k.shape[2],
                        _strides(q, k, v, out, dout, dq), 1.0 / math.sqrt(d), int(causal),
                        *plan.grid, plan.smem_bytes, torch._C._cuda_getCurrentRawStream(q.device.index))
    bwd_dq_launches += 1
    tf32x3_bwd_dq_launches += plan.route == "tf32x3"
    _build.check("flash_attention", err)
    return dq, delta


def flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, *, causal: bool = True):
    """-> (dk, dv) laid out like k and v; ``delta``: the stats of ``flash_attention_bwd_dq``."""
    global bwd_dkdv_launches, tf32x3_bwd_dkdv_launches
    B, H, S, d = q.shape
    _check_b5_keys(q, k)
    _check_args(q, k, v, causal)
    _check_lse(lse, B, H, S)
    if tuple(delta.shape) != (2, B, H, stats_row(S)) or delta.dtype != torch.float32 \
            or not delta.is_contiguous():
        raise ValueError(f"delta must be flash_attention_bwd_dq's [2,{B},{H},{stats_row(S)}] float32 stats")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if B * H * S == 0:
        return dk, dv
    for name, t in (("q", q), ("k", k), ("v", v), ("dout", dout), ("dk", dk), ("dv", dv)):
        _check_layout(name, t)
    plan = bwd_plans(B, H, k.shape[1], S, d, q.dtype, k.shape[2])[1]
    err = _entries()[2](DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                        dv.data_ptr(), B, H, k.shape[1], S, k.shape[2],
                        _strides(q, k, v, dout, dout, dout, dk, dv), 1.0 / math.sqrt(d),
                        int(causal), *plan.grid, plan.smem_bytes,
                        torch._C._cuda_getCurrentRawStream(q.device.index))
    bwd_dkdv_launches += 1
    tf32x3_bwd_dkdv_launches += plan.route == "tf32x3"
    _build.check("flash_attention", err)
    return dk, dv


def flash_decode(
    q: torch.Tensor,  # [B, H, 1, d], any strides with a contiguous d
    k_cache: torch.Tensor,  # FLAT [B, Sk, KV*d]
    v_cache: torch.Tensor,  # FLAT [B, Sk, KV*d]
    n: int,
) -> torch.Tensor:
    """B11's decode: one query a row against the first ``n`` keys of the FLAT caches,
    read in place in their own dtype -> out [B, 1, H*d] in q.dtype, the layout ``wo``
    takes."""
    global decode_launches
    _check_decode(q, k_cache, v_cache, n)
    B, H, _, d = q.shape
    KV = k_cache.shape[2] // d
    out = torch.empty((B, 1, H * d), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    plan = decode_plan(B, H, KV, n, d)
    err = _entries()[3](DTYPES[q.dtype], d, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                        out.data_ptr(), B, H, KV, n, q.stride(0), q.stride(1), k_cache.stride(0),
                        k_cache.stride(1), v_cache.stride(0), v_cache.stride(1), 1.0 / math.sqrt(d),
                        plan.rows, plan.chunk, *plan.grid,
                        torch._C._cuda_getCurrentRawStream(q.device.index))
    decode_launches += 1
    _build.check("flash_attention", err)
    return out


def _strides(q, k, v, out, dout, dq, dk=None, dv=None):
    """The backward entries' 24 (b, h, s) strides: q, k, v, o, dout, dq, dk, dv."""
    ts = (q, k, v, out, dout, dq, dk if dk is not None else k, dv if dv is not None else v)
    return (ctypes.c_int64 * 24)(*[s for t in ts for s in t.stride()[:3]])


def _check_lse(t: torch.Tensor, B: int, H: int, S: int) -> None:
    if tuple(t.shape) != (B, H, S) or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"lse must be contiguous [{B},{H},{S}] float32")


def _check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> None:
    """Raise on anything the kernels do not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q [B,H,S,d] and k, v [B,KV,Sk,d]")
    B, H, S, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, KV, Sk, d) or tuple(v.shape) != (B, KV, Sk, d):
        raise ValueError(f"k, v must be [{B},KV,Sk,{d}], got {tuple(k.shape)}, {tuple(v.shape)}")
    if causal and Sk != S:
        raise ValueError(f"causal attention masks by the sequence index: keys {Sk} must be q's {S}")
    if S > 0 and Sk == 0:
        raise ValueError("flash_attention needs at least one key")
    _check_heads(H, KV, d, q, k, v)
    if -(-S // BLOCK_Q) * H > 65535:
        raise ValueError(f"grid limit: ceil(S/{BLOCK_Q}) * H must be <= 65535")


def _check_heads(H: int, KV: int, d: int, *ts: torch.Tensor) -> None:
    """Heads, head dim, dtype and device, as both entry points take them."""
    if KV == 0 or H % KV:
        raise ValueError(f"query heads {H} must be a multiple of kv heads {KV}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dim {HEAD_DIMS}, got {d}")
    if ts[0].dtype not in DTYPES or any(t.dtype != ts[0].dtype for t in ts):
        raise TypeError(f"flash_attention takes one of {list(DTYPES)}: {[t.dtype for t in ts]}")
    if ts[0].shape[0] > 65535 or H > 65535:
        raise ValueError(f"grid limit: B={ts[0].shape[0]}, H={H} must be <= 65535")
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"flash_attention kernel needs CUDA tensors on one device, got {dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"flash_attention: {dev} is not the current CUDA device")


def _check_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n: int) -> None:
    """Raise on anything the decode kernel does not take."""
    if q.dim() != 4 or q.shape[2] != 1 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"flash_decode takes q [B,H,1,d] and FLAT caches [B,Sk,KV*d]: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, d = q.shape
    if k.shape[0] != B or k.shape[2] % d:
        raise ValueError(f"caches {tuple(k.shape)} must be [{B}, Sk, KV*{d}]")
    if not 1 <= n <= k.shape[1]:
        raise ValueError(f"flash_decode attends 1..{k.shape[1]} keys, got {n}")
    _check_heads(H, k.shape[2] // d, d, q, k, v)
    per16 = 16 // q.element_size()  # 16-byte loads of each row's head slice
    for name, t, strides in (("q", q, q.stride()[:2]), ("k_cache", k, k.stride()[:2]),
                             ("v_cache", v, v.stride()[:2])):
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(s % per16 for s in strides):
            raise ValueError(f"flash_decode: {name} rows must be contiguous and start 16-byte "
                             f"aligned (strides {t.stride()}, {t.dtype})")

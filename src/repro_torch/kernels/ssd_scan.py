"""Mamba-2 SSD intra-chunk CUDA kernel (``csrc/ssd_scan.cu``) bound with ctypes.

``ssd_intra_chunk`` keeps the TPU kernel's batched contract: x
[BNC, H, Q, hd] (the dt-weighted inputs of every chunk and head), b and c
[BNC, Q, N] (shared by the heads), cum [BNC, H, Q] -> (y [BNC, H, Q, hd]
in x.dtype, state [BNC, H, hd, N] f32).  It launches the kernel on CUDA
tensors and raises on anything it does not take; ``ops.ssd_intra_chunk_op``
also serves CPU tensors through the plain version.  ``launch_plan`` decides
heads per block, grid and shared memory in Python, where the CPU tests
reach it; the kernel refuses a plan that is not its own.  Every product runs
on the tensor cores with f32 operands split into bf16 pieces: two on bf16 x
(``"mma"``), three of every operand on f32 x (``"mma3"``), whose launches are
also counted apart (``mma3_launches``).

``ssd_intra_chunk_bwd`` is the gradient (dx, db, dc, dcum) for dy and dstate,
in two launches laid out by ``bwd_plan``, every product on the tensor cores
with f32 operands split into bf16 pieces: a main block per (head group,
chunk, 64-column tile) computes each C·Bᵀ tile once for its group and dx per
head, and stores the group's Σ dM∘L into an f32 scratch; the reduce sums
the groups in a fixed order and multiplies by B and C once per chunk for dc
and db.
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

# kernel launches since the last ops.reset_launch_counts()
launches = 0  # forward
mma3_launches = 0  # the f32 route's forward, within launches
bwd_launches = 0
bwd_reduce_launches = 0
BWD_MAX_STATE = 128  # the reduce stages a tile's rows of B or C whole
SM_SMEM_BYTES = 233_472  # shared memory of one H100 SM (228 KB); each resident block takes 1 KB more


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call is launched; ``csrc/ssd_scan.cu`` refuses any other."""

    route: str  # "mma": bf16 x, f32 operands in two bf16 pieces; "mma3": f32 x, all in three
    heads_per_block: int  # heads of one y block, which share its C·Bᵀ tiles
    y_blocks: int  # per chunk: row tiles x head groups
    state_blocks: int  # per chunk: heads x column tiles of N
    grid: tuple  # (y_blocks + state_blocks, BNC)
    threads: int
    smem_bytes: int


def launch_plan(BNC: int, H: int, Q: int, hd: int, N: int, dtype: torch.dtype) -> LaunchPlan:
    """The launch plan of the route ``dtype`` selects (no CUDA needed).

    Both routes run every product on the tensor cores with f32 operands split
    into bf16 pieces: ``"mma"`` (bf16 x) two pieces, x exact in one;
    ``"mma3"`` (f32 x) three pieces of every operand, x included.  A y block
    computes each C·Bᵀ tile of its 64 rows once for its group of heads: two
    heads while the y blocks still fill the card, two to an SM on ``"mma"``
    and one on ``"mma3"`` (whose six products a pair make C·Bᵀ's reuse worth
    more: mamba2's LM chunks ran 0.0796 ms at two heads against 0.1042 at one
    on an H100, ``torch_kernel_probe.py f32-gemm``), else one (a mesh rank's
    8 heads: 0.0278 against 0.0358 at two).
    """
    row_tiles = -(-Q // BLOCK_Q)
    if dtype == torch.bfloat16:
        route, pieces, per_sm = "mma", 2, 2
        x_bytes = 2 * 2 * 64 * (hd + 8)  # the group's x tiles [2][64][hd+8] in bf16
    else:
        route, pieces, per_sm = "mma3", 3, 1
        # the group's x rows [2][64][hd] in f32, split after C·Bᵀ into [2][3][64][hd+8] bf16
        # pieces laid over the C and B slices
        x_bytes = 4 * 2 * 64 * hd
    # y: C and B slices [pieces][64][72] each in bf16, x, cum [2][64]; state: x·decay and B
    # slices [pieces][32][hd+8] and [pieces][32][136] in bf16
    smem = max(2 * 2 * pieces * 64 * 72 + x_bytes + 4 * 2 * 64,
               2 * pieces * 32 * (hd + 8 + 136))
    g = min(2, H)
    if g > 1 and BNC * row_tiles * -(-H // g) < per_sm * _build.NUM_SMS:
        g = 1
    y_blocks = row_tiles * -(-H // g)
    state_blocks = H * -(-N // 128)
    return LaunchPlan(route, g, y_blocks, state_blocks, (y_blocks + state_blocks, BNC), 128, smem)


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How ``ssd_intra_chunk_bwd`` is launched; ``csrc/ssd_scan.cu`` refuses any other."""

    route: str  # "mma2": bf16 x, f32 operands in two bf16 pieces; "mma3": f32 x, all in three
    row_tiles: int  # 64-row tiles of a chunk
    heads_per_block: int  # a main block's head group, which shares its C·Bᵀ tiles
    groups: int  # head groups per chunk
    grid: tuple  # (groups, BNC, row_tiles): a main block per (group, chunk, k tile), k slowest
    threads: int
    smem_bytes: int
    blocks_per_sm: int  # main blocks one SM holds by shared memory (registers allow two)
    scratch: tuple  # [BNC, groups, 64 row_tiles, 64 row_tiles]: each group's Σ dM∘L, transposed
    scratch_bytes: int  # every f32 partial the main launch hands to the reduce, dstate given
    reduce_grid: tuple  # (4 row_tiles, 2, BNC): 16 rows of dc (role 0) or of db and dcum (role 1)
    reduce_threads: int
    reduce_smem_bytes: int


def bwd_plan(BNC: int, H: int, Q: int, hd: int, N: int, dtype: torch.dtype) -> BwdPlan:
    """The backward's plan (no CUDA needed); ValueError past the kernel's limits.

    The head group is the route's largest (two heads on bf16 x, whose dx accumulators share a
    thread's registers; one on f32 x, whose three-piece x and dy tiles fill shared memory) while
    the main grid still gives every SM a block; below that it shrinks.
    """
    if hd not in HEAD_DIMS or not 0 < N <= BWD_MAX_STATE:
        raise ValueError(f"ssd_intra_chunk backward takes head dim {HEAD_DIMS} and "
                         f"0 < N <= {BWD_MAX_STATE}, got {hd}, {N}")
    if BNC > 65535 or H > 65535 or Q > 65535 * BLOCK_Q:
        raise ValueError(f"grid limit: BNC={BNC}, H={H} and Q / {BLOCK_Q} = {Q / BLOCK_Q} "
                         "must be <= 65535")
    if dtype not in DTYPES:
        raise TypeError(f"ssd_intra_chunk backward takes x in {list(DTYPES)}, got {dtype}")
    row_tiles = -(-Q // BLOCK_Q)
    rq = BLOCK_Q * row_tiles
    if dtype == torch.bfloat16:
        route, pieces, x_pieces, max_heads = "mma2", 2, 1, 2
    else:
        route, pieces, x_pieces, max_heads = "mma3", 3, 3, 1
    # B and C slices [pieces][64][72] and the group's x and dy tiles [heads][x_pieces][64][hd+8]
    # in bf16, the group's cum [heads][64] in f32
    smem = 2 * (2 * pieces * 64 * 72 + 2 * max_heads * x_pieces * 64 * (hd + 8)) + 4 * max_heads * 64
    g = max(1, min(max_heads, H))
    while g > 1 and BNC * row_tiles * -(-H // g) < _build.NUM_SMS:
        g -= 1
    groups = -(-H // g)
    # the groups' sums of dM∘L and of (x∘w)·dstate, the warps' row sums of P, dcol, the warps' tw
    scratch_bytes = 4 * (BNC * groups * rq * (rq + N)
                         + BNC * H * (Q * (4 * row_tiles + 1) + 4 * row_tiles))
    # for each of two teams: S rows [pieces][16][72] and a tile's rows of B or C [pieces][64][136]
    # in bf16, and a batch of 13 groups' [16][64] f32 tiles
    reduce_smem = 2 * (2 * pieces * (16 * 72 + 64 * (BWD_MAX_STATE + 8)) + 4 * 13 * 16 * 64)
    return BwdPlan(route, row_tiles, g, groups, (groups, BNC, row_tiles), 128, smem,
                   SM_SMEM_BYTES // (smem + 1024), (BNC, groups, rq, rq), scratch_bytes,
                   (4 * row_tiles, 2, BNC), 256, reduce_smem)


@functools.lru_cache(maxsize=None)
def _bwd_entries():
    lib = _build.load("ssd_scan")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    main, red = lib.ssd_intra_chunk_bwd, lib.ssd_intra_chunk_bwd_reduce
    main.argtypes = [i, i] + [p] * 12 + [i] * 6 + [i64, p]
    red.argtypes = [i] + [p] * 10 + [i] * 5 + [i64, p]
    for fn in (main, red):
        fn.restype = ctypes.c_int
    return main, red


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("ssd_scan").ssd_intra_chunk_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, i, p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_int64, p]
    fn.restype = ctypes.c_int
    return fn


def ssd_intra_chunk(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor, cum: torch.Tensor):
    """Intra-chunk SSD of every (chunk, head); b, c and cum f32, x f32 or bf16, all contiguous."""
    global launches, mma3_launches
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
                   plan.grid[0], plan.smem_bytes,
                   torch._C._cuda_getCurrentRawStream(x.device.index))
    launches += 1
    mma3_launches += plan.route == "mma3"
    _build.check("ssd_scan", err)
    return y, state


def ssd_intra_chunk_bwd(x, b, c, cum, dy, dstate=None):
    """(dx in x.dtype, db, dc, dcum f32) of ``ssd_intra_chunk`` for the gradients dy
    [BNC,H,Q,hd] (x's dtype) and dstate [BNC,H,hd,N] f32 or None (zero); all contiguous.
    Two launches: ``ssd_intra_chunk_bwd_main``, then ``ssd_intra_chunk_bwd_reduce``."""
    dx, parts = ssd_intra_chunk_bwd_main(x, b, c, cum, dy, dstate)
    return (dx, *ssd_intra_chunk_bwd_reduce(parts))


def _ptr(t):
    return None if t is None else t.data_ptr()


@dataclasses.dataclass(frozen=True)
class BwdParts:
    """What the main launch hands to the reduce: its plan, b and c, and its f32 partials."""

    plan: BwdPlan
    dtype: torch.dtype  # x's, which picks the pieces
    b: torch.Tensor
    c: torch.Tensor
    st: torch.Tensor  # plan.scratch: each head group's sum of dM∘L, [k][q], the tiles q >= k
    dbs: torch.Tensor | None  # [BNC, groups, 64 row_tiles, N]: each head group's (x∘w)·dstate
    rowp: torch.Tensor  # [BNC, H, 4 row_tiles, Q]: P's row sums over each warp's 16 columns k
    dcol: torch.Tensor  # [BNC, H, Q]: -(P's column sums) - w x·(dstate B)
    twp: torch.Tensor  # [BNC, H, 4 row_tiles]: w x·(dstate B) summed over each warp's 16 rows


def ssd_intra_chunk_bwd_main(x, b, c, cum, dy, dstate=None):
    """The first kernel: (dx, the ``BwdParts`` that ``ssd_intra_chunk_bwd_reduce`` takes)."""
    global bwd_launches
    if x.dim() != 4 or b.dim() != 3 or c.dim() != 3 or cum.dim() != 3:
        raise ValueError("ssd_intra_chunk_bwd takes x [BNC,H,Q,hd], b, c [BNC,Q,N], cum [BNC,H,Q]")
    BNC, H, Q, hd = x.shape
    N = b.shape[2]
    if tuple(b.shape) != (BNC, Q, N) or tuple(c.shape) != (BNC, Q, N) or tuple(cum.shape) != (BNC, H, Q):
        raise ValueError(f"b, c must be [{BNC}, {Q}, N] and cum [{BNC}, {H}, {Q}]")
    if tuple(dy.shape) != tuple(x.shape) or dy.dtype != x.dtype:
        raise ValueError(f"dy must be {tuple(x.shape)} {x.dtype}")
    if dstate is not None and (tuple(dstate.shape) != (BNC, H, hd, N) or dstate.dtype != torch.float32):
        raise ValueError(f"dstate must be [{BNC}, {H}, {hd}, {N}] float32")
    if any(t.dtype != torch.float32 for t in (b, c, cum)):
        raise TypeError("ssd_intra_chunk_bwd takes f32 b, c and cum")
    plan = bwd_plan(BNC, H, Q, hd, N, x.dtype)
    tensors = [t for t in (x, b, c, cum, dy, dstate) if t is not None]
    devices = {t.device for t in tensors}
    if x.device.type != "cuda" or len(devices) != 1:
        raise ValueError(f"ssd_intra_chunk_bwd kernel needs CUDA tensors on one device, got {devices}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"ssd_intra_chunk_bwd: {x.device} is not the current CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_intra_chunk_bwd takes contiguous tensors")
    f32 = dict(dtype=torch.float32, device=x.device)
    rq = BLOCK_Q * plan.row_tiles
    dx = torch.empty_like(x)
    rt4 = 4 * plan.row_tiles
    parts = BwdParts(plan, x.dtype, b, c, torch.empty(plan.scratch, **f32),
                     None if dstate is None else torch.empty((BNC, plan.groups, rq, N), **f32),
                     torch.empty((BNC, H, rt4, Q), **f32), torch.empty((BNC, H, Q), **f32),
                     torch.empty((BNC, H, rt4), **f32))
    if x.numel() == 0:
        return dx, parts
    err = _bwd_entries()[0](
        DTYPES[x.dtype], hd, x.data_ptr(), b.data_ptr(), c.data_ptr(), cum.data_ptr(),
        dy.data_ptr(), _ptr(dstate), dx.data_ptr(),
        *(_ptr(t) for t in (parts.st, parts.dbs, parts.rowp, parts.dcol, parts.twp)),
        BNC, H, Q, N, plan.heads_per_block, plan.groups, plan.smem_bytes,
        torch._C._cuda_getCurrentRawStream(x.device.index))
    bwd_launches += 1
    _build.check("ssd_scan", err)
    return dx, parts


def ssd_intra_chunk_bwd_reduce(parts: BwdParts):
    """The second kernel: (db, dc [BNC,Q,N], dcum [BNC,H,Q], f32) from ``ssd_intra_chunk_bwd_main``'s
    parts, every sum in a fixed order."""
    global bwd_reduce_launches
    BNC, Q, N = parts.b.shape
    H = parts.dcol.shape[1]
    f32 = dict(dtype=torch.float32, device=parts.b.device)
    db, dc = torch.empty((BNC, Q, N), **f32), torch.empty((BNC, Q, N), **f32)
    dcum = torch.empty((BNC, H, Q), **f32)
    if parts.dcol.numel() == 0:
        return db.zero_(), dc.zero_(), dcum.zero_()
    err = _bwd_entries()[1](
        DTYPES[parts.dtype], parts.st.data_ptr(), _ptr(parts.dbs),
        parts.b.data_ptr(), parts.c.data_ptr(), parts.rowp.data_ptr(), parts.dcol.data_ptr(),
        parts.twp.data_ptr(), db.data_ptr(), dc.data_ptr(), dcum.data_ptr(), BNC, H, Q, N,
        parts.plan.groups, parts.plan.reduce_smem_bytes,
        torch._C._cuda_getCurrentRawStream(parts.b.device.index))
    bwd_reduce_launches += 1
    _build.check("ssd_scan", err)
    return db, dc, dcum

"""The port's kernel entry points on the CPU: plain versions vs the JAX reference.

On the CPU ``repro_torch.kernels.ops`` runs the plain versions; the CUDA
kernels themselves are held against them on the card (test_torch_gpu.py
and chip_smoke.py).  Tolerances are the JAX package's own
(tests/test_kernels.py): 2e-5 f32 and 2e-2 bf16 for attention, 1e-5 f32
for RMSNorm and 2e-2 for bf16, where one rounding step of a value near 1
is 2**-8.
"""

import collections
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import layers as jax_layers
from repro_torch.kernels import _build
from repro_torch.kernels import adamw as adamw_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import moe_matmul as moe_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rmsnorm_mod
from repro_torch.kernels import ssd_scan as ssd_mod

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# one XLA compile per shape instead of one per op
jax_flash_ref = jax.jit(jax_ref.flash_attention_ref, static_argnames="causal")
jax_rmsnorm_ref = jax.jit(jax_ref.rmsnorm_ref)
jax_rms_norm = jax.jit(jax_layers.rms_norm)


def both(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def close(got, want, tol):
    np.testing.assert_allclose(
        np.asarray(got, np.float32) if not isinstance(got, torch.Tensor) else got.float().numpy(),
        np.asarray(want, np.float32),
        rtol=tol,
        atol=tol,
    )


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,D", [(7, 960), (100, 256), (33, 64), (256, 2048)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_ref_matches_jax(T, D, dtype):
    rng = np.random.default_rng(T * 1000 + D)
    xj, xt = both(rng.standard_normal((T, D), dtype=np.float32) * 3.0, dtype)
    wj, wt = both(1.0 + 0.1 * rng.standard_normal(D, dtype=np.float32), dtype)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    got = ref.rmsnorm_ref(xt, wt)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    close(got, jax_rmsnorm_ref(xj, wj), tol)
    close(got, jax_rms_norm(xj, wj), tol)
    # the Pallas kernel itself, in interpret mode (one block: T <= 256)
    close(got, jax_ops.rmsnorm_op(xj, wj, interpret=True), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_op_flattens_leading_dims(dtype):
    rng = np.random.default_rng(1)
    xj, xt = both(rng.standard_normal((3, 5, 960), dtype=np.float32), dtype)
    wj, wt = both(1.0 + 0.1 * rng.standard_normal(960, dtype=np.float32), dtype)
    got = ops.rmsnorm_op(xt, wt, eps=1e-6)
    assert got.shape == (3, 5, 960)
    close(got, jax_ops.rmsnorm_op(xj, wj, eps=1e-6, interpret=True), 2e-2 if dtype == "bfloat16" else 1e-5)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("g", [1, 2, 3, 4])
@pytest.mark.parametrize("S", [24, 100])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_ref_matches_jax(g, S, causal, dtype):
    B, KV, d = 2, 2, 64
    rng = np.random.default_rng(g * 100 + S)
    qj, qt = both(rng.standard_normal((B, KV * g, S, d), dtype=np.float32), dtype)
    kj, kt = both(rng.standard_normal((B, KV, S, d), dtype=np.float32), dtype)
    vj, vt = both(rng.standard_normal((B, KV, S, d), dtype=np.float32), dtype)
    got = ops.flash_attention_op(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    close(got, jax_flash_ref(qj, kj, vj, causal=causal), tol)


def test_flash_attention_ref_takes_strided_views():
    """The model passes [B,S,H,d] tensors as transposed [B,H,S,d] views."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 24, 6, 64), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 24, 2, 64), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 24, 2, 64), dtype=np.float32))
    got = ops.flash_attention_op(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    want = ref.flash_attention_ref(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    )
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# gradients of the plain versions (the backward kernels' references)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("g", [1, 3, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ref_grads_match_jax(g, causal):
    """autograd through ``ref.flash_attention_ref`` against jax.grad of the JAX reference, f32."""
    B, KV, S, d = 2, 2, 40, 64
    rng = np.random.default_rng(g * 10 + causal)
    arrays = [rng.standard_normal(s, dtype=np.float32) for s in
              [(B, KV * g, S, d), (B, KV, S, d), (B, KV, S, d), (B, KV * g, S, d)]]
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
    got = torch.autograd.grad(ref.flash_attention_ref(q, k, v, causal), (q, k, v),
                              torch.from_numpy(arrays[3]))
    _, vjp = jax.vjp(lambda *t: jax_ref.flash_attention_ref(*t, causal=causal),
                     *(jnp.asarray(a) for a in arrays[:3]))
    for mine, theirs in zip(got, vjp(jnp.asarray(arrays[3]))):
        close(mine, theirs, 1e-5)


@pytest.mark.parametrize("T,D", [(7, 960), (33, 64)])
def test_rmsnorm_ref_grads_match_jax(T, D):
    rng = np.random.default_rng(T + D)
    xa = rng.standard_normal((T, D), dtype=np.float32) * 3
    wa = 1 + 0.1 * rng.standard_normal(D, dtype=np.float32)
    dy = rng.standard_normal((T, D), dtype=np.float32)
    x, w = torch.from_numpy(xa).requires_grad_(), torch.from_numpy(wa).requires_grad_()
    got = torch.autograd.grad(ref.rmsnorm_ref(x, w), (x, w), torch.from_numpy(dy))
    _, vjp = jax.vjp(jax_ref.rmsnorm_ref, jnp.asarray(xa), jnp.asarray(wa))
    for mine, theirs in zip(got, vjp(jnp.asarray(dy))):
        close(mine, theirs, 1e-5)


# ---------------------------------------------------------------------------
# wrappers: no fallback, counters, argument checks
# ---------------------------------------------------------------------------


ZERO_COUNTS = {
    "rmsnorm": 0, "rmsnorm_bwd": 0, "rmsnorm_bwd_wide": 0, "rmsnorm_bwd_dweight": 0,
    "flash_attention": 0, "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkdv": 0,
    "cross_attention": 0, "cross_attention_bwd_stats": 0, "cross_attention_bwd_fused": 0,
    "flash_decode": 0,
    "moe_matmul": 0, "moe_matmul_bwd_dbuf": 0, "moe_matmul_bwd_dw": 0,
    "ssd_intra_chunk": 0, "ssd_intra_chunk_bwd": 0, "ssd_intra_chunk_bwd_reduce": 0,
    "adamw_norm": 0, "adamw_norm_finish": 0, "adamw_update": 0,
}
ADAMW_KW = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0)


def test_cpu_tensors_leave_launch_counters_at_zero():
    ops.reset_launch_counts()
    x = torch.randn(4, 64)
    ops.rmsnorm_op(x, torch.ones(64))
    q = torch.randn(1, 2, 8, 64)
    ops.flash_attention_op(q, q, q)
    ops.moe_matmul_op(torch.randn(2, 8, 16), torch.randn(2, 16, 4))
    ops.ssd_intra_chunk_op(torch.randn(1, 2, 8, 16), torch.randn(1, 8, 4), torch.randn(1, 8, 4),
                           -torch.rand(1, 2, 8).cumsum(-1))
    one = torch.ones(())
    ops.adamw_update_([torch.randn(8)], [torch.randn(8)], [torch.zeros(8)], [torch.zeros(8)],
                      one * 1e-3, one * 0.1, one * 0.05, **ADAMW_KW)
    assert ops.launch_counts() == ZERO_COUNTS


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel functions never compute on the CPU: only ops routes there."""
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_mod.rmsnorm(torch.randn(4, 64), torch.ones(64))
    q = torch.randn(1, 2, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash_mod.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        moe_mod.moe_matmul(torch.randn(2, 8, 16), torch.randn(2, 16, 4))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_mod.ssd_intra_chunk(torch.randn(1, 2, 8, 32), torch.randn(1, 8, 4), torch.randn(1, 8, 4),
                                torch.randn(1, 2, 8))
    one = torch.ones(())
    with pytest.raises(ValueError, match="CUDA"):
        adamw_mod.adamw_update_([torch.randn(8)], [torch.randn(8)], [torch.zeros(8)],
                                [torch.zeros(8)], one, one, one, **ADAMW_KW)
    assert ops.launch_counts() == ZERO_COUNTS


@pytest.mark.parametrize(
    "x,w,err",
    [
        (torch.randn(4, 64, dtype=torch.float16), torch.ones(64, dtype=torch.float16), TypeError),
        (torch.randn(4, 64), torch.ones(32), ValueError),
        (torch.randn(4, 64), torch.ones(64, dtype=torch.bfloat16), ValueError),
        (torch.randn(4, 64, 2)[..., 0], torch.ones(64), ValueError),
        (torch.randn(2, 4, 64), torch.ones(64), ValueError),
    ],
)
def test_rmsnorm_kernel_rejects_what_it_does_not_take(x, w, err):
    with pytest.raises(err):
        rmsnorm_mod.rmsnorm(x, w)


@pytest.mark.parametrize(
    "shapes,dtype,err",
    [
        (((1, 2, 8, 32), (1, 2, 8, 32)), torch.float32, ValueError),  # head dim 32
        (((1, 3, 8, 64), (1, 2, 8, 64)), torch.float32, ValueError),  # 3 heads on 2 kv heads
        (((1, 2, 8, 64), (1, 2, 9, 64)), torch.float32, ValueError),  # k length differs
        (((1, 2, 8, 64), (1, 2, 8, 64)), torch.float16, TypeError),
    ],
)
def test_flash_kernel_rejects_what_it_does_not_take(shapes, dtype, err):
    qs, ks = shapes
    q, k = torch.zeros(qs, dtype=dtype), torch.zeros(ks, dtype=dtype)
    with pytest.raises(err):
        flash_mod.flash_attention(q, k, k)


# ---------------------------------------------------------------------------
# launch plans: decided in Python, checked again by the kernels on the card
# ---------------------------------------------------------------------------

# (B, H, KV, S, d): the serving paths (smollm prefill, llama and granite score),
# chip_smoke.py's longer shapes, and the card tests' GQA groups and lengths
FLASH_PLAN_SHAPES = sorted(
    {(4, 15, 5, 128, 64), (8, 32, 8, 160, 64), (8, 24, 8, 160, 64), (2, 8, 2, 1000, 128)}
    | {(4, H, KV, S, 64) for S in (160, 1024, 2048) for H, KV in ((32, 8), (15, 5))}
    | {(2, 2 * g, 2, S, d) for g in (1, 3, 4, 5) for S in (1, 15, 64, 65, 160, 1000) for d in (64, 128)}
)


@pytest.mark.parametrize("B,H,KV,S,d", FLASH_PLAN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_launch_plan(B, H, KV, S, d, dtype):
    plan = flash_mod.launch_plan(B, H, S, d, dtype)
    assert plan.threads == 128 and plan.block_q == 64
    if dtype == torch.bfloat16:
        # tensor cores; heads fastest, so a KV head's query heads are adjacent blocks
        assert plan.route == "mma" and plan.block_k == 64
        heads, row_tiles, batch = plan.grid
        assert plan.smem_bytes == 2 * 5 * 64 * (d + 8)  # Q, K and V twice, rows padded 16 bytes
    else:
        # split-TF32 tensor cores at every f32 shape, the grid as bf16's; K/V tiles of 64 keys
        # (32 at d = 128), padded f32 rows, two blocks an SM
        assert plan.route == "tf32x3" and plan.block_k == (64 if d == 64 else 32)
        heads, row_tiles, batch = plan.grid
        # Q, K and V twice each, rows of d + 8 floats (d + 4 for V)
        assert plan.smem_bytes == 4 * (64 * (d + 8) + 2 * plan.block_k * (2 * d + 12))
        assert 2 * plan.smem_bytes <= 228 * 1024
    assert (heads, batch) == (H, B)
    assert (row_tiles - 1) * plan.block_q < S <= row_tiles * plan.block_q
    assert plan.smem_bytes <= _build.MAX_SMEM_BYTES


# (B, H, KV, S, d): the training paths (smollm GRPO 16 x 160, llama LM 4 x 256), chip_smoke.py's
# longer shapes and the card tests' grid, with S on either side of the 128-row and 128-key tiles
FLASH_BWD_PLAN_SHAPES = sorted(
    {(16, 15, 5, 160, 64), (4, 32, 8, 256, 64)}
    | {(4, H, KV, S, 64) for S in (1024, 2048) for H, KV in ((32, 8), (15, 5))}
    | {(2, 2 * g, 2, S, d) for g in (1, 3, 4, 5) for S in (1, 63, 65, 160, 1024) for d in (64, 128)}
    | {(2, 2 * g, 2, S, d) for g in (1, 4) for S in (127, 129, 255, 257) for d in (64, 128)}
)


@pytest.mark.parametrize("B,H,KV,S,d", FLASH_BWD_PLAN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_launch_plans(B, H, KV, S, d, dtype):
    dq, dkdv = flash_mod.bwd_plans(B, H, KV, S, d, dtype)
    assert dq.grid == (H, -(-S // dq.block_q), B)  # one block per (query head, row tile)
    assert dkdv.grid == (-(-S // dkdv.block_k), KV, B)  # one block per (KV head, key tile)
    for plan in (dq, dkdv):
        assert plan.smem_bytes <= _build.MAX_SMEM_BYTES
        # nothing of size S lives in shared memory once the tiles are fixed
        longer = flash_mod.bwd_plans(B, H, KV, 4 * S + 512, d, dtype)[plan is dkdv]
        if (longer.block_q, longer.block_k) == (plan.block_q, plan.block_k):
            assert longer.smem_bytes == plan.smem_bytes
    if dtype == torch.float32:  # split TF32: 64-row dq blocks, 64-key dkdv blocks (32 where 64
        # would leave SMs idle), 64-row tiles (d 128: 32)
        bt = 64 if d == 64 else 32
        kb = 64 if -(-S // 64) * KV * B >= 132 else 32
        assert (dq.route, dq.threads, dq.block_q, dq.block_k) == ("tf32x3", 128, 64, bt)
        assert (dkdv.route, dkdv.threads, dkdv.block_q, dkdv.block_k) == ("tf32x3", 128, bt, kb)
        assert dq.smem_bytes == 4 * (d + 8) * (2 * 64 + 4 * bt)  # Q and dO, K and V twice each
        assert dkdv.smem_bytes == 4 * (2 * kb * (d + 8) + 4 * bt * (d + 9))  # K, V; Q, dO, lse, D twice
        assert 2 * dkdv.smem_bytes <= 228 * 1024 or d == 128
        return
    # wgmma: 64-row consumer warpgroups plus a producer warp; two past S = 256
    wq = 2 if S > 256 else 1
    wk = 2 if S > 256 and d == 64 else 1  # d = 128: one, for the registers of dK and dV
    stages = 3 if d == 64 else 2
    assert (dq.route, dq.block_q, dq.block_k, dq.threads, dq.stages) == ("wgmma", 64 * wq, 64, 128 * wq + 32, stages)
    assert (dkdv.route, dkdv.block_q, dkdv.block_k, dkdv.threads, dkdv.stages) == (
        "wgmma", 64, 64 * wk, 128 * wk + 32, stages)
    tile = 2 * 64 * d  # one 64-row swizzled bf16 tile
    bars = 8 * (1 + 2 * stages)
    assert dq.smem_bytes == 1024 + 2 * wq * tile + stages * 2 * tile + bars + 256 * wq
    assert dkdv.smem_bytes == 1024 + 2 * wk * tile + stages * (2 * tile + 512) + bars
    if wq == 1 and not (d == 128 and wk == 1 and S > 256):  # two blocks fit on an SM
        assert 2 * dq.smem_bytes <= 228 * 1024


def test_flash_backward_plans_fill_the_card():
    """At the GRPO shape the bf16 grids hold at least one block per SM; f32 dkdv at B4 H32 KV8 S160 too."""
    dq, dkdv = flash_mod.bwd_plans(16, 15, 5, 160, 64, torch.bfloat16)
    assert math.prod(dq.grid) >= 132 and math.prod(dkdv.grid) >= 132
    f32_dkdv = flash_mod.bwd_plans(4, 32, 8, 160, 64, torch.float32)[1]
    assert math.prod(f32_dkdv.grid) >= 132  # 160 blocks of 32 keys (64-key blocks gave 96)


def test_flash_backward_stats_rows_are_16_byte_aligned():
    for S in (1, 2, 3, 4, 5, 63, 160, 1001):
        assert flash_mod.stats_row(S) % 4 == 0 and S <= flash_mod.stats_row(S) < S + 4


# chip_smoke.py phase 3's forward shapes: smollm, llama, granite, the closed loop, hymba (d 1600
# and its SSM's 3200: prefill, decode, score, check), the LM rows, llama3-8b / glm4-9b, whisper's
# encoder, internvl's prefill, the plain checks and live mode's payloads
B1_PHASE3_SHAPES = [
    (512, 960), (4, 960), (1280, 2048), (1280, 1536), (16, 960), (128, 960), (24, 2048), (384, 960),
    *[(T, D) for D in (1600, 3200) for T in (512, 4, 1280, 636)],
    (1024, 1536), (1024, 768), (1024, 1600), (1024, 3200),
    (1280, 4096), (4, 4096), (6000, 1024), (1536, 896), (1000, 2048), (1000, 960), (64, 64), (8, 64),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rmsnorm_forward_plan_spreads_the_rows_over_every_sm(dtype):
    """The warp route: at most one block an SM, as many warps a block as rows an SM (a row a
    warp up to the most a block takes, then more rows a warp), every row once, and no SM with
    more rows than the most loaded one needs."""
    for T, D in B1_PHASE3_SHAPES:
        plan = rmsnorm_mod.fwd_plan(T, D, dtype)
        if D > rmsnorm_mod.FWD_WARP_MAX_DIM:
            assert plan == rmsnorm_mod.FwdPlan("block", 4, 1, T, plan.vec)
            continue
        most = rmsnorm_mod.fwd_warps(D, dtype, plan.vec)
        per_block = plan.warps * plan.rows_per_warp
        per_sm = -(-T // _build.NUM_SMS)
        assert plan.route == "warp" and 1 <= plan.warps <= most
        assert plan.rows_per_warp == -(-per_sm // most)
        assert (plan.blocks - 1) * per_block < T <= plan.blocks * per_block
        assert plan.blocks <= _build.NUM_SMS
        assert per_sm <= per_block < per_sm + plan.rows_per_warp  # the busiest SM, near the even share
        if T >= _build.NUM_SMS:
            assert plan.blocks > _build.NUM_SMS * 9 // 10, (T, D, plan)  # the card stays full


def test_rmsnorm_forward_plan_at_the_models_shapes():
    """The plans the main path's rows take, pinned: T = 1024 runs 128 blocks of 8 warps (not 64 of
    16), T = 1280 128 of 10, every bf16 row a row a warp up to 16 warps a block; f32 rows past
    1024 take at most 8 warps a block, then two rows a warp; whisper's encoder, past 16 rows an
    SM, three rows a warp; decode a warp a block."""
    plan = rmsnorm_mod.fwd_plan
    bf16 = torch.bfloat16
    assert plan(1024, 768) == rmsnorm_mod.FwdPlan("warp", 8, 1, 128, 8)
    assert plan(1024, 1536) == rmsnorm_mod.FwdPlan("warp", 8, 1, 128, 8)
    assert plan(1536, 896, bf16) == rmsnorm_mod.FwdPlan("warp", 12, 1, 128, 8)
    assert plan(1280, 2048) == rmsnorm_mod.FwdPlan("warp", 10, 1, 128, 8)
    assert plan(1280, 2048, torch.float32) == rmsnorm_mod.FwdPlan("warp", 5, 2, 128, 4)
    assert plan(1280, 1024) == rmsnorm_mod.FwdPlan("warp", 10, 1, 128, 8)
    assert plan(6000, 1024) == rmsnorm_mod.FwdPlan("warp", 16, 3, 125, 8)
    assert plan(4, 960) == rmsnorm_mod.FwdPlan("warp", 1, 1, 4, 8)
    assert plan(64, 64, torch.float32) == rmsnorm_mod.FwdPlan("warp", 1, 1, 64, 4)
    assert plan(1000, 2048, torch.float32) == rmsnorm_mod.FwdPlan("warp", 8, 1, 125, 4)
    assert plan(1280, 4096) == rmsnorm_mod.FwdPlan("block", 4, 1, 1280, 8)
    assert plan(10**6, 960) == rmsnorm_mod.FwdPlan("warp", 16, 474, 132, 8)


@pytest.mark.parametrize("dtype,vec", [(torch.bfloat16, 8), (torch.float32, 4)])
def test_rmsnorm_forward_route_by_width_dtype_and_alignment(dtype, vec):
    """Up to D 2048 the warp route, past it the block route; 16-byte loads where D is a
    multiple of the vector and the operands are aligned, else an element at a time."""
    plan = rmsnorm_mod.fwd_plan
    assert rmsnorm_mod.FWD_WARP_MAX_DIM == 2048
    assert plan(4, 2048, dtype).route == "warp" and plan(4, 2049, dtype).route == "block"
    assert plan(4, 2048, dtype).vec == vec and plan(4, 4096, dtype).vec == vec
    assert plan(4, 2048, dtype, aligned=False).vec == 1
    assert plan(4, 4096, dtype, aligned=False) == rmsnorm_mod.FwdPlan("block", 4, 1, 4, 1)
    assert plan(4, 2048 - vec // 2, dtype).vec == 1 and plan(4, 100, dtype).vec == (4 if vec == 4 else 1)
    # most warps a block: 16 where the row takes at most 32 registers a lane, else 8: every bf16
    # row and f32 rows up to 1024 on 16-byte loads, rows up to 1024 an element at a time
    fwd_warps = rmsnorm_mod.fwd_warps
    assert fwd_warps(4096 * vec // 16, dtype, vec) == 16 and fwd_warps(1024, dtype, 1) == 16
    assert fwd_warps(1025, dtype, 1) == 8 and fwd_warps(1025, torch.float32, 4) == 8
    assert plan(132 * 16, 2048, dtype).warps == (16 if vec == 8 else 8)
    assert plan(132 * 16, 1024, dtype, aligned=False).warps == 16
    assert plan(132 * 16, 1032, dtype, aligned=False).warps == 8


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rmsnorm_forward_plan_refuses_no_shape(dtype):
    """Every T >= 1 and D >= 1 has a plan that covers each row once; T < 1 or D < 1 raise."""
    for T in (1, 2, 3, 131, 132, 133, 1000, 2111, 2112, 2113, 4225, 99_991, 2**31 - 1):
        for D in (1, 2, 3, 7, 8, 31, 33, 100, 513, 1025, 2047, 2048, 2049, 3200, 8191, 100_000):
            plan = rmsnorm_mod.fwd_plan(T, D, dtype, aligned=D % 3 != 0)
            per_block = plan.warps * plan.rows_per_warp if plan.route == "warp" else 1
            assert plan.blocks * per_block >= T > (plan.blocks - 1) * per_block
            assert plan.route == ("warp" if D <= 2048 else "block")
    for T, D in ((0, 64), (4, 0), (-1, 64)):
        with pytest.raises(ValueError, match="rows"):
            rmsnorm_mod.fwd_plan(T, D, dtype)


@pytest.mark.parametrize("T,D", [(2560, 960), (1024, 2048), (128, 960), (4, 960), (1, 7), (300, 64)])
def test_rmsnorm_backward_launch_plan(T, D):
    """A warp per row; at most one block per SM; each warp keeps D f32 column sums."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = rmsnorm_mod.bwd_plan(T, D, dtype)
        assert plan.route == "warp"
        warps = plan.threads // 32
        assert warps == (16 if D * (4 if dtype == torch.float32 else 2) <= 2048 else 8)
        assert plan.blocks <= _build.NUM_SMS and plan.blocks <= T
        assert (plan.blocks - 1) * plan.rows_per_block < T <= plan.blocks * plan.rows_per_block
        assert plan.smem_bytes == 4 * warps * D <= _build.MAX_SMEM_BYTES
        assert rmsnorm_mod.bwd_plan(T, D, dtype, dweight=False).smem_bytes == 0
        if T >= _build.NUM_SMS * warps:
            assert plan.blocks > _build.NUM_SMS // 2  # the card stays full


@pytest.mark.parametrize("T", [132 * 16, 2560, 10_000, 1_000_000])
def test_rmsnorm_backward_grid_stops_at_the_sm_count(T):
    """A persistent grid: past one block per SM, more rows lengthen each block's walk."""
    plan = rmsnorm_mod.bwd_plan(T, 960)
    assert _build.NUM_SMS - plan.rows_per_block <= plan.blocks <= _build.NUM_SMS
    assert rmsnorm_mod.bwd_plan(4 * T, 960).blocks <= _build.NUM_SMS
    assert rmsnorm_mod.bwd_plan(4 * T, 960).rows_per_block >= 4 * plan.rows_per_block - 3


def test_rmsnorm_backward_refuses_rows_past_its_registers():
    """Rows up to 2048 keep the warp route; up to 8192 a block holds the row (the ring route
    where bulk copies can read the rows, else the block route, 32 elements a thread); wider
    rows would not fit its registers and raise."""
    assert (rmsnorm_mod.BWD_WARP_MAX_DIM, rmsnorm_mod.BWD_MAX_DIM) == (2048, 8192)
    assert rmsnorm_mod.bwd_plan(4, rmsnorm_mod.BWD_WARP_MAX_DIM).route == "warp"
    assert rmsnorm_mod.bwd_plan(4, rmsnorm_mod.BWD_WARP_MAX_DIM + 8).route == "ring"
    assert rmsnorm_mod.bwd_plan(4, rmsnorm_mod.BWD_MAX_DIM).route == "ring"
    assert rmsnorm_mod.bwd_plan(4, rmsnorm_mod.BWD_WARP_MAX_DIM + 1).route == "block"
    assert rmsnorm_mod.bwd_plan(4, rmsnorm_mod.BWD_MAX_DIM, aligned=False).route == "block"
    x = torch.randn(4, rmsnorm_mod.BWD_MAX_DIM + 8)
    with pytest.raises(ValueError, match="registers"):
        rmsnorm_mod.rmsnorm_bwd_dx(x, torch.ones(x.shape[1]), x)


def test_backward_wrappers_refuse_cpu_tensors():
    q = torch.randn(1, 2, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash_mod.flash_attention_bwd(q, q, q, q, torch.zeros(1, 2, 8), q)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_mod.rmsnorm_bwd(torch.randn(4, 64), torch.ones(64), torch.randn(4, 64))
    assert ops.launch_counts() == ZERO_COUNTS


# (BNC, H, Q, hd, N): mamba2-130m's prefill, score and 4 x 1024 tokens, chip_smoke.py's
# other shapes, the card tests' shapes, and a chunk past the C·Bᵀ tiles a block keeps
SSD_PLAN_SHAPES = sorted(
    {(4, 24, 128, 64, 128), (8, 24, 160, 64, 128), (8, 24, 128, 64, 128), (6, 24, 160, 64, 128),
     (16, 24, 256, 64, 128), (2, 3, 256, 64, 128), (3, 2, 40, 32, 16), (2, 4, 100, 32, 8),
     (1, 2, 64, 32, 32), (2, 1, 1, 32, 16), (1, 2, 1000, 32, 400)}
    | {(B, H, Q, 64, 128) for B, H in ((8, 24), (70, 7)) for Q in (1, 100, 160, 256)}
)


@pytest.mark.parametrize("BNC,H,Q,hd,N", SSD_PLAN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_launch_plan(BNC, H, Q, hd, N, dtype):
    plan = ssd_mod.launch_plan(BNC, H, Q, hd, N, dtype)
    tc = dtype == torch.bfloat16
    # both routes on the tensor cores, f32 operands in bf16 pieces: two (bf16 x), three (f32 x)
    assert (plan.route, plan.threads) == ("mma" if tc else "mma3", 128)
    g = plan.heads_per_block
    assert 1 <= g <= 2 and g <= H
    row_tiles = -(-Q // 64)
    assert plan.y_blocks == row_tiles * -(-H // g)
    assert plan.state_blocks == H * -(-N // 128)
    assert plan.grid == (plan.y_blocks + plan.state_blocks, BNC)
    assert plan.smem_bytes <= _build.MAX_SMEM_BYTES
    # y: C and B slices [pieces][64][72] in bf16, then x (bf16 tiles [2][64][hd+8], or f32 rows
    # [2][64][hd], split over the slices), cum [2][64]; state: [pieces][32][hd+8] and [pieces][32][136]
    pieces, x_bytes = (2, 2 * 2 * 64 * (hd + 8)) if tc else (3, 4 * 2 * 64 * hd)
    assert plan.smem_bytes == max(2 * 2 * pieces * 64 * 72 + x_bytes + 512,
                                  2 * pieces * 32 * (hd + 8 + 136))
    assert 2 * (plan.smem_bytes + 1024) <= ssd_mod.SM_SMEM_BYTES  # two y blocks an SM
    # nothing of size Q x Q or Q x N lives in shared memory
    assert ssd_mod.launch_plan(BNC, H, 4 * Q, hd, 4 * N, dtype).smem_bytes == plan.smem_bytes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_launch_plan_groups_heads_while_the_card_stays_full(dtype):
    """More heads per block share C·Bᵀ; the plan stops before the y blocks thin out."""
    per_sm = 2 if dtype == torch.bfloat16 else 1
    for BNC, Q in ((4, 128), (8, 160), (16, 256)):  # mamba2 prefill, score, 4 x 1024
        plan = ssd_mod.launch_plan(BNC, 24, Q, 64, 128, dtype)
        if plan.heads_per_block > 1:
            assert BNC * plan.y_blocks >= per_sm * _build.NUM_SMS
    assert ssd_mod.launch_plan(8, 24, 160, 64, 128, dtype).heads_per_block > 1  # score
    # H = 7 on 70 chunks: a group count that does not divide the heads
    assert 7 % ssd_mod.launch_plan(70, 7, 100, 64, 128, dtype).heads_per_block


# (E, C, D, F, dtype, route): granite-moe-3b-a800m's six bf16 products (decode C = 8, prefill
# C = 128, score C = 384; gate/up D 1536 -> F 512, down 512 -> 1536), a longer capacity, f32,
# the card tests' partial tiles, and rows that TMA cannot read (D or F not a multiple of 8)
MOE_PLAN_CASES = [
    (40, 8, 1536, 512, torch.bfloat16, "wgmma_t"), (40, 8, 512, 1536, torch.bfloat16, "wgmma_t"),
    (40, 128, 1536, 512, torch.bfloat16, "wgmma"), (40, 128, 512, 1536, torch.bfloat16, "wgmma"),
    (40, 384, 1536, 512, torch.bfloat16, "wgmma"), (40, 384, 512, 1536, torch.bfloat16, "wgmma"),
    (40, 1024, 1536, 512, torch.bfloat16, "wgmma"), (4, 24, 256, 128, torch.bfloat16, "wgmma_t"),
    (3, 130, 264, 200, torch.bfloat16, "wgmma"), (2, 200, 136, 520, torch.bfloat16, "wgmma"),
    (2, 1000, 72, 96, torch.bfloat16, "wgmma"), (1, 384, 512, 256, torch.bfloat16, "wgmma"),
    (2, 32, 520, 136, torch.bfloat16, "wgmma_t"), (3, 40, 1536, 512, torch.bfloat16, "wgmma"),
    (2, 1, 8, 8, torch.bfloat16, "wgmma_t"), (1, 8, 64, 8, torch.bfloat16, "wgmma_t"),
    (40, 384, 1536, 512, torch.float32, "tf32x3"), (40, 8, 1536, 512, torch.float32, "tf32x3"),
    (5, 130, 200, 72, torch.float32, "tf32x3"), (3, 70, 100, 36, torch.float32, "tf32x3"),
    # f32 at granite's LM gate/up and down, decode down, a mesh rank's experts (42 over 3 model
    # ranks) at prefill and decode, and either side of the 64-row tiles' capacity
    (40, 256, 1536, 512, torch.float32, "tf32x3"), (40, 256, 512, 1536, torch.float32, "tf32x3"),
    (40, 8, 512, 1536, torch.float32, "tf32x3"), (14, 256, 1536, 512, torch.float32, "tf32x3"),
    (14, 8, 512, 1536, torch.float32, "tf32x3"), (40, 64, 1536, 512, torch.float32, "tf32x3"),
    (40, 65, 1536, 512, torch.float32, "tf32x3"), (2, 16, 0, 64, torch.float32, "tf32x3"),
    (14, 384, 1536, 512, torch.float32, "tf32x3"),
    (3, 70, 100, 36, torch.bfloat16, "masked"), (1, 3, 7, 5, torch.bfloat16, "masked"),
    (1, 3, 7, 5, torch.float32, "masked"), (2, 16, 0, 64, torch.bfloat16, "masked"),
]


def moe_block_tiles(plan, E, C, F, block):
    """The (expert, C tile, F tile) tiles one block of ``plan``'s grid computes, in order,
    as ``csrc/moe_matmul.cu`` walks them: the TMA routes' persistent block b takes tiles
    b, b + G, ... of the order (expert, F tile, C tile), C tile fastest; the other routes'
    block (x, y, z) computes F tile x, C tile y of expert z."""
    c_tiles, f_tiles = -(-C // plan.block_m), -(-F // plan.block_n)
    if plan.route in ("wgmma", "wgmma_t"):
        return [(t // (c_tiles * f_tiles), t % c_tiles, t // c_tiles % f_tiles)
                for t in range(block, plan.tiles, plan.grid[0])]
    gx, gy, _ = plan.grid
    return [(block // (gx * gy), block // gx % gy, block % gx)]


@pytest.mark.parametrize("E,C,D,F,dtype,route", MOE_PLAN_CASES)
def test_moe_launch_plan(E, C, D, F, dtype, route):
    plan = moe_mod.launch_plan(E, C, D, F, dtype)
    assert plan.route == route
    assert plan.smem_bytes <= _build.MAX_SMEM_BYTES
    tiles = E * -(-C // plan.block_m) * -(-F // plan.block_n)
    assert plan.tiles == tiles
    # every (expert, C tile, F tile) is computed by exactly one block
    walk = collections.Counter(t for b in range(math.prod(plan.grid))
                               for t in moe_block_tiles(plan, E, C, F, b))
    assert len(walk) == tiles and set(walk.values()) == {1}
    if route == "wgmma":  # 128 rows of C on two consumer warpgroups, a producer warpgroup
        assert (plan.block_m, plan.block_k, plan.threads) == (128, 64, 384)
        assert plan.block_n == (256 if D > F else 128)  # buf re-read half as often for gate/up
        assert plan.stages == (4 if plan.block_n == 256 else 6)
        # the ring, two 64 x 64 bf16 staging tiles per consumer warpgroup, barriers, alignment slack
        assert plan.smem_bytes == (1024 + plan.stages * 2 * 64 * (128 + plan.block_n)
                                   + 2 * 2 * 64 * 64 * 2 + 16 * plan.stages)
        assert plan.grid == (min(tiles, _build.NUM_SMS), 1, 1)  # persistent: a block per SM
    elif route == "wgmma_t":  # 64 columns of F by 8 rows of C; three blocks per SM
        assert (plan.block_m, plan.block_n, plan.block_k, plan.threads) == (8, 64, 64, 160)
        assert 3 * (plan.smem_bytes + 1024) <= 228 * 1024  # three fit an SM's shared memory
        assert plan.grid == (min(tiles, 3 * _build.NUM_SMS), 1, 1)
    elif route == "tf32x3":  # split TF32 on wgmma: a warpgroup per 64 rows
        assert plan.block_m == plan.block_n == (64 if C <= 64 else 128)
        assert plan.threads == 2 * plan.block_m
        assert (plan.block_k, plan.stages) == (32, 2)  # 32-deep stages, two ahead in registers
        # two sets of hi / lo planes of both operands, 1024 bytes to align them
        assert plan.smem_bytes == 1024 + 4 * 4 * 32 * (plan.block_m + plan.block_n)
        assert plan.grid == (-(-F // plan.block_n), -(-C // plan.block_m), E)
    else:  # masked: CUDA cores, one block per 64 x 64 tile, static shared memory
        assert plan.grid == (-(-F // 64), -(-C // 64), E) and plan.threads == 128
        assert plan.stages == 1


def test_moe_launch_plan_sends_unaligned_bases_to_the_masked_route():
    for dtype in (torch.bfloat16, torch.float32):
        assert moe_mod.launch_plan(40, 384, 1536, 512, dtype, aligned=False).route == "masked"


def test_moe_decode_plan_spreads_the_weights_over_the_card():
    """C = 8: a stream over the weights.  Every block is resident at once (no
    second wave), every SM holds at least two, and no block streams more than
    one unit more than another; the wide 128-column tiles of the prefill
    route would give gate/up 160 blocks, 1.2 waves."""
    for D, F in ((1536, 512), (512, 1536)):  # gate/up, down
        plan = moe_mod.launch_plan(40, 8, D, F, torch.bfloat16)
        blocks = plan.grid[0]
        assert 2 * _build.NUM_SMS <= blocks <= 3 * _build.NUM_SMS
        units = [len(moe_block_tiles(plan, 40, 8, F, b)) for b in range(blocks)]
        assert max(units) - min(units) <= 1 and sum(units) == plan.tiles

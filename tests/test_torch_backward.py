"""The backward of the port's moe_matmul and ssd_intra_chunk, and the wide RMSNorm backward, on the CPU.

- The closed forms in ``kernels/ref.py`` (what the backward kernels
  compute) against ``jax.vjp`` of the JAX references
  (``repro.kernels.ref.moe_matmul_ref``, and ``ssd_chunk_ref`` vmapped over
  chunk and head), with both cotangents of the SSD non-zero: the gradient
  relative to the reference's largest magnitude, 1e-5 in f32 (summation
  order only) and 2e-2 in bf16 (one rounding step of a value near 1 is
  2**-8).  The JAX reference takes ``exp`` before masking the upper
  triangle, so its gradient turns NaN once a chunk's decay span passes
  ~88; the strong-decay case is held against the same closed form in
  float64 and against autograd in float64 instead.
- The ``autograd.Function``s of ``kernels/ops.py`` on CPU tensors, with
  the kernel launchers replaced by the plain versions inside each test:
  their gradients must equal autograd through ``ref``.
- The backward launch plans, which the kernels refuse to deviate from.
- ``chip_smoke.path_launches`` for one training step of each model,
  against the kernels that ``loss_fn`` and its backward reach; and
  ``chip_smoke.hold_at_shape`` / ``hold_unchecked``, which hold a kernel
  at a launched shape that no case of the script covered.
"""

import collections
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels import moe_matmul as moe_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rmsnorm_mod
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.models import build_model

from _torch_parity import chip_smoke, family_inputs

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def close_to_max(name, got, want, tol):
    """max |got - want| <= tol * max |want|, and got finite."""
    got = got.detach().double() if isinstance(got, torch.Tensor) else torch.from_numpy(
        np.asarray(got, np.float64))
    want = want.detach().double() if isinstance(want, torch.Tensor) else torch.from_numpy(
        np.asarray(want, np.float64))
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    assert bool(torch.isfinite(got).all()) and err <= tol * scale, f"{name}: {err} vs {tol} x {scale}"


def both(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


# ---------------------------------------------------------------------------
# closed forms against jax.vjp
# ---------------------------------------------------------------------------


# (E, C, D, F): granite's experts cut in count, its reduced config, ragged capacities
@pytest.mark.parametrize("E,C,D,F", [(4, 24, 256, 128), (3, 8, 96, 40), (2, 130, 72, 200), (1, 1, 8, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_matmul_bwd_ref_matches_jax_vjp(E, C, D, F, dtype):
    rng = np.random.default_rng(E * C + D + F)
    jb, tb = both(rng.standard_normal((E, C, D), dtype=np.float32), dtype)
    jw, tw = both(rng.standard_normal((E, D, F), dtype=np.float32) * 0.1, dtype)
    jd, td = both(rng.standard_normal((E, C, F), dtype=np.float32), dtype)
    _, vjp = jax.vjp(jax_ref.moe_matmul_ref, jb, jw)
    want = vjp(jd)
    got = ref.moe_matmul_bwd_ref(tb, tw, td)
    for name, g, w in zip(("dbuf", "dw"), got, want):
        assert g.dtype == DTYPES[dtype][1]
        close_to_max(name, g.float(), np.asarray(w, np.float32), TOL[dtype])


def jax_ssd_vjp(x, b, c, cum, dy, dstate):
    """jax.vjp of ssd_chunk_ref vmapped over heads (b, c shared) and chunks."""
    per_head = jax.vmap(jax_ref.ssd_chunk_ref, in_axes=(0, None, None, 0))
    fn = jax.vmap(per_head, in_axes=(0, 0, 0, 0))
    _, vjp = jax.vjp(fn, x, b, c, cum)
    return vjp((dy, dstate))


def ssd_inputs(rng, BNC, H, Q, hd, N, decay=0.1):
    x = rng.standard_normal((BNC, H, Q, hd), dtype=np.float32) * 0.5
    b = rng.standard_normal((BNC, Q, N), dtype=np.float32) * 0.5
    c = rng.standard_normal((BNC, Q, N), dtype=np.float32) * 0.5
    cum = -np.cumsum(rng.random((BNC, H, Q), dtype=np.float32) * decay, axis=-1)
    dy = rng.standard_normal((BNC, H, Q, hd), dtype=np.float32)
    dstate = rng.standard_normal((BNC, H, hd, N), dtype=np.float32)
    return x, b, c, cum, dy, dstate


# (BNC, H, Q, hd, N): mamba2's 24 heads x 64 at N 128 with a short chunk, hymba's N 16,
# the reduced configs' hd 32, ragged Q
@pytest.mark.parametrize("BNC,H,Q,hd,N", [(2, 24, 48, 64, 128), (2, 5, 40, 64, 16), (3, 2, 32, 32, 16),
                                         (1, 3, 70, 32, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_intra_chunk_bwd_ref_matches_jax_vjp(BNC, H, Q, hd, N, dtype):
    rng = np.random.default_rng(BNC * Q + N)
    x, b, c, cum, dy, dstate = ssd_inputs(rng, BNC, H, Q, hd, N)
    jx, tx = both(x, dtype)
    jdy, tdy = both(dy, dtype)
    want = jax_ssd_vjp(jx, jnp.asarray(b), jnp.asarray(c), jnp.asarray(cum), jdy, jnp.asarray(dstate))
    got = ref.ssd_intra_chunk_bwd_ref(tx, torch.from_numpy(b), torch.from_numpy(c),
                                      torch.from_numpy(cum), tdy, torch.from_numpy(dstate))
    assert got[0].dtype == DTYPES[dtype][1] and all(g.dtype == torch.float32 for g in got[1:])
    for name, g, w in zip(("dx", "db", "dc", "dcum"), got, want):
        close_to_max(name, g.float(), np.asarray(w, np.float32), TOL[dtype])


def test_ssd_intra_chunk_bwd_ref_without_dstate_is_the_zero_cotangent():
    rng = np.random.default_rng(3)
    x, b, c, cum, dy, _ = ssd_inputs(rng, 2, 3, 40, 32, 16)
    t = [torch.from_numpy(a) for a in (x, b, c, cum, dy)]
    for g, w in zip(ref.ssd_intra_chunk_bwd_ref(*t, None),
                    ref.ssd_intra_chunk_bwd_ref(*t, torch.zeros(2, 3, 32, 16))):
        assert torch.equal(g, w)


def ssd_f64(x, b, c, cum):
    """The forward in float64, masked before ``exp`` as the port's reference is."""
    Q = x.shape[2]
    tri = torch.ones(Q, Q, dtype=torch.bool).tril()
    diff = cum[..., :, None] - cum[..., None, :]
    L = torch.where(tri, torch.exp(diff.masked_fill(~tri, 0.0)), 0.0)
    y = (torch.einsum("iqn,ikn->iqk", c, b)[:, None] * L) @ x
    state = torch.einsum("ihqd,iqn->ihdn", x * torch.exp(cum[..., -1:] - cum)[..., None], b)
    return y, state


def test_ssd_intra_chunk_bwd_ref_strong_decay_is_finite_and_exact():
    """A decay span of ~600 within the chunk: exp(cum_q - cum_k) overflows above the diagonal
    (where JAX's own gradient turns NaN) and underflows far below it."""
    rng = np.random.default_rng(5)
    x, b, c, cum, dy, dstate = ssd_inputs(rng, 2, 3, 64, 32, 16, decay=20.0)
    assert cum.min() < -500
    f32 = [torch.from_numpy(a) for a in (x, b, c, cum, dy, dstate)]
    got = ref.ssd_intra_chunk_bwd_ref(*f32)
    f64 = [t.double() for t in f32]
    closed = ref.ssd_intra_chunk_bwd_ref(*f64)
    leaves = [t.clone().requires_grad_() for t in f64[:4]]
    y, state = ssd_f64(*leaves)
    auto = torch.autograd.grad((y, state), leaves, (f64[4], f64[5]))
    for name, g, c64, a64 in zip(("dx", "db", "dc", "dcum"), got, closed, auto):
        assert bool(torch.isfinite(g).all()), name
        close_to_max(f"{name} f32 vs f64 closed form", g, c64, 1e-5)
        close_to_max(f"{name} f64 closed form vs autograd", c64, a64, 1e-12)
    jgot = jax_ssd_vjp(*(jnp.asarray(a) for a in (x, b, c, cum, dy, dstate)))
    assert not all(bool(jnp.isfinite(g).all()) for g in jgot)  # the reference's exp-before-where


# ---------------------------------------------------------------------------
# the autograd Functions, with the launchers replaced by the plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def plain_kernels(monkeypatch):
    """The kernel modules' launchers as the plain versions, checking that each backward
    receives contiguous gradients; returns the backward calls made."""
    calls = collections.Counter()

    def moe_bwd(buf, w, dout, *, dbuf=True, dw=True):
        assert dout.is_contiguous()
        calls["moe"] += 1
        a, b = ref.moe_matmul_bwd_ref(buf, w, dout)
        return a if dbuf else None, b if dw else None

    def ssd_bwd(x, b, c, cum, dy, dstate=None):
        assert dy.is_contiguous() and (dstate is None or dstate.is_contiguous())
        calls["ssd", dstate is None] += 1
        return ref.ssd_intra_chunk_bwd_ref(x, b, c, cum, dy, dstate)

    monkeypatch.setattr(moe_mod, "moe_matmul", ref.moe_matmul_ref)
    monkeypatch.setattr(moe_mod, "moe_matmul_bwd", moe_bwd)
    monkeypatch.setattr(ssd_mod, "ssd_intra_chunk", ref.ssd_intra_chunk_ref)
    monkeypatch.setattr(ssd_mod, "ssd_intra_chunk_bwd", ssd_bwd)
    return calls


@pytest.mark.parametrize("frozen_w", [False, True])
def test_moe_autograd_function_matches_autograd_through_ref(plain_kernels, frozen_w):
    g = torch.Generator().manual_seed(0)
    buf = torch.randn(3, 10, 24, generator=g, requires_grad=True)
    w = torch.randn(3, 24, 16, generator=g, requires_grad=not frozen_w)
    probe = torch.randn(3, 16, 10, generator=g)  # the loss reads out transposed: a strided gradient
    leaves = (buf,) if frozen_w else (buf, w)
    got = torch.autograd.grad((ops._MoeMatmul.apply(buf, w).transpose(1, 2) * probe).sum(), leaves)
    want = torch.autograd.grad((ref.moe_matmul_ref(buf, w).transpose(1, 2) * probe).sum(), leaves)
    assert plain_kernels["moe"] == 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("uses", ["y and state", "y only", "state only"])
def test_ssd_autograd_function_matches_autograd_through_ref(plain_kernels, uses):
    """A state nobody reads arrives as None (the one-chunk case), a y nobody reads as zeros."""
    rng = np.random.default_rng(7)
    x, b, c, cum, dy, dstate = (torch.from_numpy(a) for a in ssd_inputs(rng, 2, 3, 40, 32, 16))
    leaves = [t.clone().requires_grad_() for t in (x, b, c, cum)]

    def loss(fn):
        y, state = fn(*leaves)
        terms = []
        if uses != "state only":
            terms.append((y.transpose(1, 2) * dy.transpose(1, 2)).sum())
        if uses != "y only":
            terms.append((state * dstate).sum())
        return sum(terms)

    got = torch.autograd.grad(loss(ops._SsdIntraChunk.apply), leaves)
    # with only the state read, C takes no part in the plain graph: its gradient is zero
    want = torch.autograd.grad(loss(ref.ssd_intra_chunk_ref), leaves, allow_unused=True)
    assert plain_kernels["ssd", uses == "y only"] == 1
    for name, a, w in zip(("dx", "db", "dc", "dcum"), got, want):
        if w is None:
            assert uses == "state only" and name == "dc" and not a.any()
            continue
        close_to_max(name, a, w, 1e-5)


# ---------------------------------------------------------------------------
# backward launch plans: decided in Python, checked again by the kernels on the card
# ---------------------------------------------------------------------------


# (E, C, D, F, dtype, route): granite's two training products at C 256 (gate/up, down), the
# reduced config, ragged capacities 8 to 384, f32 (split TF32), and rows TMA or the f32 route's
# 16-byte loads cannot read
MOE_BWD_CASES = [
    (40, 256, 1536, 512, torch.bfloat16, "wgmma"), (40, 256, 512, 1536, torch.bfloat16, "wgmma"),
    (4, 24, 256, 128, torch.bfloat16, "wgmma"), (3, 130, 264, 200, torch.bfloat16, "wgmma"),
    (40, 8, 1536, 512, torch.bfloat16, "wgmma"), (40, 384, 512, 1536, torch.bfloat16, "wgmma"),
    (4, 24, 256, 128, torch.float32, "tf32x3"), (40, 256, 1536, 512, torch.float32, "tf32x3"),
    (3, 70, 100, 36, torch.bfloat16, "fma"), (5, 130, 200, 72, torch.float32, "tf32x3"),
    (3, 70, 102, 36, torch.float32, "fma"),
]


def _covers_each_tile_once(blocks, tiles):
    """The persistent blocks' walk (block b takes tiles b, b + blocks, ...) covers every tile once."""
    walk = collections.Counter(t for blk in range(blocks) for t in range(blk, tiles, blocks))
    return len(walk) == tiles and set(walk.values()) == {1}


@pytest.mark.parametrize("E,C,D,F,dtype,route", MOE_BWD_CASES)
def test_moe_backward_launch_plan(E, C, D, F, dtype, route):
    """Each launch (dbuf: C x D over F; dw: D x F over C) covers its output once, within the
    shared memory a block may have: wgmma on the tile width whose rounds over the SMs,
    weighed by a tile's time, are least; tf32x3 on the forward's 128 x 128 tiles (64 x 64
    where M <= 64 or those would not fill the SMs) walked by persistent blocks; fma on 128 x 128 register-blocked tiles
    where they fill the SMs, else 64 x 64."""
    plan = moe_mod.bwd_plan(E, C, D, F, dtype)
    assert plan.route == route
    for (M, N, K), lp in (((C, D, F), plan.dbuf), ((D, F, C), plan.dw)):
        assert lp.smem_bytes <= _build.MAX_SMEM_BYTES
        assert lp.tiles == E * -(-M // lp.block_m) * -(-N // lp.block_n)
        if route == "wgmma":
            assert (lp.block_m, lp.block_k, lp.threads) == (128, 64, 384) and lp.block_n in (64, 128, 256)
            assert lp.stages == 192 * 1024 // (2 * 64 * (128 + lp.block_n))
            assert lp.route == "wgmma" and lp.grid == (min(lp.tiles, _build.NUM_SMS), 1, 1)
            assert _covers_each_tile_once(lp.grid[0], lp.tiles)

            def cost(bn):  # rounds of tiles over the SMs, times a tile's stages, times a stage's time
                rounds = -(-E * -(-M // 128) * -(-N // bn) // _build.NUM_SMS)
                return rounds * -(-K // 64) * moe_mod.BWD_STAGE_COST[bn]

            assert cost(lp.block_n) == min(cost(bn) for bn in (64, 128, 256))
            assert lp.block_n == max(bn for bn in (64, 128, 256) if cost(bn) == cost(lp.block_n))
        elif route == "tf32x3":  # split TF32 on wgmma: a warpgroup per 64 rows, 32-deep stages
            wide = E * -(-M // 128) * -(-N // 128) >= _build.NUM_SMS  # 128-wide tiles fill the SMs
            bm = 128 if M > 64 and wide else 64
            assert (lp.route, lp.block_m, lp.block_n, lp.block_k, lp.stages, lp.threads) == (
                "tf32x3", bm, bm, 32, 2, 2 * bm)
            # two sets of hi / lo planes, and an f32 staging tile for the TMA-stored epilogue
            assert lp.smem_bytes == 1024 + 2 * 2 * 2 * bm * 32 * 4 + 4 * bm * bm
            blocks = moe_mod.TF_BWD_BLOCKS[bm] * _build.NUM_SMS
            assert lp.grid == (min(lp.tiles, blocks), 1, 1) and _covers_each_tile_once(lp.grid[0], lp.tiles)
            assert lp.smem_bytes * moe_mod.TF_BWD_BLOCKS[bm] <= _build.MAX_SMEM_BYTES
        else:
            assert lp.route == "fma"
            wide = E * -(-M // 128) * -(-N // 128) >= _build.NUM_SMS  # 128-wide tiles fill the SMs
            bm = 128 if wide else 64
            assert (lp.block_m, lp.block_n, lp.block_k, lp.stages, lp.threads) == (bm, bm, 16, 2, 256)
            assert lp.grid == (-(-N // bm), -(-M // bm), E)  # a block per tile
            assert lp.grid[0] * lp.grid[1] * lp.grid[2] == lp.tiles
            assert lp.smem_bytes == 2 * 2 * 16 * (bm + 4) * 4 <= 48 * 1024  # static shared memory
    assert moe_mod.bwd_plan(E, C, D, F, dtype, aligned=False).route == "fma"


# granite-moe-3b-a800m's LM products at C 256: the route and tiles each launch takes
@pytest.mark.parametrize("D,F,dtype,dbuf_tile,dw_tile", [
    (512, 1536, torch.bfloat16, (128, 128), (128, 128)),  # down
    (1536, 512, torch.bfloat16, (128, 256), (128, 128)),  # gate/up: 480 dbuf tiles in 4 rounds
    (1536, 512, torch.float32, (128, 128), (128, 128)),  # 960 dbuf, 1920 dw tiles over 132 blocks
    (512, 1536, torch.float32, (128, 128), (128, 128)),  # 320 dbuf, 1920 dw tiles
])
def test_moe_backward_tiles_at_granites_shapes(D, F, dtype, dbuf_tile, dw_tile):
    plan = moe_mod.bwd_plan(40, 256, D, F, dtype)
    assert plan.dbuf.route == plan.dw.route == ("wgmma" if dtype == torch.bfloat16 else "tf32x3")
    assert (plan.dbuf.block_m, plan.dbuf.block_n) == dbuf_tile
    assert (plan.dw.block_m, plan.dw.block_n) == dw_tile
    if dtype == torch.float32:
        assert plan.dbuf.grid == plan.dw.grid == (_build.NUM_SMS, 1, 1)


# a phase 10 rank's reduced granite step (4 experts, C 128, gate/up and down) and the reduced
# widths at a ragged C: 128 x 128 tiles would leave most SMs idle, so both launches take 64 x 64
@pytest.mark.parametrize("E,C,D,F", [(4, 128, 256, 128), (4, 128, 128, 256), (4, 130, 256, 128)])
def test_moe_backward_f32_tiles_at_the_reduced_shapes(E, C, D, F):
    plan = moe_mod.bwd_plan(E, C, D, F, torch.float32)
    for lp in (plan.dbuf, plan.dw):
        assert (lp.route, lp.block_m, lp.block_n, lp.threads) == ("tf32x3", 64, 64, 128)
        assert lp.grid == (lp.tiles, 1, 1) and lp.tiles <= moe_mod.TF_BWD_BLOCKS[64] * _build.NUM_SMS


def test_moe_backward_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        moe_mod.moe_matmul_bwd(torch.randn(2, 8, 16), torch.randn(2, 16, 4), torch.randn(2, 8, 4))
    assert ops.launch_counts()["moe_matmul_bwd_dbuf"] == ops.launch_counts()["moe_matmul_bwd_dw"] == 0


# (BNC, H, Q, hd, N): mamba2 and hymba at 2 x 512 (NC 2), the reduced configs, ragged Q
@pytest.mark.parametrize("BNC,H,Q,hd,N", [(4, 24, 256, 64, 128), (4, 50, 256, 64, 16), (4, 8, 32, 32, 16),
                                         (2, 3, 100, 32, 64), (1, 1, 1, 64, 128), (70, 7, 160, 64, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_launch_plan(BNC, H, Q, hd, N, dtype):
    plan = ssd_mod.bwd_plan(BNC, H, Q, hd, N, dtype)
    assert plan.route == ("mma2" if dtype == torch.bfloat16 else "mma3") and plan.threads == 128
    assert plan.row_tiles == -(-Q // 64) and plan.grid == (plan.groups, BNC, plan.row_tiles)
    # the head groups cover every head once: the last one holds what is left
    g = plan.heads_per_block
    assert 1 <= g <= (2 if dtype == torch.bfloat16 else 1) and plan.groups == -(-H // g)
    assert (plan.groups - 1) * g < H <= plan.groups * g
    # the largest group whose grid still gives every SM a block (one head where none does)
    assert g == 1 or BNC * plan.row_tiles * plan.groups >= _build.NUM_SMS
    assert plan.smem_bytes <= _build.MAX_SMEM_BYTES and plan.reduce_smem_bytes <= _build.MAX_SMEM_BYTES
    assert plan.blocks_per_sm == ssd_mod.SM_SMEM_BYTES // (plan.smem_bytes + 1024) >= 2
    longer = ssd_mod.bwd_plan(BNC, H, 4 * Q, hd, N, dtype)  # nothing Q x Q in shared memory
    assert (longer.smem_bytes, longer.reduce_smem_bytes) == (plan.smem_bytes, plan.reduce_smem_bytes)
    rq = 64 * plan.row_tiles
    assert plan.scratch == (BNC, plan.groups, rq, rq)
    assert plan.scratch_bytes == 4 * (BNC * plan.groups * rq * (rq + N)
                                      + BNC * H * (Q * (4 * plan.row_tiles + 1) + 4 * plan.row_tiles))
    assert plan.reduce_grid == (rq // 16, 2, BNC) and plan.reduce_threads == 256


def test_ssd_backward_plan_at_the_lm_shapes():
    """mamba2's and hymba's LM chunks (2 x 512, four of 256): two heads a block on bf16 x, two
    blocks an SM or more, and the scratch of the groups' dM∘L sums."""
    mamba2 = ssd_mod.bwd_plan(4, 24, 256, 64, 128, torch.bfloat16)
    hymba = ssd_mod.bwd_plan(4, 50, 256, 64, 16, torch.bfloat16)
    assert (mamba2.heads_per_block, mamba2.groups, mamba2.grid) == (2, 12, (12, 4, 4))
    assert (hymba.heads_per_block, hymba.groups, hymba.grid) == (2, 25, (25, 4, 4))
    assert mamba2.scratch == (4, 12, 256, 256) and hymba.scratch == (4, 25, 256, 256)
    for dtype in (torch.bfloat16, torch.float32):
        for shape in ((4, 24, 256, 64, 128), (4, 50, 256, 64, 16)):
            assert ssd_mod.bwd_plan(*shape, dtype).blocks_per_sm >= 2


def test_ssd_backward_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="N <= 128"):
        ssd_mod.bwd_plan(2, 4, 64, 64, 129, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        ssd_mod.bwd_plan(2, 4, 64, 48, 16, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        x = torch.randn(1, 2, 8, 32)
        b = torch.randn(1, 8, 16)
        ssd_mod.ssd_intra_chunk_bwd(x, b, b, -torch.rand(1, 2, 8).cumsum(-1), x)


@pytest.mark.parametrize("T,D", [(1024, 3200), (1024, 4096), (1, 2049), (7, 3200), (2560, 8192), (300, 2056)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_wide_plan(T, D, dtype):
    """Past 2048 a block takes a row and the persistent grid covers every row once; rows
    that are 16-byte aligned take the ring route: two teams on alternate rows
    where a block has two, in a team a thread per 16-byte chunk (two past 512 chunks, four
    past 1024 with one team), and as many rows in flight as 192 KB hold, at most the
    block's, a multiple of the teams; the rest the block route.  Neither needs shared
    memory for the dweight partials (each thread owns its columns)."""
    plan = rmsnorm_mod.bwd_plan(T, D, dtype)
    assert plan.blocks <= min(T, _build.NUM_SMS)
    assert (plan.blocks - 1) * plan.rows_per_block < T <= plan.blocks * plan.rows_per_block
    assert rmsnorm_mod.bwd_plan(T, D, dtype, dweight=False) == plan
    assert plan.smem_bytes <= _build.MAX_SMEM_BYTES
    elem = torch.finfo(dtype).bits // 8
    row = D * elem
    if row % 16:
        assert (plan.route, plan.threads, plan.smem_bytes, plan.stages) == ("block", 256, 0, 1)
    else:
        chunks = row // 16
        assert plan.route == "ring"
        assert plan.ring_chunks == (1 if chunks <= 512 else 2 if chunks <= 1024 else 4)
        assert plan.teams == (2 if plan.rows_per_block >= 2 and plan.ring_chunks < 4 else 1)
        # every chunk of a row has a thread of each team, and no whole warp idles
        team = plan.threads // plan.teams
        assert team % 32 == 0 and plan.threads <= 1024 and team <= 512
        assert (team - 32) * plan.ring_chunks < chunks <= team * plan.ring_chunks
        fit = min(plan.rows_per_block, rmsnorm_mod.RING_BYTES // (2 * row))
        assert plan.stages % plan.teams == 0 and fit - plan.teams < plan.stages <= max(fit, plan.teams)
        assert plan.smem_bytes == plan.stages * (2 * row + 8)
        assert plan.stages >= min(2, plan.rows_per_block)  # two rows in flight where a block has two
    unaligned = rmsnorm_mod.bwd_plan(T, D, dtype, aligned=False)
    assert (unaligned.route, unaligned.threads, unaligned.smem_bytes) == ("block", 256, 0)
    assert (unaligned.blocks, unaligned.rows_per_block) == (plan.blocks, plan.rows_per_block)
    assert rmsnorm_mod.bwd_plan(T, 2048, dtype).route == "warp"  # B6's rows keep their route


# hymba-1.5b's out_norm [1024, 3200] and the d-4096 models' norms [1024, 4096], bf16 and f32
@pytest.mark.parametrize("D,dtype,threads,chunks,stages", [
    (3200, torch.bfloat16, 2 * 416, 1, 8), (4096, torch.bfloat16, 2 * 512, 1, 8),
    (3200, torch.float32, 2 * 416, 2, 6), (4096, torch.float32, 2 * 512, 2, 6)])
def test_rmsnorm_backward_ring_at_the_models_shapes(D, dtype, threads, chunks, stages):
    plan = rmsnorm_mod.bwd_plan(1024, D, dtype)
    assert (plan.route, plan.blocks, plan.rows_per_block, plan.teams) == ("ring", 128, 8, 2)
    assert (plan.threads, plan.ring_chunks, plan.stages) == (threads, chunks, stages)


# ---------------------------------------------------------------------------
# chip_smoke.py's training launch counts, against the kernels the code reaches
# ---------------------------------------------------------------------------


class _Backward(torch.autograd.Function):
    """Identity on an op's outputs whose backward records the backward kernels the op's
    own ``autograd.Function`` would launch on the card."""

    @staticmethod
    def forward(ctx, names, calls, *outs):
        ctx.names, ctx.calls = names, calls
        return tuple(o.clone() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.calls.update(ctx.names)
        return (None, None, *grads)


def _backward_kernels(fname, args):
    if fname == "rmsnorm_op":
        x, w = args[:2]
        names = ["rmsnorm_bwd" if rmsnorm_mod.bwd_plan(x.numel() // x.shape[-1], x.shape[-1]).route
                 == "warp" else "rmsnorm_bwd_wide"]
        return names + (["rmsnorm_bwd_dweight"] if w.requires_grad else [])
    if fname == "flash_attention_op":
        return ["flash_attention_bwd_dq", "flash_attention_bwd_dkdv"]
    if fname == "cross_attention_op":  # B11: its own two kernels in bf16, B5's pair in f32
        return (["cross_attention_bwd_stats", "cross_attention_bwd_fused"] if args[0].dtype == torch.bfloat16
                else ["flash_attention_bwd_dq", "flash_attention_bwd_dkdv"])
    if fname == "moe_matmul_op":
        return [n for n, t in zip(("moe_matmul_bwd_dbuf", "moe_matmul_bwd_dw"), args) if t.requires_grad]
    return ["ssd_intra_chunk_bwd", "ssd_intra_chunk_bwd_reduce"]


OPS = {"rmsnorm_op": "rmsnorm", "flash_attention_op": "flash_attention",
       "moe_matmul_op": "moe_matmul", "ssd_intra_chunk_op": "ssd_intra_chunk",
       "cross_attention_op": "cross_attention"}


def wide_hymba():
    """Reduced hymba with an SSM d_inner of 2304: its out_norm takes the wide backward route."""
    cfg = get_config("hymba-1.5b").reduced()
    return dataclasses.replace(cfg, name=cfg.name + "-wide", ssm_expand=9)


TRAIN_COUNT_ARCHS = ["smollm-360m", "llama3.2-1b", "granite-moe-3b-a800m", "mamba2-130m",
                     "hymba-1.5b", "wide", "internvl2-1b", "whisper-medium"]


# each arch as its config gives it (remat on), and with ":remat-off"
@pytest.mark.parametrize("arch", TRAIN_COUNT_ARCHS + [a + ":remat-off" for a in TRAIN_COUNT_ARCHS])
def test_chip_smoke_training_launch_counts_follow_the_code(arch, monkeypatch):
    """On the card every ``ops`` call under grad launches its kernel once and, in the
    backward, its backward kernels once each; ``chip_smoke.path_launches`` must predict
    the launches of one training step (``loss_fn`` and its gradient), family by family,
    with the layers rematerialised (their forward kernels run again in the backward)
    and without."""
    arch, _, off = arch.partition(":")
    cfg = wide_hymba() if arch == "wide" else get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, remat=not off)
    assert arch != "wide" or cfg.d_inner > rmsnorm_mod.BWD_WARP_MAX_DIM
    api = build_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), "cpu", trainable=True)
    calls = collections.Counter()
    for fname, kernel in OPS.items():
        def call(*a, _fn=getattr(ops, fname), _k=kernel, _f=fname, **kw):
            calls.update([_k])
            out = _fn(*a, **kw)
            if not any(isinstance(t, torch.Tensor) and t.requires_grad for t in a):
                return out
            outs = _Backward.apply(_backward_kernels(_f, a), calls,
                                   *(out if isinstance(out, tuple) else (out,)))
            return outs if isinstance(out, tuple) else outs[0]

        monkeypatch.setattr(ops, fname, call)
    seq = 64 if cfg.family in ("ssm", "hybrid") else 16  # two SSD chunks of 32
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, seq)))
    loss, _ = api.loss_fn(params, {"tokens": toks, **family_inputs(cfg, 2)})
    torch.autograd.grad(loss, [p for _, p in params.named_parameters()], allow_unused=True)
    expect = chip_smoke().path_launches(cfg, 0, 0, train_steps=1)
    assert expect.keys() == ops.launch_counts().keys()
    assert {k: calls[k] for k in expect} == expect
    if arch == "wide":
        assert expect["rmsnorm_bwd_wide"] == cfg.num_layers
    assert math.isfinite(float(loss.detach()))


# chip_smoke.py holds a kernel at any launched shape that no case of its phases 3 and 5
# covered: hold_at_shape turns the recorded shape key back into inputs and holds the
# kernel (through ``ops``) against its plain version.  On the CPU ``ops`` runs the plain
# versions, so a correct op holds with no error and a perturbed one must be refused.
HOLD_CASES = [
    ("rmsnorm", (5, 48, torch.float32)),
    ("rmsnorm_bwd", (7, 40, torch.bfloat16)),
    ("flash_attention", (2, 7, 1, 9, 16, True, torch.float32)),
    ("flash_attention_bwd", (1, 4, 2, 11, 8, False, torch.float32)),
    ("moe_matmul", (3, 5, 16, 12, torch.bfloat16)),
    ("moe_matmul_bwd", (2, 6, 8, 10, torch.float32)),
    ("ssd_intra_chunk", (2, 3, 8, 4, 5, torch.float32)),
    ("ssd_intra_chunk_bwd", (2, 2, 6, 4, 3, torch.float32)),
]
HOLD_OPS = {"rmsnorm": "rmsnorm_op", "flash_attention": "flash_attention_op",
            "moe_matmul": "moe_matmul_op", "ssd_intra_chunk": "ssd_intra_chunk_op"}


@pytest.mark.parametrize("kernel,key", HOLD_CASES, ids=[k for k, _ in HOLD_CASES])
def test_chip_smoke_hold_at_shape_refuses_a_wrong_kernel(kernel, key, monkeypatch):
    cs = chip_smoke()
    gen = torch.Generator().manual_seed(0)
    assert cs.hold_at_shape(kernel, key, "cpu", gen) == 0.0
    fname = HOLD_OPS[kernel.removesuffix("_bwd")]
    right = getattr(ops, fname)

    def wrong(*a, **kw):  # 10% off in the first output, so in its gradient too
        out = right(*a, **kw)
        return (out[0] * 1.1, *out[1:]) if isinstance(out, tuple) else out * 1.1

    monkeypatch.setattr(ops, fname, wrong)
    with pytest.raises(AssertionError, match="held where it was launched"):
        cs.hold_at_shape(kernel, key, "cpu", gen)


def test_chip_smoke_hold_unchecked_holds_only_what_no_case_covered():
    cs = chip_smoke()
    f32 = torch.float32
    shapes = {("rmsnorm", (4, 8, f32)), ("rmsnorm", (3, 8, f32)),
              ("flash_attention_bwd", (1, 2, 2, 5, 8, True, f32))}
    checked = {"rmsnorm": {(4, 8, f32)}}
    held = []
    got = cs.hold_unchecked("t", shapes, checked, lambda k, key: held.append((k, key)) or 0.0)
    want = [("flash_attention_bwd", (1, 2, 2, 5, 8, True, f32)), ("rmsnorm", (3, 8, f32))]
    assert got == held == want
    assert checked == {"rmsnorm": {(4, 8, f32), (3, 8, f32)},
                       "flash_attention_bwd": {(1, 2, 2, 5, 8, True, f32)}}
    assert cs.hold_unchecked("t", shapes, checked, lambda k, key: 1 / 0) == []


# ---------------------------------------------------------------------------
# the launcher trains every token family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mamba2-130m", "hymba-1.5b"])
def test_launcher_trains_the_moe_ssm_and_hybrid_families(arch):
    """build_trainer / train, reduced on the CPU (the SSM families on two chunks a
    sequence), as chip_smoke.py drives them at full width on the card."""
    from repro_torch.launch.train import build_trainer, train

    seq = 64 if arch != "granite-moe-3b-a800m" else 16
    trainer = build_trainer(arch, steps=2, batch=2, seq=seq, device="cpu")
    metrics = train(trainer, 2, log=lambda _: None)
    assert len(metrics) == 2 and all(math.isfinite(m["loss"]) and m["grad_norm"] > 0 for m in metrics)


def test_trainer_from_config_takes_a_depth_cut():
    """chip_smoke.py trains granite at full width on fewer layers through this builder."""
    from repro_torch.launch.train import build_trainer, train, trainer_from_config

    reduced = get_config("granite-moe-3b-a800m").reduced()
    whole = build_trainer("granite-moe-3b-a800m", device="cpu")
    assert whole.cfg == reduced and reduced.num_layers > 1
    cut = dataclasses.replace(reduced, num_layers=1)
    trainer = trainer_from_config(cut, steps=1, batch=2, seq=16, device="cpu")
    assert trainer.cfg == cut and trainer.api.param_count() < whole.api.param_count()
    metrics = train(trainer, 1, log=lambda _: None)
    assert math.isfinite(metrics[0]["loss"])

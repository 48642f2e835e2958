"""Card tests of the port: each CUDA kernel against its plain version, and the
model on the card against the same weights on the CPU.

The backward kernels (flash, rmsnorm on both of its routes, moe_matmul,
ssd_intra_chunk) are held against autograd through the plain versions
(``kernels/ref.py``), relative to the reference gradient's largest
magnitude: 2e-2 in bf16 (one rounding step of a value near 1 is 2**-8; the
reference rounds P, dS and its einsum outputs at other places), 1e-4 in
f32 (the two differ only in summation order over at most 8192 terms).
One reduced LM step of the moe, ssm and hybrid configs in f32 is held
against the CPU within 1e-3 of each gradient's largest magnitude, as
``chip_smoke.py`` phase 8 holds it.  A reference gradient that is exactly 0 (dq and dk at S = 1:
one key per query, so the softmax passes no gradient) has no magnitude;
the kernel's values there are the f32 rounding of dP - D, two sums of d
products of unit-normal inputs (~1e-6), held to ``ZERO_GRAD_ABS``.

Marked ``gpu``; each test asks the ``cuda`` fixture, which skips where
``torch.cuda.is_available()`` is false.  This file imports no JAX, so it
runs where only PyTorch is installed:
``python -m pytest -m gpu tests/test_torch_gpu.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import moe_matmul as moe_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rmsnorm_mod
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.models import build_model
from repro_torch.models.convert import flat_from_params, params_from_flat
from repro_torch.serving.engine import Engine, GenerationConfig

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def tensor(rng, shape, dtype, device, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale).to(device, dtype)


def close(got, want, tol):
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(), rtol=tol, atol=tol)


ZERO_GRAD_ABS = 1e-5


def close_to_max(name, got, want, tol):
    """max |got - want| <= tol * max |want| (ZERO_GRAD_ABS where want is all 0), and got finite."""
    assert got.shape == want.shape and got.dtype == want.dtype, name
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    limit = tol * scale if scale > 0 else ZERO_GRAD_ABS
    assert bool(torch.isfinite(got).all()) and err <= limit, f"{name}: err {err} vs {limit} ({tol} * {scale})"


def grad_tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 1e-4


# hymba-1.5b's rows: d 1600, and the SSM's out_norm over d_inner 3200; internvl2-1b's 896,
# whisper-medium's 1024 (6000 rows: its encoder over 4 x 1500 frames), llama3-8b's and glm4-9b's 4096
@pytest.mark.parametrize("T,D", [(1, 960), (7, 960), (512, 960), (1280, 2048), (3, 100),
                                 (512, 1600), (4, 3200), (1280, 3200), (4, 896), (1536, 896),
                                 (4, 1024), (6000, 1024), (4, 4096), (1280, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel(cuda, T, D, dtype):
    rng = np.random.default_rng(T + D)
    x, w = tensor(rng, (T, D), dtype, cuda, 3.0), 1 + tensor(rng, (D,), dtype, cuda, 0.1)
    before = ops.launch_counts()["rmsnorm"]
    got = ops.rmsnorm_op(x, w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rmsnorm"] == before + 1
    close(got, ref.rmsnorm_ref(x, w), 2e-2 if dtype == torch.bfloat16 else 1e-5)


def test_rmsnorm_kernel_strided_rows(cuda):
    rng = np.random.default_rng(0)
    x = tensor(rng, (4, 9, 960), torch.bfloat16, cuda)[:, -1:, :]  # [4, 1, 960] with row stride 9*960
    w = 1 + tensor(rng, (960,), torch.bfloat16, cuda, 0.1)
    close(ops.rmsnorm_op(x, w), ref.rmsnorm_ref(x, w), 2e-2)


# GQA groups g = H / KV of the served models (1, 3, 4, 5, 7, 16), ragged and whole 64-row tiles;
# hymba-1.5b's prefill and score (H 25, KV 5: an odd head count); whisper-medium's encoder
# (H 16 = KV 16 over its 1500 frames), internvl2-1b's prefill (H 14, KV 2, 256 patches + 128)
# and glm4-9b's score (H 32, KV 2, d 128)
FLASH_SHAPES = [
    (1, 2, 2, 24, 64), (2, 4, 2, 100, 64), (2, 6, 2, 160, 64), (1, 8, 2, 1000, 128), (1, 4, 1, 33, 128),
    (4, 25, 5, 128, 64), (8, 25, 5, 160, 64), (2, 16, 16, 1500, 64), (4, 14, 2, 384, 64),
    (8, 32, 2, 160, 128),
] + [(2, 2 * g, 2, S, d) for g in (1, 3, 4, 5, 7, 16) for S in (1, 15, 64, 65, 160, 1000)
     for d in (64, 128)]


@pytest.mark.parametrize("B,H,KV,S,d", FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel(cuda, B, H, KV, S, d, causal, dtype):
    rng = np.random.default_rng(B * H * S + d)
    q = tensor(rng, (B, H, S, d), dtype, cuda)
    k = tensor(rng, (B, KV, S, d), dtype, cuda)
    v = tensor(rng, (B, KV, S, d), dtype, cuda)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention_op(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    close(got, ref.flash_attention_ref(q, k, v, causal), 2e-2 if dtype == torch.bfloat16 else 2e-5)
    # [B,S,H,d] memory as transposed views, read in place: the same numbers
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    assert torch.equal(ops.flash_attention_op(*views, causal=causal), got)


# the chip phase's backward grid: GQA g, S (ragged and whole tiles), d; then S on
# either side of the 128-row and 128-key tiles and of S = 256, where the plans
# change from one consumer warpgroup to two
FLASH_BWD_SHAPES = [(2, 2 * g, 2, S, d) for g in (1, 3, 4, 5, 7, 16) for S in (1, 63, 65, 160, 1024)
                    for d in (64, 128)] + [
    (2, 2 * g, 2, S, d) for g in (1, 4) for S in (127, 129, 255, 257) for d in (64, 128)] + [
    (2, 16, 16, 1500, 64), (4, 14, 2, 512, 64), (2, 32, 2, 256, 128)]  # whisper, internvl, glm LM


@pytest.mark.parametrize("B,H,KV,S,d", FLASH_BWD_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernels(cuda, B, H, KV, S, d, causal, dtype):
    """dq, dk, dv through ops (the autograd Function) against autograd through the plain version."""
    rng = np.random.default_rng(B * H * S + d + 7)
    q, k, v, dout = (tensor(rng, shape, dtype, cuda).requires_grad_(i < 3)
                     for i, shape in enumerate([(B, H, S, d), (B, KV, S, d), (B, KV, S, d), (B, H, S, d)]))
    want = torch.autograd.grad(ref.flash_attention_ref(q, k, v, causal), (q, k, v), dout)
    before = ops.launch_counts()
    got = torch.autograd.grad(ops.flash_attention_op(q, k, v, causal=causal), (q, k, v), dout)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    for name in ("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkdv"):
        assert after[name] == before[name] + 1, name
    for name, g, w in zip("qkv", got, want):
        close_to_max(f"d{name}", g, w, grad_tol(dtype))


def test_flash_backward_keeps_the_model_layout(cuda):
    """[B,S,H,d] memory as transposed views: gradients come back in that layout, same numbers."""
    rng = np.random.default_rng(3)
    B, H, KV, S, d = 2, 15, 5, 160, 64
    q, k, v = (tensor(rng, (B, S, n, d), torch.bfloat16, cuda).requires_grad_() for n in (H, KV, KV))
    dout = tensor(rng, (B, H, S, d), torch.bfloat16, cuda)
    views = [t.transpose(1, 2) for t in (q, k, v)]
    got = torch.autograd.grad(ops.flash_attention_op(*views), views, dout)
    dense = [t.detach().transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ops.flash_attention_op(*dense), dense, dout)
    for g, w, t in zip(got, want, views):
        assert g.stride() == t.stride()
        assert torch.equal(g, w)


@pytest.mark.parametrize("B,H,KV,S,causal", [(16, 15, 5, 160, True), (4, 32, 8, 2048, True)])
def test_flash_backward_is_deterministic(cuda, B, H, KV, S, causal):
    """No atomics: two calls on the same inputs give the same bits (GRPO shape, long S)."""
    rng = np.random.default_rng(S + H)
    q, k, v, dout = (tensor(rng, shape, torch.bfloat16, cuda) for shape in
                     [(B, H, S, 64), (B, KV, S, 64), (B, KV, S, 64), (B, H, S, 64)])
    out, lse = flash_mod.flash_attention(q, k, v, causal=causal, lse=True)
    first = flash_mod.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    second = flash_mod.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("T,D", [(2560, 960), (1024, 2048)])
def test_rmsnorm_backward_is_deterministic(cuda, T, D):
    """The dweight column sums run in a fixed order: two calls give the same bits."""
    rng = np.random.default_rng(T)
    x = tensor(rng, (T, D), torch.bfloat16, cuda, 3.0)
    w = 1 + tensor(rng, (D,), torch.bfloat16, cuda, 0.1)
    dy = tensor(rng, (T, D), torch.bfloat16, cuda)
    first, second = (rmsnorm_mod.rmsnorm_bwd(x, w, dy) for _ in range(2))
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.parametrize("T,D", [(2560, 960), (1024, 2048), (1, 960), (7, 960), (3, 100), (300, 64),
                                 (2048, 896), (3000, 1024), (896, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_kernels(cuda, T, D, dtype):
    rng = np.random.default_rng(T + D + 11)
    x = tensor(rng, (T, D), dtype, cuda, 3.0).requires_grad_()
    w = (1 + tensor(rng, (D,), dtype, cuda, 0.1)).requires_grad_()
    dy = tensor(rng, (T, D), dtype, cuda)
    want = torch.autograd.grad(ref.rmsnorm_ref(x, w), (x, w), dy)
    before = ops.launch_counts()
    got = torch.autograd.grad(ops.rmsnorm_op(x, w), (x, w), dy)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    for name in ("rmsnorm", "rmsnorm_bwd", "rmsnorm_bwd_dweight"):
        assert after[name] == before[name] + 1, name
    close_to_max("dx", got[0], want[0], grad_tol(dtype))
    close_to_max("dweight", got[1], want[1], grad_tol(dtype))


def test_rmsnorm_backward_strided_rows_and_frozen_weight(cuda):
    rng = np.random.default_rng(5)
    base = tensor(rng, (4, 9, 960), torch.bfloat16, cuda).requires_grad_()
    x = base[:, -1:, :]  # rows 9*960 apart
    w = 1 + tensor(rng, (960,), torch.bfloat16, cuda, 0.1)  # no gradient wanted
    dy = tensor(rng, (4, 1, 960), torch.bfloat16, cuda)
    before = ops.launch_counts()["rmsnorm_bwd_dweight"]
    (got,) = torch.autograd.grad(ops.rmsnorm_op(x, w), (base,), dy)
    assert ops.launch_counts()["rmsnorm_bwd_dweight"] == before
    (want,) = torch.autograd.grad(ref.rmsnorm_ref(x, w), (base,), dy)
    close_to_max("dx", got, want, 2e-2)


def test_moe_and_ssd_kernels_refuse_to_drop_gradients(cuda):
    """Under grad mode the entry points go through their autograd Functions: the forward
    kernel, then the backward kernels, never a tensor without a gradient or the plain path."""
    buf = torch.randn(2, 8, 16, device=cuda, requires_grad=True)
    w = torch.randn(2, 16, 8, device=cuda)
    x = torch.randn(1, 2, 8, 32, device=cuda, requires_grad=True)
    b = torch.randn(1, 8, 16, device=cuda)
    cum = -torch.rand(1, 2, 8, device=cuda).cumsum(-1)
    before = ops.launch_counts()
    out = ops.moe_matmul_op(buf, w)
    y, state = ops.ssd_intra_chunk_op(x, b, b, cum)
    assert out.requires_grad and y.requires_grad and state.requires_grad
    (out.sum() + y.sum() + state.sum()).backward()
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in ops.launch_counts().items() if v != before[k]}
    assert got == {"moe_matmul": 1, "moe_matmul_bwd_dbuf": 1, "ssd_intra_chunk": 1,
                   "ssd_intra_chunk_bwd": 1, "ssd_intra_chunk_bwd_reduce": 1}  # w is frozen: no dw
    close_to_max("dbuf", buf.grad, torch.autograd.grad(
        ref.moe_matmul_ref(buf, w).sum(), buf)[0], 1e-4)
    with torch.inference_mode():
        assert ops.moe_matmul_op(buf, w).shape == (2, 8, 8)
        assert ops.ssd_intra_chunk_op(x, b, b, cum)[0].shape == x.shape


# (E, C, D, F): granite's LM products at C 256 (gate/up, down), its decode and score capacities,
# the reduced config, partial tiles, and rows TMA cannot read
MOE_BWD_SHAPES = [(40, 256, 1536, 512), (40, 256, 512, 1536), (40, 8, 1536, 512), (40, 384, 512, 1536),
                  (4, 24, 256, 128), (3, 130, 264, 200), (2, 200, 136, 520), (3, 70, 100, 36), (1, 3, 7, 5),
                  (40, 130, 1536, 512), (40, 1, 512, 1536)]  # ragged C on the 128-wide tiles, C = 1


@pytest.mark.parametrize("E,C,D,F", MOE_BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_matmul_backward_kernels(cuda, E, C, D, F, dtype):
    """dbuf and dw through ops (the autograd Function) against autograd through the plain
    version; two direct calls give the same bits."""
    rng = np.random.default_rng(E * C + D + F)
    buf = tensor(rng, (E, C, D), dtype, cuda).requires_grad_()
    w = tensor(rng, (E, D, F), dtype, cuda, 0.05).requires_grad_()
    dout = tensor(rng, (E, C, F), dtype, cuda)
    want = torch.autograd.grad(ref.moe_matmul_ref(buf, w), (buf, w), dout)
    before = ops.launch_counts()
    got = torch.autograd.grad(ops.moe_matmul_op(buf, w), (buf, w), dout)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    for name in ("moe_matmul", "moe_matmul_bwd_dbuf", "moe_matmul_bwd_dw"):
        assert after[name] == before[name] + 1, name
    for name, g, ww in zip(("dbuf", "dw"), got, want):
        close_to_max(name, g, ww, grad_tol(dtype))
    first, second = (moe_mod.moe_matmul_bwd(buf.detach(), w.detach(), dout) for _ in range(2))
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.parametrize("offset", ["buf", "w", "dout"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_matmul_backward_takes_an_unaligned_operand(cuda, offset, dtype):
    """One operand contiguous but one element off 16 bytes: in bf16 the launch that reads
    it takes the fma route and the other stays on wgmma, each planned from its own
    pointers; in f32 (the fma route) that launch loads element by element.  Two calls
    give the same bits."""
    rng = np.random.default_rng(11)
    E, C, D, F = 3, 40, 64, 72
    shapes = {"buf": (E, C, D), "w": (E, D, F), "dout": (E, C, F)}
    t = {k: (tensor(rng, (int(np.prod(s)) + 1,), dtype, cuda)[1:].view(s) if k == offset
             else tensor(rng, s, dtype, cuda)) for k, s in shapes.items()}
    assert t[offset].data_ptr() % 16 and t[offset].is_contiguous()
    dbuf, dw = moe_mod.moe_matmul_bwd(t["buf"], t["w"], t["dout"])
    again = moe_mod.moe_matmul_bwd(t["buf"], t["w"], t["dout"])
    assert torch.equal(dbuf, again[0]) and torch.equal(dw, again[1])
    buf, w = t["buf"].clone().requires_grad_(), t["w"].clone().requires_grad_()
    want = torch.autograd.grad(ref.moe_matmul_ref(buf, w), (buf, w), t["dout"])
    close_to_max("dbuf", dbuf, want[0], grad_tol(dtype))
    close_to_max("dw", dw, want[1], grad_tol(dtype))


# (BNC, H, Q, hd, N): mamba2 and hymba at 2 x 512 (four chunks of 256), the reduced configs,
# ragged Q, N 64; two heads a block with an odd H, at a ragged Q and at a Q below 64
SSD_BWD_SHAPES = [(4, 24, 256, 64, 128), (4, 50, 256, 64, 16), (4, 8, 32, 32, 16), (2, 3, 100, 32, 64),
                  (2, 2, 1, 64, 128), (3, 7, 160, 64, 128), (40, 5, 100, 64, 128), (160, 3, 48, 32, 64)]


@pytest.mark.parametrize("BNC,H,Q,hd,N", SSD_BWD_SHAPES)
@pytest.mark.parametrize("dstate", ["absent", "zero", "non-zero"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_intra_chunk_backward_kernels(cuda, BNC, H, Q, hd, N, dstate, dtype):
    """dx, db, dc, dcum through ops against autograd through the plain version; the state's
    gradient absent (nothing reads it), zero or not; two direct calls give the same bits."""
    if (BNC, H, Q) in ((40, 5, 100), (160, 3, 48)) and dtype == torch.bfloat16:
        assert ssd_mod.bwd_plan(BNC, H, Q, hd, N, dtype).heads_per_block == 2  # the last group has one
    rng = np.random.default_rng(BNC * Q + N + hd)
    x = tensor(rng, (BNC, H, Q, hd), dtype, cuda, 0.5).requires_grad_()
    b, c = (tensor(rng, (BNC, Q, N), torch.float32, cuda, 0.5).requires_grad_() for _ in range(2))
    cum = (-torch.cumsum(torch.from_numpy(rng.random((BNC, H, Q), dtype=np.float32) * 0.1), -1)
           ).to(cuda).requires_grad_()
    dy = tensor(rng, (BNC, H, Q, hd), dtype, cuda)
    ds = None if dstate == "absent" else (torch.zeros(BNC, H, hd, N, device=cuda) if dstate == "zero"
                                          else tensor(rng, (BNC, H, hd, N), torch.float32, cuda))

    def loss(fn):
        y, state = fn(x, b, c, cum)
        return (y.float() * dy.float()).sum() + ((state * ds).sum() if ds is not None else 0)

    want = torch.autograd.grad(loss(ref.ssd_intra_chunk_ref), (x, b, c, cum))
    before = ops.launch_counts()
    got = torch.autograd.grad(loss(ops.ssd_intra_chunk_op), (x, b, c, cum))
    torch.cuda.synchronize()
    after = ops.launch_counts()
    for name in ("ssd_intra_chunk", "ssd_intra_chunk_bwd", "ssd_intra_chunk_bwd_reduce"):
        assert after[name] == before[name] + 1, name
    for name, g, w in zip(("dx", "db", "dc", "dcum"), got, want):
        close_to_max(name, g, w, grad_tol(dtype))
    args = (x.detach(), b.detach(), c.detach(), cum.detach(), dy, ds)
    first, second = (ssd_mod.ssd_intra_chunk_bwd(*args) for _ in range(2))
    assert all(torch.equal(p, q) for p, q in zip(first, second))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_strong_decay_stays_finite(cuda, dtype):
    """A decay span of ~2,500 over the chunk: masked before exp, the gradient stays finite
    and equal to the closed form in float64."""
    rng = np.random.default_rng(11)
    x = tensor(rng, (2, 3, 256, 64), dtype, cuda, 0.5)
    b, c = (tensor(rng, (2, 256, 16), torch.float32, cuda, 0.5) for _ in range(2))
    cum = (-torch.cumsum(torch.from_numpy(rng.random((2, 3, 256), dtype=np.float32) * 20.0), -1)).to(cuda)
    dy, ds = tensor(rng, (2, 3, 256, 64), dtype, cuda), tensor(rng, (2, 3, 64, 16), torch.float32, cuda)
    got = ssd_mod.ssd_intra_chunk_bwd(x, b, c, cum, dy, ds)
    want = ref.ssd_intra_chunk_bwd_ref(*(t.double() for t in (x, b, c, cum, dy, ds)))
    for name, g, w in zip(("dx", "db", "dc", "dcum"), got, want):
        close_to_max(name, g.double(), w, grad_tol(dtype))


# rows past 2048: hymba's out_norm 3200, A10's d 4096, ragged 2049 (the block route), 2056 just
# past the warp route, the limit 8192; one row and fewer rows than SMs
@pytest.mark.parametrize("T,D", [(1, 3200), (7, 3200), (1024, 3200), (1024, 4096), (7, 2049), (64, 8192),
                                 (1, 2056), (131, 2056), (1, 8192), (200, 8192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_wide_backward_kernels(cuda, T, D, dtype):
    rng = np.random.default_rng(T + D + 13)
    x = tensor(rng, (T, D), dtype, cuda, 3.0).requires_grad_()
    w = (1 + tensor(rng, (D,), dtype, cuda, 0.1)).requires_grad_()
    dy = tensor(rng, (T, D), dtype, cuda)
    want = torch.autograd.grad(ref.rmsnorm_ref(x, w), (x, w), dy)
    before = ops.launch_counts()
    got = torch.autograd.grad(ops.rmsnorm_op(x, w), (x, w), dy)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    for name in ("rmsnorm", "rmsnorm_bwd_wide", "rmsnorm_bwd_dweight"):
        assert after[name] == before[name] + 1, name
    assert after["rmsnorm_bwd"] == before["rmsnorm_bwd"]
    close_to_max("dx", got[0], want[0], grad_tol(dtype))
    close_to_max("dweight", got[1], want[1], grad_tol(dtype))
    first, second = (rmsnorm_mod.rmsnorm_bwd(x.detach(), w.detach(), dy) for _ in range(2))
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.parametrize("layout", ["strided", "unaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_wide_backward_strided_rows(cuda, layout, dtype):
    """x a view with rows D + 8 apart: the ring route reads each row at its stride; rows
    that start one element in are not 16-byte aligned and take the block route."""
    T, D = 300, 3200
    rng = np.random.default_rng(17)
    base = tensor(rng, (T, D + 8), dtype, cuda, 3.0)
    x = base[:, :D] if layout == "strided" else base[:, 1:D + 1]
    w = 1 + tensor(rng, (D,), dtype, cuda, 0.1)
    dy = tensor(rng, (T, D), dtype, cuda)
    aligned = layout == "strided"
    assert rmsnorm_mod.bwd_plan(T, D, dtype, aligned=aligned).route == ("ring" if aligned else "block")
    before = ops.launch_counts()["rmsnorm_bwd_wide"]
    got = rmsnorm_mod.rmsnorm_bwd(x, w, dy)
    assert ops.launch_counts()["rmsnorm_bwd_wide"] == before + 1
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    want = torch.autograd.grad(ref.rmsnorm_ref(xr, wr), (xr, wr), dy)
    close_to_max("dx", got[0], want[0], grad_tol(dtype))
    close_to_max("dweight", got[1], want[1], grad_tol(dtype))
    again = rmsnorm_mod.rmsnorm_bwd(x, w, dy)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


def test_flash_kernel_rejects_head_dim_32(cuda):
    q = torch.zeros(1, 2, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_mod.flash_attention(q, q, q)


@pytest.mark.parametrize("E,C,D,F", [
    (40, 8, 1536, 512), (40, 128, 512, 1536), (4, 24, 256, 128),  # granite decode/prefill, reduced
    (40, 384, 1536, 512), (40, 384, 512, 1536),  # granite score
    (3, 70, 100, 36), (5, 130, 200, 72), (2, 1, 8, 8), (1, 3, 7, 5),  # ragged edges, odd widths
    # partial C, F and D tiles of the TMA routes (D, F multiples of 8), and one expert
    (3, 130, 264, 200), (2, 200, 136, 520), (2, 1000, 72, 96), (1, 384, 512, 256), (1, 8, 64, 8),
    (3, 40, 1536, 512), (2, 32, 520, 136),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_matmul_kernel(cuda, E, C, D, F, dtype):
    rng = np.random.default_rng(E * C + D * F)
    buf = tensor(rng, (E, C, D), dtype, cuda)
    w = tensor(rng, (E, D, F), dtype, cuda, 0.1)
    before = ops.launch_counts()["moe_matmul"]
    got = ops.moe_matmul_op(buf, w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["moe_matmul"] == before + 1
    assert moe_mod.last_plan == moe_mod.launch_plan(E, C, D, F, dtype)
    assert got.dtype == dtype and got.shape == (E, C, F)
    close(got, ref.moe_matmul_ref(buf, w), 2e-2 if dtype == torch.bfloat16 else 1e-4)
    assert torch.equal(ops.moe_matmul_op(buf, w), got)  # one summation order: bit-identical


def test_moe_matmul_kernel_refuses_a_plan_not_its_own(cuda):
    buf = torch.zeros(2, 128, 64, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(2, 64, 256, device=cuda, dtype=torch.bfloat16)
    out = torch.empty(2, 128, 256, device=cuda, dtype=torch.bfloat16)
    plan = moe_mod.launch_plan(2, 128, 64, 256, torch.bfloat16)
    assert moe_mod._launch(moe_mod._entry(), plan, buf, w, out) == 0
    assert torch.equal(out, buf @ w)
    for bad in (dataclasses.replace(plan, route="masked"), dataclasses.replace(plan, block_n=64),
                dataclasses.replace(plan, stages=plan.stages + 1),
                dataclasses.replace(plan, grid=(plan.grid[0] + 1, 1, 1)),
                dataclasses.replace(plan, smem_bytes=plan.smem_bytes - 1024),
                moe_mod._tma_plan("wgmma", 2, 128, 256, 256)):  # the other tile width (D < F: 128)
        with pytest.raises(RuntimeError, match="launch failed"):
            _build.check("moe_matmul", moe_mod._launch(moe_mod._entry(), bad, buf, w, out))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_matmul_kernel_takes_unaligned_bases(cuda, dtype):
    """Bases off 16 bytes (TMA cannot read them) take the masked route."""
    rng = np.random.default_rng(7)
    buf = tensor(rng, (3 * 40 * 64 + 1,), dtype, cuda)[1:].view(3, 40, 64)
    w = tensor(rng, (3 * 64 * 72 + 1,), dtype, cuda, 0.1)[1:].view(3, 64, 72)
    got = ops.moe_matmul_op(buf, w)
    assert moe_mod.last_plan == moe_mod.launch_plan(3, 40, 64, 72, dtype, aligned=False)
    assert moe_mod.last_plan.route == "masked"
    close(got, ref.moe_matmul_ref(buf, w), 2e-2 if dtype == torch.bfloat16 else 1e-4)


def test_moe_matmul_kernel_rejects_a_strided_buffer(cuda):
    buf = torch.zeros(2, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        moe_mod.moe_matmul(buf.transpose(1, 2), torch.zeros(2, 8, 4, device=cuda))


# mamba2-130m's H = 24, and H = 7 on 70 chunks, which the launch plans split into
# head groups of 2 (bf16) and 4 (f32) with a shorter last group; chunk lengths 1,
# 100, 160 and 256; hymba-1.5b's H = 50 with N = 16 at hd 64 (most of each N tile masked)
SSD_SHAPES = [
    (4, 24, 128, 64, 128), (8, 24, 160, 64, 128), (2, 3, 256, 64, 128),  # mamba2 prefill, score, long
    (4, 50, 128, 64, 16), (8, 50, 160, 64, 16),  # hymba prefill, score
    (3, 2, 40, 32, 16), (2, 4, 100, 32, 8), (1, 2, 64, 32, 32), (2, 1, 1, 32, 16),
] + [(B, H, Q, 64, 128) for B, H in ((8, 24), (70, 7)) for Q in (1, 100, 160, 256)]


@pytest.mark.parametrize("BNC,H,Q,hd,N", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_intra_chunk_kernel(cuda, BNC, H, Q, hd, N, dtype):
    rng = np.random.default_rng(BNC * Q + hd * N)
    x = tensor(rng, (BNC, H, Q, hd), dtype, cuda, 0.5)
    b = tensor(rng, (BNC, Q, N), torch.float32, cuda, 0.5)
    c = tensor(rng, (BNC, Q, N), torch.float32, cuda, 0.5)
    cum = -torch.cumsum(torch.from_numpy(rng.random((BNC, H, Q), dtype=np.float32) * 0.1), -1).to(cuda)
    before = ops.launch_counts()["ssd_intra_chunk"]
    y, st = ops.ssd_intra_chunk_op(x, b, c, cum)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_intra_chunk"] == before + 1
    y_ref, st_ref = ref.ssd_intra_chunk_ref(x, b, c, cum)
    assert y.dtype == dtype and st.dtype == torch.float32 and st.shape == (BNC, H, hd, N)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    close(y, y_ref, tol)
    close(st, st_ref, 1e-4)  # f32 whatever x's type: x is widened exactly


def test_ssd_kernel_decay_above_the_diagonal_stays_finite(cuda):
    """Steep decays make exp(cum_i - cum_j) overflow for i < j: masked, not inf * 0."""
    x = torch.ones(1, 1, 64, 32, device=cuda)
    b = torch.ones(1, 64, 16, device=cuda)
    cum = -torch.arange(64, dtype=torch.float32, device=cuda)[None, None] * 10.0
    y, st = ssd_mod.ssd_intra_chunk(x, b, b, cum)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    close(y, ref.ssd_intra_chunk_ref(x, b, b, cum)[0], 1e-4)


@pytest.mark.parametrize(
    "arch", ["smollm-360m", "llama3.2-1b", "granite-moe-3b-a800m", "mamba2-130m", "hymba-1.5b"]
)
def test_reduced_model_card_matches_cpu(cuda, arch):
    """Generation and scoring, f32: the kernels' path against the plain one."""
    cfg = get_config(arch).reduced()
    api = build_model(cfg)
    p_gpu = api.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    p_cpu = params_from_flat(flat_from_params(p_gpu), cfg, "cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, size=(2, 20)))
    gen = GenerationConfig(max_new_tokens=5, cache_len=32)
    a = Engine(api, p_gpu, gen).generate({"tokens": toks.to(cuda)})
    b = Engine(api, p_cpu, gen).generate({"tokens": toks})
    close(a.logits, b.logits, 1e-4)
    assert torch.equal(a.tokens.cpu(), b.tokens)
    close(Engine(api, p_gpu, gen).score({"tokens": toks.to(cuda)}),
          Engine(api, p_cpu, gen).score({"tokens": toks}), 1e-3)


def test_hybrid_forward_card_matches_cpu(cuda):
    """One full forward of reduced hymba-1.5b, f32: every kernel of the hybrid layer on the card."""
    from repro_torch.models.transformer import arange_positions, embed_tokens, forward

    cfg = get_config("hymba-1.5b").reduced()
    api = build_model(cfg)
    p_gpu = api.init(torch.Generator(device=cuda).manual_seed(4), cuda)
    p_cpu = params_from_flat(flat_from_params(p_gpu), cfg, "cpu")
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 64)))
    before = ops.launch_counts()
    with torch.inference_mode():
        outs = [forward(p, embed_tokens(p, toks.to(dev), cfg), arange_positions(2, 64, dev), cfg)[0]
                for p, dev in ((p_gpu, cuda), (p_cpu, "cpu"))]
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in ops.launch_counts().items() if v != before[k]}
    L = cfg.num_layers
    assert got == {"rmsnorm": 6 * L + 1, "flash_attention": L, "ssd_intra_chunk": L}
    close(outs[0], outs[1], 1e-4)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mamba2-130m", "hymba-1.5b"])
def test_hybrid_training_on_the_card_raises_naming_a3b(cuda, arch):
    """(Named when the SSM heads had no backward kernel; ROADMAP A3b is done.) One LM step's
    loss and gradients of the reduced moe, ssm and hybrid configs, f32, on the card through
    every backward kernel against the same weights on the CPU; the SSM families on two chunks
    a sequence, so the chunk-state gradient is live."""
    from repro_torch.training.train_step import grads_of

    cfg = get_config(arch).reduced()
    api = build_model(cfg)
    p_gpu = api.init(torch.Generator(device=cuda).manual_seed(5), cuda, trainable=True)
    p_cpu = params_from_flat(flat_from_params(p_gpu), cfg, "cpu").requires_grad_(True)
    seq = 2 * cfg.ssm_chunk if cfg.family in ("ssm", "hybrid") else 24
    toks = torch.as_tensor(np.random.default_rng(6).integers(0, cfg.vocab_size, size=(2, seq)))
    before = ops.launch_counts()
    lg = api.loss_fn(p_gpu, {"tokens": toks.to(cuda)})[0]
    gg = grads_of(lg, p_gpu)
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in ops.launch_counts().items()}
    L = cfg.num_layers
    if cfg.family == "moe":
        assert got["moe_matmul_bwd_dbuf"] == got["moe_matmul_bwd_dw"] == 3 * L
    else:
        assert got["ssd_intra_chunk_bwd"] == got["ssd_intra_chunk_bwd_reduce"] == L
    lc = api.loss_fn(p_cpu, {"tokens": toks})[0]
    gc = grads_of(lc, p_cpu)
    close(lg.detach(), lc.detach(), 1e-4)
    for k in gc:
        close_to_max(k, gg[k].cpu(), gc[k], 1e-3)


def _family_inputs(cfg, B, device):
    """The stub patches (vlm) or 12 stub frames (audio, within its reduced encoder_seq), from a seed."""
    n = {"vlm": cfg.num_patches, "audio": 12}.get(cfg.family)
    if n is None:
        return {}
    x = tensor(np.random.default_rng(7), (B, n, cfg.d_model), torch.float32, device)
    return {"patch_embeds" if cfg.family == "vlm" else "frames": x}


@pytest.mark.parametrize("arch", ["internvl2-1b", "whisper-medium"])
def test_vlm_and_audio_card_match_cpu(cuda, arch):
    """Reduced internvl2-1b and whisper-medium, f32: generation (after the patches; over
    the frames) and one LM step's loss and gradients on the card, through every kernel
    (whisper's encoder through the non-causal flash), against the same weights on the CPU
    within 1e-3."""
    from repro_torch.training.train_step import grads_of

    cfg = get_config(arch).reduced()
    api = build_model(cfg)
    p_gpu = api.init(torch.Generator(device=cuda).manual_seed(8), cuda, trainable=True)
    p_cpu = params_from_flat(flat_from_params(p_gpu), cfg, "cpu").requires_grad_(True)
    toks = torch.as_tensor(np.random.default_rng(9).integers(0, cfg.vocab_size, size=(2, 20)))
    extra = _family_inputs(cfg, 2, cuda)
    on_cpu = {k: v.cpu() for k, v in extra.items()}
    gen = GenerationConfig(max_new_tokens=5, cache_len=25 + cfg.num_patches)
    a = Engine(api, p_gpu, gen).generate({"tokens": toks.to(cuda), **extra})
    b = Engine(api, p_cpu, gen).generate({"tokens": toks, **on_cpu})
    close(a.logits, b.logits, 1e-3)
    assert torch.equal(a.tokens.cpu(), b.tokens)
    before = ops.launch_counts()
    lg = api.loss_fn(p_gpu, {"tokens": toks.to(cuda), **extra})[0]
    gg = grads_of(lg, p_gpu)
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in ops.launch_counts().items()}
    attn = cfg.num_layers + cfg.encoder_layers
    assert got["flash_attention"] == got["flash_attention_bwd_dkdv"] == attn
    lc = api.loss_fn(p_cpu, {"tokens": toks, **on_cpu})[0]
    gc = grads_of(lc, p_cpu)
    close(lg.detach(), lc.detach(), 1e-3)
    for k in gc:
        close_to_max(k, gg[k].cpu(), gc[k], 1e-3)


def test_live_grpo_step_launches(cuda):
    """One reduced step of the closed loop on the card: rollout, one judge
    action per sequence through Tangram, GRPO update, each through the kernels."""
    from repro_torch.core.cluster import paper_testbed
    from repro_torch.rl.driver import LiveGrpoDriver, build_tangram

    policy, judge = get_config("smollm-360m").reduced(), get_config("llama3.2-1b").reduced()
    driver = LiveGrpoDriver(policy, judge, group_size=4, device=cuda)
    prompts = np.random.default_rng(0).integers(0, policy.vocab_size, size=(2, 8)).astype(np.int32)
    tangram = build_tangram(paper_testbed(cpu_nodes=1, gpu_nodes=1), services=["judge"],
                            service_state_gb=1.0)
    torch.cuda.synchronize()
    before = ops.launch_counts()
    rep = driver.run_step(prompts, tangram)
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in ops.launch_counts().items()}
    n, new = 8, driver.gen_cfg.max_new_tokens
    # forwards of the policy: prefill, new - 1 decode steps, old_logp; one judge forward per
    # sequence; one training step.  Dense: 2L + 1 norms and L attentions per forward.
    pol_fwd, norms = 1 + (new - 1) + 1, 2 * policy.num_layers + 1
    assert got == {
        "rmsnorm": norms * (pol_fwd + 1) + n * (2 * judge.num_layers + 1),
        "rmsnorm_bwd": norms,
        "rmsnorm_bwd_dweight": norms,
        "flash_attention": policy.num_layers * 3 + n * judge.num_layers,
        "flash_attention_bwd_dq": policy.num_layers,
        "flash_attention_bwd_dkdv": policy.num_layers,
        "rmsnorm_bwd_wide": 0,
        "moe_matmul": 0,
        "moe_matmul_bwd_dbuf": 0,
        "moe_matmul_bwd_dw": 0,
        "ssd_intra_chunk": 0,
        "ssd_intra_chunk_bwd": 0,
        "ssd_intra_chunk_bwd_reduce": 0,
    }
    recs = tangram.telemetry.records
    assert len(recs) == n and not any(r.failed for r in recs)
    gpu = tangram.managers["gpu"]
    assert gpu.stats["hits"] + gpu.stats["misses"] == n
    assert np.isfinite(rep.grpo_loss) and np.all(rep.judge_s > 0)


def test_live_smoke_on_cuda_streams(cuda):
    """Live mode on the card: one CUDA stream per pool, the RMSNorm kernel as
    every payload; the sim's structural trace, every launch counted by the
    kernel's own counter, and each stream's last output held to 1e-5."""
    from repro_torch.core.live import ensure_devices, run_live_scenario
    from repro_torch.core.orchestrator import Orchestrator
    from repro_torch.core.scenarios import (
        build_fair_share, build_managers, compile_scenario, install_scenario, live_smoke_spec,
        structural_trace)
    from repro_torch.core.scheduler import ElasticScheduler
    from repro_torch.core.simulator import EventLoop

    compiled = compile_scenario(live_smoke_spec(), time_scale=0.05)
    loop = EventLoop()
    sim = Orchestrator(build_managers(compiled.spec, loop), loop=loop, policy=ElasticScheduler(),
                       fair_share=build_fair_share(compiled.spec), incremental=True)
    install_scenario(compiled, sim)
    sim.run()
    streams = ensure_devices(4, "cuda")
    assert all(isinstance(s, torch.cuda.Stream) for s in streams)
    before = ops.launch_counts()["rmsnorm"]
    live = run_live_scenario(compiled, devices=streams, wall_limit_s=60.0)
    launched = ops.launch_counts()["rmsnorm"] - before
    assert structural_trace(live.telemetry.records) == structural_trace(sim.telemetry.records)
    payload = live.payload
    assert sorted(payload.launches) == [0, 1, 2, 3] and min(payload.launches.values()) > 0
    assert launched == sum(payload.launches.values()) + len(streams)  # and one warm-up each
    for x, w, out in payload.outputs.values():
        assert out.is_cuda and out.dtype == torch.float32
        close(out, ref.rmsnorm_ref(x, w), 1e-5)


def test_dense_dp_torch_scan_on_the_card(cuda):
    """The dense DP's float64 scan on the card, bit-identical to the NumPy path
    on ``tests/test_dense_dp.py::test_jax_backend_matches_ref``'s cases (the
    CPU test's ``_torch_backend_cases``)."""
    from repro_torch.core.dparrange import dp_arrange_prefixes_dense
    from test_torch_core_dense_dp import _torch_backend_cases

    for tasks, op, _ in _torch_backend_cases():
        got = dp_arrange_prefixes_dense(tasks, op(), backend="torch", device="cuda")
        assert got == dp_arrange_prefixes_dense(tasks, op(), backend="numpy")


def _mesh_body(rank, world):
    """Reduced f32 granite (10 experts) on a (data 2, model 2) mesh of ranks sharing cuda:0:
    the sharded MoE and attention through the kernels, loss and gradients."""
    import warnings

    from repro_torch.launch.mesh import device_mesh
    from repro_torch.sharding.rules import make_rules
    from repro_torch.training.train_step import grads_of

    warnings.filterwarnings("ignore")
    for k in _build.KERNELS:
        _build.load(k)
    dev = torch.device("cuda", 0)
    rules = make_rules(device_mesh("cuda", (2, 2), ("data", "model")))
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(), num_experts=10)
    # drop-free (capacity factor E / K): where a data shard's capacity drops assignments, it
    # drops others than the global step's does (PERF.md)
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    api = build_model(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (4, 64), generator=torch.Generator().manual_seed(5))
    out = {}
    for name, r in (("sharded", rules), ("whole", None)):
        params = api.init(torch.Generator(device=dev).manual_seed(6), dev, trainable=True, rules=r)
        ops.reset_launch_counts()
        loss, _ = api.loss_fn(params, {"tokens": tokens.to(dev)}, r)
        grads = grads_of(loss, params)
        out[name] = (float(loss), {k: (r.full(g) if r else g).cpu() for k, g in grads.items()},
                     ops.launch_counts()["moe_matmul_bwd_dw"])
    return out


def test_sharded_train_step_on_ranks_sharing_the_card(cuda):
    """Four gloo ranks on one card: the sharded loss and gradients (B3 and B7 on each rank's
    expert slice) within 1e-4 of the same step unsharded on the card."""
    from repro_torch.launch.mesh import run_ranks

    for res in run_ranks(_mesh_body, 4, device=cuda, timeout=600):
        (ls, gs, n_sh), (lw, gw, n_wh) = res["sharded"], res["whole"]
        assert abs(ls - lw) <= 1e-4 and n_sh == n_wh > 0
        for k, g in gw.items():
            scale = g.abs().max().item() or 1.0
            assert (gs[k] - g).abs().max().item() <= 1e-4 * scale, k

"""The port's kernel entry points on the CPU: plain versions vs the JAX reference.

On the CPU ``repro_torch.kernels.ops`` runs the plain versions; the CUDA
kernels themselves are held against them on the card (test_torch_gpu.py
and chip_smoke.py).  Tolerances are the JAX package's own
(tests/test_kernels.py): 2e-5 f32 and 2e-2 bf16 for attention, 1e-5 f32
for RMSNorm and 2e-2 for bf16, where one rounding step of a value near 1
is 2**-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import layers as jax_layers
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
# wrappers: no fallback, counters, argument checks
# ---------------------------------------------------------------------------


ZERO_COUNTS = {"rmsnorm": 0, "flash_attention": 0, "moe_matmul": 0, "ssd_intra_chunk": 0}


def test_cpu_tensors_leave_launch_counters_at_zero():
    ops.reset_launch_counts()
    x = torch.randn(4, 64)
    ops.rmsnorm_op(x, torch.ones(64))
    q = torch.randn(1, 2, 8, 64)
    ops.flash_attention_op(q, q, q)
    ops.moe_matmul_op(torch.randn(2, 8, 16), torch.randn(2, 16, 4))
    ops.ssd_intra_chunk_op(torch.randn(1, 2, 8, 16), torch.randn(1, 8, 4), torch.randn(1, 8, 4),
                           -torch.rand(1, 2, 8).cumsum(-1))
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

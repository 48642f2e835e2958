"""The port's MoE pieces on the CPU vs ``repro``: the grouped matmul's plain
version against the Pallas kernel (interpret mode), ``expert_capacity``, and
``moe_ffn`` against ``_moe_ffn_global`` with and without capacity drops.

Tolerances: the grouped matmul at the JAX package's own (tests/test_kernels.py:
1e-4 f32, 5e-2 bf16); ``moe_ffn`` in f32 at 1e-5 for y and 1e-6 for the aux
losses, where only the summation order differs.  The whole-model MoE paths
(forward, prefill, decode, generate, score) are in test_torch_models.py and
test_torch_engine.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jax_ops
from repro.models import moe as jax_moe
from repro_torch.configs import get_config
from repro_torch.kernels import moe_matmul as moe_kernel
from repro_torch.kernels import ops
from repro_torch.models import moe

from _torch_parity import np32, torch_cfg

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def close(got, want, tol):
    np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("E,C,D,F", [
    (4, 128, 128, 128), (2, 256, 128, 256), (8, 128, 256, 128),  # tests/test_kernels.py's sweep
    (4, 8, 256, 128), (40, 8, 64, 32), (3, 24, 64, 96),  # decode capacities, reduced widths
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_matmul_ref_matches_jax_kernel(E, C, D, F, dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(E * C + D + F)
    buf = rng.standard_normal((E, C, D), dtype=np.float32)
    w = rng.standard_normal((E, D, F), dtype=np.float32) * 0.1
    got = ops.moe_matmul_op(torch.from_numpy(buf).to(td), torch.from_numpy(w).to(td))
    assert got.dtype == td and got.shape == (E, C, F)
    want = jax_ops.moe_matmul_op(jnp.asarray(buf, jd), jnp.asarray(w, jd), interpret=True)
    close(got, want, 5e-2 if dtype == "bfloat16" else 1e-4)


@pytest.mark.parametrize("T", [1, 4, 8, 31, 100, 128, 512, 636, 1280, 4096])
def test_expert_capacity_matches_jax(T):
    for arch in ("granite-moe-3b-a800m", "kimi-k2-1t-a32b"):
        jcfg = jax_get_config(arch)
        for cfg in (jcfg, jcfg.reduced(), dataclasses.replace(jcfg, capacity_factor=0.5)):
            assert moe.expert_capacity(T, torch_cfg(cfg)) == jax_moe.expert_capacity(T, cfg)


def _moe_case(E, K, cf, seed=0):
    """Reduced granite widths with E experts, top-K and capacity factor cf; f32 params and x."""
    jcfg = dataclasses.replace(
        jax_get_config("granite-moe-3b-a800m").reduced(),
        num_experts=E, experts_per_token=K, capacity_factor=cf,
    )
    D, Fe = jcfg.d_model, jcfg.expert_d_ff
    rng = np.random.default_rng(seed)
    params = {
        "router": rng.standard_normal((D, E), dtype=np.float32) * 0.3,
        "w_gate": rng.standard_normal((E, D, Fe), dtype=np.float32) * 0.1,
        "w_up": rng.standard_normal((E, D, Fe), dtype=np.float32) * 0.1,
        "w_down": rng.standard_normal((E, Fe, D), dtype=np.float32) * 0.1,
    }
    x = rng.standard_normal((2, 32, D), dtype=np.float32) * 0.5
    return jcfg, params, x


@pytest.mark.parametrize("E,K", [(4, 2), (6, 3), (8, 1)])
@pytest.mark.parametrize("capacity", ["ample", "tight"])
def test_moe_ffn_matches_jax_global(E, K, capacity):
    cf = float(E) if capacity == "ample" else 0.5
    jcfg, params, x = _moe_case(E, K, cf, seed=E * 10 + K)
    tcfg = torch_cfg(jcfg)
    T = x.shape[0] * x.shape[1]
    # tight capacity drops assignments; ample drops none
    probs = jax.nn.softmax(jnp.asarray(x.reshape(T, -1)) @ params["router"], axis=-1)
    load = np.bincount(np.asarray(jax.lax.top_k(probs, K)[1]).ravel(), minlength=E)
    C = moe.expert_capacity(T, tcfg)
    assert (load.max() > C) == (capacity == "tight"), (load, C)

    want_y, want_aux = jax_moe._moe_ffn_global(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), jcfg, None
    )
    y, aux = moe.moe_ffn({k: torch.from_numpy(v) for k, v in params.items()}, torch.from_numpy(x), tcfg)
    assert y.shape == x.shape and y.dtype == torch.float32
    close(y, want_y, 1e-5)
    for name in ("load_balance", "router_z"):
        close(aux[name], want_aux[name], 1e-6)


def test_moe_ffn_zero_experts_give_zero():
    jcfg, params, x = _moe_case(4, 2, 4.0)
    zeroed = {k: torch.zeros(v.shape) if k != "router" else torch.from_numpy(v) for k, v in params.items()}
    y, aux = moe.moe_ffn(zeroed, torch.from_numpy(x), torch_cfg(jcfg))
    assert not y.any()
    assert float(aux["load_balance"]) >= 0.99  # >= 1 at perfect balance


def test_moe_ffn_bf16_runs_in_the_working_type():
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(), dtype="bfloat16")
    _, params, x = _moe_case(cfg.num_experts, cfg.experts_per_token, cfg.capacity_factor)
    y, aux = moe.moe_ffn(
        {k: torch.from_numpy(v).bfloat16() for k, v in params.items()}, torch.from_numpy(x).bfloat16(), cfg
    )
    assert y.dtype == torch.bfloat16 and aux["router_z"].dtype == torch.float32
    assert bool(torch.isfinite(y.float()).all())


# ---------------------------------------------------------------------------
# wrapper: no fallback, counter, argument checks
# ---------------------------------------------------------------------------


def test_moe_cpu_tensors_leave_the_counter_at_zero():
    ops.reset_launch_counts()
    ops.moe_matmul_op(torch.randn(2, 8, 16), torch.randn(2, 16, 4))
    _, params, x = _moe_case(4, 2, 4.0)
    moe.moe_ffn({k: torch.from_numpy(v) for k, v in params.items()}, torch.from_numpy(x),
                get_config("granite-moe-3b-a800m").reduced())
    assert ops.launch_counts()["moe_matmul"] == 0


@pytest.mark.parametrize(
    "buf,w,err",
    [
        (torch.randn(2, 8, 16), torch.randn(2, 16, 4), ValueError),  # a CPU tensor
        (torch.randn(2, 8, 16, dtype=torch.float16), torch.randn(2, 16, 4, dtype=torch.float16), TypeError),
        (torch.randn(2, 8, 16), torch.randn(2, 16, 4, dtype=torch.bfloat16), TypeError),
        (torch.randn(2, 8, 16), torch.randn(3, 16, 4), ValueError),  # expert count differs
        (torch.randn(2, 8, 16), torch.randn(2, 12, 4), ValueError),  # depth differs
        (torch.randn(8, 16), torch.randn(16, 4), ValueError),  # no expert dim
    ],
)
def test_moe_matmul_kernel_rejects_what_it_does_not_take(buf, w, err):
    ops.reset_launch_counts()
    with pytest.raises(err):
        moe_kernel.moe_matmul(buf, w)
    assert ops.launch_counts()["moe_matmul"] == 0


def test_moe_ffn_hands_the_kernel_contiguous_tensors(monkeypatch):
    """The CUDA kernel takes only contiguous inputs; the plain version would not notice."""
    seen = []

    def spy(buf, w):
        seen.append(buf.is_contiguous() and w.is_contiguous())
        return ref_op(buf, w)

    ref_op = ops.moe_matmul_op
    monkeypatch.setattr(ops, "moe_matmul_op", spy)
    jcfg, params, x = _moe_case(4, 2, 0.5)
    moe.moe_ffn({k: torch.from_numpy(v) for k, v in params.items()}, torch.from_numpy(x), torch_cfg(jcfg))
    assert seen == [True, True, True]

"""The port's Mamba-2 SSD pieces on the CPU vs ``repro``: the intra-chunk
kernel's plain version against the Pallas kernel (interpret mode), the
chunked scan against ``repro.models.ssm.ssd_scan_with_state`` over several
chunks, the decode step against JAX's, the chunked scan against the
port's own O(1) recurrence, and the bf16 drift between decode and a full
forward against the reference's own.

Tolerances: the intra-chunk kernel at the JAX package's own (1e-4,
tests/test_kernels.py:69-86; 2e-2 where x is bf16, one rounding of y);
the scan and the decode step in f32 at 1e-4 (summation order only); the
chunked scan against the recurrence at the reference's 1e-3
(tests/test_models.py:143-170: two algorithms).  The whole-model SSM paths
(forward, prefill, decode, generate, score) are in test_torch_models.py and
test_torch_engine.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.models import ssm as jax_ssm
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd_kernel
from repro_torch.models import ssm
from repro_torch.models import transformer as tt

from _torch_parity import bf16_decode_drift, models, np32

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def close(got, want, tol):
    np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol)


def ssd_inputs(BNC, H, Q, hd, N, seed):
    """Realistic decays: negative, decreasing cumsums (tests/test_kernels.py:75)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BNC, H, Q, hd), dtype=np.float32) * 0.5
    b = rng.standard_normal((BNC, Q, N), dtype=np.float32) * 0.5
    c = rng.standard_normal((BNC, Q, N), dtype=np.float32) * 0.5
    cum = -np.cumsum(rng.random((BNC, H, Q), dtype=np.float32) * 0.1, axis=-1)
    return x, b, c, cum


@pytest.mark.parametrize("BNC,H,Q,hd,N", [
    (2, 3, 32, 16, 8), (4, 2, 64, 32, 16), (1, 1, 128, 64, 32),  # tests/test_kernels.py's sweep
    (2, 4, 40, 32, 16), (1, 2, 160, 64, 128),  # ragged chunks, mamba2-130m's head and state widths
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_intra_chunk_ref_matches_jax_kernel(BNC, H, Q, hd, N, dtype):
    jd, td = DTYPES[dtype]
    x, b, c, cum = ssd_inputs(BNC, H, Q, hd, N, seed=BNC * Q + N)
    y, st = ops.ssd_intra_chunk_op(torch.from_numpy(x).to(td), torch.from_numpy(b),
                                   torch.from_numpy(c), torch.from_numpy(cum))
    want_y, want_st = jax_ops.ssd_intra_chunk_op(jnp.asarray(x, jd), jnp.asarray(b), jnp.asarray(c),
                                                 jnp.asarray(cum), interpret=True)
    assert y.dtype == td and y.shape == (BNC, H, Q, hd)
    assert st.dtype == torch.float32 and st.shape == (BNC, H, hd, N)
    close(y, want_y, 2e-2 if dtype == "bfloat16" else 1e-4)
    close(st, want_st, 1e-4)


def test_ssd_intra_chunk_ref_masks_before_exp():
    """A steep decay overflows exp above the diagonal; the mask keeps y finite."""
    x = torch.ones(1, 1, 64, 16)
    b = torch.ones(1, 64, 8)
    cum = -torch.arange(64, dtype=torch.float32)[None, None] * 10.0
    y, st = ops.ssd_intra_chunk_op(x, b, b, cum)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    assert torch.allclose(y[0, 0, :, 0], torch.full((64,), 8.0), atol=1e-3)  # the diagonal only


def _layer0(arch="mamba2-130m"):
    japi, jparams, tapi, tparams = models(arch)
    jlp = jax.tree.map(lambda a: a[0], jparams["layers"])["ssm"]
    tlp = tt.layer_params(tparams["layers"])[0]["ssm"]
    return japi.cfg, tapi.cfg, jlp, tlp


@pytest.mark.parametrize("S,chunk", [(64, 32), (96, 32), (32, 32), (24, 32)])
def test_ssd_scan_with_state_matches_jax(S, chunk):
    jcfg, tcfg, jlp, tlp = _layer0()
    jcfg, tcfg = (dataclasses.replace(c, ssm_chunk=chunk) for c in (jcfg, tcfg))
    x = np.random.default_rng(S).standard_normal((2, S, jcfg.d_model), dtype=np.float32) * 0.5
    want_y, want_st = jax_ssm.ssd_scan_with_state(jlp, jnp.asarray(x), jcfg, None)
    y, st = ssm.ssd_scan_with_state(tlp, torch.from_numpy(x), tcfg)
    close(y, want_y, 1e-4)
    close(st, want_st, 1e-4)


def test_ssd_scan_refuses_a_ragged_last_chunk():
    _, tcfg, _, tlp = _layer0()
    with pytest.raises(ValueError, match="not divisible by chunk"):
        ssm.ssd_scan_with_state(tlp, torch.zeros(1, 40, tcfg.d_model), tcfg)


def test_ssd_decode_steps_match_jax():
    jcfg, tcfg, jlp, tlp = _layer0()
    B, S = 2, 6
    x = np.random.default_rng(7).standard_normal((B, S, jcfg.d_model), dtype=np.float32) * 0.5
    jstate = jax_ssm.ssm_decode_state(jcfg, B)
    state = ssm.ssm_decode_state(tcfg, B, "cpu")
    for t in range(S):
        want, jstate = jax_ssm.ssd_decode_step(jlp, jnp.asarray(x[:, t : t + 1]), jstate, jcfg)
        got, state = ssm.ssd_decode_step(tlp, torch.from_numpy(x[:, t : t + 1]), state, tcfg)
        close(got, want, 1e-4)
        close(state, jstate, 1e-4)


def test_chunked_scan_matches_the_recurrence():
    """tests/test_models.py:143-170 on the port: several chunks against token-by-token decode."""
    _, tcfg, _, tlp = _layer0()
    B, S = 2, 64
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((B, S, tcfg.d_model), dtype=np.float32) * 0.5)
    y_chunked, final_state = ssm.ssd_scan_with_state(tlp, x, tcfg)
    state = ssm.ssm_decode_state(tcfg, B, "cpu")
    ys = []
    for t in range(S):
        y_t, state = ssm.ssd_decode_step(tlp, x[:, t : t + 1], state, tcfg)
        ys.append(y_t)
    close(y_chunked, torch.cat(ys, dim=1), 1e-3)
    close(final_state, state, 1e-3)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_decode_drifts_from_forward_no_more_than_jax(seed):
    """In bf16 the O(1) recurrence and the chunked scan round differently, so
    decode steps drift from a full forward over the same tokens in the
    reference too.  The port's drift, on the same bf16 weights and tokens,
    stays within 1.5x of the reference's own at every decode step taken
    together (measured ratio 0.7-0.95 over seeds 0-2)."""
    port_drift, jax_drift = bf16_decode_drift("mamba2-130m", seed)
    assert 0 < jax_drift < 0.1, jax_drift  # bf16 rounding, not a broken path
    assert port_drift <= 1.5 * jax_drift, (port_drift, jax_drift)


# ---------------------------------------------------------------------------
# wrapper: no fallback, counter, argument checks
# ---------------------------------------------------------------------------


def test_ssd_cpu_tensors_leave_the_counter_at_zero():
    ops.reset_launch_counts()
    x, b, c, cum = (torch.from_numpy(a) for a in ssd_inputs(1, 2, 32, 32, 8, seed=0))
    ops.ssd_intra_chunk_op(x, b, c, cum)
    _, tcfg, _, tlp = _layer0()
    ssm.ssd_scan(tlp, torch.zeros(1, 64, tcfg.d_model), tcfg)
    assert ops.launch_counts()["ssd_intra_chunk"] == 0


def _args(hd=32, N=8, x_dtype=torch.float32, b_dtype=torch.float32, cum_shape=(1, 2, 32)):
    return (torch.zeros(1, 2, 32, hd, dtype=x_dtype), torch.zeros(1, 32, N, dtype=b_dtype),
            torch.zeros(1, 32, N, dtype=b_dtype), torch.zeros(cum_shape))


@pytest.mark.parametrize(
    "args,err",
    [
        (_args(), ValueError),  # CPU tensors
        (_args(hd=24), ValueError),  # head dim the kernel has no instance for
        (_args(hd=16), ValueError),
        (_args(x_dtype=torch.float16), TypeError),
        (_args(b_dtype=torch.bfloat16), TypeError),  # b and c stay f32
        (_args(cum_shape=(1, 2, 31)), ValueError),
        (_args()[:3] + (torch.zeros(1, 2, 32, 1),), ValueError),
    ],
)
def test_ssd_kernel_rejects_what_it_does_not_take(args, err):
    ops.reset_launch_counts()
    with pytest.raises(err):
        ssd_kernel.ssd_intra_chunk(*args)
    assert ops.launch_counts()["ssd_intra_chunk"] == 0


def test_scan_hands_the_kernel_contiguous_tensors(monkeypatch):
    """The CUDA kernel takes only contiguous inputs; the plain version would not notice."""
    seen = []

    def spy(x, b, c, cum):
        seen.append(all(t.is_contiguous() for t in (x, b, c, cum)))
        return ref_op(x, b, c, cum)

    ref_op = ops.ssd_intra_chunk_op
    monkeypatch.setattr(ops, "ssd_intra_chunk_op", spy)
    _, tcfg, _, tlp = _layer0()
    for S in (20, 64):  # one chunk, two chunks
        ssm.ssd_scan_with_state(tlp, torch.zeros(2, S, tcfg.d_model), tcfg)
    assert seen == [True, True]

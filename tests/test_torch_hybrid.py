"""The port's hybrid family (``hymba-1.5b``: parallel attention and Mamba-2
heads) against ``repro.models`` on the CPU, and the kernel launches that
``chip_smoke.py`` asserts on the card, counted here from the code.

The whole-model paths of the hybrid (forward, lm_loss and its gradients,
prefill, decode with and without a window, generate, score, the launcher)
run in test_torch_models.py, test_torch_training.py and test_torch_engine.py
beside the other families.  Tolerance: ``_torch_parity.MODEL_TOL`` (1e-4,
f32 with a different summation order).
"""

import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jax_tt
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models import transformer as tt
from repro_torch.serving.engine import Engine, GenerationConfig

from _torch_parity import MODEL_TOL, bf16_decode_drift, chip_smoke, family_inputs, models, np32



def close(got, want, tol=MODEL_TOL):
    np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol)


def tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, S))


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_the_reference_field_for_field(reduced):
    ours, theirs = get_config("hymba-1.5b"), jax_get_config("hymba-1.5b")
    if reduced:
        ours, theirs = ours.reduced(), theirs.reduced()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    if reduced:
        assert (ours.num_layers, ours.ssm_state, ours.ssm_head_dim, ours.ssm_chunk, ours.dtype) == (
            2, 16, 32, 32, "float32")
        assert ours.d_model <= 256
    else:  # the published widths of nvidia/Hymba-1.5B-Base
        assert (ours.num_layers, ours.d_model, ours.num_heads, ours.num_kv_heads,
                ours.resolved_head_dim, ours.d_ff, ours.vocab_size) == (32, 1600, 25, 5, 64, 5504, 32001)
        assert (ours.d_inner, ours.ssm_heads, ours.ssm_head_dim, ours.ssm_state) == (3200, 50, 64, 16)


def test_layer_schema_matches_the_reference():
    cfg = get_config("hymba-1.5b").reduced()
    jschema = jax_tt.layer_schema(jax_get_config("hymba-1.5b").reduced())
    ours = tt.layer_schema(cfg)
    assert set(ours) == set(jschema) == {
        "attn", "norm_attn", "ssm", "norm_ssm", "norm_attn_out", "norm_ssm_out", "ffn", "norm_ffn"}
    for k, v in ours.items():
        if isinstance(v, dict):
            assert {n: p.shape for n, p in v.items()} == {n: p.shape for n, p in jschema[k].items()}, k
        else:
            assert v.shape == jschema[k].shape and v.init == jschema[k].init, k


def test_layer_forward_matches_the_reference():
    """One layer of the parallel fusion x + 0.5 (rms(attn) + rms(ssm)), then the FFN."""
    japi, jparams, tapi, tparams = models("hymba-1.5b", weight_mult=5.0)
    B, S = 2, 16
    x = np.random.default_rng(7).standard_normal((B, S, japi.cfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jlp = jax.tree.map(lambda a: a[1], jparams["layers"])
    want, _ = jax_tt.layer_forward(jlp, jnp.asarray(x), jnp.asarray(pos), japi.cfg, None)
    lp = tt.layer_params(tparams["layers"])[1]
    got, aux, st = tt.layer_forward(lp, torch.from_numpy(x), torch.from_numpy(pos.copy()), tapi.cfg)
    close(got, want)
    assert aux is None
    assert st.shape == (B, tapi.cfg.ssm_heads, tapi.cfg.ssm_head_dim, tapi.cfg.ssm_state)
    assert st.dtype == torch.float32


def test_prefill_then_decode_equals_decode_from_scratch():
    """Prefill's caches and SSD states carry on exactly where token-by-token decode would be."""
    _, _, tapi, tparams = models("hymba-1.5b", weight_mult=5.0)
    B, P, new = 2, 8, 4
    toks = torch.as_tensor(tokens(tapi.cfg, B, P + new, seed=8))
    logits, state = tapi.prefill(tparams, {"tokens": toks[:, :P]}, cache_len=P + new)
    scratch = tapi.init_decode_state(B, P + new, device="cpu")
    for t in range(P):
        want, scratch = tapi.decode_step(tparams, scratch, toks[:, t : t + 1])
    close(logits, want)
    for t in range(P, P + new):
        got, state = tapi.decode_step(tparams, state, toks[:, t : t + 1])
        want, scratch = tapi.decode_step(tparams, scratch, toks[:, t : t + 1])
        close(got, want)
    for field in ("k_cache", "v_cache", "ssm_state"):
        close(getattr(state, field), getattr(scratch, field))
    assert state.pos == scratch.pos == P + new


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_decode_drifts_from_forward_no_more_than_jax(seed):
    """The hybrid's half that is an SSM rounds differently in the O(1)
    decode and the chunked scan, in bf16, in the reference too.  The
    port's drift on the same bf16 weights and tokens stays within 1.5x of
    the reference's own (measured ratio 0.55-1.04 over seeds 0-2)."""
    port_drift, jax_drift = bf16_decode_drift("hymba-1.5b", seed)
    assert 0 < jax_drift < 0.1, jax_drift  # bf16 rounding, not a broken path
    assert port_drift <= 1.5 * jax_drift, (port_drift, jax_drift)


def test_cpu_serving_launches_no_kernel():
    _, _, tapi, tparams = models("hymba-1.5b")
    ops.reset_launch_counts()
    batch = {"tokens": torch.as_tensor(tokens(tapi.cfg, 2, 8))}
    Engine(tapi, tparams, GenerationConfig(max_new_tokens=3, cache_len=11)).generate(batch)
    Engine(tapi, tparams, GenerationConfig()).score(batch)
    assert not any(ops.launch_counts().values())


# ---------------------------------------------------------------------------
# chip_smoke.py's exact launch counts, against the op calls the code makes
# ---------------------------------------------------------------------------


OPS = {"rmsnorm_op": "rmsnorm", "flash_attention_op": "flash_attention",
       "moe_matmul_op": "moe_matmul", "ssd_intra_chunk_op": "ssd_intra_chunk",
       "cross_attention_op": "cross_attention", "decode_attention_op": "flash_decode"}


COUNT_ARCHS = ["smollm-360m", "llama3.2-1b", "granite-moe-3b-a800m", "mamba2-130m", "hymba-1.5b",
               "internvl2-1b", "whisper-medium"]


# each arch as its config gives it (remat on), and with ":remat-off"
@pytest.mark.parametrize("arch", COUNT_ARCHS + [a + ":remat-off" for a in COUNT_ARCHS])
def test_chip_smoke_launch_counts_follow_the_code(arch, monkeypatch):
    """On the card every call of an ``ops`` entry point without a gradient
    launches its kernel once; ``chip_smoke.path_launches`` must predict the
    calls that generation and scoring make, family by family (the vlm with
    its patch prefix, the audio family over its frames; it cannot score).
    Serving records no gradient, so ``remat`` changes none of them."""
    arch, _, off = arch.partition(":")
    _, _, tapi, tparams = models(arch)
    if off:
        tapi = build_model(dataclasses.replace(tapi.cfg, remat=False))
    calls = Counter()
    for fname, kernel in OPS.items():
        fn = getattr(ops, fname)
        monkeypatch.setattr(ops, fname, lambda *a, _fn=fn, _k=kernel, **kw: (calls.update([_k]), _fn(*a, **kw))[1])
    expect = chip_smoke().path_launches
    zero = {k: 0 for k in ops.launch_counts() if k not in OPS.values()}  # the backward kernels
    batch = {"tokens": torch.as_tensor(tokens(tapi.cfg, 2, 8)), **family_inputs(tapi.cfg, 2)}
    new = 4
    cache_len = 8 + new + tapi.cfg.num_patches
    Engine(tapi, tparams, GenerationConfig(max_new_tokens=new, cache_len=cache_len)).generate(batch)
    assert {**zero, **{k: calls[k] for k in OPS.values()}} == expect(tapi.cfg, 1, new - 1)
    if tapi.cfg.family == "audio":
        return
    calls.clear()
    Engine(tapi, tparams, GenerationConfig()).score(batch)
    assert {**zero, **{k: calls[k] for k in OPS.values()}} == expect(tapi.cfg, 1, 0)

"""mamba2's SSM mixer split over its heads on the model axis, on gloo ranks
(spawned CPU processes), against the JAX package's mixer; and phase 10's bf16
train steps on the mesh.

* Reduced mamba2 cut as ``tests/test_torch_sharded_equivalence.py``'s
  ``mamba2-130m:mesh`` (d_model 192: 12 SSM heads of 32, d_inner 384 and
  vocabulary 510 split 4 / 128 / 170 a model rank) on (data 2, model 3), from
  the JAX package's weights through ``params_from_flat``: layer 0's mixer
  (``ssm.ssd_scan_with_state`` with the rules) against JAX's
  ``ssd_scan_with_state`` on the same numpy inputs (output and final state
  within 1e-5), its gradients of sum(y * dy) against ``jax.vjp``'s (1e-4 of
  each leaf's largest magnitude; two backward passes bit-identical), and a
  decode step after the prefill (``sharded_ssd_decode_step`` on each rank's
  block of the state) against JAX's ``ssd_decode_step`` (1e-5).  No rank
  gathers its blocks of ``w_in_z``, ``w_in_x`` or ``w_out``; each gathers the
  heads' gated outputs, and its B4 calls see 4 of the 12 heads.
* ``chip_smoke.mesh_ssm_heads`` (``ssm.heads_a_rank``): the heads a rank's B4
  and B8 run on, as the parameter specs split them.
* A bf16 train step of reduced mamba2 and whisper on (2, 2) through
  ``chip_smoke.mesh_rank``: finite, and its gradients no more than
  ``MESH_ANCHOR_RATIO`` times as far from the f32 step on the same weights as
  the unsharded bf16 step's (rank 0's ``chip_smoke.mesh_train_errors``); and
  ``chip_smoke.path_launches`` on the mesh names the bf16 backward counters.
* ``chip_smoke.check_mesh_train``'s rules on set readings: f32 within 2e-4 of
  the per-shard step whatever the noise; bf16 loss and gradients each within
  the family's own limit, so that a step without gradients is refused.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import ssm as jax_ssm
from repro.training.checkpoint import _flatten
from repro_torch.launch.mesh import device_mesh, run_ranks

from _torch_parity import chip_smoke

CUT = dict(d_model=192, vocab_size=510)  # MESH_LIKE["mamba2-130m:mesh"]
B, S = 4, 64  # two chunks of 32
SSM = ("w_in_z", "w_in_x", "w_in_b", "w_in_c", "w_in_dt", "a_log", "dt_bias", "d_skip",
       "out_norm", "w_out")


def jax_case():
    """(JAX config, layer 0's SSM params, the model's weights flat, x, dy, x1) as numpy."""
    jcfg = dataclasses.replace(jax_get_config("mamba2-130m").reduced(), **CUT)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    # a_log, dt_bias and d_skip are zeros / ones at init: spread them so that each head differs
    flat = {k: np.asarray(v) for k, v in _flatten(jparams).items()}
    rng = np.random.default_rng(11)
    for n in ("a_log", "dt_bias", "d_skip"):
        k = f"layers/ssm/{n}"
        flat[k] = (flat[k] + 0.5 * rng.standard_normal(flat[k].shape)).astype(np.float32)
    jlp = {n: jnp.asarray(flat[f"layers/ssm/{n}"][0]) for n in SSM}
    x = rng.standard_normal((B, S, jcfg.d_model), dtype=np.float32)
    dy = rng.standard_normal((B, S, jcfg.d_model), dtype=np.float32)
    x1 = rng.standard_normal((B, 1, jcfg.d_model), dtype=np.float32)
    return jcfg, jlp, flat, x, dy, x1


def _mixer_body(rank, world, flat, x, dy, x1):
    """Layer 0's mixer on (data 2, model 3): forward and backward twice, then a prefill and a
    decode step without gradients; what each rank gathered and the heads its B4 calls saw."""
    warnings.simplefilter("ignore")
    from unittest import mock

    from torch.distributed.tensor import Shard

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import ssm, transformer
    from repro_torch.models.convert import params_from_flat
    from repro_torch.sharding import rules as rules_mod
    from repro_torch.sharding.rules import block_of, make_rules
    from repro_torch.training.train_step import grads_of

    cfg = dataclasses.replace(get_config("mamba2-130m").reduced(), **CUT)
    rules = make_rules(device_mesh("cpu", (2, 3), ("data", "model")))
    params = params_from_flat(flat, cfg, "cpu", rules).requires_grad_(True)
    weights = {params["layers"]["ssm"][n].to_local().untyped_storage().data_ptr()
               for n in ("w_in_z", "w_in_x", "w_out")}
    gathered, heads = [], []
    gather, intra = rules_mod.Rules.gather, ops.ssd_intra_chunk_op

    def spy_gather(self, t, dim, mesh_dims):
        gathered.append((t.untyped_storage().data_ptr() in weights, tuple(t.shape), dim))
        return gather(self, t, dim, mesh_dims)

    def spy_intra(xc, *args):
        heads.append(xc.shape[1])
        return intra(xc, *args)

    xd = rules.distribute(torch.from_numpy(x), ("batch", None, None))
    dyl = rules.distribute(torch.from_numpy(dy), ("batch", None, None)).to_local()

    def step():
        lp = transformer.layer_params(params["layers"])[0]["ssm"]
        y, st = ssm.ssd_scan_with_state(lp, xd, cfg, rules)
        loss = rules.sum_data((y.to_local() * dyl).sum(), True)
        return y, st, grads_of(loss, params)

    def whole_state(st):  # the ranks' blocks [B_l, H_l, hd, N] joined
        return rules.gather(rules.gather(st, 1, [rules.model_dim]), 0, list(rules.data_dims))

    with mock.patch.object(rules_mod.Rules, "gather", spy_gather), \
            mock.patch.object(ops, "ssd_intra_chunk_op", spy_intra):
        y, st, g1 = step()
        _, _, g2 = step()
        with torch.no_grad():
            lp = transformer.layer_params(params["layers"])[0]["ssm"]
            _, block = ssm.ssd_scan_with_state(lp, xd, cfg, rules)
            shape = (B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
            placements = rules.placements(shape, ("batch", "ssm_inner", None, None))
            _, off = block_of(shape, rules.mesh, placements)
            dims = tuple(i for i, p in enumerate(placements) if p == Shard(1))
            y1 = ssm.sharded_ssd_decode_step(
                lp, rules.distribute(torch.from_numpy(x1), ("batch", None, None)), block, off[1],
                dims, cfg, rules)
    names = [f"layers.ssm.{n}" for n in SSM]
    return {
        "y": rules.full(y).detach(), "state": whole_state(st.detach()),
        "grads": {n: rules.full(g1[n])[0] for n in names},
        "twice": all(torch.equal(rules.full(g1[k]), rules.full(g2[k])) for k in g1),
        "decode_y": rules.full(y1), "decode_state": whole_state(block),
        "gathered": gathered, "heads": heads,
        "cols": rules.kept_range(params["layers"]["ssm"]["w_in_x"], 2),
    }


@pytest.fixture(scope="module")
def case():
    return jax_case()


@pytest.fixture(scope="module")
def mixer_runs(case):
    _, _, flat, x, dy, x1 = case
    return run_ranks(_mixer_body, 6, (flat, x, dy, x1), device="cpu", timeout=300)


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=0)


def test_split_mixer_matches_jax_ssd_scan_with_state(case, mixer_runs):
    jcfg, jlp, _, x, _, _ = case
    want_y, want_st = jax_ssm.ssd_scan_with_state(jlp, jnp.asarray(x), jcfg, None)
    np.testing.assert_allclose(np.asarray(jax_ssm.ssd_scan(jlp, jnp.asarray(x), jcfg)), want_y)
    for r in mixer_runs:
        close(r["y"], want_y, 1e-5)
        close(r["state"], want_st, 1e-5)


def test_split_mixer_gradients_match_jax_vjp(case, mixer_runs):
    jcfg, jlp, _, x, dy, _ = case
    _, vjp = jax.vjp(lambda p: jax_ssm.ssd_scan(p, jnp.asarray(x), jcfg), jlp)
    (want,) = vjp(jnp.asarray(dy))
    for r in mixer_runs:
        for n in SSM:
            w = np.asarray(want[n])
            err = np.abs(r["grads"][f"layers.ssm.{n}"].numpy() - w).max()
            assert err <= 1e-4 * np.abs(w).max(), (n, err, np.abs(w).max())


def test_split_mixer_backward_is_bit_identical_twice(mixer_runs):
    """The output norm's backward runs on the whole rows' gradient, gathered alike on every
    model rank: no sum over the ranks whose order could vary."""
    assert all(r["twice"] for r in mixer_runs)


def test_split_decode_step_after_prefill_matches_jax(case, mixer_runs):
    jcfg, jlp, _, x, _, x1 = case
    _, st = jax_ssm.ssd_scan_with_state(jlp, jnp.asarray(x), jcfg, None)
    want_y, want_st = jax_ssm.ssd_decode_step(jlp, jnp.asarray(x1), st, jcfg)
    for r in mixer_runs:
        close(r["decode_y"], want_y, 1e-5)
        close(r["decode_state"], want_st, 1e-5)


def test_split_mixer_gathers_activations_never_its_sharded_weights(case, mixer_runs):
    """Each rank keeps its columns of w_in_z and w_in_x and its rows of w_out; what it gathers
    over the model axis is its heads' gated rows, [B_l, S, 128] in the scan (forward, the
    backward's recompute of nothing: no remat here) and [B_l, 1, 128] in decode."""
    jcfg = case[0]
    cols = jcfg.ssm_expand * jcfg.d_model // 3
    for r in mixer_runs:
        assert not any(w for w, _, _ in r["gathered"])
        rows = [(shape, dim) for _, shape, dim in r["gathered"] if dim == 2]
        assert ((B // 2, S, cols), 2) in rows and ((B // 2, 1, cols), 2) in rows, rows
        assert r["cols"] is not None and r["cols"][1] - r["cols"][0] == cols


def test_split_mixer_runs_b4_on_its_heads(case, mixer_runs):
    jcfg = case[0]
    H = jcfg.ssm_expand * jcfg.d_model // jcfg.ssm_head_dim
    for r in mixer_runs:
        assert r["heads"] == [H // 3] * 3  # two scans with gradients, one prefill


@pytest.mark.parametrize("arch,cut,mesh,want", [
    ("mamba2-130m", {}, (2, 3), 8),  # 24 heads of d_inner 1536 split 8 a model rank
    ("hymba-1.5b", {}, (2, 3), 50),  # d_inner 3200: 3 divides none of it, repeated
    ("mamba2-130m", CUT, (2, 3), 4),
    ("mamba2-130m", "reduced", (2, 3), 16),  # d_inner 512 replicated on 3
    ("mamba2-130m", "reduced", (2, 2), 8),
    ("hymba-1.5b", "reduced", (2, 2), 8),
])
def test_mesh_ssm_heads_follow_the_specs(arch, cut, mesh, want):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if cut:
        cfg = cfg.reduced() if cut == "reduced" else dataclasses.replace(cfg.reduced(), **cut)
    assert chip_smoke().mesh_ssm_heads(cfg, mesh) == want


@pytest.fixture(scope="module")
def bf16_steps():
    cs = chip_smoke()
    rows = [(f"{arch} reduced bf16", seed,
             cs.mesh_config(f"{arch} reduced", arch, "bfloat16", None))
            for arch, seed in (("mamba2-130m", 5), ("whisper-medium", 6))]
    ranks = run_ranks(_bf16_body, 4, (rows,), device="cpu", timeout=300)
    return cs, rows, ranks


def _bf16_body(rank, world, rows):
    """chip_smoke's rank function on (data 2, model 2), its train steps read on rank 0."""
    return chip_smoke().mesh_rank(rank, world, (2, 2), "cpu", [], rows, [])


@pytest.mark.parametrize("i", [0, 1], ids=["mamba2-130m", "whisper-medium"])
def test_bf16_train_step_on_the_mesh_passes_the_anchor_rule(bf16_steps, i):
    """Finite gradients (``train_step_errors`` raises on others) no more than the anchor ratio
    times as far from the f32 step as the unsharded bf16 step's; the whole-batch readings are
    the bf16 roundings of other shapes, not a broken step."""
    cs, rows, ranks = bf16_steps
    label, _, cfg = rows[i]
    res = ranks[0][f"train {label}"]
    sharded, unsharded = res["anchor"]
    assert 0 < unsharded and sharded <= cs.MESH_ANCHOR_RATIO * unsharded, res
    assert np.isfinite(res["whole"][0]) and res["whole"][1] < 0.1, res
    assert res["shards"][1] < 0.1, res


@pytest.mark.parametrize("arch,counters", [
    ("whisper-medium", ("cross_attention_bwd_stats", "cross_attention_bwd_fused")),
    ("mamba2-130m", ("ssd_intra_chunk_bwd", "ssd_intra_chunk_bwd_reduce")),
    ("granite-moe-3b-a800m", ("moe_matmul_bwd_dbuf", "moe_matmul_bwd_dw")),
])
def test_path_launches_names_the_bf16_backward_counters(arch, counters):
    """phase 10's bf16 train steps: B11's own backward (whisper), B8 (mamba2) and B7 (granite)
    launch L (3L) times a step on every rank; f32 whisper runs B5's pair at Sk instead."""
    cs = chip_smoke()
    label, _, _, dt, layers = next(r for r in cs.MESH_TRAIN if r[1] == arch and r[3] == "bfloat16")
    cfg = cs.mesh_config(label, arch, dt, layers)
    got = cs.path_launches(cfg, 0, 0, 1, opt_steps=1, mesh=cs.MESH_SHAPE)
    per = 3 if arch.startswith("granite") else 1
    assert all(got[c] == per * cfg.num_layers for c in counters), got
    if arch == "whisper-medium":
        f32 = cs.path_launches(dataclasses.replace(cfg, dtype="float32"), 0, 0, 1,
                               mesh=cs.MESH_SHAPE)
        assert f32["cross_attention_bwd_stats"] == 0
        assert f32["flash_attention_bwd_dq"] == got["flash_attention_bwd_dq"] + cfg.num_layers


def test_mesh_rank_params_and_vlm_inputs():
    """What a rank holds (printed before phase 10's train steps), the vlm's stub patches in
    its batches and the caches' length past them."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cs = chip_smoke()
    cfg = get_config("llama3.2-1b").reduced()
    assert cs.mesh_rank_params(cfg, (1, 1)) == build_model(cfg).param_count()
    # internvl2-1b: 3 divides none of its 14 heads, 2 KV heads, d_ff 4864 or vocabulary 151655,
    # so each rank holds all of it, as in JAX; mamba2-130m shards d_inner and the vocabulary
    ivl = cs.mesh_config("internvl2-1b 4L", "internvl2-1b", "float32", 4)
    assert cs.mesh_rank_params(ivl) == build_model(ivl).param_count()
    m2 = get_config("mamba2-130m")
    assert cs.mesh_rank_params(m2) < build_model(m2).param_count() / 2
    batch = cs.mesh_batch(ivl, 40, cs.MESH_TRAIN_SHAPE)
    assert batch["patch_embeds"].shape == (4, ivl.num_patches, ivl.d_model)
    cache = cs.mesh_cache(ivl)
    assert cache % cs.MESH_SHAPE[1] == 0 and cache >= ivl.num_patches + cs.PROMPT + cs.MESH_NEW
    llama = cs.mesh_config("llama3.2-1b", "llama3.2-1b", "bfloat16", None)
    assert cs.mesh_cache(llama) == cs.MESH_CACHE


@pytest.mark.parametrize("dtype,res,ok", [
    # f32, little noise: per shard and whole batch within 2e-4
    ("float32", {"whole": (1e-6, 1.5e-4, "a"), "shards": (1e-6, 1.9e-4, "a"),
                 "noise": (1e-7, 1e-6, "a")}, True),
    ("float32", {"whole": (1e-6, 1.5e-4, "a"), "shards": (1e-6, 2.1e-4, "a"),
                 "noise": (1e-7, 1e-6, "a")}, False),
    # f32, a model that carries the card's roundings through other shapes of its products
    # (mamba2-130m's 2-row against 4-row noise at 24 layers, PERF.md): the whole-batch limit
    # grows with that noise, the per-shard limit does not
    ("float32", {"whole": (2e-6, 1.1e-2, "a"), "shards": (5e-7, 1.5e-4, "a"),
                 "noise": (2e-6, 5.9e-3, "a")}, True),
    ("float32", {"whole": (2e-6, 1.32e-2, "a"), "shards": (5e-7, 1.2e-2, "a"),
                 "noise": (2e-6, 5.9e-3, "a")}, False),
    ("float32", {"whole": (2e-6, 1.8e-2, "a"), "shards": (5e-7, 1.5e-4, "a"),
                 "noise": (2e-6, 5.9e-3, "a")}, False),
    # moe: the whole batch only, at 2e-4
    ("float32", {"whole": (1e-6, 2.1e-4, "a")}, False),
    # bf16: the family's limits, and the f32 anchor
    ("bfloat16", {"whole": (5e-4, 0.02, "a"), "shards": (5e-4, 0.02, "a"),
                  "noise": (0, 0.01, "a"), "anchor": (0.02, 0.019)}, True),
    ("bfloat16", {"whole": (5e-4, 0.02, "a"), "shards": (5e-4, 0.02, "a"),
                  "noise": (0, 0.01, "a"), "anchor": (0.04, 0.019)}, False),
    ("bfloat16", {"whole": (5e-4, 0.03, "a"), "shards": (5e-4, 0.02, "a"),
                  "noise": (0, 0.01, "a"), "anchor": (0.02, 0.019)}, False),
    # f32: mamba2's split mixer at 24 layers, 7.3e-3 from the per-shard step beside a noise
    # of 5.9e-3 (PERF.md): a departure of the size of the noise is still refused per shard
    ("float32", {"whole": (2e-6, 1.32e-2, "a"), "shards": (5e-7, 7.3e-3, "a"),
                 "noise": (2e-6, 5.9e-3, "a")}, False),
    # bf16: a loss beyond its own limit, the gradients within theirs
    ("bfloat16", {"whole": (1.2e-3, 0.02, "a"), "shards": (5e-4, 0.02, "a"),
                  "noise": (0, 0.01, "a"), "anchor": (0.02, 0.019)}, False),
])
def test_check_mesh_train_rules(dtype, res, ok):
    """phase 10's train-step rules (``chip_smoke.check_mesh_train``) on set readings: whisper's
    audio limits for bf16 (loss 9.9e-4, grads 0.029), granite's family where only the whole
    batch is read."""
    cs = chip_smoke()
    arch = "granite-moe-3b-a800m" if "shards" not in res else "whisper-medium"
    cfg = dataclasses.replace(cs.mesh_config(arch, arch, dtype, 4), dtype=dtype)
    if ok:
        cs.check_mesh_train("case", cfg, res)
    else:
        with pytest.raises(AssertionError):
            cs.check_mesh_train("case", cfg, res)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mamba2-130m", "whisper-medium"])
def test_check_mesh_train_refuses_a_bf16_step_without_gradients(arch):
    """A sharded bf16 step whose gradients are all zero reads 1.0 against every reference
    (each leaf's error relative to its largest magnitude): the family's gradient limit refuses
    it, and so does the f32 anchor; a loss 3.7 off is refused by the loss limit alone."""
    cs = chip_smoke()
    label, _, _, dt, layers = next(r for r in cs.MESH_TRAIN if r[1] == arch and r[3] == "bfloat16")
    cfg = cs.mesh_config(label, arch, dt, layers)
    loss_tol, grad_tol = cs.MESH_BF16_TRAIN_TOL[cfg.family]
    assert grad_tol < 1.0 and loss_tol < 0.1
    row = cfg.family != "moe"
    zero = {"whole": (0.0, 1.0, "a"), **({"shards": (0.0, 1.0, "a"), "noise": (0.0, 0.0, "a")}
                                         if row else {})}
    for res in (zero, {**zero, "anchor": (1.0, 0.02)}):
        with pytest.raises(AssertionError):
            cs.check_mesh_train("case", cfg, res)
    off = {"whole": (3.7, 0.0, "a"), **({"shards": (3.7, 0.0, "a"), "noise": (0.0, 0.0, "a")}
                                        if row else {}), "anchor": (0.02, 0.02)}
    with pytest.raises(AssertionError, match="loss err"):
        cs.check_mesh_train("case", cfg, off)

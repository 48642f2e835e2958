"""The port's training path vs ``repro.training`` on reduced configs, in f32.

Weights cross from JAX through the checkpoint path keys
(``convert.params_from_flat``), and every batch is made with numpy, so
both frameworks see identical numbers.  Tolerances:

- AdamW on the same parameters and gradients: 1e-6 (f32 elementwise
  arithmetic in the same order);
- losses and metrics: 1e-5; gradients per leaf: ``max |got - want|`` within
  1e-4 of the leaf's norm (f32, summation order only);
- parameters after one full step from the same state: Adam moves a weight
  by about lr * sign(g) wherever |g| >> eps, so a weight whose true
  gradient is ~0 may move by up to 2 lr differently in the two frameworks.
  Every element is held within ``2 lr + 1e-6`` and 99.9% of each leaf's
  elements within 1e-5.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.training import checkpoint as jax_ckpt
from repro.training import data as jax_data
from repro.training import grpo as jax_grpo
from repro.training import optimizer as jax_opt
from repro.training import train_step as jax_ts
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.kernels import ops
from repro_torch.models import transformer as tt
from repro_torch.models.convert import flat_from_params
from repro_torch.serving.engine import Engine, GenerationConfig
from repro_torch.training import (
    AdamWConfig,
    DataConfig,
    MarkovTextStream,
    TrainState,
    adamw_update,
    batch_for,
    group_advantages,
    grpo_loss,
    init_adamw,
    init_train_state,
    load_checkpoint,
    make_grad_accum_train_step,
    make_grpo_step,
    make_train_step,
    save_checkpoint,
)
from repro_torch.training.grpo import token_logprobs
from repro_torch.training.optimizer import lr_schedule

from _torch_parity import assert_params_after_one_step, models, np32, trainable

ROOT = Path(__file__).resolve().parents[1]


def to_jax_cfg(cfg: AdamWConfig) -> jax_opt.AdamWConfig:
    return jax_opt.AdamWConfig(**cfg.__dict__)


def torch_grads(loss, params):
    names, leaves = zip(*params.named_parameters())
    return {n.replace(".", "/"): g for n, g in zip(names, torch.autograd.grad(loss, leaves))}


def assert_grads_match(got, want_tree):
    want = _flatten(want_tree)
    assert got.keys() == want.keys()
    for k, w in want.items():
        err = np.abs(np32(got[k]) - w).max()
        assert err <= 1e-4 * max(np.linalg.norm(w), 1e-30), (k, err, np.linalg.norm(w))


def tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, S))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def test_lr_schedule_matches():
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    for s in (0, 5, 10, 50, 100):
        got = float(lr_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
        want = float(jax_opt.lr_schedule(to_jax_cfg(cfg), jnp.asarray(s, jnp.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), s


@pytest.mark.parametrize("clip", [1.0, 1e3])  # clipping on and off
def test_adamw_update_matches_on_the_same_grads(clip):
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 7), "b/c": (3,), "b/d": (2, 4, 6)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20, grad_clip=clip)
    jcfg = to_jax_cfg(cfg)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    tstate, jstate = init_adamw(tparams), jax_opt.init_adamw(jparams)
    for step in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32) * 3 for k, s in shapes.items()}
        _, tstate, tm = adamw_update(cfg, tparams, {k: torch.from_numpy(v) for k, v in g.items()}, tstate)
        jparams, jstate, jm = jax_opt.adamw_update(jcfg, jparams, {k: jnp.asarray(v) for k, v in g.items()}, jstate)
        assert int(tstate.step) == int(jstate.step) == step + 1
        for k in shapes:
            np.testing.assert_allclose(np32(tparams[k]), np.asarray(jparams[k]), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(np32(tstate.m[k]), np.asarray(jstate.m[k]), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(np32(tstate.v[k]), np.asarray(jstate.v[k]), rtol=1e-6, atol=1e-6)
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)


def test_adamw_keeps_parameter_storage_and_dtype():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    ptr = p["w"].data_ptr()
    _, st, m = adamw_update(AdamWConfig(weight_decay=0.0), p, {"w": torch.full((4,), 100.0)}, init_adamw(p))
    assert p["w"].data_ptr() == ptr and p["w"].dtype == torch.bfloat16
    assert st.m["w"].dtype == torch.float32 and float(m["grad_norm"]) == pytest.approx(200.0)


# ---------------------------------------------------------------------------
# gradients against jax.grad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["smollm-360m", "llama3.2-1b", "granite-moe-3b-a800m", "mamba2-130m"])
def test_lm_loss_grads_match(arch):
    japi, jparams, tapi, params = trainable(arch)
    toks = tokens(japi.cfg, 2, 32, seed=1)
    (want, jm), jg = jax.value_and_grad(
        lambda p: japi.loss_fn(p, {"tokens": jnp.asarray(toks, jnp.int32)}), has_aux=True
    )(jparams)
    loss, m = tapi.loss_fn(params, {"tokens": torch.as_tensor(toks)})
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5, abs=1e-5)
    for k in jm:
        assert float(m[k].detach()) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-5), k
    if japi.cfg.family == "moe":
        assert float(m["load_balance"].detach()) > 0 and float(m["router_z"].detach()) > 0
    assert_grads_match(torch_grads(loss, params), jg)


@functools.lru_cache(maxsize=None)
def grpo_batch(arch: str = "smollm-360m", N: int = 8, S: int = 12):
    """A GRPO batch as numpy: rollout log-probs from the JAX policy, half the advantages +1."""
    japi, jparams, _, _ = models(arch)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, japi.cfg.vocab_size, size=(N, S))
    old = np.array(jax_grpo.token_logprobs(jparams, jnp.asarray(toks, jnp.int32), japi))
    mask = np.ones((N, S - 1), np.float32)
    mask[:, : S // 2] = 0.0  # only "generated" positions train
    return {
        "tokens": toks,
        "mask": mask,
        "advantages": np.concatenate([np.ones(N // 2), -np.ones(N // 2)]).astype(np.float32),
        # a reference policy a little off the rollout one, so the KL term has a gradient
        "old_logp": old,
        "ref_logp": (old + 0.05 * rng.standard_normal(old.shape)).astype(np.float32),
    }


def jax_batch(b):
    return {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32) for k, v in b.items()}


def torch_batch(b, device="cpu"):
    return {k: torch.as_tensor(v, device=device) for k, v in b.items()}


def test_grpo_loss_grads_match():
    japi, jparams, tapi, params = trainable("smollm-360m")
    b = grpo_batch()
    (want, jm), jg = jax.value_and_grad(
        lambda p: jax_grpo.grpo_loss(p, jax_batch(b), japi), has_aux=True
    )(jparams)
    loss, m = grpo_loss(params, torch_batch(b), tapi)
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5, abs=1e-5)
    assert m.keys() == jm.keys() == {"pg_loss", "kl", "ratio_mean"}
    for k in jm:
        assert float(m[k].detach()) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-5), k
    assert_grads_match(torch_grads(loss, params), jg)


@pytest.mark.parametrize("kind", ["grpo", "lm"])
def test_one_step_matches(kind):
    """make_grpo_step / make_train_step against JAX's from the same state and batch."""
    japi, jparams, tapi, params = trainable("smollm-360m")
    cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    if kind == "grpo":
        b = grpo_batch()
        jstep, tstep = jax_grpo.make_grpo_step(japi, to_jax_cfg(cfg)), make_grpo_step(tapi, cfg)
        jb, tb = jax_batch(b), torch_batch(b)
    else:
        toks = tokens(japi.cfg, 4, 32, seed=5)
        jstep, tstep = jax_ts.make_train_step(japi, to_jax_cfg(cfg)), make_train_step(tapi, cfg)
        jb, tb = {"tokens": jnp.asarray(toks, jnp.int32)}, {"tokens": torch.as_tensor(toks)}
    jstate, jm = jstep(jax_ts.TrainState(jparams, jax_opt.init_adamw(jparams)), jb)
    state, m = tstep(TrainState(params, init_adamw(params)), tb)
    assert state.params is params and int(state.opt.step) == 1
    assert m.keys() == jm.keys()
    for k in jm:
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-5), k
    assert_params_after_one_step(params, jstate.params, float(jm["lr"]))


def test_grad_accum_step_matches_jax():
    japi, jparams, tapi, params = trainable("smollm-360m")
    cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    toks = tokens(japi.cfg, 4, 16, seed=6).reshape(2, 2, 16)  # [accum, micro, S]
    jstep = jax_ts.make_grad_accum_train_step(japi, to_jax_cfg(cfg), 2)
    jstate, jm = jstep(jax_ts.TrainState(jparams, jax_opt.init_adamw(jparams)),
                       {"tokens": jnp.asarray(toks, jnp.int32)})
    state, m = make_grad_accum_train_step(tapi, cfg, 2)(TrainState(params, init_adamw(params)),
                                                        {"tokens": torch.as_tensor(toks)})
    for k in jm:
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-5), k
    assert_params_after_one_step(params, jstate.params, float(jm["lr"]))


@pytest.mark.parametrize("rewards", [
    [[1.0, 0.0, 0.5, 0.5], [0.0, 0.0, 1.0, 1.0]],  # ties within a group
    [[0.3, 0.3, 0.3, 0.3], [2.0, -1.0, 0.5, 0.0]],  # a group of equal rewards
])
def test_group_advantages_match(rewards):
    r = np.asarray(rewards, np.float32)
    got = group_advantages(torch.from_numpy(r))
    np.testing.assert_allclose(np32(got), np.asarray(jax_grpo.group_advantages(jnp.asarray(r))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np32(got).mean(axis=1), 0.0, atol=1e-6)
    if r[0, 0] == r[0, 1]:
        assert not got[0].any()  # equal rewards: no advantage, not NaN


# ---------------------------------------------------------------------------
# mirrors of tests/test_training.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m", "mamba2-130m"])
def test_batch_for_matches_jax(arch):
    shape = InputShape("t", 24, 3, "train")
    got = batch_for(get_config(arch), shape, seed=7)
    want = jax_data.batch_for(jax_get_config(arch), shape, seed=7)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])


def test_batch_for_refuses_families_the_port_lacks():
    cfg = dataclasses.replace(get_config("smollm-360m"), family="vlm")
    with pytest.raises(NotImplementedError, match="A8"):
        batch_for(cfg, InputShape("t", 24, 3, "train"))


def test_loss_decreases_on_learnable_stream():
    """tests/test_training.py:47-65: the loss drops on the Markov stream."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("smollm-360m").reduced()
    api = build_model(cfg)
    state = init_train_state(api, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(api, AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=60, weight_decay=0.01))
    data = MarkovTextStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, batch_size=16, branching=4))
    losses = []
    for _, batch in zip(range(40), data):
        state, metrics = step(state, {"tokens": torch.as_tensor(batch["tokens"][:, :32])})
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.7, f"no learning: {losses[0]} -> {losses[-1]}"


def test_moe_train_step_updates_router():
    japi, jparams, tapi, params = trainable("granite-moe-3b-a800m")
    before = params["layers"]["moe"]["router"].detach().clone()
    step = make_train_step(tapi, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10))
    _, m = step(TrainState(params, init_adamw(params)), {"tokens": torch.as_tensor(tokens(japi.cfg, 4, 32, 1))})
    assert not torch.allclose(before, params["layers"]["moe"]["router"])
    assert float(m["load_balance"]) > 0


def test_grpo_step_moves_policy_toward_reward():
    japi, jparams, tapi, params = trainable("smollm-360m")
    N, S = 8, 12
    toks = torch.as_tensor(tokens(japi.cfg, N, S, seed=2))
    with torch.no_grad():
        old = token_logprobs(params, toks, tapi)
    batch = {"tokens": toks, "mask": torch.ones(N, S - 1), "old_logp": old, "ref_logp": old,
             "advantages": torch.cat([torch.ones(N // 2), -torch.ones(N // 2)])}
    step = make_grpo_step(tapi, AdamWConfig(lr=5e-3, warmup_steps=1, total_steps=10, weight_decay=0.0))
    _, m = step(TrainState(params, init_adamw(params)), batch)
    assert bool(torch.isfinite(m["loss"]))
    with torch.no_grad():
        new = token_logprobs(params, toks, tapi)
    pos, neg = (new - old)[: N // 2].mean(), (new - old)[N // 2:].mean()
    assert pos > neg, "positive-advantage sequences should gain probability"


def test_kl_zero_at_reference():
    japi, jparams, tapi, params = trainable("smollm-360m")
    toks = torch.as_tensor(tokens(japi.cfg, 2, 8, seed=3))
    with torch.no_grad():
        logp = token_logprobs(params, toks, tapi)
    batch = {"tokens": toks, "mask": torch.ones(2, 7), "advantages": torch.zeros(2),
             "old_logp": logp, "ref_logp": logp}
    loss, m = grpo_loss(params, batch, tapi)
    assert float(m["kl"].detach()) == pytest.approx(0.0, abs=1e-5)
    assert float(loss.detach()) == pytest.approx(0.0, abs=1e-5)


def test_checkpoint_round_trips_across_frameworks(tmp_path):
    japi, jparams, tapi, params = trainable("smollm-360m")
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jax_ckpt.save_checkpoint(jpath, jparams, step=7)
    restored, step = load_checkpoint(jpath, params)
    assert step == 7 and all(p.requires_grad for p in restored.parameters())
    for k, v in _flatten(jparams).items():
        np.testing.assert_array_equal(flat_from_params(restored)[k], v)
    save_checkpoint(tpath, restored, step=9)
    back, step = jax_ckpt.load_checkpoint(tpath, jparams)
    assert step == 9
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_rejects_a_shape_mismatch(tmp_path):
    _, jparams, _, params = trainable("smollm-360m")
    path = str(tmp_path / "c.npz")
    flat = _flatten(jparams)
    flat["final_norm"] = np.ones(3, np.float32)
    np.savez(path, **flat)
    with pytest.raises(ValueError, match="final_norm"):
        load_checkpoint(path, params)


# ---------------------------------------------------------------------------
# serving and training on one set of parameters
# ---------------------------------------------------------------------------


def test_generate_then_train_the_same_params():
    """Generation caches inference-mode layer views; the next grad step must not reuse them."""
    japi, jparams, tapi, params = trainable("smollm-360m")
    toks = torch.as_tensor(tokens(japi.cfg, 2, 8, seed=4))
    engine = Engine(tapi, params, GenerationConfig(max_new_tokens=4, cache_len=16))
    first = engine.generate({"tokens": toks})
    step = make_train_step(tapi, AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10))
    state, m = step(TrainState(params, init_adamw(params)), {"tokens": toks})
    assert bool(torch.isfinite(m["loss"])) and float(m["grad_norm"]) > 0
    assert int(state.opt.step) == 1
    # the engine holds the same tree: it serves the updated weights
    second = engine.generate({"tokens": toks})
    assert not torch.equal(first.logits, second.logits)
    again, _ = tt.forward(params, tt.embed_tokens(params, toks, tapi.cfg),
                          tt.arange_positions(2, 8, "cpu"), tapi.cfg)
    assert again.requires_grad


def test_cpu_training_launches_no_kernel():
    japi, jparams, tapi, params = trainable("smollm-360m")
    ops.reset_launch_counts()
    make_train_step(tapi, AdamWConfig())(TrainState(params, init_adamw(params)),
                                         {"tokens": torch.as_tensor(tokens(japi.cfg, 2, 8, 1))})
    assert not any(ops.launch_counts().values())


def test_train_launcher_cpu_smoke():
    """``python -m repro_torch.launch.train --arch smollm-360m --steps 3 --device cpu``."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "smollm-360m", "--steps", "3",
         "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    losses = [float(line.split()[3]) for line in res.stdout.splitlines() if line.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses)), res.stdout

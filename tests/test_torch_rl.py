"""The port's RL layer (``repro_torch.rl``) and its live GRPO loop.

1. Mirrors of the reference suites ``tests/test_rl.py`` (workload
   generators, rollout runner, paper-claim checks) and
   ``tests/test_system.py`` (the submit -> schedule -> execute -> observe
   cycle across heterogeneous resources), imports rewritten, each case kept.
   ``test_elastic_beats_fixed_dop`` takes ``_fix_dop`` from
   ``benchmarks/fig9_elastic.py``, which imports ``repro``: it is inlined.
2. ``LiveGrpoDriver``'s reward-and-update part on reduced f32 configs, fed
   sequences the JAX policy generated, with the JAX weights of policy and
   judge loaded through ``params_from_flat``, against the same steps done
   with the reference's functions.  Tolerances: rewards, advantages and
   rollout-time log-probs 1e-4 (whole model, f32; a reward sums 23 token
   log-probs), losses and metrics 1e-5, parameters after the step by
   ``_torch_parity.assert_params_after_one_step`` (as the training tests).
3. Tangram's decisions over the live loop's judge actions, with fixed
   durations, identical in both packages; the loop's no-fallback rules;
   the twins of ``examples/agentic_rl_e2e.py`` and
   ``examples/serve_reward_models.py`` as subprocesses on the CPU.
"""

import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.action as j_action
import repro.rl.driver as j_driver
from repro.configs import get_config as jax_get_config
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import GenerationConfig as JaxGenerationConfig
from repro.training import grpo as jax_grpo
from repro.training import optimizer as jax_opt
from repro.training import train_step as jax_ts
from repro_torch.configs import get_config
from repro_torch.core.action import ResourceRequest
from repro_torch.core.cluster import paper_testbed
from repro_torch.core.managers.gpu import GpuManager
from repro_torch.core.telemetry import decision_trace
from repro_torch.rl.driver import (
    LiveGrpoDriver,
    build_tangram,
    judge_action,
    run_baseline_step,
    run_tangram_step,
)
from repro_torch.rl.rollout import RolloutRunner
from repro_torch.rl.tasks import (
    make_coding_workload,
    make_deepsearch_workload,
    make_mopd_workload,
    workload_services,
)
from repro_torch.serving.engine import Engine
from repro_torch.serving.reward_service import RewardService, deploy_reward_service
from repro_torch.training import TrainState, init_adamw

from _torch_parity import assert_params_after_one_step, models, np32, trainable

ROOT = Path(__file__).resolve().parents[1]


def _fix_dop(trajs, dop: int):
    """Clamp every scalable action to a single fixed DoP (``benchmarks/fig9_elastic.py``)."""
    out = []
    for spec in trajs:
        new_reward = []
        for tmpl in spec.reward:
            orig_build = tmpl.build

            def build(task_id, traj_id, _orig=orig_build, _dop=dop):
                a = _orig(task_id, traj_id)
                if a.key_resource == "cpu":
                    a.cost["cpu"] = ResourceRequest("cpu", (_dop,))
                return a

            new_reward.append(dataclasses.replace(tmpl, build=build))
        out.append(dataclasses.replace(spec, reward=new_reward))
    return out


# ---------------------------------------------------------------------------
# 1. mirrors of tests/test_rl.py and tests/test_system.py
# ---------------------------------------------------------------------------


class TestWorkloadGenerators:
    def test_deterministic(self):
        a = make_coding_workload(10, seed=3)
        b = make_coding_workload(10, seed=3)
        for x, y in zip(a, b):
            assert x.traj_id == y.traj_id
            assert len(x.turns) == len(y.turns)
            assert x.arrival_s == y.arrival_s

    def test_coding_actions_well_formed(self):
        trajs = make_coding_workload(5)
        for t in trajs:
            assert t.turns, "coding trajectories are multi-turn"
            a = t.reward[0].make(t.task_id, t.traj_id)
            assert a.key_resource == "cpu"
            assert a.scalable
            assert a.cost["cpu"].units == (1, 2, 4, 8, 16, 32)

    def test_mopd_teachers_enumerated(self):
        trajs = make_mopd_workload(20, n_teachers=5, teachers_per_traj=2)
        services = workload_services(trajs)
        assert all(s.startswith("teacher") for s in services)
        assert len(services) <= 5

    def test_deepsearch_uses_basic_resources(self):
        trajs = make_deepsearch_workload(5)
        apis = set()
        for t in trajs:
            for turn in t.turns:
                for tmpl in turn.actions:
                    a = tmpl.make(t.task_id, t.traj_id)
                    apis.update(a.cost)
        assert apis <= {"google_search", "web_fetch", "pdf_parse"}


class TestRolloutRunner:
    def test_all_trajectories_complete(self):
        cluster = paper_testbed(cpu_nodes=2, gpu_nodes=2)
        trajs = make_coding_workload(16)
        stats, tg = run_tangram_step(trajs, cluster)
        assert stats.step_duration > 0
        assert math.isfinite(stats.mean_act)
        assert tg.queue_depth() == 0 and tg.in_flight() == 0
        # every reward ran exactly once
        rewards = [r for r in tg.telemetry.records if r.name.startswith("reward")]
        assert len(rewards) == 16

    def test_stage_durations_tracked(self):
        cluster = paper_testbed(cpu_nodes=2, gpu_nodes=2)
        trajs = make_coding_workload(8)
        stats, _ = run_tangram_step(trajs, cluster)
        assert stats.stage_durations["gen"] > 0
        assert stats.stage_durations["tool"] > 0
        assert stats.stage_durations["reward"] > 0


class TestPaperClaims:
    """Qualitative reproduction gates on small-scale versions of §6.2/6.3."""

    def test_coding_act_improvement(self):
        """Tangram must beat the k8s baseline clearly on bursty coding."""
        cluster = paper_testbed(cpu_nodes=2, cores_per_node=128, gpu_nodes=1)
        trajs = make_coding_workload(128, arrival_spread_s=20)
        tg, _ = run_tangram_step(trajs, cluster)
        bl, _ = run_baseline_step(trajs, cluster)
        assert bl.mean_act / tg.mean_act > 1.5, (
            f"expected >1.5x ACT gain, got {bl.mean_act / tg.mean_act:.2f}"
        )

    def test_coding_step_speedup(self):
        cluster = paper_testbed(cpu_nodes=2, cores_per_node=128, gpu_nodes=1)
        trajs = make_coding_workload(128, arrival_spread_s=20)
        tg, _ = run_tangram_step(trajs, cluster)
        bl, _ = run_baseline_step(trajs, cluster)
        assert bl.step_duration > tg.step_duration

    def test_mopd_multiplexing_beats_static(self):
        cluster = paper_testbed(cpu_nodes=1, gpu_nodes=3)
        trajs = make_mopd_workload(128, n_teachers=6, arrival_spread_s=5)
        tg, _ = run_tangram_step(trajs, cluster)
        st, _ = run_baseline_step(trajs, cluster, gpu_baseline="static")
        assert tg.mean_act < st.mean_act

    def test_resource_saving_at_equal_act(self):
        """§6.3 / Fig. 8b Right: Tangram serves 10 reward services on ~30%
        of the GPUs the static baseline needs, at comparable ACT (paper:
        29% of GPUs, same ACT — i.e. 71.2% savings).

        Regime calibration (see EXPERIMENTS.md): the claim holds where
        teacher popularity is heavily skewed (Fig. 3d: invocations vary by
        orders of magnitude) so the static baseline's hot services saturate
        while its cold services idle, and aggregate demand (~9 GPU-equiv)
        still fits Tangram's pooled 12 GPUs."""
        from repro_torch.core.cluster import ClusterSpec, CpuNodeSpec, GpuNodeSpec

        trajs = make_mopd_workload(
            128, n_teachers=10, arrival_spread_s=240, teacher_skew=3.0
        )
        static, _ = run_baseline_step(
            trajs, paper_testbed(cpu_nodes=1, gpu_nodes=5), gpu_baseline="static"
        )
        small_cluster = ClusterSpec(
            cpu_nodes=(CpuNodeSpec(name="cpu0"),),
            gpu_nodes=(
                GpuNodeSpec(name="gpu0", devices=8),
                GpuNodeSpec(name="gpu1", devices=4),
            ),
        )
        small, _ = run_tangram_step(trajs, small_cluster)
        # 12 GPUs (30% of the static baseline's 40) at <=1.2x its ACT
        assert small.mean_act <= static.mean_act * 1.2

    def test_elastic_beats_fixed_dop(self):
        """Fig. 9: elastic allocation adapts to contention where any fixed
        DoP is wrong at one end of the load range.  Paper: 2.0x vs DoP=4
        at low batch (resources abundant -> scale up) and 3.0x vs DoP=16
        at high batch (congested -> shrink toward min units)."""
        # abundant: elastic scales rewards up, fixed4 underuses the pool
        cluster = paper_testbed(cpu_nodes=1, cores_per_node=128, gpu_nodes=1)
        trajs = make_coding_workload(32, arrival_spread_s=10)
        elastic, _ = run_tangram_step(trajs, cluster)
        fixed4, _ = run_tangram_step(_fix_dop(trajs, 4), cluster)
        assert fixed4.mean_act / elastic.mean_act > 1.5, (
            f"abundant: expected >1.5x vs fixed4, got "
            f"{fixed4.mean_act / elastic.mean_act:.2f}"
        )

        # congested: elastic shrinks toward min units, fixed16 thrashes
        cluster = paper_testbed(cpu_nodes=1, cores_per_node=64, gpu_nodes=1)
        trajs = make_coding_workload(192, arrival_spread_s=10)
        elastic, _ = run_tangram_step(trajs, cluster)
        fixed16, _ = run_tangram_step(_fix_dop(trajs, 16), cluster)
        assert fixed16.mean_act / elastic.mean_act > 1.5, (
            f"congested: expected >1.5x vs fixed16, got "
            f"{fixed16.mean_act / elastic.mean_act:.2f}"
        )

    def test_serverless_baseline_worse_than_tangram(self):
        cluster = paper_testbed(cpu_nodes=1, gpu_nodes=2)
        trajs = make_mopd_workload(96, n_teachers=6, arrival_spread_s=5)
        tg, _ = run_tangram_step(trajs, cluster)
        sl, _ = run_baseline_step(trajs, cluster, gpu_baseline="serverless")
        assert tg.mean_act < sl.mean_act


def _mixed_workload(seed=0):
    """MOPD + DeepSearch sharing one resource pool (paper 'MOPD+Search')."""
    mopd = make_mopd_workload(48, seed=seed, n_teachers=6, arrival_spread_s=30)
    search = make_deepsearch_workload(32, seed=seed + 1)
    return mopd + search


class TestMixedWorkloadE2E:
    def test_all_actions_complete_exactly_once(self):
        cluster = paper_testbed(cpu_nodes=2, gpu_nodes=2)
        trajs = _mixed_workload()
        stats, tg = run_tangram_step(trajs, cluster)
        assert tg.queue_depth() == 0 and tg.in_flight() == 0
        # one telemetry record per submitted action
        expected = sum(
            len(turn.actions) for t in trajs for turn in t.turns
        ) + sum(len(t.reward) for t in trajs)
        assert len(tg.telemetry.records) == expected
        assert math.isfinite(stats.mean_act) and stats.mean_act > 0

    def test_breakdown_structure_matches_table1(self):
        """ACT decomposes into exec + queue + sys overhead (Table 1)."""
        cluster = paper_testbed(cpu_nodes=2, gpu_nodes=2)
        stats, tg = run_tangram_step(_mixed_workload(), cluster)
        br = stats.breakdown
        assert set(br) >= {"exec", "queue", "overhead"}
        assert all(v >= 0 for v in br.values())
        assert br["exec"] > 0
        # mean ACT equals the breakdown sum (it is a decomposition)
        assert stats.mean_act == pytest.approx(
            br["exec"] + br["queue"] + br["overhead"], rel=1e-6
        )

    def test_cpu_overhead_under_3_percent(self):
        """Table 1: CPU-workload system overhead is <3% of exec time."""
        cluster = paper_testbed(cpu_nodes=2, cores_per_node=128, gpu_nodes=1)
        stats, _ = run_tangram_step(make_coding_workload(64), cluster)
        assert stats.breakdown["overhead"] < 0.03 * stats.breakdown["exec"]

    def test_mixed_beats_static_baseline(self):
        """§6.2 'MOPD+Search': pooling across tasks beats per-task statics.

        The static baseline deploys every service on dedicated TP-4 GPUs
        regardless of cluster size (that IS the over-provisioning), so the
        equal-resources comparison needs a cluster that can actually hold
        all 7 services x 4 GPUs: gpu_nodes=4 -> 32 devices."""
        cluster = paper_testbed(cpu_nodes=2, gpu_nodes=4)
        trajs = _mixed_workload()
        tg_stats, _ = run_tangram_step(trajs, cluster)
        bl_stats, _ = run_baseline_step(trajs, cluster, gpu_baseline="static")
        assert tg_stats.mean_act < bl_stats.mean_act


class TestResourceInvariants:
    def test_gpu_chunks_never_oversubscribed(self):
        """EOE + chunk allocator: at completion all chunks are free and
        hits+misses account for every service-backed execution."""
        cluster = paper_testbed(cpu_nodes=1, gpu_nodes=2)
        trajs = make_mopd_workload(48, n_teachers=6, arrival_spread_s=10)
        _, tg = run_tangram_step(trajs, cluster)
        gm = tg.managers["gpu"]
        assert isinstance(gm, GpuManager)
        assert gm.available == gm.capacity  # everything released
        served = gm.stats["hits"] + gm.stats["misses"]
        gpu_actions = [
            r for r in tg.telemetry.records if r.name.startswith("reward")
        ]
        assert served == len(gpu_actions)
        assert gm.stats["restore_s"] >= 0

    def test_api_quota_respected(self):
        """Basic manager: per-window quota consumption never exceeds the
        configured quota (DeepSearch google_search is quota-mode)."""
        cluster = paper_testbed(cpu_nodes=1, gpu_nodes=1)
        trajs = make_deepsearch_workload(64, seed=3)
        _, tg = run_tangram_step(trajs, cluster)
        mgr = tg.managers["google_search"]
        spec = next(a for a in cluster.apis if a.name == "google_search")
        for used in getattr(mgr, "window_usage", lambda: [])():
            assert used <= spec.quota

    def test_fcfs_no_starvation(self):
        """Every submitted action eventually runs; queue drains to zero
        even under heavy contention (starvation kills trajectories)."""
        cluster = paper_testbed(cpu_nodes=1, cores_per_node=64, gpu_nodes=1)
        trajs = make_coding_workload(128, arrival_spread_s=5)
        _, tg = run_tangram_step(trajs, cluster)
        assert tg.queue_depth() == 0 and tg.in_flight() == 0
        for rec in tg.telemetry.records:
            assert rec.start >= rec.submit
            assert rec.finish > rec.start

    def test_vectorized_constraints_all_resources(self):
        """An action's allocation never exceeds any cost dimension's
        feasible set (the scheduler's vectorized constraint, §4.1)."""
        cluster = paper_testbed(cpu_nodes=1, gpu_nodes=1)
        trajs = _mixed_workload(seed=5)
        _, tg = run_tangram_step(trajs, cluster)
        by_name = {}
        for t in trajs:
            for turn in t.turns:
                for tmpl in turn.actions:
                    a = tmpl.make(t.task_id, t.traj_id)
                    by_name.setdefault(a.name, a)
            for tmpl in t.reward:
                a = tmpl.make(t.task_id, t.traj_id)
                by_name.setdefault(a.name, a)
        for rec in tg.telemetry.records:
            proto = by_name.get(rec.name)
            if proto is None:
                continue
            for rtype, units in rec.units.items():
                assert units in proto.cost[rtype].units


class TestSchedulerModesE2E:
    def test_beyond_paper_mode_runs_clean(self):
        """The opt-in scheduler extensions complete the same workload with
        identical action accounting (no lost/duplicated actions)."""
        from repro_torch.core.scheduler import ElasticScheduler

        cluster = paper_testbed(cpu_nodes=1, cores_per_node=64, gpu_nodes=1)
        trajs = make_coding_workload(64, arrival_spread_s=10)
        services = workload_services(trajs)

        tg = build_tangram(cluster, services)
        tg.scheduler = ElasticScheduler(
            depth=2, history=tg.history, estimate_units="dp_avg"
        )
        tg.scheduler.eviction_search = "exhaustive"
        tg.scheduler.dop_floor = 4
        runner = RolloutRunner(
            {"*": tg, "cpu": tg, "gpu": tg, **{a.name: tg for a in cluster.apis}},
            tg.loop,
        )
        stats = runner.run_step(trajs)
        assert tg.queue_depth() == 0 and tg.in_flight() == 0
        rewards = [r for r in tg.telemetry.records if r.name.startswith("reward")]
        assert len(rewards) == 64
        assert math.isfinite(stats.mean_act)


# ---------------------------------------------------------------------------
# 2. the live loop's reward-and-update part against the reference's functions
# ---------------------------------------------------------------------------


POLICY, JUDGE, GROUP, PROMPT = "smollm-360m", "llama3.2-1b", 4, 8
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)  # the reference driver's AdamW


def _jax_rollout(batch=2):
    """[batch * GROUP, PROMPT + 16] sequences sampled by the JAX policy, as
    the reference's ``LiveGrpoDriver.run_step`` samples them."""
    japi, jparams, _, _ = models(POLICY)
    prompts = np.random.default_rng(0).integers(0, japi.cfg.vocab_size, size=(batch, PROMPT))
    rep = np.repeat(prompts.astype(np.int32), GROUP, axis=0)
    engine = JaxEngine(japi, jparams,
                       JaxGenerationConfig(max_new_tokens=16, temperature=1.0, cache_len=64))
    toks, _ = engine.generate({"tokens": jnp.asarray(rep)}, key=jax.random.PRNGKey(1))
    return np.concatenate([rep, np.asarray(toks)], axis=1)


def _cpu_driver_on_jax_weights():
    """A CPU ``LiveGrpoDriver`` whose policy and judge carry the JAX weights."""
    _, _, tapi, params = trainable(POLICY)
    _, _, jtapi, jtparams = models(JUDGE)
    driver = LiveGrpoDriver(tapi.cfg, jtapi.cfg, group_size=GROUP, device="cpu")
    driver.state = TrainState(params, init_adamw(params))
    driver.judge = dataclasses.replace(
        driver.judge, engine=Engine(jtapi, jtparams, driver.judge.engine.gen))
    return driver


def _tangram():
    return build_tangram(paper_testbed(cpu_nodes=1, gpu_nodes=1), services=["judge"],
                         service_state_gb=1.0)


def _trace(tangram):
    return decision_trace(tangram.telemetry.records)


def test_live_reward_and_update_match_reference():
    seqs = _jax_rollout()
    N = len(seqs)
    driver = _cpu_driver_on_jax_weights()
    tg = _tangram()
    rewards, judge_s = driver.score(torch.as_tensor(seqs, dtype=torch.long), tg)
    metrics, batch = driver.update(torch.as_tensor(seqs, dtype=torch.long), PROMPT, rewards)

    # every judge action ran once, on the GPU pool, for its measured wall
    recs = tg.telemetry.records
    assert len(recs) == N and not any(r.failed for r in recs)
    gpu = tg.managers["gpu"]
    assert gpu.stats["hits"] + gpu.stats["misses"] == N
    assert np.all(judge_s > 0)
    # the same durations, fixed, make a fresh Tangram decide the same
    replay = _tangram()
    for i, d in enumerate(judge_s):
        replay.submit(judge_action(i, lambda dop, d=float(d): d))
    replay.run()
    assert _trace(replay) == _trace(tg)

    # the same steps with the reference's functions
    japi, jparams, _, _ = models(POLICY)
    jjapi, jjparams, _, _ = models(JUDGE)
    judge = JaxEngine(jjapi, jjparams, JaxGenerationConfig(max_new_tokens=8, cache_len=128))
    want_r = np.array([float(judge.score({"tokens": jnp.asarray(seqs[i:i + 1])})[0])
                       for i in range(N)], np.float32)
    np.testing.assert_allclose(rewards, want_r, rtol=1e-4, atol=1e-4)
    adv = jax_grpo.group_advantages(jnp.asarray(want_r.reshape(-1, GROUP))).reshape(-1)
    np.testing.assert_allclose(np32(batch["advantages"]), np.asarray(adv), rtol=1e-4, atol=1e-4)
    tokens = jnp.asarray(seqs, jnp.int32)
    old = jax_grpo.token_logprobs(jparams, tokens, japi)
    np.testing.assert_allclose(np32(batch["old_logp"]), np.asarray(old), rtol=1e-4, atol=1e-4)
    mask = np.zeros((N, seqs.shape[1] - 1), np.float32)
    mask[:, PROMPT - 1:] = 1.0
    np.testing.assert_array_equal(np32(batch["mask"]), mask)
    jbatch = {"tokens": tokens, "mask": jnp.asarray(mask), "advantages": adv, "old_logp": old,
              "ref_logp": old}
    jstep = jax_grpo.make_grpo_step(japi, jax_opt.AdamWConfig(**OPT))
    jstate, jm = jstep(jax_ts.TrainState(jparams, jax_opt.init_adamw(jparams)), jbatch)
    assert metrics.keys() == jm.keys()
    for k in jm:
        assert metrics[k] == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-5), k
    assert_params_after_one_step(driver.state.params, jstate.params, float(jm["lr"]))


def test_live_run_step_on_the_cpu():
    """One whole step: rollout, judge actions through Tangram, GRPO update."""
    driver = _cpu_driver_on_jax_weights()
    before = {k: v.detach().clone() for k, v in driver.state.params.named_parameters()}
    prompts = np.random.default_rng(3).integers(0, driver.api.cfg.vocab_size, size=(2, PROMPT))
    tg = _tangram()
    rep = driver.run_step(prompts.astype(np.int32), tg)
    assert len(tg.telemetry.records) == 2 * GROUP and rep.judge_s.shape == (2 * GROUP,)
    assert rep.mean_act == pytest.approx(tg.telemetry.mean_act())
    assert all(math.isfinite(x) for x in (rep.grpo_loss, rep.mean_reward, rep.mean_act))
    assert min(rep.rollout_wall_s, rep.reward_wall_s, rep.update_wall_s) > 0
    assert int(driver.state.opt.step) == 1
    assert any(not torch.equal(p, before[k]) for k, p in driver.state.params.named_parameters())


def _reference_judge_trace(durations):
    """The reference driver's judge actions (``rl/driver.py:207-217``) with
    fixed durations, through the reference's Tangram."""
    import repro.core.cluster as j_cluster
    from repro.rl.tasks import GPU_ELASTICITY

    tg = j_driver.build_tangram(j_cluster.paper_testbed(cpu_nodes=1, gpu_nodes=1),
                                services=["judge"], service_state_gb=1.0)
    for i, d in enumerate(durations):
        tg.submit(j_action.Action(
            name="reward:judge", cost={"gpu": j_action.ResourceRequest("gpu", (1, 2, 4, 8))},
            key_resource="gpu", elasticity=GPU_ELASTICITY, base_duration=0.05,
            duration_sampler=lambda dop, d=d: d, service="judge", task_id="live",
            trajectory_id=f"live-{i}"))
    tg.run()
    return _trace(tg), dict(tg.managers["gpu"].stats), tg.telemetry.mean_act()


@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_judge_decisions_identical_with_fixed_durations(seed, n):
    durations = np.random.default_rng(seed).lognormal(np.log(0.02), 0.5, size=n).tolist()
    tg = _tangram()
    for i, d in enumerate(durations):
        tg.submit(judge_action(i, lambda dop, d=d: d))
    tg.run()
    got = (_trace(tg), dict(tg.managers["gpu"].stats), tg.telemetry.mean_act())
    assert len(got[0]) == n and got[1]["hits"] + got[1]["misses"] == n
    assert got == _reference_judge_trace(durations)


# ---------------------------------------------------------------------------
# 3. reward services, no fallback, and the twins of the examples
# ---------------------------------------------------------------------------


def test_reward_service_as_in_the_reference():
    from repro.serving.reward_service import RewardService as JaxRewardService
    from repro.serving.reward_service import deploy_reward_service as jax_deploy

    for arch in ("llama3.2-1b", "smollm-360m", "glm4-9b"):  # examples/serve_reward_models.py
        # the same model; the port names smollm-360m's source right (ROADMAP C)
        got, want = (dataclasses.asdict(c) for c in (get_config(arch), jax_get_config(arch)))
        assert {**got, "source": None} == {**want, "source": None}
    cfg = get_config(JUDGE).reduced()
    svc = deploy_reward_service("judge", cfg, seed=0, device="cpu")
    ref = jax_deploy("judge", jax_get_config(JUDGE).reduced(), jax.random.PRNGKey(0))
    assert svc.state_gb == ref.state_gb
    assert dataclasses.asdict(svc.spec()) == dataclasses.asdict(ref.spec())
    assert RewardService.profiled_elasticity().table == JaxRewardService.profiled_elasticity().table
    scores = svc.score(torch.zeros(2, 12, dtype=torch.long))
    assert scores.shape == (2,) and bool(torch.isfinite(scores).all())
    # an explicit seed: the same weights in every process, another seed others
    again = deploy_reward_service("judge", cfg, seed=0, device="cpu")
    other = deploy_reward_service("judge", cfg, seed=1, device="cpu")
    assert torch.equal(again.engine.params["embed"], svc.engine.params["embed"])
    assert not torch.equal(other.engine.params["embed"], svc.engine.params["embed"])


def test_live_loop_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    policy, judge = get_config(POLICY).reduced(), get_config(JUDGE).reduced()
    with pytest.raises(RuntimeError):
        deploy_reward_service("judge", judge, seed=0)
    with pytest.raises(RuntimeError):
        LiveGrpoDriver(policy, judge)


def _run_twin(module, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    return subprocess.run([sys.executable, "-m", f"repro_torch.examples.{module}", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("module,args,expect", [
    ("agentic_rl_e2e", ("--steps", "1", "--device", "cpu"),
     r"^step 0: grpo_loss=[+-]\d+\.\d{4} mean_reward=-?\d+\.\d\d mean_ACT=\d+\.\d{3}s "
     r"EOE_hits=\d+/16 rollout=\d+\.\d{3}s reward=\d+\.\d{3}s update=\d+\.\d{3}s$"),
    ("serve_reward_models", ("--device", "cpu"),
     r"^served 24 real scoring requests over \d+\.\ds virtual time$"),
])
def test_twin_runs_on_the_cpu(module, args, expect):
    import re

    res = _run_twin(module, *args)
    assert res.returncode == 0, res.stderr
    assert re.match(expect, res.stdout.splitlines()[0]), res.stdout


@pytest.mark.parametrize("module", ["agentic_rl_e2e", "serve_reward_models"])
def test_twin_fails_without_a_card(module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = _run_twin(module, *(("--steps", "1") if module == "agentic_rl_e2e" else ()))
    assert res.returncode != 0 and "step 0" not in res.stdout and "served" not in res.stdout

"""Wiring helpers: build ARL-Tangram or baseline stacks for a workload,
run steps, and the live GRPO-with-Tangram loop used by the e2e example.

Torch twin of ``repro.rl.driver``: the builders and step runners are
copies; :class:`LiveGrpoDriver` runs on the port's engine, judge and GRPO
step, on the card unless it is given ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.action import Action, ResourceRequest
from repro_torch.core.baselines import (
    ServerlessLlmSystem,
    StaticGpuServiceSystem,
    TrajectoryStaticCpuSystem,
    UnmanagedApiSystem,
)
from repro_torch.core.cluster import ClusterSpec, paper_testbed
from repro_torch.core.fairqueue import FairSharePolicy
from repro_torch.core.managers.basic import BasicResourceManager
from repro_torch.core.managers.cpu import CpuManager
from repro_torch.core.managers.gpu import GpuManager, ServiceSpec
from repro_torch.core.orchestrator import Orchestrator, SchedulingPolicy
from repro_torch.core.scheduler import ElasticScheduler
from repro_torch.core.simulator import EventLoop
from repro_torch.core.tangram import Tangram
from repro_torch.models import build_model
from repro_torch.rl.rollout import RolloutRunner, StepStats
from repro_torch.rl.tasks import GPU_ELASTICITY, TrajectorySpec, workload_services
from repro_torch.serving.engine import Engine, GenerationConfig
from repro_torch.serving.reward_service import deploy_reward_service
from repro_torch.training import (
    AdamWConfig,
    group_advantages,
    init_train_state,
    make_grpo_step,
)
from repro_torch.training.grpo import token_logprobs


def build_managers(
    cluster: ClusterSpec,
    services: Sequence[str] = (),
    service_state_gb: float = 40.0,
    loop: Optional[EventLoop] = None,
) -> Tuple[Dict[str, object], EventLoop]:
    loop = loop or EventLoop()
    managers: Dict[str, object] = {}
    if cluster.cpu_nodes:
        managers["cpu"] = CpuManager(cluster.cpu_nodes)
    if cluster.gpu_nodes:
        managers["gpu"] = GpuManager(
            cluster.gpu_nodes,
            [ServiceSpec(s, service_state_gb) for s in services],
        )
    for api in cluster.apis:
        managers[api.name] = BasicResourceManager(api, loop.clock)
    return managers, loop


def build_orchestrator(
    cluster: ClusterSpec,
    policy: Optional[SchedulingPolicy] = None,
    services: Sequence[str] = (),
    service_state_gb: float = 40.0,
    loop: Optional[EventLoop] = None,
    incremental: bool = True,
    fair_share: Optional[FairSharePolicy] = None,
    shards: Optional[int] = None,
) -> Orchestrator:
    """One orchestrator, swappable policy (ElasticScheduler by default,
    or the FCFS/static baseline policies for ablations).  ``fair_share``
    turns on multi-tenant weighted queueing across task_ids; ``shards``
    switches the round loop to the plan/commit engine (repro_torch.core.shards)
    with that many parallel planners."""
    managers, loop = build_managers(cluster, services, service_state_gb, loop)
    return Orchestrator(
        managers, loop=loop, policy=policy, incremental=incremental,
        fair_share=fair_share, shards=shards,
    )


def build_tangram(
    cluster: ClusterSpec,
    services: Sequence[str] = (),
    service_state_gb: float = 40.0,
    loop: Optional[EventLoop] = None,
    depth: int = 2,
    fair_share: Optional[FairSharePolicy] = None,
) -> Tangram:
    managers, loop = build_managers(cluster, services, service_state_gb, loop)
    tg = Tangram(managers, loop=loop, fair_share=fair_share)
    tg.scheduler = ElasticScheduler(depth=depth, history=tg.history)
    return tg


def run_tangram_step(
    trajectories: Sequence[TrajectorySpec],
    cluster: Optional[ClusterSpec] = None,
    depth: int = 2,
) -> Tuple[StepStats, Tangram]:
    cluster = cluster or paper_testbed()
    services = workload_services(trajectories)
    tg = build_tangram(cluster, services, depth=depth)
    runner = RolloutRunner({"*": tg, "cpu": tg, "gpu": tg,
                            **{a.name: tg for a in cluster.apis}}, tg.loop)
    stats = runner.run_step(trajectories)
    return stats, tg


def run_baseline_step(
    trajectories: Sequence[TrajectorySpec],
    cluster: Optional[ClusterSpec] = None,
    gpu_baseline: str = "static",  # "static" | "serverless"
) -> Tuple[StepStats, Dict[str, object]]:
    """Workload-specific baselines (§6.1): k8s pods for CPU, SGLang-style
    static services (or ServerlessLLM) for GPU, unmanaged API calls."""
    cluster = cluster or paper_testbed()
    loop = EventLoop()
    services = workload_services(trajectories)
    systems: Dict[str, object] = {}
    cpu_sys = TrajectoryStaticCpuSystem(total_cores=cluster.total_cores, loop=loop)
    systems["cpu"] = cpu_sys
    if services:
        if gpu_baseline == "static":
            per = max(1, cluster.total_devices // 4 // max(1, len(services)))
            gpu_sys = StaticGpuServiceSystem({s: per for s in services}, tp=4, loop=loop)
        else:
            gpu_sys = ServerlessLlmSystem(
                cluster.total_devices, {s: 40.0 for s in services}, loop=loop
            )
        systems["gpu"] = gpu_sys
    api_sys = UnmanagedApiSystem(rate_limit=64, loop=loop)
    for api in cluster.apis:
        systems[api.name] = api_sys
    systems["*"] = cpu_sys
    runner = RolloutRunner(systems, loop)
    stats = runner.run_step(trajectories)
    return stats, systems


# ---------------------------------------------------------------------------
# Live end-to-end: GRPO training with rewards through ARL-Tangram
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LiveStepReport:
    grpo_loss: float
    mean_reward: float
    mean_act: float
    rollout_wall_s: float
    reward_wall_s: float  # the judge actions' Tangram run
    update_wall_s: float  # group advantages, rollout-time log-probs, one GRPO step
    judge_s: np.ndarray  # [B*G] the measured wall of each judge call: its action's duration


def judge_action(index: int, duration_sampler: Callable[[int], float]) -> Action:
    """The reward action of sequence ``index``: one judge call on the GPU pool."""
    return Action(
        name="reward:judge",
        cost={"gpu": ResourceRequest("gpu", (1, 2, 4, 8))},
        key_resource="gpu",
        elasticity=GPU_ELASTICITY,
        base_duration=0.05,
        duration_sampler=duration_sampler,
        service="judge",
        task_id="live",
        trajectory_id=f"live-{index}",
    )


class LiveGrpoDriver:
    """Trains a policy with GRPO; reward computation executes REAL
    inference while resource occupancy/latency is accounted through
    ARL-Tangram's scheduler (measured durations feed the DES).

    Weights come from ``torch.Generator``s on ``device`` (the card unless
    ``"cpu"`` is asked for): the policy's from ``seed``, the judge's from
    ``seed + 2``; sampling draws from ``seed + 1``.
    """

    def __init__(
        self,
        policy_cfg: ModelConfig,
        judge_cfg: ModelConfig,
        group_size: int = 4,
        seed: int = 0,
        device: Optional[torch.device | str] = None,
    ):
        self.device = torch.device("cuda" if device is None else device)
        self.api = build_model(policy_cfg)
        self.state = init_train_state(
            self.api, torch.Generator(device=self.device).manual_seed(seed), self.device
        )
        self.group_size = group_size
        self.gen_cfg = GenerationConfig(max_new_tokens=16, temperature=1.0, cache_len=64)
        self.judge = deploy_reward_service("judge", judge_cfg, seed + 2, self.device)
        self.grpo_step = make_grpo_step(
            self.api, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
        )
        self._generator = torch.Generator(device=self.device).manual_seed(seed + 1)

    def _sync(self) -> None:
        """Wait for the card: its launches return before the work is done."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_step(self, prompts: np.ndarray, tangram: Tangram) -> LiveStepReport:
        """prompts: [B, S0] int32.  One rollout + reward + GRPO update."""
        t0 = time.perf_counter()
        seqs = self.rollout(prompts)
        self._sync()
        t1 = time.perf_counter()
        rewards, judge_s = self.score(seqs, tangram)
        t2 = time.perf_counter()
        metrics, _ = self.update(seqs, prompts.shape[1], rewards)
        t3 = time.perf_counter()
        return LiveStepReport(
            grpo_loss=metrics["loss"],
            mean_reward=float(rewards.mean()),
            mean_act=tangram.telemetry.mean_act(),
            rollout_wall_s=t1 - t0,
            reward_wall_s=t2 - t1,
            update_wall_s=t3 - t2,
            judge_s=judge_s,
        )

    def rollout(self, prompts: np.ndarray) -> torch.Tensor:
        """Group rollouts: each prompt G times -> [B*G, S0 + new] int64 sequences."""
        rep = torch.as_tensor(np.repeat(prompts, self.group_size, axis=0), dtype=torch.long,
                              device=self.device)
        engine = Engine(self.api, self.state.params, self.gen_cfg)
        gen = engine.generate({"tokens": rep}, generator=self._generator)
        return torch.cat([rep, gen.tokens], dim=1)

    def score(self, seqs: torch.Tensor, tangram: Tangram) -> Tuple[np.ndarray, np.ndarray]:
        """Rewards through Tangram: one judge action per sequence, each a real
        judge call whose measured wall is its duration.  -> (rewards, walls)."""
        n = seqs.shape[0]
        rewards = np.zeros(n, np.float32)
        judge_s = np.full(n, np.nan)

        def score_fn(idx):
            def run(dop: int) -> float:
                t = time.perf_counter()
                # float() waits for the card, so the wall holds the judge's device time
                rewards[idx] = float(self.judge.score(seqs[idx : idx + 1])[0])
                judge_s[idx] = wall = time.perf_counter() - t
                return wall

            return run

        for i in range(n):
            tangram.submit(judge_action(i, score_fn(i)))
        tangram.run()
        return rewards, judge_s

    def update(
        self, seqs: torch.Tensor, prompt_len: int, rewards: np.ndarray
    ) -> Tuple[Dict[str, float], Dict[str, torch.Tensor]]:
        """GRPO update (real) on the generated positions; -> (metrics, batch)."""
        B, G = len(rewards) // self.group_size, self.group_size
        adv = group_advantages(torch.as_tensor(rewards.reshape(B, G), device=self.device))
        with torch.no_grad():
            old_logp = token_logprobs(self.state.params, seqs, self.api)
        mask = torch.zeros(B * G, seqs.shape[1] - 1, device=self.device)
        mask[:, prompt_len - 1 :] = 1.0  # only generated positions train
        batch = {
            "tokens": seqs,
            "mask": mask,
            "advantages": adv.reshape(-1),
            "old_logp": old_logp,
            "ref_logp": old_logp,
        }
        self.state, metrics = self.grpo_step(self.state, batch)
        return {k: float(v) for k, v in metrics.items()}, batch  # float() waits for the step

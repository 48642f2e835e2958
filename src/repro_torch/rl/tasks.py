"""Agentic RL workload generators (paper §6.1), trace-parameterized.

Three production workloads drive the evaluation:

* **AI coding** — per-trajectory isolated environments; multi-turn
  ReAct with short shell/edit tool calls (~ms-seconds, 1 CPU,
  non-scalable) and a *long-tailed, CPU-scalable* reward action (test
  execution, pytest -n parallelizable, DoP 1..32).  Generators are
  calibrated so the env-busy ratio matches the paper's ~47% (Fig. 3c).
* **DeepSearch** — BrowseComp-style: rate-limited API calls
  (search / fetch / pdf; non-scalable; Basic manager) plus an LLM-judge
  reward on the GPU pool (scalable DoP 1-8).
* **MOPD** — multi-teacher distillation: trajectory log-probs computed
  against ~10 teacher-model services; invocations concentrate at
  trajectory boundaries (the 3-orders-of-magnitude burstiness of
  Fig. 3d).

Durations are sampled from seeded lognormals; every action carries the
paper's §4.1 formulation (vectorized cost, key elasticity resource,
profiled elasticity for scalable kinds).
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Callable, List, Sequence

from repro_torch.core.action import (
    Action,
    AmdahlElasticity,
    TableElasticity,
    fixed,
    ResourceRequest,
)

GPU_ELASTICITY = TableElasticity(table=((1, 1.0), (2, 0.92), (4, 0.81), (8, 0.62)))
CPU_TEST_ELASTICITY = AmdahlElasticity(serial=0.05)


@dataclasses.dataclass
class ActionTemplate:
    """Factory producing a fresh Action per invocation."""

    build: Callable[[str, str], Action]

    def make(self, task_id: str, traj_id: str) -> Action:
        return self.build(task_id, traj_id)


@dataclasses.dataclass
class TurnSpec:
    gen_s: float  # LLM generation time preceding the tool call(s)
    actions: List[ActionTemplate]


@dataclasses.dataclass
class TrajectorySpec:
    task_id: str
    traj_id: str
    arrival_s: float
    turns: List[TurnSpec]
    reward: List[ActionTemplate]
    memory_gb: float = 4.0


def _lognormal(rng: random.Random, median: float, sigma: float) -> float:
    return median * math.exp(rng.gauss(0.0, sigma))


# ---------------------------------------------------------------------------
# AI coding
# ---------------------------------------------------------------------------


def make_coding_workload(
    n_traj: int,
    seed: int = 0,
    turns_lo: int = 3,
    turns_hi: int = 10,
    tool_median_s: float = 1.2,
    gen_median_s: float = 4.0,
    reward_median_s: float = 30.0,
    reward_sigma: float = 1.0,  # heavy tail (paper: long-tailed test runs)
    arrival_spread_s: float = 10.0,
    task_id: str = "coding",
) -> List[TrajectorySpec]:
    rng = random.Random(seed)
    out = []
    for i in range(n_traj):
        turns = []
        for _ in range(rng.randint(turns_lo, turns_hi)):
            dur = _lognormal(rng, tool_median_s, 0.6)
            turns.append(
                TurnSpec(
                    gen_s=_lognormal(rng, gen_median_s, 0.4),
                    actions=[_cpu_tool(dur)],
                )
            )
        reward_dur = _lognormal(rng, reward_median_s, reward_sigma)
        out.append(
            TrajectorySpec(
                task_id=task_id,
                traj_id=f"{task_id}-{seed}-{i}",
                arrival_s=rng.uniform(0, arrival_spread_s),
                turns=turns,
                reward=[_cpu_reward(reward_dur)],
                memory_gb=rng.choice([2.0, 4.0, 8.0]),
            )
        )
    return out


def _cpu_tool(duration: float) -> ActionTemplate:
    def build(task_id: str, traj_id: str) -> Action:
        return Action(
            name="tool:exec",
            cost={"cpu": fixed("cpu", 1)},
            base_duration=duration,
            task_id=task_id,
            trajectory_id=traj_id,
        )

    return ActionTemplate(build)


def _cpu_reward(duration: float) -> ActionTemplate:
    def build(task_id: str, traj_id: str) -> Action:
        return Action(
            name="reward:tests",
            # discrete power-of-two DoPs (paper §4.1: "the allowed unit of
            # resource is discrete"); also bounds the DP option fan-out
            cost={"cpu": ResourceRequest("cpu", (1, 2, 4, 8, 16, 32))},
            key_resource="cpu",
            elasticity=CPU_TEST_ELASTICITY,
            base_duration=duration,
            task_id=task_id,
            trajectory_id=traj_id,
        )

    return ActionTemplate(build)


# ---------------------------------------------------------------------------
# DeepSearch
# ---------------------------------------------------------------------------


def make_deepsearch_workload(
    n_traj: int,
    seed: int = 0,
    turns_lo: int = 4,
    turns_hi: int = 12,
    api_median_s: float = 2.5,
    gen_median_s: float = 6.0,
    judge_median_s: float = 8.0,
    arrival_spread_s: float = 10.0,
    task_id: str = "deepsearch",
) -> List[TrajectorySpec]:
    rng = random.Random(seed + 1)
    out = []
    apis = ["google_search", "web_fetch", "web_fetch", "pdf_parse"]
    for i in range(n_traj):
        turns = []
        for _ in range(rng.randint(turns_lo, turns_hi)):
            api = rng.choice(apis)
            turns.append(
                TurnSpec(
                    gen_s=_lognormal(rng, gen_median_s, 0.4),
                    actions=[_api_call(api, _lognormal(rng, api_median_s, 0.5))],
                )
            )
        out.append(
            TrajectorySpec(
                task_id=task_id,
                traj_id=f"{task_id}-{seed}-{i}",
                arrival_s=rng.uniform(0, arrival_spread_s),
                turns=turns,
                reward=[_gpu_reward("judge", _lognormal(rng, judge_median_s, 0.5))],
                memory_gb=1.0,
            )
        )
    return out


def _api_call(api: str, duration: float) -> ActionTemplate:
    def build(task_id: str, traj_id: str) -> Action:
        return Action(
            name=f"tool:{api}",
            cost={api: fixed(api, 1)},
            base_duration=duration,
            task_id=task_id,
            trajectory_id=traj_id,
        )

    return ActionTemplate(build)


def _gpu_reward(service: str, duration: float) -> ActionTemplate:
    def build(task_id: str, traj_id: str) -> Action:
        return Action(
            name=f"reward:{service}",
            cost={"gpu": ResourceRequest("gpu", (1, 2, 4, 8))},
            key_resource="gpu",
            elasticity=GPU_ELASTICITY,
            base_duration=duration,
            service=service,
            task_id=task_id,
            trajectory_id=traj_id,
        )

    return ActionTemplate(build)


# ---------------------------------------------------------------------------
# MOPD (multi-teacher distillation)
# ---------------------------------------------------------------------------


def _zipf_sample(rng: random.Random, n: int, k: int, skew: float) -> List[int]:
    """Weighted sample of ``k`` distinct indices with Zipf(``skew``)
    popularity (paper Fig. 3d: per-service invocation counts vary by up
    to three orders of magnitude).  ``skew=0`` degenerates to uniform."""
    pool = list(range(n))
    weights = [1.0 / (t + 1) ** skew for t in pool]
    chosen: List[int] = []
    for _ in range(min(k, n)):
        total = sum(weights)
        r = rng.uniform(0, total)
        acc = 0.0
        for idx, w in enumerate(weights):
            acc += w
            if r <= acc:
                chosen.append(pool.pop(idx))
                weights.pop(idx)
                break
        else:  # pragma: no cover - float edge
            chosen.append(pool.pop())
            weights.pop()
    return chosen


def make_mopd_workload(
    n_traj: int,
    seed: int = 0,
    n_teachers: int = 9,
    gen_median_s: float = 12.0,
    teacher_median_s: float = 6.0,
    teachers_per_traj: int = 3,
    arrival_spread_s: float = 5.0,  # bursty: tight arrivals
    teacher_skew: float = 1.5,  # Zipf exponent over teacher popularity (Fig. 3d)
    task_id: str = "mopd",
) -> List[TrajectorySpec]:
    rng = random.Random(seed + 2)
    out = []
    for i in range(n_traj):
        # a single long generation phase, then a burst of teacher scoring
        turns = [TurnSpec(gen_s=_lognormal(rng, gen_median_s, 0.6), actions=[])]
        teachers = _zipf_sample(rng, n_teachers, teachers_per_traj, teacher_skew)
        reward = [
            _gpu_reward(f"teacher{t}", _lognormal(rng, teacher_median_s, 0.5))
            for t in teachers
        ]
        out.append(
            TrajectorySpec(
                task_id=task_id,
                traj_id=f"{task_id}-{seed}-{i}",
                arrival_s=rng.uniform(0, arrival_spread_s),
                turns=turns,
                reward=reward,
                memory_gb=1.0,
            )
        )
    return out


def workload_services(trajs: Sequence[TrajectorySpec]) -> List[str]:
    """All GPU service names a workload references (for EOE deployment)."""
    names = set()
    for t in trajs:
        for tmpl in t.reward:
            a = tmpl.make(t.task_id, t.traj_id)
            if a.service:
                names.add(a.service)
    return sorted(names)

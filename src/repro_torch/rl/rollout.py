"""Rollout runner: drives trajectory state machines through any external
resource system (ARL-Tangram or a baseline) inside the DES.

Per the paper's workflow (§2.1 Fig. 2): each trajectory interleaves LLM
generation (time advance, training-cluster side) with external actions
(submitted to the system under test, critical-path blocking); rewards
run at trajectory end; the RL *step* completes when every trajectory in
the batch has its reward (synchronous GRPO step).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence

from repro_torch.core.simulator import EventLoop
from repro_torch.rl.tasks import TrajectorySpec


@dataclasses.dataclass
class StepStats:
    step_duration: float
    mean_act: float
    p99_act: float
    failure_rate: float
    breakdown: Dict[str, float]
    stage_durations: Dict[str, float]  # total time per stage label
    retries: int = 0  # lifecycle re-queues observed across all systems


class RolloutRunner:
    """Runs one synchronous RL step (a batch of trajectories)."""

    def __init__(
        self,
        systems: Dict[str, object],  # resource-kind -> system; "*" = default
        loop: EventLoop,
    ) -> None:
        self.systems = systems
        self.loop = loop
        self._remaining = 0
        self._t_begin = math.inf
        self._t_end = 0.0
        self._stage_time: Dict[str, float] = {"gen": 0.0, "tool": 0.0, "reward": 0.0}

    def _system_for(self, action) -> object:
        for rtype in action.cost:
            if rtype in self.systems:
                return self.systems[rtype]
        return self.systems["*"]

    # ------------------------------------------------------------------
    def run_step(self, trajectories: Sequence[TrajectorySpec]) -> StepStats:
        self._remaining = len(trajectories)
        self._t_begin = math.inf
        self._t_end = 0.0
        for spec in trajectories:
            self.loop.call_after(spec.arrival_s, lambda s=spec: self._start_traj(s))
        self.loop.run()
        # aggregate telemetry from every distinct system
        seen = {id(s): s for s in self.systems.values()}
        acts: List[float] = []
        fails = 0
        total = 0
        retries = 0
        sums = {"exec": 0.0, "queue": 0.0, "overhead": 0.0}
        for sys_ in seen.values():
            tel = sys_.telemetry
            for r in tel.records:
                total += 1
                retries += r.retries
                if r.failed:
                    fails += 1
                else:
                    acts.append(r.act)
                    sums["exec"] += r.exec_dur
                    sums["queue"] += r.queue_dur
                    sums["overhead"] += r.sys_overhead
        # per-action means, so the breakdown decomposes mean_act exactly
        # (a per-system mean-of-means would not when several baseline
        # systems with different record counts coexist)
        breakdown = {
            k: (v / len(acts) if acts else math.nan) for k, v in sums.items()
        }
        acts.sort()
        return StepStats(
            step_duration=self._t_end - min(self._t_begin, self._t_end),
            mean_act=sum(acts) / len(acts) if acts else math.nan,
            p99_act=acts[int(0.99 * (len(acts) - 1))] if acts else math.nan,
            failure_rate=fails / total if total else 0.0,
            breakdown=breakdown,
            stage_durations=dict(self._stage_time),
            retries=retries,
        )

    # ------------------------------------------------------------------
    def _start_traj(self, spec: TrajectorySpec) -> None:
        self._t_begin = min(self._t_begin, self.loop.clock.now())
        for sys_ in {id(s): s for s in self.systems.values()}.values():
            sys_.trajectory_start(spec.traj_id, {"traj_mem_gb": spec.memory_gb})
        self._next_turn(spec, 0)

    def _next_turn(self, spec: TrajectorySpec, turn_idx: int) -> None:
        if turn_idx >= len(spec.turns):
            self._run_rewards(spec)
            return
        turn = spec.turns[turn_idx]
        self._stage_time["gen"] += turn.gen_s

        def after_gen() -> None:
            if not turn.actions:
                self._next_turn(spec, turn_idx + 1)
                return
            pending = len(turn.actions)
            t_submit = self.loop.clock.now()

            def one_done(_fut) -> None:
                nonlocal pending
                pending -= 1
                self._stage_time["tool"] += self.loop.clock.now() - t_submit
                if pending == 0:
                    self._next_turn(spec, turn_idx + 1)

            for tmpl in turn.actions:
                action = tmpl.make(spec.task_id, spec.traj_id)
                fut = self._system_for(action).submit(action)
                fut.add_done_callback(one_done)

        self.loop.call_after(turn.gen_s, after_gen)

    def _run_rewards(self, spec: TrajectorySpec) -> None:
        if not spec.reward:
            self._finish_traj(spec)
            return
        pending = len(spec.reward)
        t_submit = self.loop.clock.now()

        def one_done(_fut) -> None:
            nonlocal pending
            pending -= 1
            self._stage_time["reward"] += self.loop.clock.now() - t_submit
            if pending == 0:
                self._finish_traj(spec)

        for tmpl in spec.reward:
            action = tmpl.make(spec.task_id, spec.traj_id)
            fut = self._system_for(action).submit(action)
            fut.add_done_callback(one_done)

    def _finish_traj(self, spec: TrajectorySpec) -> None:
        for sys_ in {id(s): s for s in self.systems.values()}.values():
            sys_.trajectory_end(spec.traj_id)
        self._t_end = max(self._t_end, self.loop.clock.now())
        self._remaining -= 1

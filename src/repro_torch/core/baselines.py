"""Baseline external-resource systems the paper compares against (§6.1).

All baselines expose the same ``submit / trajectory_start / trajectory_end
/ run`` surface as :class:`~repro_torch.core.tangram.Tangram`, so the workload
generators drive either system unchanged.

* :class:`TrajectoryStaticCpuSystem` — the Kubernetes baseline: one pod
  per trajectory (0.5-CPU request, 4-CPU limit), pod creation through a
  serialized control plane, CFS fair-sharing when demand exceeds cores,
  resources held for the trajectory's whole lifetime.
* :class:`StaticGpuServiceSystem`  — the SGLang baseline: each service
  pinned to dedicated GPUs at fixed TP, per-service FIFO replicas, no
  cross-service sharing.
* :class:`ServerlessLlmSystem`     — MaaS baseline: shared GPU pool,
  fixed DoP, cold-start model loading (slower than EOE restore), no
  elastic reallocation, timeout failures under pressure.
* :class:`UnmanagedApiSystem`      — DeepSearch baseline: clients fire
  API calls directly; rate-limit violations cause failures and <=3
  retries with a 600 s timeout.

Additionally, two *policy-level* baselines implement the orchestrator's
:class:`~repro_torch.core.orchestrator.SchedulingPolicy` protocol, so ablations
can swap the scheduling algorithm while keeping Tangram's managers,
lifecycle, and telemetry:

* :class:`FcfsPolicy`      — strict FCFS at minimum units, no elasticity;
* :class:`StaticDopPolicy` — every scalable action pinned to one fixed
  DoP (the SGLang-style "static TP" discipline) on a shared pool.

Multi-tenant fairness ablations compose orthogonally: the *queueing*
ablation is ``Orchestrator(fair_share=None)`` (plain cross-task FCFS
partitions — the pre-fairness path), and the *allocation* ablation is
``FcfsPolicy`` under a fair-share orchestrator (weighted ordering, but
no elastic/weighted allocation).  ``bench_scheduler --suite fairness``
measures both against the full WFQ + fairness-aware ElasticScheduler
stack.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch.core.action import Action, ActionState
from repro_torch.core.scheduler import Decision, ScheduleResult
from repro_torch.core.simulator import EventLoop, Future
from repro_torch.core.telemetry import ActionRecord, Telemetry


# ---------------------------------------------------------------------------
# Policy-level baselines (SchedulingPolicy protocol)
# ---------------------------------------------------------------------------


class FcfsPolicy:
    """Strict FCFS at least-required units — the no-elasticity ablation."""

    def __init__(self, candidate_limit: int = 128) -> None:
        self.candidate_limit = candidate_limit

    def arrange(
        self,
        candidates: Sequence[Action],
        remaining: Sequence[Action],
        executing: Sequence[Action],
        managers: Dict[str, object],
        now: float,
    ) -> ScheduleResult:
        return ScheduleResult(
            decisions=[Decision(a, a.min_cost()) for a in candidates]
        )

    def schedule(
        self,
        waiting: Sequence[Action],
        executing: Sequence[Action],
        managers: Dict[str, object],
        now: float,
    ) -> ScheduleResult:
        from repro_torch.core.orchestrator import candidate_window

        candidates = candidate_window(waiting, managers, self.candidate_limit)
        return self.arrange(
            candidates, list(waiting[len(candidates) :]), executing, managers, now
        )


class StaticDopPolicy(FcfsPolicy):
    """FCFS with every scalable action pinned at a fixed DoP (static TP).

    The admission window still opens at min units, so an action whose
    static DoP exceeds what is currently free simply fails allocation
    and retries — mirroring the queueing behaviour of a fixed-TP
    deployment on a shared pool.
    """

    def __init__(self, dop: int = 4, candidate_limit: int = 128) -> None:
        super().__init__(candidate_limit)
        self.dop = dop

    def arrange(
        self,
        candidates: Sequence[Action],
        remaining: Sequence[Action],
        executing: Sequence[Action],
        managers: Dict[str, object],
        now: float,
    ) -> ScheduleResult:
        decisions = []
        for a in candidates:
            units = a.min_cost()
            if a.key_resource is not None:
                feasible = a.key_units()
                units[a.key_resource] = max(
                    (u for u in feasible if u <= self.dop), default=feasible[0]
                )
            decisions.append(Decision(a, units))
        return ScheduleResult(decisions=decisions)


class _BaseSystem:
    def __init__(self, loop: Optional[EventLoop] = None) -> None:
        self.loop = loop or EventLoop()
        self.telemetry = Telemetry()
        self._futures: Dict[int, Future] = {}

    @property
    def now(self) -> float:
        return self.loop.clock.now()

    def run(self, until: Optional[float] = None) -> float:
        return self.loop.run(until=until)

    def trajectory_start(self, trajectory_id: str, metadata: Optional[dict] = None) -> None:
        pass

    def trajectory_end(self, trajectory_id: str) -> None:
        pass

    def _finish(self, action: Action, units: Dict[str, int], failed: bool = False, retries: int = 0) -> None:
        action.state = ActionState.FAILED if failed else ActionState.DONE
        self.telemetry.record(
            ActionRecord(
                name=action.name,
                task_id=action.task_id,
                trajectory_id=action.trajectory_id,
                submit=action.submit_time,
                start=action.start_time,
                finish=action.finish_time,
                sys_overhead=action.sys_overhead,
                units=units,
                failed=failed,
                retries=retries,
            )
        )
        fut = self._futures.pop(action.uid, None)
        if fut is not None:
            fut.set_result(not failed)


# ---------------------------------------------------------------------------
# Kubernetes-style trajectory-level CPU baseline
# ---------------------------------------------------------------------------


@dataclass
class _CfsJob:
    action: Action
    demand: float  # cores desired
    remaining: float  # core-seconds of work left
    rate: float = 0.0
    event: object = None


class TrajectoryStaticCpuSystem(_BaseSystem):
    """Pod-per-trajectory with CFS fair sharing (paper §6.1 AI-coding baseline)."""

    def __init__(
        self,
        total_cores: int,
        loop: Optional[EventLoop] = None,
        pod_request: float = 0.5,
        pod_limit: float = 4.0,
        pod_create_base_s: float = 2.0,
        control_plane_rate: float = 8.0,  # pod creations per second
        admission_timeout_s: float = 600.0,
    ) -> None:
        super().__init__(loop)
        self.total_cores = total_cores
        self.pod_request = pod_request
        self.pod_limit = pod_limit
        self.pod_create_base_s = pod_create_base_s
        self.control_plane_rate = control_plane_rate
        self.admission_timeout_s = admission_timeout_s
        self._reserved = 0.0
        self._pods_ready: Dict[str, float] = {}  # traj -> ready time
        self._cp_free_at = 0.0  # control plane serialization
        self._jobs: List[_CfsJob] = []

    # -- trajectory lifecycle -----------------------------------------------
    def trajectory_start(self, trajectory_id: str, metadata: Optional[dict] = None) -> None:
        # admission: wait until reservation fits, then pay serialized
        # control-plane latency.
        t = self.now
        self._cp_free_at = max(self._cp_free_at, t) + 1.0 / self.control_plane_rate
        ready = self._cp_free_at + self.pod_create_base_s
        # reservation pressure: if the cluster is fully reserved the pod
        # queues behind running trajectories (modeled as proportional delay).
        over = max(0.0, (self._reserved + self.pod_request) - self.total_cores)
        if over > 0:
            ready += over / self.pod_request * 1.0  # each blocked pod ~1 s retry loop
        self._reserved += self.pod_request
        self._pods_ready[trajectory_id] = ready

    def trajectory_end(self, trajectory_id: str) -> None:
        if trajectory_id in self._pods_ready:
            del self._pods_ready[trajectory_id]
            self._reserved -= self.pod_request

    # -- CFS fluid model ------------------------------------------------------
    def _rebalance(self) -> None:
        now = self.now
        # settle progress at old rates
        for j in self._jobs:
            pass  # progress is settled in _advance before mutation
        demand = sum(j.demand for j in self._jobs)
        scale = min(1.0, self.total_cores / demand) if demand > 0 else 1.0
        for j in self._jobs:
            j.rate = j.demand * scale
            if j.event is not None:
                self.loop.cancel(j.event)
            eta = j.remaining / j.rate if j.rate > 0 else math.inf
            j.event = self.loop.call_after(eta, lambda jj=j: self._job_done(jj))
            j.action.finish_time = now + eta

    def _advance(self) -> None:
        """Settle remaining work at current rates up to now."""
        now = self.now
        for j in self._jobs:
            elapsed = now - getattr(j, "_last_t", j.action.start_time)
            j.remaining = max(0.0, j.remaining - elapsed * j.rate)
            j._last_t = now  # type: ignore[attr-defined]

    def submit(self, action: Action, delay: float = 0.0) -> Future:
        fut = Future()
        self._futures[action.uid] = fut

        def _arrive() -> None:
            action.submit_time = self.now
            ready = self._pods_ready.get(action.trajectory_id, self.now)
            wait = max(0.0, ready - self.now)
            if wait > self.admission_timeout_s:
                action.start_time = self.now
                action.finish_time = self.now + self.admission_timeout_s
                self._finish(action, {}, failed=True)
                return
            self.loop.call_after(wait, lambda: self._start(action))

        self.loop.call_after(delay, _arrive)
        return fut

    def _start(self, action: Action) -> None:
        self._advance()
        action.start_time = self.now
        # demand capped by the pod limit; elasticity beyond the limit is lost
        feasible = action.key_units()
        demand = float(min(self.pod_limit, max(1, feasible[0])))
        base = action.base_duration
        if base is None and action.duration_sampler is not None:
            base = action.duration_sampler(1)
        work = float(base if base is not None else 1.0)  # core-seconds at 1 core
        if action.elasticity is not None and demand > 1:
            work = base / action.elasticity.speedup(int(demand)) * demand
        job = _CfsJob(action=action, demand=demand, remaining=work)
        job._last_t = self.now  # type: ignore[attr-defined]
        self._jobs.append(job)
        self._rebalance()

    def _job_done(self, job: _CfsJob) -> None:
        self._advance()
        if job not in self._jobs:
            return
        if job.remaining > 1e-9:  # rates changed; re-arm
            self._rebalance()
            return
        self._jobs.remove(job)
        job.action.finish_time = self.now
        self._finish(job.action, {"cpu": int(job.demand)})
        self._rebalance()


# ---------------------------------------------------------------------------
# SGLang-style static GPU services
# ---------------------------------------------------------------------------


class StaticGpuServiceSystem(_BaseSystem):
    """Each service pinned to dedicated GPUs at fixed TP; FIFO per service."""

    def __init__(
        self,
        services: Dict[str, int],  # service -> replica count
        tp: int = 4,
        loop: Optional[EventLoop] = None,
    ) -> None:
        super().__init__(loop)
        self.tp = tp
        self._free: Dict[str, int] = dict(services)
        self._queues: Dict[str, List[Action]] = {s: [] for s in services}
        self.total_gpus = sum(services.values()) * tp

    def submit(self, action: Action, delay: float = 0.0) -> Future:
        fut = Future()
        self._futures[action.uid] = fut

        def _arrive() -> None:
            action.submit_time = self.now
            svc = action.service or "default"
            if svc not in self._queues:
                raise KeyError(f"service {svc!r} not deployed in static baseline")
            self._queues[svc].append(action)
            self._drain(svc)

        self.loop.call_after(delay, _arrive)
        return fut

    def _drain(self, svc: str) -> None:
        while self._queues[svc] and self._free[svc] > 0:
            action = self._queues[svc].pop(0)
            self._free[svc] -= 1
            action.start_time = self.now
            dur = self._dur(action)
            action.finish_time = self.now + dur
            self.loop.call_at(
                action.finish_time, lambda a=action, s=svc: self._done(a, s)
            )

    def _dur(self, action: Action) -> float:
        if action.duration_sampler is not None:
            return action.duration_sampler(self.tp)
        feasible = action.key_units()
        m = max((u for u in feasible if u <= self.tp), default=feasible[0])
        try:
            return action.get_dur(m)
        except ValueError:
            return action.get_dur()

    def _done(self, action: Action, svc: str) -> None:
        self._free[svc] += 1
        self._finish(action, {"gpu": self.tp})
        self._drain(svc)


# ---------------------------------------------------------------------------
# ServerlessLLM-style MaaS
# ---------------------------------------------------------------------------


class ServerlessLlmSystem(_BaseSystem):
    """Shared pool, fixed DoP, cold-start loads, no elastic reallocation."""

    def __init__(
        self,
        total_gpus: int,
        service_state_gb: Dict[str, float],
        dop: int = 4,
        load_bw_gbps: float = 16.0,  # slower than EOE restore (no live snapshot)
        timeout_s: float = 600.0,
        loop: Optional[EventLoop] = None,
    ) -> None:
        super().__init__(loop)
        self.dop = dop
        self.slots = total_gpus // dop
        self.state_gb = service_state_gb
        self.load_bw = load_bw_gbps
        self.timeout_s = timeout_s
        self._slot_model: List[Optional[str]] = [None] * self.slots
        self._slot_busy: List[bool] = [False] * self.slots
        self._slot_lru: List[float] = [0.0] * self.slots
        self._queue: List[Action] = []

    def submit(self, action: Action, delay: float = 0.0) -> Future:
        fut = Future()
        self._futures[action.uid] = fut

        def _arrive() -> None:
            action.submit_time = self.now
            self._queue.append(action)
            self._drain()

        self.loop.call_after(delay, _arrive)
        return fut

    def _drain(self) -> None:
        progressed = True
        while progressed and self._queue:
            progressed = False
            action = self._queue[0]
            if self.now - action.submit_time > self.timeout_s:
                self._queue.pop(0)
                action.start_time = action.submit_time
                action.finish_time = action.submit_time + self.timeout_s
                self._finish(action, {}, failed=True)
                progressed = True
                continue
            svc = action.service or "default"
            slot = self._pick_slot(svc)
            if slot is None:
                break
            self._queue.pop(0)
            self._slot_busy[slot] = True
            cold = self._slot_model[slot] != svc
            overhead = (
                self.state_gb.get(svc, 40.0) / self.load_bw if cold else 0.0
            )
            self._slot_model[slot] = svc
            self._slot_lru[slot] = self.now
            action.start_time = self.now
            action.sys_overhead = overhead
            dur = self._dur(action)
            action.finish_time = self.now + overhead + dur
            self.loop.call_at(action.finish_time, lambda a=action, s=slot: self._done(a, s))
            progressed = True
        # timeout sweep for queued requests
        if self._queue:
            head = self._queue[0]
            self.loop.call_after(
                max(0.0, head.submit_time + self.timeout_s - self.now) + 1e-6,
                self._drain,
            )

    def _pick_slot(self, svc: str) -> Optional[int]:
        idle = [i for i in range(self.slots) if not self._slot_busy[i]]
        if not idle:
            return None
        warm = [i for i in idle if self._slot_model[i] == svc]
        if warm:
            return warm[0]
        empty = [i for i in idle if self._slot_model[i] is None]
        if empty:
            return empty[0]
        return min(idle, key=lambda i: self._slot_lru[i])  # LRU cold replace

    def _dur(self, action: Action) -> float:
        if action.duration_sampler is not None:
            return action.duration_sampler(self.dop)
        feasible = action.key_units()
        m = max((u for u in feasible if u <= self.dop), default=feasible[0])
        try:
            return action.get_dur(m)
        except ValueError:
            return action.get_dur()

    def _done(self, action: Action, slot: int) -> None:
        self._slot_busy[slot] = False
        self._slot_lru[slot] = self.now
        self._finish(action, {"gpu": self.dop})
        self._drain()


# ---------------------------------------------------------------------------
# Unmanaged API calls (DeepSearch baseline)
# ---------------------------------------------------------------------------


class UnmanagedApiSystem(_BaseSystem):
    """Clients call APIs directly; overload causes failures and retries."""

    def __init__(
        self,
        rate_limit: int = 64,  # concurrent calls tolerated by the provider
        retry_limit: int = 3,
        timeout_s: float = 600.0,
        backoff_s: float = 30.0,
        seed: int = 0,
        loop: Optional[EventLoop] = None,
    ) -> None:
        super().__init__(loop)
        self.rate_limit = rate_limit
        self.retry_limit = retry_limit
        self.timeout_s = timeout_s
        self.backoff_s = backoff_s
        self._rng = random.Random(seed)
        self._in_flight = 0

    def submit(self, action: Action, delay: float = 0.0) -> Future:
        fut = Future()
        self._futures[action.uid] = fut
        self.loop.call_after(delay, lambda: self._attempt(action, 0, None))
        return fut

    def _attempt(self, action: Action, tries: int, first_submit: Optional[float]) -> None:
        if first_submit is None:
            first_submit = self.now
            action.submit_time = self.now
        self._in_flight += 1
        over = max(0.0, (self._in_flight - self.rate_limit) / max(1, self.rate_limit))
        p_fail = min(0.9, over)  # throttling probability grows with overload
        dur = (
            action.duration_sampler(1)
            if action.duration_sampler is not None
            else (action.base_duration or 1.0)
        )
        if self._rng.random() < p_fail:
            # throttled: wastes a timeout slice, then retries
            wasted = min(self.timeout_s, self.backoff_s * (tries + 1))
            self.loop.call_after(
                wasted, lambda: self._retry(action, tries, first_submit)
            )
        else:
            self.loop.call_after(dur, lambda: self._ok(action, first_submit, tries))

    def _retry(self, action: Action, tries: int, first_submit: float) -> None:
        self._in_flight -= 1
        if tries + 1 >= self.retry_limit or self.now - first_submit > self.timeout_s:
            action.start_time = first_submit
            action.finish_time = self.now
            self._finish(action, {}, failed=True, retries=tries + 1)
            return
        self._attempt(action, tries + 1, first_submit)

    def _ok(self, action: Action, first_submit: float, tries: int) -> None:
        self._in_flight -= 1
        action.start_time = first_submit
        action.finish_time = self.now
        self._finish(action, {"api": 1}, retries=tries)

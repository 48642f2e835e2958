"""Event-driven orchestrator core (paper §3, engineered for scale).

The seed ``Tangram`` facade rebuilt the whole scheduling problem from
scratch on every submission/completion and scanned / ``remove()``d a
single global waiting list — O(n²) control-plane work per round.  This
module restructures orchestration as an *incremental* event-driven
subsystem:

* **Partitioned waiting queues** — one queue per scheduling partition
  (an action's key elasticity resource, or its sole resource type).
  Admission, removal, and retry-at-head are all O(1) tag work; FCFS
  order is preserved *within* a task, and partitions of unrelated
  resources no longer block each other.  Each partition queue is a
  :class:`~repro_torch.core.fairqueue.PartitionQueue`: with a
  :class:`~repro_torch.core.fairqueue.FairSharePolicy` it holds per-task
  sub-queues drained by weighted start-time fair queueing (multi-tenant
  fair share, optional quota caps); with ``fair_share=None`` it is the
  plain cross-task FCFS deque (bit-identical to the pre-fairness path,
  and the fairness ablation).
* **Event coalescing** — all submissions/completions arriving at the
  same virtual timestamp are folded into ONE scheduling round (the
  round fires as a zero-delay event behind them).
* **Dirty tracking** — a round only re-runs the policy for partitions
  whose queue or manager state actually changed.  A partition goes
  *clean* only in states that are provably time-independent no-ops
  (empty queue, or FCFS head inadmissible at min units); partitions
  that deferred work stay on a watch list and re-run every round, so
  incremental rounds launch exactly what full rescheduling would.
* **Incremental candidate window** — managers expose an admission
  cursor (:meth:`ResourceManager.begin_admission` /
  :meth:`~ResourceManager.admit_one`) so the FCFS window is computed
  in O(window) instead of O(window²) full rescans.  The cursor loop
  lives in :func:`repro_torch.core.scheduler.candidate_window` (re-exported
  here) and is shared by the policy's standalone ``schedule()`` path.
* **Pluggable policy** — anything satisfying :class:`SchedulingPolicy`
  (the ported :class:`~repro_torch.core.scheduler.ElasticScheduler`, or the
  FCFS/static baselines in :mod:`repro_torch.core.baselines`) drives the same
  orchestrator; systems are composed, not duck-typed.
* **Action lifecycle** — per-attempt deadlines (``Action.timeout_s``)
  raised as loop events, bounded retry with re-queue at the FCFS head
  (``Action.max_retries``), cancellation, release-on-failure through
  the managers, failure/retry telemetry, and
  :meth:`Future.set_exception` propagation.

Set ``incremental=False`` to force full rescheduling every round (every
partition dirty, no DP memo, the policy's own window scan) — the
equivalence tests run both modes over identical workloads and assert
identical launch traces.

``shards=N`` turns the round loop into the **plan/commit engine**
(:mod:`repro_torch.core.shards`): dirty partitions are planned concurrently
over manager free-state snapshots and committed serially against live
state, with conflicts re-dirtied onto the ordinary retry rail.
``shards=None`` (default) keeps the serial loop bit-identical to the
pre-shard code; on conflict-free workloads the two produce identical
launch traces (tests/test_shards.py).
"""

from __future__ import annotations

import math
import time
from functools import partial
from typing import (
    TYPE_CHECKING,
    Dict,
    Iterable,
    List,
    Mapping,
    Optional,
    Protocol,
    Sequence,
    Set,
    Tuple,
)

from repro_torch.core.action import (
    TERMINAL_STATES,
    Action,
    ActionState,
    DurationHistory,
    ResourceRequest,
)
from repro_torch.core.fairqueue import FairSharePolicy, PartitionQueue, default_cost
from repro_torch.core.managers.base import Allocation, ResourceManager
from repro_torch.core.scheduler import (
    Decision,
    ElasticScheduler,
    ScheduleResult,
    candidate_window,
)
from repro_torch.core.shards import (
    PartitionPlan,
    RoundExecutor,
    classify_after_commit,
    commit_decision,
    duration_of,
    plan_partition,
    quota_clamp,
    quota_reservations,
)
from repro_torch.core.simulator import EventLoop, Future
from repro_torch.core.telemetry import ActionRecord, Telemetry

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.rebalance import RebalancePolicy, RebalanceSignals

# Decision latency charged per scheduling round when not measuring the
# real wall clock (Table 1 shows sub-3% system overhead on CPU workloads).
SCHED_TICK_S = 0.0005
# Max consecutive no-progress retry ticks between real events (stalled-
# launch guard); bounds DES work when a queue is truly unschedulable.
STALL_RETRY_LIMIT = 4


class ActionError(Exception):
    """Terminal action failure, delivered via ``Future.set_exception``."""

    def __init__(self, action: Action, reason: str) -> None:
        super().__init__(f"{action.name}#{action.uid}: {reason}")
        self.action = action
        self.reason = reason


class ActionTimeout(ActionError):
    pass


class ActionCancelled(ActionError):
    pass


class SchedulingPolicy(Protocol):
    """What the orchestrator needs from a scheduling algorithm.

    ``arrange`` receives an already-computed FCFS candidate window plus
    the rest of the queue and returns unit decisions; ``schedule`` is
    the self-windowing entry point used for full (non-incremental)
    rescheduling and by standalone callers.
    """

    candidate_limit: int

    def arrange(
        self,
        candidates: Sequence[Action],
        remaining: Sequence[Action],
        executing: Sequence[Action],
        managers: Dict[str, ResourceManager],
        now: float,
    ) -> ScheduleResult: ...

    def schedule(
        self,
        waiting: Sequence[Action],
        executing: Sequence[Action],
        managers: Dict[str, ResourceManager],
        now: float,
    ) -> ScheduleResult: ...


class CommitEngine:
    """Commit-phase seam for sharded rounds: the client-serial default.

    The plan phase is already pluggable (inline / threads / remote
    workers — :class:`~repro_torch.core.shards.RoundExecutor`); this class is
    the same seam for the COMMIT phase.  The base implementation is the
    original client-serial walk, kept bit-identical: every plan's
    intents are validated-and-launched against the live local managers
    in global sorted partition order on the orchestrator thread.

    ``commit_mode="worker"`` swaps in
    :class:`~repro_torch.core.remote.WorkerCommitEngine`: remote workers hold
    the *authoritative* manager replicas for the rtypes they own (under
    epoch-stamped ownership leases) and commit becomes a two-phase
    prepare → intent/ack → commit|abort exchange over the wire, with
    conflicts resolved worker-side on the same shared commit core
    (:func:`repro_torch.core.shards.commit_decision`).  Any round the worker
    engine cannot own outright (cross-owner resource footprints, lost
    workers) falls back to this serial walk — the always-correct rail.
    """

    mode = "client"

    def __init__(self, orch: "Orchestrator") -> None:
        self.orch = orch

    def fused_round(self, keys: Sequence[str]) -> Optional[bool]:
        """Offer the engine a whole fixpoint pass (plan AND commit) for
        the dirty ``keys``.  Returns None to decline — the orchestrator
        then runs the ordinary plan_round + :meth:`commit_round` split —
        or the pass's any-launch-failed flag when the engine handled it
        end-to-end (the worker-owned fused ``plan_commit`` path)."""
        return None

    def commit_round(self, plans: Sequence[PartitionPlan]) -> int:
        """Commit one pass's plans (already in global sorted partition
        order); returns the number of refused launches (conflicts)."""
        orch = self.orch
        conflicts = 0
        for plan in plans:
            conflicts += orch._commit_partition(plan)
        return conflicts

    def fence(self, rtypes: Optional[Sequence[str]] = None) -> int:
        """Fence ownership state covering ``rtypes`` (None = all) before
        a handoff (``migrate_task``/``rebalance``): any in-flight or
        unconfirmed prepared intents touching them are deterministically
        aborted and their leases revoked (epoch bump), so a later ack
        from the old owner can never land.  Returns the number of
        aborted intents; the serial engine holds no leases — a no-op."""
        return 0

    def close(self) -> None:
        """Release engine-held protocol state (idempotent)."""


class Orchestrator:
    """Event-driven control plane: queues, rounds, lifecycle, migration,
    telemetry.

    Public surface (contract-level docs on each method): ``submit`` /
    ``cancel`` drive the action lifecycle; ``trajectory_start`` /
    ``trajectory_end`` bracket per-trajectory manager state; ``run``
    drains the loop; ``migrate_task`` / ``rebalance`` move WFQ
    sub-queues between partition replicas; ``queue_depth`` /
    ``in_flight`` / ``starvation_ages`` / ``telemetry`` observe; and
    ``close`` releases out-of-process workers.  See
    ``docs/architecture.md`` for how the pieces compose and
    ``examples/remote_round.py`` for a runnable end-to-end round."""

    def __init__(
        self,
        managers: Dict[str, ResourceManager],
        loop: Optional[EventLoop] = None,
        policy: Optional[SchedulingPolicy] = None,
        charge_real_sched_latency: bool = False,
        incremental: bool = True,
        fair_share: Optional[FairSharePolicy] = None,
        shards: Optional[int] = None,
        plan_mode: str = "inline",
        transport="loopback",
        wire_codec: str = "json",
        commit_mode: str = "client",
        commit_max_passes: int = 8,
    ) -> None:
        self.loop = loop or EventLoop()
        self.history = DurationHistory()
        self.managers = managers
        self.telemetry = Telemetry()
        self.charge_real_sched_latency = charge_real_sched_latency
        self.incremental = incremental
        # Multi-tenant fair share: None = single-tenant FCFS queues (the
        # pre-fairness path and the fairness ablation); a FairSharePolicy
        # turns every partition into weighted per-task sub-queues (WFQ)
        # and makes a fairness-capable policy weight its objective.
        self.fair_share = fair_share
        self.policy = policy or ElasticScheduler(history=self.history)
        if getattr(self.policy, "cache_dp", False) is None:
            # DP memoization is only sound/useful on the incremental path
            self.policy.cache_dp = incremental
        if (
            fair_share is not None
            and hasattr(self.policy, "fair_share")
            and self.policy.fair_share is None
        ):
            self.policy.fair_share = fair_share
        # --- partitioned queues + reverse index -------------------------
        self._queues: Dict[str, PartitionQueue] = {}
        self._rtype_index: Dict[str, Dict[str, int]] = {}  # rtype -> {part: n}
        # --- execution state ---------------------------------------------
        self._executing: Dict[int, Action] = {}
        self._futures: Dict[int, Future] = {}
        self._allocs: Dict[int, List[Allocation]] = {}
        self._pending_ev: Dict[int, object] = {}  # delayed _enqueue events
        self._completion_ev: Dict[int, object] = {}
        self._deadline_ev: Dict[int, object] = {}
        # --- incremental round state ---------------------------------------
        self._dirty: Set[str] = set()
        self._watch: Set[str] = set()  # partitions with deferred work
        self._round_scheduled = False
        self._refill_wake_at = math.inf
        self._stall_retries = 0  # consecutive no-event retry ticks
        # --- telemetry-driven rebalance cadence (enable_rebalance) ---------
        self._rebalance_policy = None
        self._rebalance_replicas: List[str] = []
        self._rebalance_armed = False
        # Sharded plan/commit rounds (None = the serial loop, bit-
        # identical to the pre-shard engine).  shards=1 still exercises
        # the snapshot plan/commit machinery — the equivalence tests'
        # control arm.  plan_mode: "inline" (exact critical-path
        # accounting), "threads" (in-process pool), "auto" (per-round
        # pick from the measured plan-cost EWMA), or "remote" (each
        # shard's plan phase in a separate worker process behind the
        # ``transport`` — "loopback" plans in-process through the full
        # wire codecs, "process" spawns real workers, or a callable
        # ``shard_idx -> ShardTransport`` such as
        # repro_torch.core.transport.socket_fleet for workers on other
        # machines; ``wire_codec`` — "binary" compact frames or "json"
        # v1 text).  Plans are identical in every mode and codec, and a
        # lost worker's partitions fall back to inline planning (see
        # repro_torch.core.remote).
        self.shards = shards
        self._executor = (
            RoundExecutor(
                self, shards, plan_mode, transport=transport, wire_codec=wire_codec
            )
            if shards is not None
            else None
        )
        # Commit-phase seam: "client" (default) keeps the serial
        # validated commit against live local managers, bit-identical to
        # the pre-engine code.  "worker" (requires plan_mode="remote")
        # moves authoritative manager replicas out to the shard workers
        # under epoch-stamped ownership leases — commit becomes a
        # two-phase prepare/ack exchange over the wire, and dependent
        # fixpoint passes batch into one fused plan_commit frame
        # (bounded by commit_max_passes; 1 = one pass per wire round,
        # the sequential control arm).  Launch traces are identical in
        # both modes; ineligible or degraded rounds fall back to the
        # client-serial walk.
        if commit_mode not in ("client", "worker"):
            raise ValueError(f"unknown commit_mode {commit_mode!r}")
        self.commit_mode = commit_mode
        self.commit_max_passes = int(commit_max_passes)
        if commit_mode == "worker":
            if self._executor is None or self._executor._remote is None:
                raise ValueError(
                    "commit_mode='worker' requires shards=N with plan_mode='remote'"
                )
            from repro_torch.core.remote import WorkerCommitEngine

            self._commit_engine: CommitEngine = WorkerCommitEngine(
                self, self._executor._remote
            )
        else:
            self._commit_engine = CommitEngine(self)
        self.stats: Dict[str, int] = {
            "rounds": 0,
            "partition_runs": 0,
            "partitions_skipped": 0,
            "events_coalesced": 0,
            "launch_failures": 0,
            "quota_deferrals": 0,
            "sharded_rounds": 0,
        }

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def submit(self, action: Action, delay: float = 0.0) -> Future:
        """Submit an action for scheduling after ``delay`` virtual
        seconds (0 = this instant, coalesced with same-timestamp
        events into one round).  Returns a :class:`Future` resolved
        with the action's execution duration on completion, or with an
        :class:`ActionError` subclass on timeout/cancellation.  The
        action must be freshly constructed (PENDING); resubmitting a
        live or terminal action is undefined."""
        fut = Future()
        self._futures[action.uid] = fut
        self._pending_ev[action.uid] = self.loop.call_after(
            delay, lambda: self._enqueue(action)
        )
        return fut

    def cancel(self, action: Action) -> bool:
        """Withdraw a queued or running action; resolves its future with
        :class:`ActionCancelled`.  Returns False if already terminal."""
        if action.state in TERMINAL_STATES or action.uid not in self._futures:
            return False
        released = self._withdraw(action)
        self.telemetry.cancellations += 1
        self._finalize_failure(
            action, ActionState.CANCELLED, ActionCancelled(action, "cancelled")
        )
        self._dirty.add(self._partition_of(action))
        self._dirty_rtypes(released)
        self._request_round()
        return True

    def trajectory_start(self, trajectory_id: str, metadata: Optional[dict] = None) -> None:
        """Announce a trajectory to every manager (lifetime hooks, e.g.
        the CPU manager's memory pinning) before its actions arrive."""
        for m in self.managers.values():
            m.trajectory_start(trajectory_id, metadata or {})
        self._mark_all_dirty()

    def trajectory_end(self, trajectory_id: str) -> None:
        """Release per-trajectory manager state (idempotent)."""
        for m in self.managers.values():
            m.trajectory_end(trajectory_id)
        # freed trajectory memory may unblock admission
        self._mark_all_dirty()
        self._request_round()

    def run(self, until: Optional[float] = None) -> float:
        """Drain the event loop (optionally up to virtual time
        ``until``); returns the clock after the last event."""
        return self.loop.run(until=until)

    def close(self) -> None:
        """Release out-of-process resources (remote shard workers).
        Idempotent; a no-op for in-process plan modes."""
        self._commit_engine.close()
        if self._executor is not None:
            self._executor.close()

    @property
    def now(self) -> float:
        """Current virtual time (the event loop's clock)."""
        return self.loop.clock.now()

    def queue_depth(self) -> int:
        """Actions currently queued across all partitions."""
        return sum(len(q) for q in self._queues.values())

    def in_flight(self) -> int:
        """Actions currently executing (holding allocations)."""
        return len(self._executing)

    def starvation_ages(self) -> Dict[str, float]:
        """Live starvation telemetry: per task, the age (now - submit) of
        its oldest queued action across all partitions."""
        now = self.now
        ages: Dict[str, float] = {}
        for queue in self._queues.values():
            for task, oldest in queue.oldest_submit_by_task().items():
                age = now - oldest
                if age > ages.get(task, -math.inf):
                    ages[task] = age
        return ages

    # ------------------------------------------------------------------
    # sub-queue migration between partition replicas (the "sub-queue is
    # the shard unit" seam: PartitionQueue.detach_task / merge_shard /
    # sync_vtime, wired into live orchestration)
    # ------------------------------------------------------------------
    def migrate_task(self, task_id: str, src: str, dst: str) -> int:
        """Move ``task_id``'s queued sub-queue from partition ``src`` to
        the replica partition ``dst``; returns the number of migrated
        actions (0 when the task has nothing queued on ``src``).

        ``src`` and ``dst`` must be *replicas*: equivalent resource
        pools (same unit semantics — e.g. the symmetric per-pool
        managers of a fleet), both with live managers.  Each migrated
        action's cost vector is retargeted from ``src`` to ``dst``
        (unit sets preserved); actions whose cost touches other
        resource types keep those dimensions untouched, but the move
        must land the action in ``dst``'s partition — a cost vector
        that would re-partition elsewhere raises ``ValueError`` before
        anything is mutated.

        WFQ semantics ride along for free (the detach/merge seam's
        whole point): the detached :class:`~repro_torch.core.fairqueue.TaskShard`
        carries its actions' original virtual-time tags plus the source
        clock, merging syncs ``dst``'s clock monotonically, and the
        task's finish chain resumes from the later of the two tags — so
        fair ordering is preserved and no queue's clock ever moves
        backward.  Actions already RUNNING on ``src`` are not touched
        (they hold ``src`` allocations until they complete).
        """
        if src == dst:
            return 0
        if src not in self.managers or dst not in self.managers:
            raise ValueError(f"migrate_task: unknown partition {src!r} or {dst!r}")
        src_q = self._queues.get(src)
        if src_q is None:
            return 0
        # validate the replica contract BEFORE detaching: every queued
        # action of the task must re-partition onto dst after retarget
        for a in src_q.ordered():
            if a.task_id != task_id:
                continue
            kr = dst if a.key_resource == src else a.key_resource
            cost_keys = {dst if r == src else r for r in a.cost}
            part = kr if kr is not None else (min(cost_keys) if cost_keys else "*")
            if part != dst:
                raise ValueError(
                    f"migrate_task: {a.name}#{a.uid} would re-partition onto "
                    f"{part!r}, not {dst!r} — {src!r}/{dst!r} are not replicas "
                    f"for its cost vector {sorted(a.cost)}"
                )
        # ownership handoff fence: abort any in-flight/unconfirmed
        # worker-side commit intents touching either partition's rtype
        # before queue state moves (no-op for the client-serial engine)
        self._commit_engine.fence((src, dst))
        t0 = time.perf_counter()
        shard = src_q.detach_task(task_id)
        if shard is None:
            return 0
        for _key, action in shard.entries:
            self._index_remove(src, action)
            self._retarget(action, src, dst)
            self._index_add(dst, action)
        dst_q = self._queues.get(dst)
        if dst_q is None:
            dst_q = self._queues[dst] = self._make_queue(dst)
        dst_q.merge_shard(shard)
        n = len(shard.entries)
        self.telemetry.note_migration(n, time.perf_counter() - t0)
        self._dirty.add(src)
        self._dirty.add(dst)
        self._request_round()
        return n

    @staticmethod
    def _retarget(action: Action, src: str, dst: str) -> None:
        """Rewrite one action's cost vector from the ``src`` resource to
        its ``dst`` replica (unit sets preserved)."""
        req = action.cost.pop(src, None)
        if req is not None:
            action.cost[dst] = ResourceRequest(dst, req.units)
        if action.key_resource == src:
            action.key_resource = dst
        # derived per-resource caches keyed on the old rtype are stale
        action.metadata.pop("_dp_durs", None)

    def rebalance(
        self, replicas: Sequence[str], max_gap: int = 1
    ) -> int:
        """Even out queued backlog across a replica group by migrating
        whole task sub-queues from the most- to the least-loaded
        partition until the depth gap is at most ``max_gap`` (or no
        single sub-queue move improves it).  Returns the number of
        migrated actions.  Deterministic: ties break on sorted
        partition/task names — a rebalance at the same state always
        makes the same moves.  This is the hook a deployment's
        rebalancer (or a test) drives; migration cost and counts land
        in ``Telemetry.migrations``/``migrated_actions``/
        ``migration_wall_s``."""
        moved = 0
        while True:
            depths = {p: len(self._queues.get(p) or ()) for p in replicas}
            hi = max(sorted(depths), key=lambda p: depths[p])
            lo = min(sorted(depths), key=lambda p: depths[p])
            gap = depths[hi] - depths[lo]
            if gap <= max_gap:
                return moved
            src_q = self._queues.get(hi)
            backlog = src_q.backlog() if src_q is not None else {}
            # moving n actions turns the pair's gap into |gap - 2n|, so
            # the best single move is the sub-queue whose size is
            # closest to gap/2 — anything larger inverts the imbalance
            # and anything is only worth moving if the gap strictly
            # shrinks (ties break on fewer migrated actions, then task
            # name, for determinism)
            candidates = [
                (abs(gap - 2 * n), n, t)
                for t, n in sorted(backlog.items())
                if 0 < n and abs(gap - 2 * n) < gap
            ]
            if not candidates:
                return moved
            _, _, task = min(candidates)
            moved += self.migrate_task(task, hi, lo)

    # ------------------------------------------------------------------
    # telemetry-driven rebalance cadence (repro_torch.core.rebalance)
    # ------------------------------------------------------------------
    def enable_rebalance(
        self,
        replicas: Sequence[str],
        policy: Optional["RebalancePolicy"] = None,
        period_s: Optional[float] = None,
    ) -> None:
        """Drive sub-queue rebalancing across the ``replicas`` group on
        a virtual-time cadence: every ``policy.period_s`` seconds (while
        any replica has queued work) a :class:`~repro_torch.core.rebalance.
        RebalancePolicy` reads live signals — queue depths, per-task
        backlog and queued work, starvation ages, pool utilization, the
        round engine's per-partition plan-cost EWMAs — and orders
        migrations through :meth:`migrate_task`.  The cadence disarms
        itself when the replicas drain (so ``run()`` terminates) and
        re-arms on the next enqueue.  ``replicas`` must be genuine
        replicas (same unit semantics — the :meth:`migrate_task`
        contract).  Deterministic under the DES clock: the same run
        always makes the same moves."""
        from repro_torch.core.rebalance import RebalancePolicy

        if policy is None:
            policy = (
                RebalancePolicy()
                if period_s is None
                else RebalancePolicy(period_s=period_s)
            )
        elif period_s is not None:
            policy.period_s = float(period_s)
        replicas = sorted(replicas)
        for p in replicas:
            if p not in self.managers:
                raise ValueError(f"enable_rebalance: unknown replica partition {p!r}")
        self._rebalance_replicas = replicas
        self._rebalance_policy = policy
        self._arm_rebalance()

    def _arm_rebalance(self) -> None:
        if self._rebalance_policy is None or self._rebalance_armed:
            return
        self._rebalance_armed = True
        self.loop.call_after(self._rebalance_policy.period_s, self._rebalance_tick)

    def _rebalance_tick(self) -> None:
        self._rebalance_armed = False
        policy = self._rebalance_policy
        if policy is None:
            return
        if not any(self._queues.get(p) for p in self._rebalance_replicas):
            return  # drained: stay disarmed until the next enqueue
        self.telemetry.rebalance_ticks += 1
        moves = policy.decide(self._rebalance_signals(), self._rebalance_replicas)
        for task, src, dst in moves:
            if self.migrate_task(task, src, dst):
                self.telemetry.rebalance_moves += 1
        self._arm_rebalance()

    def _rebalance_signals(self) -> "RebalanceSignals":
        """Snapshot the policy's inputs from live orchestrator state."""
        from repro_torch.core.rebalance import RebalanceSignals

        now = self.now
        sig = RebalanceSignals(now=now)
        for p in self._rebalance_replicas:
            q = self._queues.get(p)
            sig.depths[p] = len(q) if q is not None else 0
            sig.backlogs[p] = q.backlog() if q else {}
            sig.backlog_cost[p] = q.backlog_cost() if q else {}
            sig.starvation[p] = (
                {t: now - s for t, s in q.oldest_submit_by_task().items()}
                if q
                else {}
            )
            m = self.managers.get(p)
            sig.utilization[p] = m.utilization() if m is not None else 0.0
        if self._executor is not None:
            sig.plan_cost_s = dict(self._executor.plan_cost_by_part)
        return sig

    # ------------------------------------------------------------------
    # queue + index plumbing (all O(1))
    # ------------------------------------------------------------------
    @staticmethod
    def _partition_of(action: Action) -> str:
        if action.key_resource is not None:
            return action.key_resource
        return min(action.cost) if action.cost else "*"

    def _make_queue(self, part: str) -> PartitionQueue:
        fs = self.fair_share
        if fs is None:
            return PartitionQueue(fair=False)
        rtype = part if part in self.managers else None
        return PartitionQueue(
            fair=True,
            weight_of=fs.weight_of,
            cost_of=partial(default_cost, rtype=rtype),
        )

    def _index_add(self, part: str, action: Action) -> None:
        for rtype in action.cost:
            self._rtype_index.setdefault(rtype, {})
            self._rtype_index[rtype][part] = self._rtype_index[rtype].get(part, 0) + 1

    def _index_remove(self, part: str, action: Action) -> None:
        for rtype in action.cost:
            counts = self._rtype_index.get(rtype)
            if counts is None:
                continue
            left = counts.get(part, 0) - 1
            if left <= 0:
                counts.pop(part, None)
            else:
                counts[part] = left

    def _enqueue(self, action: Action, at_head: bool = False) -> None:
        self._pending_ev.pop(action.uid, None)
        if action.state in TERMINAL_STATES:
            return  # cancelled while the delayed submission was in flight
        part = self._partition_of(action)
        queue = self._queues.get(part)
        if queue is None:
            queue = self._queues[part] = self._make_queue(part)
        action.state = ActionState.QUEUED
        if not at_head:
            action.submit_time = self.now
        # an arrival only touches its task's sub-queue (tag + one merge
        # insert) and dirties this partition — no other task re-tags
        queue.push(action, at_head=at_head)
        self._index_add(part, action)
        self._arm_deadline(action)
        self._stall_retries = 0
        self._dirty.add(part)
        self._request_round()
        # new queued work re-arms the rebalance cadence (it disarms
        # itself when the replica group drains, so run() terminates)
        self._arm_rebalance()

    def _dequeue(self, action: Action, served: bool = False) -> None:
        part = self._partition_of(action)
        queue = self._queues.get(part)
        if queue is not None and action.uid in queue:
            queue.remove(action.uid, served=served)
            self._index_remove(part, action)

    def _dirty_rtypes(self, rtypes: Iterable[str]) -> None:
        for rtype in rtypes:
            self._dirty.update(self._rtype_index.get(rtype, ()))

    def _mark_all_dirty(self) -> None:
        self._dirty.update(k for k, q in self._queues.items() if q)

    # ------------------------------------------------------------------
    # scheduling rounds
    # ------------------------------------------------------------------
    def _request_round(self) -> None:
        if self._round_scheduled:
            self.stats["events_coalesced"] += 1
            return
        self._round_scheduled = True
        self.loop.call_after(0.0, self._round)

    def _round(self) -> None:
        self._round_scheduled = False
        for m in self.managers.values():
            if hasattr(m, "set_time"):
                m.set_time(self.now)

        if self.incremental:
            self._dirty |= self._watch
        else:
            self._mark_all_dirty()
        self.stats["partitions_skipped"] += sum(
            1 for k, q in self._queues.items() if q and k not in self._dirty
        )
        if not any(self._queues.get(k) for k in self._dirty):
            self._dirty.clear()
            return
        self.stats["rounds"] += 1
        self.telemetry.sched_invocations += 1

        if self._executor is not None:
            any_failed = self._sharded_fixpoint()
        else:
            t0 = time.perf_counter()
            any_failed = False
            # fixpoint: launching may re-expose an admissible head (the
            # classification in _commit_partition re-dirties such
            # partitions); every extra pass strictly consumes resources,
            # so this terminates within the round's virtual instant.
            while True:
                keys = sorted(k for k in self._dirty if self._queues.get(k))
                self._dirty.clear()
                if not keys:
                    break
                for key in keys:
                    any_failed |= self._run_partition(key)
            self.telemetry.sched_wall_s += time.perf_counter() - t0

        self._post_round(any_failed)

    def _sharded_fixpoint(self) -> bool:
        """The plan/commit round loop (shards=N): plan all dirty
        partitions in parallel over free-state snapshots, then commit
        serially in the same sorted order the serial loop walks.  A
        commit whose allocation no longer fits live state rolls back
        (``release_unlaunched``) and leaves its partition watched — the
        same rail ordinary ``try_allocate`` refusals ride — so the next
        round replans it against fresh state.

        Decision latency charged per plan/commit pass is the critical
        path ``max(per-shard plan CPU) + commit wall`` — what a fleet of
        per-shard workers pays; the real in-process plan wall clock is
        recorded separately (``Telemetry.plan_wall_s``).

        The commit walk itself sits behind the :class:`CommitEngine`
        seam: the default engine is the client-serial loop this
        docstring describes; the worker-owned engine may take a whole
        pass (plan AND commit fused into one wire exchange per owner
        worker) via ``fused_round`` — its charged commit critical path
        is then ``max(per-worker commit wall)``, with the client's
        mirror-apply wall recorded separately
        (``Telemetry.commit_apply_s``) — never conflated."""
        any_failed = False
        while True:
            keys = sorted(k for k in self._dirty if self._queues.get(k))
            self._dirty.clear()
            if not keys:
                return any_failed
            if len(keys) == 1:
                # one dirty partition has no parallelism to exploit: the
                # serial runner (live-state planning, no snapshot cost)
                # is cheaper and trivially plan/commit-equivalent
                t0 = time.perf_counter()
                any_failed |= self._run_partition(keys[0])
                self.telemetry.sched_wall_s += time.perf_counter() - t0
                continue
            self.stats["sharded_rounds"] += 1
            handled = self._commit_engine.fused_round(keys)
            if handled is not None:
                any_failed |= handled
                continue
            plans, critical = self._executor.plan_round(keys)
            t0 = time.perf_counter()
            conflicts = self._commit_engine.commit_round(plans)
            if conflicts:
                any_failed = True
                self.telemetry.commit_conflicts += conflicts
            commit_wall = time.perf_counter() - t0
            self.telemetry.commit_wall_s += commit_wall
            self.telemetry.sched_wall_s += critical + commit_wall

    def _run_partition(self, part: str) -> bool:
        """One serial policy pass over a partition (plan against LIVE
        managers, commit immediately); returns True if any launch failed
        (decision made but allocation refused)."""
        return self._commit_partition(self._plan_partition(part, self.managers)) > 0

    def _plan_partition(
        self, part: str, managers: Mapping[str, ResourceManager], shard: int = 0
    ) -> PartitionPlan:
        """Arrange one partition against ``managers`` (live for the
        serial loop, free-state snapshots for a shard) WITHOUT touching
        shared orchestrator state — safe to run from a plan thread.  The
        plan core itself (:func:`repro_torch.core.shards.plan_partition`) is a
        free function shared verbatim with the out-of-process
        :class:`~repro_torch.core.remote.RemoteShardWorker`, which is what
        keeps remote plans bit-identical to inline ones."""
        queue = self._queues.get(part)
        if not queue:
            return PartitionPlan(part, planned=False, shard=shard)
        # WFQ service order: FCFS within a task, min-virtual-start-tag
        # across tasks — so the candidate window below is drawn
        # round-robin-by-virtual-time across tasks.  With fair_share=None
        # (or a single task) this IS plain arrival order.
        return plan_partition(
            part,
            queue.ordered(),
            list(self._executing.values()),
            managers,
            self.policy,
            self.fair_share,
            self.now,
            self.incremental,
            shard=shard,
        )

    def _commit_partition(self, plan: PartitionPlan) -> int:
        """Validate-and-launch one partition's intents against LIVE
        manager state (single-threaded), then classify the partition;
        returns the number of refused launches (decisions made but
        allocation refused)."""
        part = plan.part
        queue = self._queues.get(part)
        if not plan.planned or not queue:
            self._watch.discard(part)
            return 0
        self.stats["partition_runs"] += 1
        self.stats["quota_deferrals"] += plan.held
        if plan.result is None:
            # the quota gate held the entire window
            self._watch.discard(part)
            if plan.held:
                self._watch.add(part)
            return 0
        overhead = plan.wall_s if self.charge_real_sched_latency else SCHED_TICK_S
        quota_pending = self._quota_reservations(plan.result.decisions)
        failed = 0
        for decision in plan.result.decisions:
            if not self._launch(decision, overhead, quota_pending):
                failed += 1
        # cleanliness classification is the shared core's
        # classify_after_commit (see its contract); the worker-owned
        # commit engine runs the same function over its replicas, which
        # is what keeps worker-computed fixpoint passes identical to the
        # serial loop's.  Quota-clock changes are covered by the refill
        # wake; "dirty" re-enters this round's fixpoint loop.
        self._watch.discard(part)
        cls = classify_after_commit(
            queue, plan.result.evicted, failed, plan.held, self.managers
        )
        if cls == "watch":
            self._watch.add(part)
        elif cls == "dirty":
            self._dirty.add(part)
        return failed

    def _quota_reservations(
        self, decisions: Sequence[Decision]
    ) -> Optional[Dict[Tuple[str, str], int]]:
        """Thin wrapper over the shared commit core's
        :func:`repro_torch.core.shards.quota_reservations` (see its contract —
        the ROADMAP's "exact quota for scalable scale-up" item), bound
        to the live managers + this orchestrator's fair-share policy."""
        return quota_reservations(decisions, self.managers, self.fair_share)

    def _quota_clamp(
        self,
        action: Action,
        rtype: str,
        units: int,
        pending: Optional[Dict[Tuple[str, str], int]] = None,
    ) -> int:
        """Thin wrapper over the shared commit core's
        :func:`repro_torch.core.shards.quota_clamp`, bound to live state."""
        return quota_clamp(
            action, rtype, units, self.managers, self.fair_share, pending
        )

    def _post_round(self, any_failed: bool) -> None:
        if any_failed:
            self.stats["launch_failures"] += 1
        if not any(self._queues.values()):
            return
        # quota refills may unblock queued actions even without completions
        wake = min(
            (
                m.time_to_next_refill()
                for m in self.managers.values()
                if hasattr(m, "time_to_next_refill")
            ),
            default=math.inf,
        )
        if math.isfinite(wake) and wake > 0 and self.now + wake < self._refill_wake_at:
            self._refill_wake_at = self.now + wake
            self.loop.call_after(wake + 1e-6, self._on_refill_wake)
            return
        # stalled-launch guard: work was decided-but-refused or deferred,
        # nothing is in flight to guarantee a future round, and no refill
        # is coming — schedule a retry tick unconditionally.  Retries
        # back off geometrically and are bounded between real events, so
        # an unschedulable queue quiesces instead of spinning the loop.
        stalled = any_failed or bool(self._watch)
        if stalled and not self._executing and self._stall_retries < STALL_RETRY_LIMIT:
            delay = SCHED_TICK_S * (1 << self._stall_retries)
            self._stall_retries += 1

            def _retry() -> None:
                self._mark_all_dirty()
                self._request_round()

            self.loop.call_after(delay, _retry)

    def _on_refill_wake(self) -> None:
        self._refill_wake_at = math.inf
        self._stall_retries = 0
        self._mark_all_dirty()
        self._request_round()

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def _launch(
        self,
        decision: Decision,
        sched_overhead: float,
        quota_pending: Optional[Dict[Tuple[str, str], int]] = None,
    ) -> bool:
        action = decision.action
        # the manager-mutating middle (reservation release, quota clamp,
        # sorted try_allocate with rollback, share accounting) is the
        # shared commit core — one implementation with the worker-owned
        # commit engine's replica-side commit
        granted = commit_decision(
            decision, self.managers, self.fair_share, quota_pending
        )
        if granted is None:
            return False
        units, allocs = granted
        self._dequeue(action, served=True)
        self._executing[action.uid] = action
        self._allocs[action.uid] = allocs
        action.state = ActionState.RUNNING
        action.start_time = self.now
        overhead = sched_overhead + sum(a.overhead for a in allocs)
        action.sys_overhead = overhead

        key_units = units.get(action.key_resource or "", None)
        duration = self._duration_of(action, key_units)
        self._schedule_completion(action, duration, overhead)
        return True

    def _schedule_completion(
        self, action: Action, duration: float, overhead: float
    ) -> None:
        """Arm the completion of a launched action.

        The DES completes by clock: a single timer at the modeled finish
        instant.  This is the live-mode seam — a live orchestrator
        (:class:`repro_torch.core.live.LiveOrchestrator`) overrides this one
        method to run the action's real payload on a worker thread and
        complete when the work actually returns, leaving every other
        lifecycle path (withdraw, deadline, retry, telemetry) shared."""
        action.finish_time = self.now + overhead + duration
        self._completion_ev[action.uid] = self.loop.call_at(
            action.finish_time, lambda: self._complete(action, duration)
        )

    def _duration_of(self, action: Action, key_units: Optional[int]) -> float:
        return duration_of(action, key_units, self.history)

    def _complete(self, action: Action, duration: float) -> None:
        self._completion_ev.pop(action.uid, None)
        self._cancel_deadline(action)
        self._executing.pop(action.uid, None)
        allocs = self._allocs.pop(action.uid, [])
        released: Set[str] = set()
        for alloc in allocs:
            self.managers[alloc.rtype].release(action, alloc)
            self.managers[alloc.rtype].note_released(action.task_id, alloc.units)
            released.add(alloc.rtype)
        action.state = ActionState.DONE
        self.history.observe(action.name, duration)
        self.telemetry.record(
            ActionRecord(
                name=action.name,
                task_id=action.task_id,
                trajectory_id=action.trajectory_id,
                submit=action.submit_time,
                start=action.start_time,
                finish=action.finish_time,
                sys_overhead=action.sys_overhead,
                units={a.rtype: a.units for a in allocs},
                retries=action.attempts,
            )
        )
        fut = self._futures.pop(action.uid, None)
        if fut is not None:
            fut.set_result(duration)
        self._stall_retries = 0
        self._dirty_rtypes(released)
        self._request_round()

    # ------------------------------------------------------------------
    # lifecycle: deadlines, retries, cancellation
    # ------------------------------------------------------------------
    def _arm_deadline(self, action: Action) -> None:
        self._cancel_deadline(action)
        if action.timeout_s is None:
            return
        self._deadline_ev[action.uid] = self.loop.call_after(
            action.timeout_s, lambda: self._on_deadline(action)
        )

    def _cancel_deadline(self, action: Action) -> None:
        ev = self._deadline_ev.pop(action.uid, None)
        if ev is not None:
            self.loop.cancel(ev)

    def _withdraw(self, action: Action) -> Set[str]:
        """Pull an action out of the system (queued or running); returns
        the resource types whose state changed."""
        self._cancel_deadline(action)
        pending = self._pending_ev.pop(action.uid, None)
        if pending is not None:
            self.loop.cancel(pending)
        released: Set[str] = set()
        if action.state is ActionState.RUNNING:
            ev = self._completion_ev.pop(action.uid, None)
            if ev is not None:
                self.loop.cancel(ev)
            self._executing.pop(action.uid, None)
            for alloc in self._allocs.pop(action.uid, []):
                self.managers[alloc.rtype].release_on_failure(action, alloc)
                self.managers[alloc.rtype].note_released(action.task_id, alloc.units)
                released.add(alloc.rtype)
        elif action.state is ActionState.QUEUED:
            self._dequeue(action)
        return released

    def _on_deadline(self, action: Action) -> None:
        if action.state in TERMINAL_STATES:
            return  # stale timer
        self.telemetry.timeouts += 1
        released = self._withdraw(action)
        action.attempts += 1
        if action.attempts <= action.max_retries:
            # bounded retry: back to the FCFS head of its partition
            self.telemetry.retries += 1
            self._enqueue(action, at_head=True)
        else:
            action.failure = f"timeout after {action.attempts} attempt(s)"
            self._finalize_failure(
                action, ActionState.TIMEOUT, ActionTimeout(action, action.failure)
            )
            # removal may unblock queued work behind the departed head
            self._dirty.add(self._partition_of(action))
        # either way the withdrawn attempt's resources are free again —
        # wake every partition waiting on them (the retry may not be the
        # one that can use them, e.g. when it re-queues quota-blocked)
        self._dirty_rtypes(released)
        self._request_round()

    def _finalize_failure(
        self, action: Action, state: ActionState, exc: ActionError
    ) -> None:
        action.state = state
        action.finish_time = self.now
        if action.failure is None:
            action.failure = exc.reason
        self.telemetry.record(
            ActionRecord(
                name=action.name,
                task_id=action.task_id,
                trajectory_id=action.trajectory_id,
                submit=action.submit_time,
                start=action.start_time,
                finish=action.finish_time,
                sys_overhead=action.sys_overhead,
                units={},
                failed=True,
                retries=max(0, action.attempts - 1),
            )
        )
        fut = self._futures.pop(action.uid, None)
        if fut is not None:
            fut.set_exception(exc)

"""Sharded scheduling rounds: parallel per-partition planning, serialized
validated commit (the ROADMAP's async-rounds item, step one).

The serial round loop re-arranges every dirty partition in one thread,
mutating manager state as it walks — decision latency grows linearly
with the number of dirty partitions, which is the control-plane scale
wall once the external fleet (and therefore the partition count) grows.
This module converts the round's core invariant from "a round mutates
managers as it walks partitions" into **plan-then-commit**:

* the dirty set is split into **shards** — each shard owns *whole*
  partitions (and with it, whole per-task WFQ sub-queues: a
  :class:`~repro_torch.core.fairqueue.PartitionQueue` never straddles
  shards), assigned by deterministic striping over the sorted keys;
* each shard snapshots the managers' free state
  (:meth:`ResourceManager.snapshot`) and runs ``policy.arrange`` for
  its partitions concurrently on a thread pool, producing
  **launch intents** (:class:`PartitionPlan`) without touching live
  state;
* a single-threaded **commit phase** replays the intents in global
  sorted partition order against *live* managers.  A plan that no
  longer fits (another shard's commit took the capacity, a trajectory
  bound elsewhere) fails ``try_allocate``, rolls back through
  ``release_unlaunched``, and re-dirties its partition — exactly the
  retry rail ordinary ``try_allocate`` refusals already ride — so
  conflicts cost one extra round, never a lost or double-launched
  action.

Snapshot contract — what a shard may read while planning:

* the **manager snapshots** handed to it: ``available``/``capacity``,
  ``begin_admission``/``admit_one``, ``dp_operator``/``dp_cache_key``,
  ``partition`` (the CPU manager's trajectory binding mutates only the
  snapshot), ``task_usage``, ``min_units``.
* **off-snapshot (live) state that is frozen during a round's plan
  phase** and therefore safe to read: the partition queues it owns
  (``ordered()``/``head()``), the orchestrator's executing map, policy
  configuration, and the virtual clock — no event callback runs while
  plans are outstanding.
* **never off-snapshot**: ``try_allocate``/``release*``/``note_*`` and
  any manager internals behind the snapshot (free cores, chunk
  allocators, token buckets).  Placement is commit-phase only, against
  live managers, on the orchestrator thread.

Decision-latency accounting: the round is charged
``max(per-shard plan cost) + commit wall`` — the **critical path** a
fleet of per-shard workers (the multi-process managers this engine is
the prerequisite for) would pay.  Two plan modes measure it:

* ``plan_mode="inline"`` (default): shards are planned back-to-back on
  the orchestrator thread, each timed with ``perf_counter`` free of any
  interference — exact per-shard costs, no pool dispatch overhead.
  This is the DES benchmarking mode: plans are deterministic and
  identical in every mode, so only the latency *accounting* needs the
  critical-path model.
* ``plan_mode="threads"``: shards are dispatched to a process-wide
  thread pool — real in-process concurrency for deployments where plan
  cost lives in GIL-releasing code (the dense-DP NumPy sweeps, large
  state spaces).  Per-shard timings then include GIL waits, so the
  charged critical path is conservative (an upper bound).

The real plan-phase wall clock is always recorded in
``Telemetry.plan_wall_s`` alongside the modeled critical path
(``Telemetry.plan_critical_s``), so the two are never conflated.

``shards=None`` on the :class:`~repro_torch.core.orchestrator.Orchestrator`
keeps the serial loop bit-identical; ``shards=N`` must produce identical
launch traces on conflict-free workloads (partitions whose actions touch
disjoint resource types — the equivalence suites), proven by
``tests/test_shards.py`` and gated in CI by the shard-smoke benchmark.
"""

from __future__ import annotations

import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.action import Action, ActionState
from repro_torch.core.fairqueue import FairSharePolicy
from repro_torch.core.managers.base import Allocation
from repro_torch.core.scheduler import Decision, ScheduleResult, candidate_window

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (typing only)
    from repro_torch.core.orchestrator import Orchestrator


@dataclass
class PartitionPlan:
    """One partition's launch intents, planned off-snapshot.

    ``result is None`` with ``planned=True`` means the quota gate held
    the whole window (``held`` actions stay queued, partition stays
    watched); ``planned=False`` means the queue was already empty at
    plan time (nothing to commit beyond watch-list cleanup)."""

    part: str
    result: Optional[ScheduleResult] = None
    held: int = 0
    wall_s: float = 0.0  # this partition's arrange wall time
    shard: int = 0
    planned: bool = True


# ---------------------------------------------------------------------------
# The plan core — shared verbatim by the serial loop, the in-process
# sharded plan phase, AND the out-of-process RemoteShardWorker
# (repro_torch.core.remote).  Keeping it a free function over explicit inputs
# is what guarantees remote plans are bit-identical to inline ones:
# there is exactly one implementation to diverge from.
# ---------------------------------------------------------------------------


def apply_quota(
    part: str,
    waiting: List[Action],
    managers: Mapping[str, object],
    fair_share: FairSharePolicy,
) -> Tuple[List[Action], int]:
    """Hard share caps: withhold from this round's window the actions of
    tasks at/above their quota fraction of the partition manager's
    capacity.  Held actions stay queued (the partition stays watched); a
    completion releasing units re-dirties it.  ``managers`` is the
    planning view — live for the serial loop, snapshots otherwise.

    The per-task budget walk admits min-unit requirements in service
    order (exact for rigid actions; scalable grants beyond min units are
    clamped against the same budget at launch).  Progress rail: a task
    holding NOTHING always gets its first window action even when its
    min units exceed the configured cap — a sub-min quota must degrade
    to "one action at a time", never to a silent permanent hold."""
    manager = managers.get(part)
    if manager is None or manager.capacity <= 0:
        return waiting, 0
    usage = manager.task_usage()
    budget: Dict[str, float] = {}
    eligible: List[Action] = []
    held = 0
    for a in waiting:
        t = a.task_id
        q = fair_share.quota_of(t)
        if math.isinf(q):
            eligible.append(a)
            continue
        first = t not in budget
        if first:
            budget[t] = q * manager.capacity - usage.get(t, 0)
        req = a.cost.get(part)
        need = req.min_units if req is not None else 1
        if need <= budget[t] or (first and usage.get(t, 0) == 0):
            budget[t] -= need
            eligible.append(a)
        else:
            held += 1
    return eligible, held


def plan_partition(
    part: str,
    waiting: List[Action],
    executing: Sequence[Action],
    managers: Mapping[str, object],
    policy: object,
    fair_share: Optional[FairSharePolicy],
    now: float,
    incremental: bool,
    shard: int = 0,
) -> PartitionPlan:
    """Arrange one partition against ``managers`` WITHOUT touching any
    shared orchestrator state — safe to run from a plan thread or a
    separate process.  The only writes it performs land on the given
    managers (the CPU manager's trajectory binding — snapshots absorb
    them off the live path), per-action metadata owned by this
    partition, and the policy's lock-guarded caches.

    ``waiting`` must already be in the partition queue's service order
    (WFQ: FCFS within a task, min-virtual-start-tag across tasks; plain
    arrival order with ``fair_share=None`` or a single task)."""
    held = 0
    if fair_share is not None and fair_share.quota:
        waiting, held = apply_quota(part, waiting, managers, fair_share)
        if not waiting:
            return PartitionPlan(part, result=None, held=held, shard=shard)
    t0 = time.perf_counter()
    if incremental:
        limit = getattr(policy, "candidate_limit", 128)
        candidates = candidate_window(waiting, managers, limit)
        result = policy.arrange(
            candidates, waiting[len(candidates):], executing, managers, now
        )
    else:
        result = policy.schedule(waiting, executing, managers, now)
    wall = time.perf_counter() - t0
    return PartitionPlan(part, result=result, held=held, wall_s=wall, shard=shard)


# ---------------------------------------------------------------------------
# The commit core — the manager-mutating middle of a launch, shared
# verbatim by the client-serial commit engine (Orchestrator._launch) and
# the worker-owned commit engine (a RemoteShardWorker committing a
# round's intents against the authoritative replicas it holds a lease
# on — repro_torch.core.remote).  Like the plan core above, keeping these free
# functions over explicit inputs is what makes worker-side commits
# bit-identical to client-serial ones: one implementation, zero drift.
# ---------------------------------------------------------------------------


def quota_reservations(
    decisions: Sequence[Decision],
    managers: Mapping[str, object],
    fair_share: Optional[FairSharePolicy],
) -> Optional[Dict[Tuple[str, str], int]]:
    """Min-unit budget reservations per (quota'd task, rtype) over a
    commit batch.  Admission (:func:`apply_quota`) guaranteed every
    admitted action its *min* units within the task's budget; an elastic
    grant scaled beyond min must therefore be clamped against the budget
    MINUS the min-unit reservations of the batch's not-yet-launched
    sibling actions — otherwise the first scalable launch eats the whole
    budget and the siblings' min-unit progress rail pushes the task past
    its cap mid-flight."""
    if fair_share is None or not fair_share.quota:
        return None
    pending: Dict[Tuple[str, str], int] = {}
    for d in decisions:
        if math.isinf(fair_share.quota_of(d.action.task_id)):
            continue
        for rtype in d.units:
            req = d.action.cost.get(rtype)
            if req is None or rtype not in managers:
                continue
            key = (d.action.task_id, rtype)
            pending[key] = pending.get(key, 0) + req.min_units
    return pending or None


def quota_clamp(
    action: Action,
    rtype: str,
    units: int,
    managers: Mapping[str, object],
    fair_share: Optional[FairSharePolicy],
    pending: Optional[Dict[Tuple[str, str], int]] = None,
) -> int:
    """Cap an elastic grant against the task's remaining quota budget on
    ``rtype``: snap down to the largest feasible unit count within the
    budget — net of the min-unit reservations still ``pending`` for the
    task's other actions in this commit batch — but never below min
    units (the progress rail — admission already decided this action may
    run)."""
    if fair_share is None:
        return units
    q = fair_share.quota_of(action.task_id)
    if math.isinf(q):
        return units
    manager = managers.get(rtype)
    req = action.cost.get(rtype)
    if manager is None or req is None or units <= req.min_units:
        return units
    allowed = q * manager.capacity - manager.task_usage().get(action.task_id, 0)
    if pending:
        allowed -= pending.get((action.task_id, rtype), 0)
    if units <= allowed:
        return units
    return max((u for u in req.units if u <= allowed), default=req.min_units)


def commit_decision(
    decision: Decision,
    managers: Mapping[str, object],
    fair_share: Optional[FairSharePolicy],
    quota_pending: Optional[Dict[Tuple[str, str], int]] = None,
) -> Optional[Tuple[Dict[str, int], List[Allocation]]]:
    """Acquire one decision's allocation vector against ``managers``
    (live managers client-side, leased authoritative replicas
    worker-side): release the action's own min-unit reservations from
    the batch's pending map, clamp elastic grants against quota, then
    ``try_allocate`` each rtype in sorted order with full rollback
    through ``release_unlaunched`` on refusal (so consumable state —
    quota tokens — is refunded: the action never started).  Returns the
    granted ``(units, allocations)`` or None when the launch is refused
    (a commit-phase conflict or a withdrawn action) — the manager state
    is then exactly as it was, minus the reservation release."""
    action = decision.action
    if quota_pending is not None:
        # this action's own min-unit reservation no longer binds its
        # siblings' clamp once it reaches the front of the batch —
        # released BEFORE the withdrawn-action early-out below, or a
        # withdrawn sibling's reservation would over-clamp the rest of
        # the batch against budget nobody is going to use
        for rtype in decision.units:
            key = (action.task_id, rtype)
            req = action.cost.get(rtype)
            if req is not None and key in quota_pending:
                quota_pending[key] = max(0, quota_pending[key] - req.min_units)
    if action.state is not ActionState.QUEUED:
        return None  # withdrawn between arrange and launch
    # elastic grants are capped against the task's quota budget up front
    # so the charged duration matches the actual allocation
    units = {
        rtype: quota_clamp(action, rtype, u, managers, fair_share, quota_pending)
        for rtype, u in decision.units.items()
    }
    allocs: List[Allocation] = []
    for rtype in sorted(units):
        manager = managers.get(rtype)
        if manager is None:
            continue
        alloc = manager.try_allocate(action, units[rtype])
        if alloc is None:
            # rollback a partial acquisition (or a commit whose plan no
            # longer fits the committing state)
            for a in allocs:
                managers[a.rtype].release_unlaunched(action, a)
            return None
        allocs.append(alloc)
    for a in allocs:  # multi-tenant share accounting
        managers[a.rtype].note_allocated(action.task_id, a.units)
    return units, allocs


def classify_after_commit(
    queue, evicted: int, failed: int, held: int, managers: Mapping[str, object]
) -> Optional[str]:
    """Post-commit partition classification, shared by both commit
    engines.  A partition may only go clean in states that are no-ops
    until the next event: deliberate deferrals (eviction, quota holds)
    and refused allocations are time/state-dependent — they stay on the
    ``"watch"`` list and re-run every round.  Otherwise the policy
    launched its whole window; the partition is clean exactly when the
    remaining head is inadmissible at min units *now* against the
    committing managers, else it is ``"dirty"`` and re-enters this
    round's fixpoint loop.  ``queue`` is anything with truthiness + a
    ``head()`` peek (a PartitionQueue client-side, a remaining-waiting
    view worker-side)."""
    if not queue:
        return None
    if evicted or failed or held:
        return "watch"
    head = queue.head()
    if head is not None and candidate_window([head], managers, 1):
        return "dirty"
    return None


def duration_of(action: Action, key_units: Optional[int], history) -> float:
    """An action's charged execution duration at its granted key-resource
    units: the host-local sampler when present (never crosses the wire —
    worker-owned multi-pass commit is gated off when any queued action
    carries one), else the unit-scaled elasticity table, else the
    name-keyed history estimate."""
    if action.duration_sampler is not None:
        return action.duration_sampler(key_units or 1)
    d = action.get_dur(key_units) if key_units is not None else action.get_dur()
    if math.isnan(d):
        d = history.estimate(action)
    return d


class SnapshotMap:
    """Lazy manager-snapshot view handed to a shard's plan pass.

    Looks like the orchestrator's ``managers`` mapping, but the first
    access to an rtype snapshots that manager — a shard owning two of
    sixteen pools copies two free states, not sixteen.  Read-only from
    the caller's perspective (the snapshots themselves absorb the plan's
    mutations, e.g. CPU trajectory binding)."""

    __slots__ = ("_live", "_snaps")

    def __init__(self, managers: Dict[str, object]) -> None:
        self._live = managers
        self._snaps: Dict[str, object] = {}

    def __getitem__(self, rtype: str):
        snap = self._snaps.get(rtype)
        if snap is None:
            snap = self._snaps[rtype] = self._live[rtype].snapshot()
        return snap

    def get(self, rtype: str, default=None):
        if rtype not in self._live:
            return default
        return self[rtype]

    def __contains__(self, rtype: str) -> bool:
        return rtype in self._live

    def __len__(self) -> int:
        return len(self._live)

    def keys(self):
        return self._live.keys()


# Process-wide plan pools, shared across orchestrators (tests build
# dozens; per-instance pools would leak idle threads).  Keyed by size;
# workers are daemonic-by-default executor threads that die with the
# process.
_POOLS: Dict[int, ThreadPoolExecutor] = {}
_POOLS_LOCK = threading.Lock()


def _pool(workers: int) -> ThreadPoolExecutor:
    with _POOLS_LOCK:
        pool = _POOLS.get(workers)
        if pool is None:
            pool = _POOLS[workers] = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix=f"shard-plan-{workers}"
            )
        return pool


#: Estimated per-shard plan cost (seconds) above which ``plan_mode=
#: "auto"`` dispatches to the thread pool: below it the pool's dispatch
#: + wakeup overhead (~100-500 us/shard) outweighs any overlap, and plan
#: cost that small is dict work that holds the GIL anyway.  Above it the
#: plan phase is dominated by the dense-DP NumPy sweeps, which release
#: the GIL — the regime the ROADMAP's profiling item identified as the
#: only one where pooled planning pays.
AUTO_THREADS_CUTOVER_S = 2e-3

#: EWMA smoothing for the measured per-partition plan cost that drives
#: the auto plan-mode decision.
AUTO_EWMA_ALPHA = 0.2


class RoundExecutor:
    """Plans a round's dirty partitions across ``shards`` workers and
    hands the orchestrator an ordered commit list.

    ``plan_mode``:

    * ``"inline"`` — shards planned back-to-back on the orchestrator
      thread (exact contention-free critical-path accounting);
    * ``"threads"`` — shards dispatched to a process-wide thread pool;
    * ``"auto"`` — pick between the two per round from a measured
      per-partition plan-cost EWMA (see :data:`AUTO_THREADS_CUTOVER_S`);
      every decision is logged in ``Telemetry.plan_mode_rounds``;
    * ``"remote"`` — each shard's plan phase runs in a
      :class:`~repro_torch.core.remote.RemoteShardWorker` behind a
      :class:`~repro_torch.core.remote.ShardTransport` (snapshots and plans
      cross a serialization boundary; shard frames are dispatched
      pipelined — shard *i+1* encodes while shard *i* is in flight —
      against workers holding resident replicas refreshed in place;
      see :mod:`repro_torch.core.remote`).

    Plans are deterministic — identical in every mode."""

    PLAN_MODES = ("inline", "threads", "auto", "remote")

    def __init__(
        self,
        orch: "Orchestrator",
        shards: int,
        plan_mode: str = "inline",
        transport="loopback",
        wire_codec: str = "json",
    ) -> None:
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if plan_mode not in self.PLAN_MODES:
            raise ValueError(f"unknown plan_mode {plan_mode!r}")
        self.orch = orch
        self.shards = int(shards)
        self.plan_mode = plan_mode
        # measured per-partition plan cost (seconds), EWMA — drives the
        # "auto" inline-vs-threads pick and is exported to telemetry
        self.plan_cost_ewma: Optional[float] = None
        # same EWMA kept per partition: a rebalance policy's signal for
        # how expensive each partition's plan phases are where they run
        self.plan_cost_by_part: Dict[str, float] = {}
        self._remote = None
        if plan_mode == "remote":
            from repro_torch.core.remote import RemoteRoundClient

            self._remote = RemoteRoundClient(orch, transport, codec=wire_codec)

    def close(self) -> None:
        """Shut down any out-of-process shard workers (idempotent)."""
        if self._remote is not None:
            self._remote.close()

    # ------------------------------------------------------------------
    def assign(self, keys: Sequence[str]) -> List[List[str]]:
        """Deterministic shard ownership: stripe the sorted partition
        keys round-robin.  Whole partitions only — and therefore whole
        WFQ sub-queues, since a PartitionQueue's per-task sub-queues
        never leave their partition."""
        ordered = sorted(keys)
        n = max(1, min(self.shards, len(ordered)))
        return [ordered[i::n] for i in range(n)]

    # ------------------------------------------------------------------
    def plan_round(self, keys: Sequence[str]) -> Tuple[List[PartitionPlan], float]:
        """Plan every partition in ``keys``; returns the plans in global
        sorted partition order (the commit order — identical to the
        serial loop's walk) plus the round's critical-path plan cost:
        the maximum per-shard plan time."""
        groups = self.assign(keys)
        telemetry = self.orch.telemetry
        if self._remote is not None:
            plans, critical = self._remote.plan_round(groups)
            plans.sort(key=lambda p: p.part)
            self._note_plan_costs(plans)
            return plans, critical

        mode = self.plan_mode
        if mode == "auto":
            mode = self._auto_mode(groups)
            telemetry.note_plan_mode(mode, self.plan_cost_ewma)
        t_wall = time.perf_counter()
        if len(groups) == 1 or mode == "inline":
            results = [self._plan_shard(i, g) for i, g in enumerate(groups)]
        else:
            pool = _pool(self.shards)
            futs = [
                pool.submit(self._plan_shard, i, group)
                for i, group in enumerate(groups)
            ]
            results = [f.result() for f in futs]
        telemetry.plan_wall_s += time.perf_counter() - t_wall

        plans: List[PartitionPlan] = []
        critical = 0.0
        for shard_idx, (shard_plans, plan_s) in enumerate(results):
            critical = max(critical, plan_s)
            telemetry.note_shard_round(shard_idx, len(shard_plans), plan_s)
            plans.extend(shard_plans)
        telemetry.plan_critical_s += critical
        plans.sort(key=lambda p: p.part)
        self._note_plan_costs(plans)
        return plans, critical

    # ------------------------------------------------------------------
    def _auto_mode(self, groups: List[List[str]]) -> str:
        """The per-round inline-vs-threads pick: dispatch to the pool
        only when the measured plan-cost EWMA predicts a per-shard plan
        phase expensive enough to amortize pool dispatch (and there is
        more than one shard to overlap).  Before any measurement exists
        the round plans inline — the measurement itself is free there."""
        if len(groups) <= 1 or self.plan_cost_ewma is None:
            return "inline"
        est_shard_cost = self.plan_cost_ewma * max(len(g) for g in groups)
        return "threads" if est_shard_cost >= AUTO_THREADS_CUTOVER_S else "inline"

    def _note_plan_costs(self, plans: Sequence[PartitionPlan]) -> None:
        """Fold this round's measured per-partition plan walls into the
        EWMA that drives (and is reported beside) the auto decision."""
        ewma = self.plan_cost_ewma
        by_part = self.plan_cost_by_part
        for p in plans:
            if not p.planned:
                continue
            ewma = (
                p.wall_s
                if ewma is None
                else AUTO_EWMA_ALPHA * p.wall_s + (1.0 - AUTO_EWMA_ALPHA) * ewma
            )
            prev = by_part.get(p.part)
            by_part[p.part] = (
                p.wall_s
                if prev is None
                else AUTO_EWMA_ALPHA * p.wall_s + (1.0 - AUTO_EWMA_ALPHA) * prev
            )
        self.plan_cost_ewma = ewma
        if ewma is not None:
            self.orch.telemetry.plan_cost_ewma_s = ewma

    # ------------------------------------------------------------------
    def _plan_shard(
        self, shard_idx: int, keys: Sequence[str]
    ) -> Tuple[List[PartitionPlan], float]:
        """One shard's work unit: snapshot the managers' free state once,
        then arrange each owned partition against the snapshots.  May
        run on a pool thread; must only touch snapshot state and this
        shard's own partitions (see the module docstring's contract).
        The returned cost is this shard's plan wall time — exact in
        ``inline`` mode (nothing else runs), an upper bound (includes
        GIL waits) in ``threads`` mode."""
        t0 = time.perf_counter()
        snapshots = SnapshotMap(self.orch.managers)
        plans = [
            self.orch._plan_partition(part, snapshots, shard=shard_idx)
            for part in keys
        ]
        return plans, time.perf_counter() - t0

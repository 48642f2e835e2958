"""Telemetry-driven sub-queue rebalancing across replica pools.

PR 5 built the mechanism — :meth:`Orchestrator.migrate_task` moves a
whole WFQ task sub-queue between replica partitions with fair ordering
preserved, and :meth:`Orchestrator.rebalance` evens depths on demand.
This module adds the *driver*: a :class:`RebalancePolicy` evaluated on
a virtual-time cadence (:meth:`Orchestrator.enable_rebalance`) that
reads live telemetry —

* per-replica **queue depth** and per-task backlog (count and queued
  work in cost units, :meth:`PartitionQueue.backlog_cost`),
* per-task **starvation ages** (now − oldest queued submit),
* per-pool **utilization** (busy fraction of the replica's manager),
* per-partition **plan-cost EWMAs** from the round engine (a proxy for
  how expensive a partition's rounds are where they're planned),

— and orders migrations through the existing ``migrate_task``
machinery.  The decision rule is deliberately the proven one from
``Orchestrator.rebalance`` (move the sub-queue whose size is closest
to half the depth gap — the best single move), extended with the
telemetry the cadence makes available: the most loaded replica is the
source (depth, then worst starvation, then plan cost), the least
loaded *unsaturated* replica is the sink, and among equally
gap-improving sub-queues the most starved task moves first (it reaches
service soonest on the idle pool).

Everything is deterministic: signals are snapshots of DES state, ties
break on sorted names, and the cadence fires at fixed virtual-time
periods — the same run always makes the same moves, which is what lets
the bench gate measured ACT wins.

Cost model honesty: migrations are not free (detach + retarget + merge
walls land in ``Telemetry.migration_wall_s``; each move also dirties
two partitions, forcing replans).  ``min_gap`` is the hysteresis that
keeps the policy from thrashing sub-queues between near-balanced
pools, and ``max_moves`` bounds the work any single tick may order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple


@dataclass
class RebalanceSignals:
    """One cadence tick's snapshot of the orchestrator's telemetry
    (collected by ``Orchestrator._rebalance_signals``; all maps are
    keyed by replica partition name)."""

    now: float
    #: queued actions per replica
    depths: Dict[str, int] = field(default_factory=dict)
    #: per replica: task -> queued action count
    backlogs: Dict[str, Dict[str, int]] = field(default_factory=dict)
    #: per replica: task -> queued work in WFQ cost units
    backlog_cost: Dict[str, Dict[str, float]] = field(default_factory=dict)
    #: per replica: task -> starvation age of its oldest queued action
    starvation: Dict[str, Dict[str, float]] = field(default_factory=dict)
    #: per replica: busy fraction of the pool manager (1 - free/capacity)
    utilization: Dict[str, float] = field(default_factory=dict)
    #: per partition: plan-cost EWMA from the round engine (seconds)
    plan_cost_s: Dict[str, float] = field(default_factory=dict)


class RebalancePolicy:
    """Decides sub-queue migrations from one tick's signals.

    ``period_s`` is the cadence (virtual seconds between evaluations),
    ``min_gap`` the depth-gap hysteresis below which no move is worth
    its cost, ``max_moves`` the per-tick move budget, and
    ``util_ceiling`` the sink gate: a replica already busier than this
    fraction receives no new sub-queues (its queue would grow, not
    drain)."""

    def __init__(
        self,
        period_s: float = 0.25,
        min_gap: int = 2,
        max_moves: int = 2,
        util_ceiling: float = 0.95,
    ) -> None:
        if period_s <= 0:
            raise ValueError(f"period_s must be > 0, got {period_s}")
        self.period_s = float(period_s)
        self.min_gap = int(min_gap)
        self.max_moves = int(max_moves)
        self.util_ceiling = float(util_ceiling)

    # ------------------------------------------------------------------
    def decide(
        self, signals: RebalanceSignals, replicas: Sequence[str]
    ) -> List[Tuple[str, str, str]]:
        """The tick's migration orders as ``(task_id, src, dst)``
        triples, at most ``max_moves`` of them.  Later moves see the
        depths earlier ones will produce (the tick plans a consistent
        batch, not ``max_moves`` copies of the same move)."""
        ordered = sorted(replicas)
        depths = {p: signals.depths.get(p, 0) for p in ordered}
        backlogs = {p: dict(signals.backlogs.get(p, {})) for p in ordered}
        moves: List[Tuple[str, str, str]] = []
        for _ in range(self.max_moves):
            src = max(ordered, key=lambda p: self._load(signals, p, depths))
            dst = self._sink(signals, ordered, depths, src)
            if dst is None:
                break
            gap = depths[src] - depths[dst]
            if gap <= self.min_gap:
                break
            task, n = self._pick_subqueue(signals, backlogs[src], src, gap)
            if task is None:
                break
            moves.append((task, src, dst))
            depths[src] -= n
            depths[dst] += n
            backlogs[src].pop(task, None)
            backlogs[dst][task] = backlogs[dst].get(task, 0) + n
        return moves

    # ------------------------------------------------------------------
    def _load(self, signals: RebalanceSignals, p: str, depths: Dict[str, int]):
        """Source ranking: queue depth first (the quantity migration
        directly moves), then worst starvation age, then the partition's
        plan-cost EWMA.  The name tiebreak keeps max() deterministic."""
        starv = signals.starvation.get(p, {})
        return (
            depths[p],
            max(starv.values(), default=0.0),
            signals.plan_cost_s.get(p, 0.0),
            p,
        )

    def _sink(
        self,
        signals: RebalanceSignals,
        ordered: Sequence[str],
        depths: Dict[str, int],
        src: str,
    ):
        """Sink: the least-loaded replica still below the utilization
        ceiling (shallowest queue, then least busy, then name)."""
        candidates = [
            p
            for p in ordered
            if p != src
            and signals.utilization.get(p, 0.0) < self.util_ceiling
        ]
        if not candidates:
            return None
        return min(
            candidates,
            key=lambda p: (depths[p], signals.utilization.get(p, 0.0), p),
        )

    def _pick_subqueue(
        self,
        signals: RebalanceSignals,
        backlog: Dict[str, int],
        src: str,
        gap: int,
    ):
        """The sub-queue to move: size closest to half the gap (the
        move that most evens the pair — same math as
        ``Orchestrator.rebalance``), then the most starved task, then
        queued work, then name."""
        starv = signals.starvation.get(src, {})
        cost = signals.backlog_cost.get(src, {})
        best = None
        for t, n in sorted(backlog.items()):
            if n <= 0 or abs(gap - 2 * n) >= gap:
                continue  # the move must strictly shrink the gap
            key = (abs(gap - 2 * n), -starv.get(t, 0.0), -cost.get(t, 0.0), t)
            if best is None or key < best[0]:
                best = (key, t, n)
        if best is None:
            return None, 0
        return best[1], best[2]

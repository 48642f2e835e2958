"""Multi-tenant fair-share queueing (weighted start-time fair queueing).

The paper's action-level formulation assumes external resources are
*shared across tasks*; with the orchestrator's per-resource partitioned
queues still draining pure FCFS, one task's burst of actions starves
every other task's actions on the same partition — the head-of-line
pathology §3 motivates, reappearing one level up.  This module adds the
fairness layer:

* :class:`FairSharePolicy` — the knob set: per-task ``weights`` (service
  share ∝ weight under saturation), optional hard ``quota`` caps
  (fraction of a partition's capacity a task may hold), and
  ``preempt_scalable`` (a task over its fair share has its scalable
  DoP>1 allocations shrunk before any under-share task's actions are
  deferred — see :meth:`ElasticScheduler._greedy_eviction`).
* :class:`PartitionQueue` — one per scheduling partition: per-task
  sub-queues drained by **start-time fair queueing** (SFQ).  Every
  arrival gets a virtual-time tag ``S = max(V, F_task)`` and
  ``F_task = S + cost / weight``; pick-next is the minimum start tag
  (O(log T) across T task sub-queues); the virtual clock ``V`` advances
  to the tag of the action actually entering service.  Cost is measured
  in resource-seconds (min units × estimated duration), so a task
  burning big/long actions is charged proportionally more virtual time
  than one issuing short probes.

Single-task equivalence (the refactor's safety rail): with one task the
tags are strictly monotone in arrival order, so the drain order — and
therefore the candidate window, the DP input, and the launch trace — is
**bit-identical** to the plain FCFS deque this structure replaced
(equivalence-tested in ``tests/test_fairness.py`` and gated in CI by the
fairness-smoke benchmark).  ``fair=False`` degenerates to exactly the
FCFS deque (tags collapse to the arrival sequence number), which is the
multi-task fairness *ablation*.

The per-task sub-queue is also the unit the ROADMAP's async/distributed
rounds will shard: a sub-queue's tags are self-contained, so a remote
shard only needs the partition's virtual clock to merge.
"""

from __future__ import annotations

import math
from bisect import bisect_left, insort
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.action import Action

#: Floor on weights/costs so a zero never stalls the virtual clock.
_EPS = 1e-9


@dataclass
class FairSharePolicy:
    """Knob set for multi-tenant weighted sharing.

    ``weights``: task_id -> relative weight (default ``default_weight``);
    under saturation a task's service share of each partition tracks
    ``w_i / sum_j w_j`` over the tasks with backlog.  ``quota``:
    task_id -> cap, as a fraction of a partition's capacity, on the
    units a task may hold concurrently — enforced twice: min-unit
    admission is budgeted per round, and elastic grants are clamped
    down to the budget at launch.  Progress rail: a task holding
    nothing always gets one action at min units even when the cap is
    smaller than its min requirement (a sub-min quota degrades to
    one-action-at-a-time, never to a silent permanent hold).
    ``preempt_scalable``: allow the scheduler to
    shrink an over-share task's scalable (DoP>1) allocations to minimum
    units before any under-share task's actions are deferred by
    eviction.  ``share_slack``: relative tolerance band around the
    weighted fair share before a task counts as over-share.
    """

    weights: Dict[str, float] = field(default_factory=dict)
    default_weight: float = 1.0
    quota: Dict[str, float] = field(default_factory=dict)
    preempt_scalable: bool = True
    share_slack: float = 0.1

    def weight_of(self, action_or_task: object) -> float:
        """Weight for an action (its own ``weight`` wins) or a task id."""
        if isinstance(action_or_task, Action):
            if action_or_task.weight is not None:
                return max(_EPS, float(action_or_task.weight))
            task_id = action_or_task.task_id
        else:
            task_id = str(action_or_task)
        return max(_EPS, float(self.weights.get(task_id, self.default_weight)))

    def quota_of(self, task_id: str) -> float:
        return float(self.quota.get(task_id, math.inf))


@dataclass
class TaskShard:
    """A detached per-task sub-queue in transit between partition
    replicas (see :meth:`PartitionQueue.detach_task`).  Tags are
    self-contained — merging needs only a monotone virtual-clock sync
    — and the payload is wire-serializable
    (:func:`repro.core.wire.encode_task_shard`), so a sub-queue can
    move between processes, not just between queues.

    >>> from repro_torch.core.action import Action, fixed
    >>> src = PartitionQueue(fair=True)
    >>> dst = PartitionQueue(fair=True)
    >>> a = Action(name="x", cost={"r": fixed("r")}, task_id="mover",
    ...            trajectory_id="t0")
    >>> src.push(a)
    >>> shard = src.detach_task("mover")
    >>> (len(src), shard.task_id, len(shard.entries))
    (0, 'mover', 1)
    >>> dst.merge_shard(shard)
    >>> [x.name for x in dst.ordered()]
    ['x']
    >>> dst.vtime >= shard.vtime  # clock sync is monotone
    True
    """

    task_id: str
    entries: List[Tuple[Tuple[float, int], Action]]
    finish_tag: float  # the task's virtual finish chain at detach
    vtime: float  # the source partition's clock at detach


def default_cost(action: Action, rtype: Optional[str]) -> float:
    """SFQ service cost in resource-seconds the action will actually
    occupy at its minimum allocation: min units of the partition's
    resource × estimated duration AT that allocation (1.0 when
    unprofiled).  Using the elastic min-unit duration — not the 1-unit
    base — matters: charging a scalable action its un-sped-up base would
    over-bill elastic tenants in virtual time and hand their share to
    rigid ones."""
    units = 1
    if rtype is not None:
        req = action.cost.get(rtype)
        if req is not None:
            units = req.min_units
    if action.base_duration is None:
        dur = 1.0
    elif rtype is not None and rtype == action.key_resource:
        dur = action.get_dur(action.cost[rtype].min_units)
    else:
        dur = action.base_duration
    return max(_EPS, units * dur)


class PartitionQueue:
    """Per-task sub-queues drained by weighted start-time fair queueing.

    Mutations are O(log n) tag work plus one insertion into the cached
    merged order (a sorted list — arrivals of one task never force the
    other tasks' sub-queues to be re-tagged or re-merged, which is what
    keeps a task's arrival from dirtying anything but its own
    sub-queue).  Removals are lazy tombstones; the merged order compacts
    when more than half its entries are stale.  ``fair=False`` orders by
    the global arrival sequence alone — the pre-fairness FCFS deque.
    """

    def __init__(
        self,
        fair: bool = False,
        weight_of: Optional[Callable[[Action], float]] = None,
        cost_of: Optional[Callable[[Action], float]] = None,
    ) -> None:
        self.fair = fair
        self._weight_of = weight_of or (lambda a: 1.0)
        self._cost_of = cost_of or (lambda a: 1.0)
        # --- sub-queues + tags -------------------------------------------
        self._subs: Dict[str, "OrderedDict[int, Action]"] = {}
        self._uid_task: Dict[int, str] = {}
        self._key: Dict[int, Tuple[float, int]] = {}  # uid -> (vstart, seq)
        self._task_finish: Dict[str, float] = {}  # task -> last finish tag
        self._vtime = 0.0  # partition virtual clock
        self._seq = 0  # ascending for appends
        self._head_seq = 0  # descending for at-head requeues
        # --- merged-order cache (sorted by key; stale entries tombstoned)
        self._order: List[Tuple[Tuple[float, int], Action]] = []
        self._stale = 0
        self.compactions = 0  # telemetry: full rebuilds of the merge
        # bumped on every membership mutation (push / remove / detach /
        # merge).  Tags are fixed at admission, so an unchanged version
        # means ordered() yields the identical sequence — callers may
        # cache derived views (the wire encoder does) against it.
        self.version = 0

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._uid_task)

    def __bool__(self) -> bool:
        return bool(self._uid_task)

    def __contains__(self, uid: int) -> bool:
        return uid in self._uid_task

    @property
    def vtime(self) -> float:
        return self._vtime

    def tag_of(self, uid: int) -> Optional[Tuple[float, int]]:
        return self._key.get(uid)

    def tasks(self) -> List[str]:
        return [t for t, sub in self._subs.items() if sub]

    # ------------------------------------------------------------------
    def push(self, action: Action, at_head: bool = False) -> None:
        self.version += 1
        task = action.task_id
        sub = self._subs.setdefault(task, OrderedDict())
        if not self.fair:
            # FCFS ablation: tags collapse to the arrival sequence; the
            # descending head counter reproduces deque appendleft order.
            if at_head:
                self._head_seq -= 1
                key = (0.0, self._head_seq)
            else:
                self._seq += 1
                key = (0.0, self._seq)
        elif at_head:
            # retry-at-head: resume at the front of its OWN sub-queue
            # without re-charging the task's virtual finish chain (the
            # original admission already advanced it).
            self._head_seq -= 1
            if sub:
                head_start = self._key[next(iter(sub))][0]
            else:
                head_start = self._vtime
            key = (head_start, self._head_seq)
        else:
            w = self._weight_of(action)
            start = max(self._vtime, self._task_finish.get(task, 0.0))
            self._task_finish[task] = start + self._cost_of(action) / w
            self._seq += 1
            key = (start, self._seq)
        if at_head:
            sub[action.uid] = action
            sub.move_to_end(action.uid, last=False)
        else:
            sub[action.uid] = action
        self._uid_task[action.uid] = task
        self._key[action.uid] = key
        insort(self._order, (key, action), key=lambda e: e[0])

    def remove(self, uid: int, served: bool = False) -> Optional[Action]:
        """Drop ``uid`` (tombstoning its merged-order entry).  ``served``
        marks an action entering service: the virtual clock advances to
        its start tag so later arrivals cannot back-date behind it."""
        task = self._uid_task.pop(uid, None)
        if task is None:
            return None
        self.version += 1
        action = self._subs[task].pop(uid)
        key = self._key.pop(uid)
        if served and self.fair:
            self._vtime = max(self._vtime, key[0])
        if self.fair and not self._uid_task:
            self._end_busy_period()
        self._stale += 1
        if self._stale > max(16, len(self._order) // 2):
            self._compact()
        return action

    def _end_busy_period(self) -> None:
        """SFQ resume rule at a full drain (the last queued action left).

        The virtual clock jumps (monotonically — never backward) to the
        maximum finish tag any task was charged, and the per-task finish
        chains reset: every debt is settled at the end of a busy period.
        Without this, the drain freezes ``V`` at the last *start* tag
        while stale ``F_task`` entries persist — after the refill, tasks
        that never queued during the old busy period would be granted
        stale (unfairly small) start tags ``S = V_old`` and slot in ahead
        of a returning task still paying ``F_task > V_old`` for service
        it received before the queue went idle.  After the rule, every
        arrival in the new busy period starts level at the settled
        clock."""
        if self._task_finish:
            self._vtime = max(
                self._vtime, max(self._task_finish.values())
            )
            self._task_finish.clear()

    def _compact(self) -> None:
        self._order = [e for e in self._order if self._key.get(e[1].uid) == e[0]]
        self._stale = 0
        self.compactions += 1

    # ------------------------------------------------------------------
    # sub-queue detach / merge (the distribution seam: a shard owns whole
    # per-task sub-queues and syncs only the partition virtual clock)
    # ------------------------------------------------------------------
    def sync_vtime(self, v: float) -> None:
        """Advance the partition virtual clock to an external observation
        (a peer shard's clock at merge).  Monotone by construction — the
        clock can never leap backward."""
        if self.fair:
            self._vtime = max(self._vtime, float(v))

    def detach_task(self, task_id: str) -> Optional["TaskShard"]:
        """Detach ``task_id``'s whole sub-queue for remote ownership.

        The shard is self-contained: it carries the queued actions with
        their original ``(vstart, seq)`` tags, the task's virtual finish
        tag, and this partition's clock at detach time — everything a
        remote scheduler needs to keep draining the task fairly.  The
        entries are tombstoned here (not served: the clock does NOT
        advance, and a detach that empties the partition is not a
        busy-period end — the work still exists, elsewhere)."""
        sub = self._subs.pop(task_id, None)
        if not sub:
            return None
        self.version += 1
        entries: List[Tuple[Tuple[float, int], Action]] = []
        for uid, action in sub.items():
            self._uid_task.pop(uid, None)
            entries.append((self._key.pop(uid), action))
        self._stale += len(entries)
        if self._stale > max(16, len(self._order) // 2):
            self._compact()
        return TaskShard(
            task_id=task_id,
            entries=entries,
            finish_tag=self._task_finish.pop(task_id, 0.0),
            vtime=self._vtime,
        )

    def merge_shard(self, shard: "TaskShard") -> None:
        """Re-adopt a detached sub-queue (possibly into a *different*
        partition replica).  Tags are self-contained, so entries merge
        with their original keys; only the virtual clock needs syncing —
        monotone max, so neither side's clock moves backward — and the
        task's finish chain resumes from the later of the two tags."""
        self.sync_vtime(shard.vtime)
        self.version += 1
        sub = self._subs.setdefault(shard.task_id, OrderedDict())
        for key, action in shard.entries:
            if action.uid in self._uid_task:
                continue  # already re-queued locally; never double-admit
            sub[action.uid] = action
            self._uid_task[action.uid] = shard.task_id
            self._key[action.uid] = key
            # restoring the key re-validates a tombstone left by detach
            # in THIS queue — only insert when no entry already sits at
            # (key, action), or ordered() would yield the action twice
            if self._resurrect(key, action):
                self._stale = max(0, self._stale - 1)
            else:
                insort(self._order, (key, action), key=lambda e: e[0])
            self._seq = max(self._seq, key[1])
        self._task_finish[shard.task_id] = max(
            self._task_finish.get(shard.task_id, 0.0), shard.finish_tag
        )

    # ------------------------------------------------------------------
    def ordered(self) -> List[Action]:
        """Waiting actions in fair service order (FCFS within a task,
        min-start-tag across tasks; arrival order when ``fair=False``)."""
        key = self._key
        return [a for k, a in self._order if key.get(a.uid) == k]

    def head(self) -> Optional[Action]:
        key = self._key
        for k, a in self._order:
            if key.get(a.uid) == k:
                return a
        return None

    # ------------------------------------------------------------------
    # per-task introspection (telemetry / starvation tracking)
    # ------------------------------------------------------------------
    def backlog(self) -> Dict[str, int]:
        return {t: len(sub) for t, sub in self._subs.items() if sub}

    def backlog_cost(self) -> Dict[str, float]:
        """Queued *work*, per task, in this queue's cost units (the
        same ``cost_of`` WFQ tags are charged in — resource-seconds
        under :func:`default_cost`).  The rebalance policy weighs moves
        by queued work, not action count: ten 1-second actions and one
        10-second action are the same backlog."""
        return {
            t: sum(self._cost_of(a) for a in sub.values())
            for t, sub in self._subs.items()
            if sub
        }

    def oldest_submit_by_task(self) -> Dict[str, float]:
        """Earliest submit time among queued actions, per task — the
        numerator of the starvation-age telemetry."""
        out: Dict[str, float] = {}
        for t, sub in self._subs.items():
            times = [a.submit_time for a in sub.values() if not math.isnan(a.submit_time)]
            if times:
                out[t] = min(times)
        return out

    def _resurrect(self, key: Tuple[float, int], action: Action) -> bool:
        """True iff ``_order`` already holds the exact (key, action)
        entry — a tombstone this queue's own detach left behind, now
        valid again because the key was restored."""
        i = bisect_left(self._order, key, key=lambda e: e[0])
        while i < len(self._order) and self._order[i][0] == key:
            if self._order[i][1] is action:
                return True
            i += 1
        return False

    # bisect helper exposed for tests: rank of a hypothetical key
    def _rank(self, key: Tuple[float, int]) -> int:
        return bisect_left([k for k, _ in self._order], key)

"""Unified resource-manager interface (paper §5).

Heterogeneous resources "expose a standardized interface to the
scheduler, maintaining transparency of heterogeneous resources to the
scheduling algorithm".  The scheduler only ever calls:

* ``can_accommodate(actions)``   — min-requirement + topology admission
  test used to pick the FCFS candidate window (Alg. 1 line 2);
* ``dp_operator(actions)``       — the topology abstraction DPArrange
  runs over (Appendix B);
* ``partition(actions)``         — optional sub-scheduling domains (the
  CPU manager schedules per node, §5.2);
* ``try_allocate / release``     — concrete placement (Breakdown), with
  per-allocation system overhead (cgroup update, service restore, ...);
* ``trajectory_start / trajectory_end`` — lifetime hooks (the CPU
  manager pins trajectory memory while cores are action-scoped).

**Authoritative state vs replicas.**  A manager instance is either the
*authoritative* copy — the one whose ``try_allocate`` decides a launch
— or a *replica* derived from it through the snapshot surface.  Under
the default client-serial commit engine the orchestrator's managers
are authoritative and every snapshot (in-process plan isolation or a
wire ``snapshot_state``) is a plan-phase throwaway.  Under worker-owned
commit (``commit_mode="worker"``) authority moves with the ownership
lease: the shard worker's resident replica commits, and the
orchestrator's manager becomes the *verified replay* copy — it applies
the worker's committed outcomes and must reproduce the worker's
post-commit snapshot fingerprint exactly.  Nothing in the contract
changes per role; what makes the handoff sound is that the snapshot
codecs round-trip the full commit-relevant state (asserted in
``tests/test_wire.py``) and that every mutation happens through the
same methods on whichever copy is authoritative.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, Hashable, List, Optional, Sequence

from repro_torch.core.action import Action
from repro_torch.core.dparrange import BasicDPOperator, DPOperator

#: Sentinel distinguishing "key absent" from "key holds None" in
#: snapshot_delta's per-key comparison.
_MISSING = object()


@dataclass
class Allocation:
    """Opaque placement handle returned by a manager."""

    rtype: str
    units: int
    node: Optional[str] = None
    detail: Dict[str, object] = field(default_factory=dict)
    overhead: float = 0.0  # system-overhead seconds charged to the action


class ResourceManager:
    """Base class; also usable directly for simple fungible resources.

    The scheduler-facing contract (what every manager family must keep
    honest) is the method set documented below: admission
    (:meth:`can_accommodate` / the :meth:`begin_admission` cursor), the
    DP hooks (:meth:`dp_operator` / :meth:`dp_cache_key` /
    :meth:`partition`), placement (:meth:`try_allocate` /
    :meth:`release` and the two failure-path releases), share
    accounting (:meth:`note_allocated` / :meth:`note_released` /
    :meth:`task_usage` / :meth:`check_occupancy`), and the plan-phase
    snapshot surface (:meth:`snapshot`, plus the wire codecs
    :meth:`snapshot_state` / :meth:`restore_snapshot` used by
    :mod:`repro_torch.core.wire` when plans leave the process).  See
    ``docs/architecture.md`` ("Managers") and ``examples/remote_round.py``
    for a worked end-to-end use.
    """

    #: Wire-codec family tag (see :func:`repro_torch.core.wire.encode_snapshot`).
    #: Subclasses of a library manager inherit their family's codec; a
    #: new manager family that adds plan-relevant state must define its
    #: own tag + ``snapshot_state``/``restore_snapshot`` pair and
    #: register it in :mod:`repro_torch.core.wire`.
    wire_impl = "pool"

    #: Does planning over this manager mutate it?  The plan phase only
    #: *reads* the base family (admission cursors are fresh copies from
    #: ``begin_admission``; ``dp_operator`` closes over snapshots), so a
    #: long-lived worker replica can be handed to ``plan_partition``
    #: directly, round after round.  A family whose plan surface writes
    #: into the manager (the CPU manager's trajectory binding via
    #: ``partition()``) sets this True, and the resident-state layer
    #: plans over a throwaway ``snapshot()`` instead — the copy-on-plan
    #: reset.  Keep this honest: a False here with a mutating plan
    #: surface corrupts worker state across rounds (the resident-state
    #: property tests assert snapshot stability after planning).
    plan_mutates = False

    def __init__(self, rtype: str, capacity: int) -> None:
        self.rtype = rtype
        self.capacity = int(capacity)
        self._in_use = 0
        # per-task units currently held (multi-tenant fair share): the
        # orchestrator notes every launch/release here, so accounting is
        # manager-agnostic — subclasses never need to touch it.
        self._task_use: Dict[str, int] = {}

    # ------------------------------------------------------------------
    # capacity / admission
    # ------------------------------------------------------------------
    @property
    def available(self) -> int:
        """Units currently grantable (for quota managers: remaining
        tokens, which is why :meth:`held_units` is a separate notion)."""
        return self.capacity - self._in_use

    def min_units(self, action: Action) -> int:
        """The action's minimum requirement on this resource (0 when
        its cost vector does not touch this rtype)."""
        req = action.cost.get(self.rtype)
        return req.min_units if req is not None else 0

    def can_accommodate(self, actions: Sequence[Action]) -> bool:
        """Admission test with every action at least-required units."""
        state = self.begin_admission()
        return all(self.admit_one(state, a) for a in actions)

    # ------------------------------------------------------------------
    # incremental admission (orchestrator candidate window)
    # ------------------------------------------------------------------
    # ``can_accommodate(prefix)`` re-evaluated for every FCFS prefix is
    # O(n^2) per round.  The orchestrator instead opens one admission
    # cursor per round and feeds actions through it one at a time:
    # ``admit_one`` must behave exactly like extending the prefix, so
    # the incremental window equals the seed's full-rescan window.
    def begin_admission(self) -> object:
        """Opaque mutable cursor over a *copy* of the free state."""
        return [self.available]

    def admit_one(self, state: object, action: Action) -> bool:
        """Extend the admission prefix by one action at min units."""
        need = self.min_units(action)
        if need > state[0]:  # type: ignore[index]
            return False
        state[0] -= need  # type: ignore[index]
        return True

    # ------------------------------------------------------------------
    # scheduling hooks
    # ------------------------------------------------------------------
    def dp_operator(self, actions: Sequence[Action], reserve: int = 0) -> DPOperator:
        """Topology abstraction DPArrange runs over (paper Appendix B).

        ``reserve`` units are already committed to co-scheduled actions
        in the same round and must be excluded from elastic scaling.

        Dense-DP contract (PR 2): the returned operator SHOULD implement
        :meth:`~repro_torch.core.dparrange.DPOperator.transition_table` so the
        scheduler can run DPArrange as vectorized array sweeps — a
        ``state x unit-choice -> next-state`` int table with a ``-1``
        invalid sentinel plus a per-state validity mask.  The operator
        (and therefore the table) must be a PURE function of the
        manager state snapshot taken at this call: any feasibility
        callback it closes over must read a snapshot, never live manager
        state, or cached tables would silently go stale."""
        return BasicDPOperator(max(0, self.available - reserve))

    def dp_cache_key(
        self, actions: Sequence[Action], reserve: int = 0
    ) -> Optional[Hashable]:
        """Hashable key under which DPArrange artifacts over ``actions``
        may be memoized, or None if results are state-dependent in ways
        the key cannot capture.  Contract: equal keys imply
        ``dp_operator`` yields an operator with identical transition
        structure — so the key guards BOTH the per-task-tuple DP-result
        memo and the task-independent dense transition-table cache
        (:class:`~repro_torch.core.dparrange.TransitionTable`).  A manager must
        therefore fold into the key everything its operator's
        transitions/validity read (free units here; the GPU manager adds
        its per-node free-chunk level counts, which is what invalidates
        cached tables when chunks are taken or returned)."""
        return (self.rtype, max(0, self.available - reserve))

    def partition(self, actions: Sequence[Action]) -> Dict[str, List[Action]]:
        """Sub-scheduling domains; default: one global domain."""
        return {"*": list(actions)}

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------
    def try_allocate(self, action: Action, units: int) -> Optional[Allocation]:
        """Concrete placement: grant ``units`` (returning an opaque
        :class:`Allocation` carrying any per-allocation system overhead)
        or return None WITHOUT side effects — a refusal must leave the
        manager exactly as it was, because the orchestrator retries
        refused launches on the ordinary round rail.  Live managers
        only: plan-phase snapshots never place."""
        if units > self.available:
            return None
        self._in_use += units
        return Allocation(self.rtype, units)

    def release(self, action: Action, allocation: Allocation) -> None:
        """Return a completed action's allocation.  Must accept exactly
        the Allocation ``try_allocate`` returned, once."""
        self._in_use -= allocation.units
        assert self._in_use >= 0, f"{self.rtype}: negative usage"

    def release_on_failure(self, action: Action, allocation: Allocation) -> None:
        """Release after a timeout/cancel/failure mid-execution.  Default:
        identical to a normal release; managers with non-returnable
        consumption (quota tokens) or cleanup costs may override."""
        self.release(action, allocation)

    def release_unlaunched(self, action: Action, allocation: Allocation) -> None:
        """Release an allocation whose action NEVER started: the rollback
        of a partial multi-resource acquisition (one manager in the
        vector refused) or of a commit-phase conflict in the sharded
        round engine.  Distinct from :meth:`release_on_failure` because
        the work was never attempted — managers with consumable state
        (quota tokens) must refund it here, where a mid-execution
        failure legitimately consumed it."""
        self.release(action, allocation)

    # ------------------------------------------------------------------
    # multi-tenant share accounting (fed by the orchestrator's launch /
    # release choke points; read by the fairness-aware scheduler)
    # ------------------------------------------------------------------
    def note_allocated(self, task_id: str, units: int) -> None:
        self._task_use[task_id] = self._task_use.get(task_id, 0) + units

    def note_released(self, task_id: str, units: int) -> None:
        left = self._task_use.get(task_id, 0) - units
        if left > 0:
            self._task_use[task_id] = left
        else:
            self._task_use.pop(task_id, None)

    def task_usage(self) -> Dict[str, int]:
        """Units currently held per task (live dict — treat as read-only).

        This measures *occupancy* regardless of the manager's own
        release semantics (quota managers consume tokens on release, but
        the task is still no longer occupying them)."""
        return self._task_use

    def held_units(self) -> int:
        """Total units currently occupied by running actions.  Must equal
        ``sum(task_usage().values())`` at every event boundary — the
        occupancy invariant :meth:`check_occupancy` asserts.  Subclasses
        whose ``available`` is not ``capacity - held`` (quota managers:
        availability is tokens, not free slots) must override."""
        return self._in_use

    def check_occupancy(self) -> None:
        """Assert the multi-tenant occupancy invariant: the per-task
        usage ledger (fed by the orchestrator's launch/release choke
        points) sums exactly to the units the manager itself says are
        held.  A violation means some release path skipped
        ``note_released`` (or double-noted) — the leak that permanently
        inflates quota charging for the leaked task."""
        noted = sum(self._task_use.values())
        held = self.held_units()
        assert noted == held, (
            f"{self.rtype}: occupancy leak — task_usage sums to {noted} "
            f"but {held} unit(s) are held ({dict(self._task_use)})"
        )

    # ------------------------------------------------------------------
    # plan-phase snapshots (sharded scheduling rounds)
    # ------------------------------------------------------------------
    def snapshot(self) -> "ResourceManager":
        """Cheap copy-on-snapshot free-state view for shard planning.

        The returned object supports the full *read/plan* surface the
        scheduling policy touches — ``available``/``capacity``,
        ``begin_admission``/``admit_one``, ``dp_operator``/
        ``dp_cache_key``, ``partition``, ``task_usage``, ``min_units`` —
        without any locking against the live manager: mutations a plan
        makes (admission cursors, the CPU manager's trajectory binding)
        land on the snapshot and are discarded.  Placement
        (``try_allocate``/``release``/``note_*``) must NEVER be called
        on a snapshot; it belongs to the single-threaded commit phase
        against the live manager.  Subclasses with deeper mutable state
        (nodes, chunk allocators, token buckets) extend this."""
        clone = copy.copy(self)
        clone._task_use = dict(self._task_use)
        return clone

    # ------------------------------------------------------------------
    # wire snapshots (out-of-process plan phase, repro_torch.core.wire)
    # ------------------------------------------------------------------
    def snapshot_state(self) -> Dict[str, object]:
        """Plain-dict (JSON-able) encoding of the plan-phase free state.

        Together with :meth:`restore_snapshot` this is the wire twin of
        :meth:`snapshot`: ``restore_snapshot(snapshot_state())`` must
        yield an object whose *plan surface* (``available``, admission
        cursor, ``dp_operator``/``dp_cache_key``, ``partition``,
        ``task_usage``, ``min_units``) behaves identically to an
        in-process snapshot — that equivalence is what makes remote
        plans bit-identical to inline ones.  Subclasses with deeper
        state override both methods (and keep them in sync)."""
        return {
            "rtype": self.rtype,
            "capacity": self.capacity,
            "in_use": self._in_use,
            "task_use": dict(self._task_use),
        }

    @classmethod
    def restore_snapshot(cls, state: Dict[str, object]) -> "ResourceManager":
        """Rebuild a plan-capable snapshot from :meth:`snapshot_state`.

        The result is for PLANNING only — committing against it would
        mutate a copy nobody owns.  Placement always happens on the live
        manager, in the orchestrator's single-threaded commit phase."""
        m = ResourceManager(str(state["rtype"]), int(state["capacity"]))  # type: ignore[arg-type]
        m._in_use = int(state.get("in_use", 0))  # type: ignore[arg-type]
        task_use = dict(state.get("task_use", {}))  # type: ignore[arg-type]
        m._task_use = {str(k): int(v) for k, v in task_use.items()}
        return m

    def apply_state(self, state: Dict[str, object]) -> bool:
        """Refresh this (already-restored) replica in place from a new
        :meth:`snapshot_state` payload, returning True on success.

        This is the cheap path a long-lived worker replica takes between
        rounds: mutable free state is overwritten, immutable topology
        (specs, node objects, allocator shells) is reused, and derived
        caches that depend only on topology stay warm.  Returns False
        when the payload describes a different topology (rtype,
        capacity, node set...) — the caller then falls back to a full
        ``restore_snapshot`` rebuild.  Contract: after a True return,
        ``snapshot_state()`` must equal ``state`` exactly (the resident
        property tests byte-compare them)."""
        if str(state.get("rtype")) != self.rtype or int(
            state.get("capacity", -1)  # type: ignore[arg-type]
        ) != self.capacity:
            return False
        self._in_use = int(state.get("in_use", 0))  # type: ignore[arg-type]
        task_use = dict(state.get("task_use", {}))  # type: ignore[arg-type]
        self._task_use = {str(k): int(v) for k, v in task_use.items()}
        return True

    # ------------------------------------------------------------------
    # structural snapshot deltas (wire twins of snapshot_state)
    # ------------------------------------------------------------------
    @classmethod
    def snapshot_delta(
        cls, prev: Dict[str, object], cur: Dict[str, object]
    ) -> Dict[str, object]:
        """Structural diff between two :meth:`snapshot_state` payloads.

        The base family diffs shallowly, per top-level key: ``set``
        carries keys whose value changed (or appeared), ``del`` lists
        keys that vanished.  Subclasses with deep state (per-node core
        sets, per-allocator chunk maps) override this — and
        :meth:`apply_delta` — so the wire carries what *changed*, not
        the fleet.  Contract: ``apply_delta(prev, snapshot_delta(prev,
        cur)) == cur`` exactly (the receiver fingerprint-verifies it)."""
        delta: Dict[str, object] = {}
        changed = {k: v for k, v in cur.items() if prev.get(k, _MISSING) != v}
        gone = [k for k in prev if k not in cur]
        if changed:
            delta["set"] = changed
        if gone:
            delta["del"] = gone
        return delta

    @classmethod
    def apply_delta(
        cls, base: Dict[str, object], delta: Dict[str, object]
    ) -> Dict[str, object]:
        """Rebuild a full :meth:`snapshot_state` payload from a cached
        base plus a :meth:`snapshot_delta` diff (pure — the base dict is
        not mutated; an empty delta returns an equal copy)."""
        state = dict(base)
        for k, v in delta.get("set", {}).items():  # type: ignore[union-attr]
            state[k] = v
        for k in delta.get("del", []):  # type: ignore[union-attr]
            state.pop(k, None)
        return state

    # ------------------------------------------------------------------
    # lifetime hooks
    # ------------------------------------------------------------------
    def trajectory_start(self, trajectory_id: str, metadata: Dict[str, object]) -> bool:
        """Admit (or veto) a new trajectory.  Called once per trajectory
        before any of its actions are scheduled; managers that pin
        per-trajectory state (the CPU manager's memory binding) hook
        this.  Returning False rejects the trajectory."""
        return True

    def trajectory_end(self, trajectory_id: str) -> None:
        """Release any per-trajectory state pinned by
        :meth:`trajectory_start` (idempotent for unknown ids)."""
        pass

    # ------------------------------------------------------------------
    def utilization(self) -> float:
        """Fraction of capacity currently held by running actions."""
        return self._in_use / self.capacity if self.capacity else 0.0

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.rtype}: {self._in_use}/{self.capacity})"

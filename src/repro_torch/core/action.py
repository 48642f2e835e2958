"""Unified action-level formulation (paper §4.1).

Every external-resource invocation in agentic RL is normalized into an
:class:`Action` carrying

* a **vectorized resource cost** ``C_i = (c_i0, ..., c_ik-1)`` — one
  :class:`ResourceRequest` per resource type the action touches.  Each
  dimension is not a scalar but a *constrained set* of feasible
  quantities (e.g. GPUs in ``{1, 2, 4, 8}``),
* an **elasticity model** ``dur(m) = T_ori / (E(m) * m)`` with
  ``0 < E(m) <= 1`` (paper Eq. 1), attached to a single *key elasticity
  resource* (paper assumption: one resource type dominates scaling), and
* a profiled **base duration** ``T_ori`` (duration with one unit of the
  key resource) where available; actions with unknown duration are still
  schedulable (they are simply never scaled, §4.2).
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Resource requests
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ResourceRequest:
    """One dimension of the vectorized cost ``C_i``.

    ``units`` is the ordered set of feasible quantities for this resource
    (paper: "the c_{i,j} in C_i has a specific constraint, representing
    its all possible resource quantity").  A non-elastic request has a
    single feasible quantity.
    """

    rtype: str
    units: Tuple[int, ...]  # sorted ascending, all > 0

    def __post_init__(self) -> None:
        if not self.units:
            raise ValueError(f"{self.rtype}: empty feasible-unit set")
        if any(u <= 0 for u in self.units):
            raise ValueError(f"{self.rtype}: units must be positive")
        if tuple(sorted(self.units)) != tuple(self.units):
            object.__setattr__(self, "units", tuple(sorted(self.units)))

    @property
    def min_units(self) -> int:
        return self.units[0]

    @property
    def max_units(self) -> int:
        return self.units[-1]

    @property
    def elastic(self) -> bool:
        return len(self.units) > 1


def fixed(rtype: str, units: int = 1) -> ResourceRequest:
    return ResourceRequest(rtype, (units,))


def ranged(rtype: str, lo: int, hi: int, step: int = 1) -> ResourceRequest:
    return ResourceRequest(rtype, tuple(range(lo, hi + 1, step)))


def powers_of_two(rtype: str, lo: int = 1, hi: int = 8) -> ResourceRequest:
    units = tuple(1 << a for a in range(int(math.log2(lo)), int(math.log2(hi)) + 1))
    return ResourceRequest(rtype, units)


# ---------------------------------------------------------------------------
# Elasticity modelling (paper Eq. 1)
# ---------------------------------------------------------------------------


class Elasticity:
    """Mapping m -> E(m) in (0, 1]; E(1) == 1 by normalization."""

    def ratio(self, m: int) -> float:  # pragma: no cover - interface
        raise NotImplementedError

    def speedup(self, m: int) -> float:
        """Effective speedup over one unit: E(m) * m."""
        e = self.ratio(m)
        if not (0.0 < e <= 1.0 + 1e-9):
            raise ValueError(f"E({m}) = {e} outside (0, 1]")
        return e * m


@dataclass(frozen=True)
class AmdahlElasticity(Elasticity):
    """E(m) from Amdahl's law with serial fraction ``serial``.

    speedup(m) = 1 / (serial + (1 - serial)/m), E(m) = speedup(m)/m.
    Models parallel test execution (pytest -n) and TP inference, whose
    efficiency decays with DoP.
    """

    serial: float = 0.05

    def ratio(self, m: int) -> float:
        if m <= 0:
            raise ValueError("m must be positive")
        sp = 1.0 / (self.serial + (1.0 - self.serial) / m)
        return sp / m


@dataclass(frozen=True)
class TableElasticity(Elasticity):
    """Profiled E(m) table with geometric interpolation between knots."""

    table: Tuple[Tuple[int, float], ...]  # ((m, E(m)), ...) sorted by m

    def ratio(self, m: int) -> float:
        knots = self.table
        if m <= knots[0][0]:
            return knots[0][1]
        for (m0, e0), (m1, e1) in itertools.pairwise(knots):
            if m0 <= m <= m1:
                if m1 == m0:
                    return e1
                t = (m - m0) / (m1 - m0)
                return e0 * (e1 / e0) ** t
        return knots[-1][1]


@dataclass(frozen=True)
class LinearElasticity(Elasticity):
    """Perfectly elastic: E(m) == 1 (ideal batch-parallel work)."""

    def ratio(self, m: int) -> float:
        return 1.0


# ---------------------------------------------------------------------------
# Actions
# ---------------------------------------------------------------------------


class ActionState(Enum):
    PENDING = "pending"
    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"
    TIMEOUT = "timeout"
    CANCELLED = "cancelled"


#: States from which an action can never leave (its future is resolved).
TERMINAL_STATES = frozenset(
    {ActionState.DONE, ActionState.FAILED, ActionState.TIMEOUT, ActionState.CANCELLED}
)


_ACTION_COUNTER = itertools.count()


@dataclass
class Action:
    """An atomic external-resource invocation (paper §2.4, §4.1)."""

    name: str
    cost: Dict[str, ResourceRequest]
    # --- elasticity (paper §4.1): single key elasticity resource ---
    key_resource: Optional[str] = None
    elasticity: Optional[Elasticity] = None
    base_duration: Optional[float] = None  # T_ori (1 unit of key resource)
    # --- provenance / multi-tenant fair share ---
    task_id: str = "task0"
    trajectory_id: str = "traj0"
    # fair-share weight override for THIS action; None defers to the
    # FairSharePolicy's per-task weight (tasks are the sharing tenant —
    # per-action overrides exist for e.g. latency-critical probes).
    weight: Optional[float] = None
    service: Optional[str] = None  # GPU manager: required service name
    # --- execution payload (live mode) / duration sampler (sim mode) ---
    fn: Optional[Callable[..., object]] = None
    duration_sampler: Optional[Callable[[int], float]] = None
    metadata: Dict[str, object] = field(default_factory=dict)
    # --- lifecycle policy (orchestrator-enforced) ---
    timeout_s: Optional[float] = None  # per-attempt deadline from (re)queueing
    max_retries: int = 0  # bounded re-queue-at-head retries after timeout

    # --- lifecycle bookkeeping (filled by the system) ---
    uid: int = field(default_factory=lambda: next(_ACTION_COUNTER))
    state: ActionState = ActionState.PENDING
    submit_time: float = math.nan
    start_time: float = math.nan
    finish_time: float = math.nan
    sys_overhead: float = 0.0
    attempts: int = 0  # completed (timed-out) attempts so far
    failure: Optional[str] = None  # terminal failure reason, if any
    allocation: Optional[object] = None  # set by the manager

    def __post_init__(self) -> None:
        if self.key_resource is not None and self.key_resource not in self.cost:
            raise ValueError(
                f"key resource {self.key_resource!r} not in cost vector "
                f"{sorted(self.cost)}"
            )
        if self.elasticity is not None and self.key_resource is None:
            raise ValueError("elasticity requires a key_resource")

    # -- paper Eq. 1 -------------------------------------------------------
    def get_dur(self, m: Optional[int] = None) -> float:
        """Estimated execution duration with ``m`` key-resource units.

        ``a.getDur(m) = T_ori / (E(m) * m)``.  For actions without a
        profiled duration this returns NaN — the scheduler treats such
        actions as non-scalable and uses historical averages for heap
        insertion (§4.2).
        """
        if self.base_duration is None:
            return math.nan
        if m is None or self.elasticity is None or self.key_resource is None:
            return self.base_duration
        req = self.cost[self.key_resource]
        if m not in req.units:
            raise ValueError(f"{m} not a feasible unit count for {self.name}: {req.units}")
        return self.base_duration / self.elasticity.speedup(m)

    @property
    def scalable(self) -> bool:
        """Scalable := elasticity known, key resource elastic, duration known."""
        return (
            self.elasticity is not None
            and self.key_resource is not None
            and self.cost[self.key_resource].elastic
            and self.base_duration is not None
        )

    def key_units(self) -> Tuple[int, ...]:
        if self.key_resource is None:
            return (1,)
        return self.cost[self.key_resource].units

    def min_cost(self) -> Dict[str, int]:
        return {r: req.min_units for r, req in self.cost.items()}

    # -- telemetry ---------------------------------------------------------
    @property
    def queue_duration(self) -> float:
        return self.start_time - self.submit_time

    @property
    def exec_duration(self) -> float:
        return self.finish_time - self.start_time

    @property
    def act(self) -> float:
        """Action completion time = queueing + execution (paper Eq. 2)."""
        return self.finish_time - self.submit_time

    def __repr__(self) -> str:  # concise for logs
        return (
            f"Action({self.name}#{self.uid} traj={self.trajectory_id} "
            f"state={self.state.value})"
        )


# ---------------------------------------------------------------------------
# Historical-average duration registry (paper §4.2: non-scalable actions'
# durations "approximated by historical averages")
# ---------------------------------------------------------------------------


class DurationHistory:
    """EWMA of observed execution durations keyed by action name."""

    def __init__(self, alpha: float = 0.3, default: float = 1.0) -> None:
        self._alpha = alpha
        self._default = default
        self._avg: Dict[str, float] = {}

    def observe(self, name: str, duration: float) -> None:
        prev = self._avg.get(name)
        self._avg[name] = (
            duration if prev is None else self._alpha * duration + (1 - self._alpha) * prev
        )

    def estimate(self, action: Action) -> float:
        if action.base_duration is not None:
            return action.base_duration
        return self._avg.get(action.name, self._default)

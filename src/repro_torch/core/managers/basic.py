"""Basic resource manager (paper §5.1).

For resources that cannot be scaled up — website quotas, request QPS
limits — supporting two consumption patterns:

* **concurrency-based**: bounds the maximum concurrent usage;
* **quota-based**: bounds total usage within a rolling period (tokens
  refilled every ``period_s`` of the governing clock).

Both prevent the contention / rate-limit violations that cause the
baseline's API failures and retries (§6.2, DeepSearch).
"""

from __future__ import annotations

import math
from typing import Optional

from repro_torch.core.action import Action
from repro_torch.core.cluster import ApiResourceSpec
from repro_torch.core.managers.base import Allocation, ResourceManager
from repro_torch.core.simulator import Clock, FrozenClock


class BasicResourceManager(ResourceManager):
    wire_impl = "api"

    def __init__(self, spec: ApiResourceSpec, clock: Clock) -> None:
        self.spec = spec
        self.mode = spec.mode
        self._clock = clock
        if self.mode == "concurrency":
            super().__init__(spec.name, spec.max_concurrency)
        elif self.mode == "quota":
            super().__init__(spec.name, spec.quota)
            self._period_start = clock.now()
            self._tokens = spec.quota
        else:
            raise ValueError(f"unknown mode {spec.mode!r}")

    # -- quota refill -------------------------------------------------------
    def _refill(self) -> None:
        now = self._clock.now()
        periods = math.floor((now - self._period_start) / self.spec.period_s)
        if periods > 0:
            self._period_start += periods * self.spec.period_s
            self._tokens = self.spec.quota

    @property
    def available(self) -> int:
        if self.mode == "quota":
            self._refill()
            # quota consumption is additionally bounded by concurrency of
            # in-flight requests only through tokens, so availability is
            # remaining tokens.
            return self._tokens
        return super().available

    # NOTE on the inherited dp_cache_key: it reads ``available``, which
    # for the quota mode re-runs _refill against the governing clock, so
    # the key reflects the token count AT THIS INSTANT — a refill
    # between rounds rotates the key, keeping cached DP results and
    # dense transition tables sound even though this manager's state
    # moves with time rather than with allocate/release alone.

    def try_allocate(self, action: Action, units: int) -> Optional[Allocation]:
        if self.mode == "quota":
            self._refill()
            if units > self._tokens:
                return None
            self._tokens -= units
            # occupancy is tracked separately from tokens: the occupancy
            # invariant (task_usage sums to held units) must hold even
            # though availability is the token count, not free slots
            self._in_use += units
            return Allocation(self.rtype, units, detail={"mode": "quota"})
        return super().try_allocate(action, units)

    def release(self, action: Action, allocation: Allocation) -> None:
        if self.mode == "quota":
            # tokens are consumed, not returned — refill restores them —
            # but the units are no longer *occupied* by a running action
            self._in_use -= allocation.units
            assert self._in_use >= 0, f"{self.rtype}: negative occupancy"
            return
        super().release(action, allocation)

    def release_unlaunched(self, action: Action, allocation: Allocation) -> None:
        """Rollback of an acquisition whose action never started (partial
        multi-resource failure, sharded commit conflict): the API call
        was never made, so the tokens are REFUNDED — the plain release
        path would silently burn quota for work that never ran."""
        if self.mode == "quota":
            self._in_use -= allocation.units
            assert self._in_use >= 0, f"{self.rtype}: negative occupancy"
            self._tokens = min(self.spec.quota, self._tokens + allocation.units)
            return
        super().release(action, allocation)

    def time_to_next_refill(self) -> float:
        """Seconds until the next quota refill (inf for concurrency
        mode) — the orchestrator's post-round refill wake reads this."""
        if self.mode != "quota":
            return math.inf
        now = self._clock.now()
        return self._period_start + self.spec.period_s - now

    # ------------------------------------------------------------------
    # wire snapshots (see the ResourceManager base contract)
    # ------------------------------------------------------------------
    def snapshot_state(self) -> dict:
        """Wire twin of ``snapshot()``: spec + token/occupancy state,
        with the quota refill settled at the governing clock's current
        instant so the remote side can pin its clock there
        (:class:`~repro_torch.core.simulator.FrozenClock`) and read the same
        ``available`` the in-process snapshot would."""
        if self.mode == "quota":
            self._refill()
        state = {
            "spec": {
                "name": self.spec.name,
                "mode": self.spec.mode,
                "max_concurrency": self.spec.max_concurrency,
                "quota": self.spec.quota,
                "period_s": self.spec.period_s,
            },
            "now": self._clock.now(),
            "in_use": self._in_use,
            "task_use": dict(self._task_use),
        }
        if self.mode == "quota":
            state["tokens"] = self._tokens
            state["period_start"] = self._period_start
        return state

    @classmethod
    def restore_snapshot(cls, state: dict) -> "BasicResourceManager":
        spec = ApiResourceSpec(
            name=str(state["spec"]["name"]),
            mode=str(state["spec"]["mode"]),
            max_concurrency=int(state["spec"]["max_concurrency"]),
            quota=int(state["spec"]["quota"]),
            period_s=float(state["spec"]["period_s"]),
        )
        m = BasicResourceManager(spec, FrozenClock(float(state.get("now", 0.0))))
        if m.mode == "quota":
            m._tokens = int(state.get("tokens", spec.quota))
            m._period_start = float(state.get("period_start", 0.0))
        m._in_use = int(state.get("in_use", 0))
        m._task_use = {str(k): int(v) for k, v in state.get("task_use", {}).items()}
        return m

    def apply_state(self, state: dict) -> bool:
        """In-place refresh of a restored replica (base contract).  The
        pinned :class:`~repro_torch.core.simulator.FrozenClock` is re-pinned at
        the new snapshot instant — the state dict arrives refill-settled
        at that instant, so the first ``available`` read after a True
        return is a no-op refill and reads exactly the settled tokens."""
        spec = state.get("spec", {})
        if (
            self.spec.name != str(spec.get("name"))
            or self.spec.mode != str(spec.get("mode"))
            or self.spec.max_concurrency != int(spec.get("max_concurrency", -1))
            or self.spec.quota != int(spec.get("quota", -1))
            or self.spec.period_s != float(spec.get("period_s", -1.0))
        ):
            return False
        if not super().apply_state(
            {"rtype": self.rtype, "capacity": self.capacity, **state}
        ):
            return False
        self._clock = FrozenClock(float(state.get("now", 0.0)))
        if self.mode == "quota":
            self._tokens = int(state.get("tokens", self.spec.quota))
            self._period_start = float(state.get("period_start", 0.0))
        return True

"""ARL-Tangram system facade (paper §3).

The standardized execution cycle:

1. **Action submission** — the RL framework (or a workload generator)
   calls :meth:`Tangram.submit`; the action enters the unified queue.
2. **Unified formulation & queuing** — actions arrive already normalized
   (:mod:`repro_torch.core.action`); FCFS order is their submission order.
3. **Elastic scheduling** — every submission/completion event triggers a
   scheduling round (:mod:`repro_torch.core.scheduler`) against live manager
   state.
4. **Action execution** — selected actions acquire *all* their
   vectorized resources (rollback on partial failure), run for
   ``duration(units) + system overhead``, then
5. **Transmit & observation** — resources are released, telemetry and
   duration history are updated, the action's future resolves, and the
   next round fires.

Since the event-driven refactor the mechanics live in
:class:`repro_torch.core.orchestrator.Orchestrator` (partitioned queues,
coalesced rounds, dirty tracking, the action lifecycle); ``Tangram``
is the paper-facing facade that wires an
:class:`~repro_torch.core.scheduler.ElasticScheduler` policy in by default
and keeps the historical ``scheduler`` attribute name.  The facade is
clock-agnostic: driven by a DES :class:`EventLoop` for the benchmarks,
or stepped with real threads in live mode (examples).
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core.fairqueue import FairSharePolicy
from repro_torch.core.managers.base import ResourceManager
from repro_torch.core.orchestrator import SCHED_TICK_S, Orchestrator, SchedulingPolicy
from repro_torch.core.simulator import EventLoop

__all__ = ["Tangram", "SCHED_TICK_S"]


class Tangram(Orchestrator):
    def __init__(
        self,
        managers: Dict[str, ResourceManager],
        loop: Optional[EventLoop] = None,
        scheduler: Optional[SchedulingPolicy] = None,
        charge_real_sched_latency: bool = False,
        incremental: bool = True,
        fair_share: Optional[FairSharePolicy] = None,
        shards: Optional[int] = None,
    ) -> None:
        super().__init__(
            managers,
            loop=loop,
            policy=scheduler,
            charge_real_sched_latency=charge_real_sched_latency,
            incremental=incremental,
            fair_share=fair_share,
            shards=shards,
        )

    # historical name for the policy slot (pre-refactor callers assign a
    # configured ElasticScheduler here after construction)
    @property
    def scheduler(self) -> SchedulingPolicy:
        return self.policy

    @scheduler.setter
    def scheduler(self, policy: SchedulingPolicy) -> None:
        self.policy = policy
        if getattr(policy, "cache_dp", False) is None:
            policy.cache_dp = self.incremental
        if (
            self.fair_share is not None
            and hasattr(policy, "fair_share")
            and policy.fair_share is None
        ):
            policy.fair_share = self.fair_share

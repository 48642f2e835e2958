"""The port's copy of the control plane (``repro_torch.core``) under the
reference suite ``tests/test_orchestrator.py``, imports rewritten, each case kept.

The reference suite's own description follows.

Event-driven orchestrator: incremental-vs-full decision equivalence,
partitioned queues, dirty-tracking skips, and the stalled-launch guard."""

import random

import pytest

from repro_torch.core.action import Action, AmdahlElasticity, ResourceRequest, fixed, ranged
from repro_torch.core.baselines import FcfsPolicy, StaticDopPolicy
from repro_torch.core.cluster import ApiResourceSpec, CpuNodeSpec, GpuNodeSpec
from repro_torch.core.managers.base import ResourceManager
from repro_torch.core.managers.basic import BasicResourceManager
from repro_torch.core.managers.cpu import CpuManager
from repro_torch.core.managers.gpu import GpuManager, ServiceSpec
from repro_torch.core.orchestrator import Orchestrator, candidate_window
from repro_torch.core.scheduler import ElasticScheduler
from repro_torch.core.simulator import EventLoop


# ---------------------------------------------------------------------------
# workload / system factories (fresh managers + actions per run, so two
# orchestrator modes replay identical event traces)
# ---------------------------------------------------------------------------


def _make_system(incremental: bool, cores: int = 32, gpus: int = 1):
    loop = EventLoop()
    managers = {
        "cpu": CpuManager([CpuNodeSpec("n0", cores=cores)]),
        "gpu": GpuManager(
            [GpuNodeSpec(f"g{i}") for i in range(gpus)], [ServiceSpec("rm0", 40.0)]
        ),
        "api": BasicResourceManager(
            ApiResourceSpec("api", mode="quota", quota=4, period_s=5.0), loop.clock
        ),
    }
    return Orchestrator(managers, loop=loop, incremental=incremental)


def _submit_workload(orch: Orchestrator, seed: int, n: int = 60) -> None:
    rng = random.Random(seed)
    for i in range(n):
        kind = rng.random()
        delay = rng.uniform(0.0, 5.0)
        if kind < 0.4:
            a = Action(
                name="reward:pytest",
                cost={"cpu": ranged("cpu", 1, 8)},
                key_resource="cpu",
                elasticity=AmdahlElasticity(0.08),
                base_duration=rng.uniform(1.0, 8.0),
                trajectory_id=f"t{i}",
            )
        elif kind < 0.6:
            a = Action(
                name="tool:exec",
                cost={"cpu": fixed("cpu", rng.choice((1, 2)))},
                base_duration=rng.uniform(0.2, 2.0),
                trajectory_id=f"t{i}",
            )
        elif kind < 0.8:
            a = Action(
                name="rm:score",
                cost={"gpu": ResourceRequest("gpu", (1, 2, 4, 8))},
                key_resource="gpu",
                elasticity=AmdahlElasticity(0.15),
                base_duration=rng.uniform(0.5, 3.0),
                service="rm0",
                trajectory_id=f"t{i}",
            )
        else:
            a = Action(
                name="api:search",
                cost={"api": fixed("api")},
                base_duration=rng.uniform(0.1, 1.0),
                trajectory_id=f"t{i}",
            )
        orch.submit(a, delay=delay)


def _trace(orch: Orchestrator):
    """Observable launch/completion trace, insensitive to uid numbering."""
    return sorted(
        (r.name, r.trajectory_id, round(r.submit, 9), round(r.start, 9),
         round(r.finish, 9), tuple(sorted(r.units.items())), r.failed)
        for r in orch.telemetry.records
    )


# ---------------------------------------------------------------------------
# incremental == full rescheduling
# ---------------------------------------------------------------------------


class TestIncrementalEquivalence:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6, 7])
    def test_same_decisions_as_full_reschedule(self, seed):
        """Dirty-tracked incremental rounds (partition skips + admission
        cursor + DP memo) must launch exactly what rescheduling every
        partition from scratch with the seed O(n^2) window would."""
        inc = _make_system(incremental=True)
        full = _make_system(incremental=False)
        _submit_workload(inc, seed)
        _submit_workload(full, seed)
        inc.run()
        full.run()
        assert len(inc.telemetry.records) == 60
        assert _trace(inc) == _trace(full)
        assert inc.queue_depth() == 0 and inc.in_flight() == 0

    def test_identical_queue_state_single_round(self):
        """Same queue, same managers: one coalesced round produces the
        same decisions in both modes (unit-level equivalence)."""
        for seed in range(4):
            inc = _make_system(incremental=True)
            full = _make_system(incremental=False)
            rng_actions = lambda: None  # noqa: E731 - readability only
            for orch in (inc, full):
                rng = random.Random(seed + 100)
                for i in range(24):
                    orch.submit(
                        Action(
                            name=f"a{i}",
                            cost={"cpu": ranged("cpu", 1, 8)},
                            key_resource="cpu",
                            elasticity=AmdahlElasticity(0.1),
                            base_duration=rng.uniform(1.0, 20.0),
                            trajectory_id=f"t{i}",
                        )
                    )
                orch.run(until=0.0)  # exactly the coalesced first round
            started_inc = sorted(
                (a.name, a.state.value) for a in inc._executing.values()
            )
            started_full = sorted(
                (a.name, a.state.value) for a in full._executing.values()
            )
            assert started_inc == started_full

    def test_dp_cache_reuses_arrangements(self):
        orch = _make_system(incremental=True)
        _submit_workload(orch, seed=9, n=80)
        orch.run()
        sched = orch.policy
        assert sched.dp_cache_hits > 0  # steady churn re-sees group states

    def test_incremental_skips_partitions(self):
        """A cpu-only event stream must not re-run the api/gpu partitions."""
        inc = _make_system(incremental=True)
        full = _make_system(incremental=False)
        for orch in (inc, full):
            for i in range(40):
                orch.submit(
                    Action(
                        name="tool",
                        cost={"cpu": fixed("cpu", 8)},
                        base_duration=1.0,
                        trajectory_id=f"t{i}",
                    ),
                    delay=0.01 * i,
                )
            # one queued api action that never becomes admissible mid-churn
            orch.submit(
                Action(name="api:q", cost={"api": fixed("api", 4)},
                       base_duration=0.1, trajectory_id="api0"),
                delay=0.0,
            )
            orch.run()
        assert _trace(inc) == _trace(full)
        assert inc.stats["partition_runs"] < full.stats["partition_runs"]


# ---------------------------------------------------------------------------
# queues, window, policies
# ---------------------------------------------------------------------------


class TestPartitionedQueues:
    def test_partitions_do_not_block_each_other(self):
        """An inadmissible cpu head must not starve gpu/api work (the seed
        global FCFS window would)."""
        orch = _make_system(incremental=True, cores=4)
        blocked = Action(
            name="big", cost={"cpu": fixed("cpu", 64)}, base_duration=1.0,
            trajectory_id="tb",
        )
        orch.submit(blocked)
        done = orch.submit(
            Action(name="api:q", cost={"api": fixed("api")}, base_duration=0.5,
                   trajectory_id="ta"),
        )
        orch.run(until=10.0)
        assert done.done()  # api partition progressed independently

    def test_candidate_window_matches_full_rescan(self):
        """Incremental admission cursor == per-prefix can_accommodate."""
        rng = random.Random(4)
        managers = {"cpu": ResourceManager("cpu", 13)}
        waiting = [
            Action(name=f"a{i}", cost={"cpu": fixed("cpu", rng.randint(1, 5))},
                   trajectory_id=f"t{i}")
            for i in range(12)
        ]
        fast = candidate_window(waiting, managers, limit=128)
        # reference: the seed scan
        best = 0
        for i in range(1, len(waiting) + 1):
            if managers["cpu"].can_accommodate(waiting[:i]):
                best = i
            else:
                break
        assert [a.uid for a in fast] == [a.uid for a in waiting[:best]]

    def test_fcfs_policy_runs_min_units(self):
        loop = EventLoop()
        orch = Orchestrator(
            {"cpu": CpuManager([CpuNodeSpec("n0", cores=16)])},
            loop=loop,
            policy=FcfsPolicy(),
        )
        futs = [
            orch.submit(
                Action(
                    name=f"a{i}",
                    cost={"cpu": ranged("cpu", 1, 8)},
                    key_resource="cpu",
                    elasticity=AmdahlElasticity(0.05),
                    base_duration=4.0,
                    trajectory_id=f"t{i}",
                )
            )
            for i in range(4)
        ]
        orch.run()
        assert all(f.done() for f in futs)
        assert all(r.units["cpu"] == 1 for r in orch.telemetry.records)

    def test_static_dop_policy_pins_units(self):
        loop = EventLoop()
        orch = Orchestrator(
            {"cpu": CpuManager([CpuNodeSpec("n0", cores=16)])},
            loop=loop,
            policy=StaticDopPolicy(dop=4),
        )
        for i in range(3):
            orch.submit(
                Action(
                    name=f"a{i}",
                    cost={"cpu": ranged("cpu", 1, 8)},
                    key_resource="cpu",
                    elasticity=AmdahlElasticity(0.05),
                    base_duration=4.0,
                    trajectory_id=f"t{i}",
                )
            )
        orch.run()
        assert all(r.units["cpu"] == 4 for r in orch.telemetry.records)

    def test_elastic_policy_beats_fcfs_on_mean_act(self):
        """The pluggable-policy seam: same orchestrator, same workload,
        elastic allocation must not lose to rigid FCFS."""

        def run(policy):
            loop = EventLoop()
            orch = Orchestrator(
                {"cpu": CpuManager([CpuNodeSpec("n0", cores=32)])},
                loop=loop, policy=policy,
            )
            rng = random.Random(7)
            for i in range(24):
                orch.submit(
                    Action(
                        name="r",
                        cost={"cpu": ranged("cpu", 1, 8)},
                        key_resource="cpu",
                        elasticity=AmdahlElasticity(0.05),
                        base_duration=rng.uniform(2.0, 10.0),
                        trajectory_id=f"t{i}",
                    ),
                    delay=rng.uniform(0, 3.0),
                )
            orch.run()
            return orch.telemetry.mean_act()

        assert run(ElasticScheduler()) <= run(FcfsPolicy()) + 1e-9


# ---------------------------------------------------------------------------
# stalled-launch guard (the seed bug: a failed try_allocate left the
# action QUEUED with no guaranteed re-tick unless a refill manager existed)
# ---------------------------------------------------------------------------


class _FlakyManager(ResourceManager):
    """Refuses the first ``fail_n`` allocations despite having capacity —
    models placement-level failures the admission test cannot see."""

    def __init__(self, rtype, capacity, fail_n):
        super().__init__(rtype, capacity)
        self.fail_n = fail_n

    def try_allocate(self, action, units):
        if self.fail_n > 0:
            self.fail_n -= 1
            return None
        return super().try_allocate(action, units)


class TestStalledLaunchGuard:
    def test_failed_launch_retries_without_refill_or_inflight(self):
        loop = EventLoop()
        orch = Orchestrator({"cpu": _FlakyManager("cpu", 8, fail_n=2)}, loop=loop)
        fut = orch.submit(
            Action(name="a", cost={"cpu": fixed("cpu", 2)}, base_duration=1.0,
                   trajectory_id="t0")
        )
        orch.run()
        assert fut.done()
        assert fut.result() == pytest.approx(1.0)
        assert orch.stats["launch_failures"] >= 1

    def test_unschedulable_queue_quiesces(self):
        """An action that can never fit must not spin the event loop."""
        loop = EventLoop()
        orch = Orchestrator({"cpu": ResourceManager("cpu", 4)}, loop=loop)
        orch.submit(
            Action(name="too-big", cost={"cpu": fixed("cpu", 64)},
                   base_duration=1.0, trajectory_id="t0")
        )
        end = orch.run()  # must terminate
        assert orch.queue_depth() == 1
        assert end < 1.0

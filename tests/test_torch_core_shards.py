"""The port's copy of the control plane (``repro_torch.core``) under the
reference suite ``tests/test_shards.py``, imports rewritten, each case kept.

The reference suite's own description follows.

Sharded plan/commit scheduling rounds: launch-trace equivalence with
the serial round loop, commit-phase conflict convergence, manager
snapshot isolation, and the occupancy invariant under cancel/timeout
storms."""

import math
import random

import pytest

from repro_torch.core.action import Action, AmdahlElasticity, ResourceRequest, fixed, ranged
from repro_torch.core.cluster import ApiResourceSpec, CpuNodeSpec, GpuNodeSpec
from repro_torch.core.fairqueue import FairSharePolicy
from repro_torch.core.managers.base import ResourceManager
from repro_torch.core.managers.basic import BasicResourceManager
from repro_torch.core.managers.cpu import CpuManager
from repro_torch.core.managers.gpu import GpuManager, ServiceSpec
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.shards import RoundExecutor, SnapshotMap
from repro_torch.core.telemetry import decision_trace
from repro_torch.core.simulator import EventLoop


# ---------------------------------------------------------------------------
# workload / system factories (fresh managers + actions per run so every
# mode replays an identical event trace)
# ---------------------------------------------------------------------------


def _make_system(shards, incremental=True, fair=False, cores=32, **kw):
    loop = EventLoop()
    managers = {
        "cpu": CpuManager([CpuNodeSpec("n0", cores=cores)]),
        "gpu": GpuManager([GpuNodeSpec("g0")], [ServiceSpec("rm0", 40.0)]),
        "api": BasicResourceManager(
            ApiResourceSpec("api", mode="quota", quota=4, period_s=5.0), loop.clock
        ),
    }
    fs = FairSharePolicy(weights={"heavy": 2.0, "light": 1.0}) if fair else None
    return Orchestrator(
        managers, loop=loop, incremental=incremental, fair_share=fs,
        shards=shards, **kw,
    )


def _submit_workload(orch, seed, tasks=("task0",), n=60):
    rng = random.Random(seed)
    for i in range(n):
        task = tasks[i % len(tasks)]
        kind = rng.random()
        delay = rng.uniform(0.0, 5.0)
        if kind < 0.4:
            a = Action(
                name="reward", cost={"cpu": ranged("cpu", 1, 8)}, key_resource="cpu",
                elasticity=AmdahlElasticity(0.08), base_duration=rng.uniform(1, 8),
                task_id=task, trajectory_id=f"{task}-{i}",
            )
        elif kind < 0.6:
            a = Action(
                name="tool", cost={"cpu": fixed("cpu", rng.choice((1, 2)))},
                base_duration=rng.uniform(0.2, 2.0), task_id=task,
                trajectory_id=f"{task}-{i}",
            )
        elif kind < 0.8:
            a = Action(
                name="rm:score", cost={"gpu": ResourceRequest("gpu", (1, 2, 4, 8))},
                key_resource="gpu", elasticity=AmdahlElasticity(0.15),
                base_duration=rng.uniform(0.5, 3.0), service="rm0", task_id=task,
                trajectory_id=f"{task}-{i}",
            )
        else:
            a = Action(
                name="api:q", cost={"api": fixed("api")},
                base_duration=rng.uniform(0.1, 1.0), task_id=task,
                trajectory_id=f"{task}-{i}",
            )
        orch.submit(a, delay=delay)


def _trace(orch):
    return decision_trace(orch.telemetry.records)


def _check_all_occupancy(orch):
    for m in orch.managers.values():
        m.check_occupancy()


# ---------------------------------------------------------------------------
# launch-trace equivalence: serial == shards=1 == shards=4 on the
# conflict-free workloads (every action touches one resource type)
# ---------------------------------------------------------------------------


class TestShardEquivalence:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6, 7])
    def test_serial_vs_sharded_trace_identity(self, seed):
        """shards=1 and shards=4 must launch exactly what the serial
        round loop launches — plan-over-snapshot + serialized commit is
        a pure refactor on conflict-free workloads."""
        traces = {}
        for shards in (None, 1, 4):
            orch = _make_system(shards)
            _submit_workload(orch, seed)
            orch.run()
            traces[shards] = _trace(orch)
            assert orch.queue_depth() == 0 and orch.in_flight() == 0
            _check_all_occupancy(orch)
        assert traces[None] == traces[1], f"seed {seed}: shards=1 diverged"
        assert traces[None] == traces[4], f"seed {seed}: shards=4 diverged"

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_sharded_full_reschedule_equivalence(self, seed):
        """The plan/commit engine composes with incremental=False (every
        partition dirty, the policy's own window scan)."""
        serial = _make_system(None, incremental=False)
        sharded = _make_system(4, incremental=False)
        _submit_workload(serial, seed)
        _submit_workload(sharded, seed)
        serial.run()
        sharded.run()
        assert _trace(serial) == _trace(sharded)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_sharded_fairness_equivalence(self, seed):
        """Multi-tenant WFQ queues drain identically under the sharded
        engine (sub-queues never straddle shards)."""
        tasks = ("heavy", "light")
        serial = _make_system(None, fair=True)
        sharded = _make_system(4, fair=True)
        _submit_workload(serial, seed, tasks=tasks)
        _submit_workload(sharded, seed, tasks=tasks)
        serial.run()
        sharded.run()
        assert _trace(serial) == _trace(sharded)
        assert sharded.queue_depth() == 0 and sharded.in_flight() == 0

    def test_thread_pool_plans_match_inline(self):
        """plan_mode='threads' dispatches shards to a real pool; plans
        are deterministic, so the trace matches the inline mode."""
        inline = _make_system(4, plan_mode="inline")
        threaded = _make_system(4, plan_mode="threads")
        _submit_workload(inline, seed=11)
        _submit_workload(threaded, seed=11)
        inline.run()
        threaded.run()
        assert _trace(inline) == _trace(threaded)

    def test_sharded_rounds_actually_engage(self):
        """A coalesced multi-partition round must go through the plan
        pool, not the serial fallback."""
        orch = _make_system(4)
        _submit_workload(orch, seed=3)
        orch.run()
        assert orch.stats["sharded_rounds"] > 0
        summary = orch.telemetry.shard_summary()
        assert summary["shards"] >= 2
        assert summary["plan_total_s"] > 0.0

    def test_shard_assignment_is_deterministic_striping(self):
        orch = _make_system(4)
        ex = orch._executor
        assert isinstance(ex, RoundExecutor)
        keys = ["e", "a", "c", "b", "d"]
        groups = ex.assign(keys)
        assert groups == [["a", "e"], ["b"], ["c"], ["d"]]
        # whole partitions only, every key exactly once
        flat = sorted(k for g in groups for k in g)
        assert flat == sorted(keys)
        assert ex.assign(keys) == groups  # stable

    def test_invalid_shard_config_rejected(self):
        with pytest.raises(ValueError):
            _make_system(0)
        with pytest.raises(ValueError):
            _make_system(2, plan_mode="quantum")


# ---------------------------------------------------------------------------
# forced commit-phase conflicts: two partitions' plans claim the same
# shared resource off the same snapshot; the commit must re-dirty the
# loser and converge with no lost or double-launched action
# ---------------------------------------------------------------------------


class TestCommitConflicts:
    def _conflict_system(self, shards):
        loop = EventLoop()
        managers = {
            "a": ResourceManager("a", 4),
            "b": ResourceManager("b", 4),
            "shared": ResourceManager("shared", 2),
        }
        return Orchestrator(managers, loop=loop, shards=shards)

    def _submit_contenders(self, orch, n=6):
        futs = []
        for i in range(n):
            part = "a" if i % 2 == 0 else "b"
            futs.append(
                orch.submit(
                    Action(
                        name=f"{part}{i}",
                        cost={part: fixed(part, 1), "shared": fixed("shared", 2)},
                        key_resource=part,
                        base_duration=1.0,
                        trajectory_id=f"t{i}",
                    )
                )
            )
        return futs

    def test_conflicts_converge_without_loss_or_double_launch(self):
        orch = self._conflict_system(shards=2)
        futs = self._submit_contenders(orch)
        orch.run()
        # both partitions planned 'shared' off the same snapshot: only
        # one commit fits, the other must have been refused and retried
        assert orch.telemetry.commit_conflicts > 0
        assert all(f.done() for f in futs)  # no lost actions
        records = [r for r in orch.telemetry.records if not r.failed]
        assert len(records) == 6
        # no double launch: every trajectory completes exactly once
        assert len({r.trajectory_id for r in records}) == 6
        assert orch.queue_depth() == 0 and orch.in_flight() == 0
        _check_all_occupancy(orch)

    def test_serial_never_conflicts_on_same_workload(self):
        """The serial loop plans against live state, so the same
        workload produces zero commit conflicts — the conflicts above
        are purely a property of snapshot planning."""
        orch = self._conflict_system(shards=None)
        futs = self._submit_contenders(orch)
        orch.run()
        assert orch.telemetry.commit_conflicts == 0
        assert all(f.done() for f in futs)


# ---------------------------------------------------------------------------
# manager snapshots: plans must not touch live state
# ---------------------------------------------------------------------------


class TestSnapshots:
    def test_base_snapshot_isolates_usage_and_admission(self):
        m = ResourceManager("r", 8)
        m.note_allocated("t", 3)
        snap = m.snapshot()
        snap.note_allocated("t", 2)  # a plan-side what-if
        assert m.task_usage() == {"t": 3}
        cur = snap.begin_admission()
        assert snap.admit_one(cur, Action(name="a", cost={"r": fixed("r", 8)},
                                          trajectory_id="t0"))
        assert m.available == 8

    def test_cpu_snapshot_binding_does_not_leak(self):
        m = CpuManager([CpuNodeSpec("n0", cores=8, memory_gb=16.0)])
        snap = m.snapshot()
        a = Action(name="a", cost={"cpu": fixed("cpu", 2)}, trajectory_id="tX")
        snap.partition([a])  # binds tX on the SNAPSHOT only
        assert snap.node_of("tX") == "n0"
        assert m.node_of("tX") is None
        assert m.nodes["n0"].free_mem_gb == pytest.approx(16.0)

    def test_gpu_snapshot_allocator_isolated(self):
        m = GpuManager([GpuNodeSpec("g0")], [ServiceSpec("rm0", 40.0)])
        snap = m.snapshot()
        got = snap.allocators["g0"].allocate(4, None, 0.0)
        assert got is not None
        assert snap.available == m.available - 4
        assert m.available == 8
        m.check_occupancy()

    def test_quota_snapshot_tokens_isolated(self):
        loop = EventLoop()
        m = BasicResourceManager(
            ApiResourceSpec("api", mode="quota", quota=4, period_s=5.0), loop.clock
        )
        snap = m.snapshot()
        a = Action(name="a", cost={"api": fixed("api")}, trajectory_id="t0")
        assert snap.try_allocate(a, 2) is not None  # plan-side what-if only
        assert m.available == 4

    def test_snapshot_map_is_lazy(self):
        taken = []

        class Spy(ResourceManager):
            def snapshot(self):
                taken.append(self.rtype)
                return super().snapshot()

        managers = {"a": Spy("a", 4), "b": Spy("b", 4)}
        view = SnapshotMap(managers)
        assert "a" in view and "missing" not in view
        assert taken == []
        _ = view["a"]
        _ = view.get("a")  # cached — no second snapshot
        assert taken == ["a"]
        assert view.get("missing", None) is None
        assert taken == ["a"]


# ---------------------------------------------------------------------------
# occupancy invariant under randomized cancel/timeout storms (the
# note_released audit), plus the unlaunched-rollback token refund
# ---------------------------------------------------------------------------


class _FlakyManager(ResourceManager):
    """Admits but refuses the first ``fail_n`` placements — forces the
    partial-acquisition rollback path."""

    def __init__(self, rtype, capacity, fail_n):
        super().__init__(rtype, capacity)
        self.fail_n = fail_n

    def try_allocate(self, action, units):
        if self.fail_n > 0:
            self.fail_n -= 1
            return None
        return super().try_allocate(action, units)


class TestOccupancyInvariant:
    @pytest.mark.parametrize("shards", [None, 4])
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_cancel_timeout_storm_leaks_nothing(self, shards, seed):
        """Randomized cancels + tight timeouts with retries: after the
        storm drains, every manager's task_usage ledger must sum exactly
        to its held units (zero, here) — the invariant that catches any
        release path skipping note_released."""
        orch = _make_system(shards, cores=8)
        rng = random.Random(seed)
        actions, futs = [], []
        for i in range(40):
            kind = rng.random()
            if kind < 0.5:
                a = Action(
                    name="reward", cost={"cpu": ranged("cpu", 1, 4)},
                    key_resource="cpu", elasticity=AmdahlElasticity(0.1),
                    base_duration=rng.uniform(0.5, 4.0),
                    timeout_s=rng.choice([0.4, 1.5, None]),
                    max_retries=rng.choice([0, 1, 2]),
                    task_id=f"t{i % 3}", trajectory_id=f"t{i}",
                )
            elif kind < 0.8:
                a = Action(
                    name="rm:score", cost={"gpu": ResourceRequest("gpu", (1, 2))},
                    key_resource="gpu", elasticity=AmdahlElasticity(0.15),
                    base_duration=rng.uniform(0.5, 2.0), service="rm0",
                    timeout_s=rng.choice([0.5, None]), max_retries=1,
                    task_id=f"t{i % 3}", trajectory_id=f"t{i}",
                )
            else:
                a = Action(
                    name="api:q", cost={"api": fixed("api")},
                    base_duration=rng.uniform(0.1, 1.0),
                    task_id=f"t{i % 3}", trajectory_id=f"t{i}",
                )
            actions.append(a)
            futs.append(orch.submit(a, delay=rng.uniform(0.0, 3.0)))
        # storm of cancellations at random mid-run instants
        for a in rng.sample(actions, 12):
            orch.loop.call_after(rng.uniform(0.2, 4.0), lambda a=a: orch.cancel(a))
        # and invariant probes WHILE the storm is in flight
        for t in (1.0, 2.5, 4.0):
            orch.loop.call_after(t, lambda: _check_all_occupancy(orch))
        orch.run()
        assert all(f.done() for f in futs)
        assert orch.in_flight() == 0
        _check_all_occupancy(orch)
        for rtype in ("cpu", "gpu", "api"):
            assert orch.managers[rtype].task_usage() == {}

    def test_unlaunched_rollback_refunds_quota_tokens(self):
        """A partial acquisition that rolls back must REFUND quota
        tokens (the call never happened); the old release path silently
        burned them — the occupancy/quota leak this PR's audit fixes."""
        loop = EventLoop()
        managers = {
            "api": BasicResourceManager(
                ApiResourceSpec("api", mode="quota", quota=4, period_s=100.0),
                loop.clock,
            ),
            "flaky": _FlakyManager("flaky", 8, fail_n=2),
        }
        orch = Orchestrator(managers, loop=loop)
        fut = orch.submit(
            Action(
                name="a",
                cost={"api": fixed("api", 3), "flaky": fixed("flaky", 2)},
                key_resource="flaky",
                base_duration=1.0,
                trajectory_id="t0",
            )
        )
        orch.run()
        assert fut.done()
        # exactly ONE successful attempt consumed tokens; both rolled-
        # back attempts refunded theirs
        assert managers["api"].available == 1
        _check_all_occupancy(orch)

    def test_quota_occupancy_tracks_in_flight(self):
        """Quota-mode managers now track occupancy separately from
        tokens: mid-flight the ledger matches held units, and release
        clears occupancy without returning tokens."""
        loop = EventLoop()
        m = BasicResourceManager(
            ApiResourceSpec("api", mode="quota", quota=4, period_s=100.0), loop.clock
        )
        orch = Orchestrator({"api": m}, loop=loop)
        orch.submit(
            Action(name="a", cost={"api": fixed("api", 2)}, base_duration=1.0,
                   trajectory_id="t0", task_id="t")
        )
        orch.run(until=0.5)
        assert m.held_units() == 2
        assert m.task_usage() == {"t": 2}
        m.check_occupancy()
        orch.run()
        assert m.held_units() == 0
        assert m.task_usage() == {}
        assert m.available == 2  # tokens stay consumed until the refill
        m.check_occupancy()


# ---------------------------------------------------------------------------
# telemetry surface
# ---------------------------------------------------------------------------


class TestShardTelemetry:
    def test_per_shard_round_stats(self):
        orch = _make_system(2)
        _submit_workload(orch, seed=5)
        orch.run()
        assert orch.telemetry.shards  # populated by the plan phase
        total_rounds = sum(s.rounds for s in orch.telemetry.shards.values())
        assert total_rounds >= orch.stats["sharded_rounds"]
        summary = orch.telemetry.shard_summary()
        assert summary["imbalance"] >= 1.0
        assert summary["plan_critical_s"] <= summary["plan_total_s"] + 1e-12
        assert not math.isnan(summary["plan_wall_s"])

    def test_serial_mode_has_no_shard_stats(self):
        orch = _make_system(None)
        _submit_workload(orch, seed=5, n=20)
        orch.run()
        assert orch.telemetry.shard_summary() == {}
        assert orch.stats["sharded_rounds"] == 0

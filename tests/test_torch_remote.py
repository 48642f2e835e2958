"""The port's copy of the control plane (``repro_torch.core``) under the
reference suite ``tests/test_remote.py``, imports rewritten, each case kept.

The reference suite's own description follows.

Out-of-process shard workers and sub-queue migration.

Equivalence rails: plan-over-wire (loopback AND real worker processes)
must launch exactly what the serial round loop launches on conflict-free
workloads; forced commit conflicts must converge over the wire; and
`TaskShard` migrate-then-merge must preserve WFQ order and virtual-clock
monotonicity."""

import math
import random

import pytest

from repro_torch.core.action import Action, AmdahlElasticity, ResourceRequest, fixed, ranged
from repro_torch.core.cluster import ApiResourceSpec, CpuNodeSpec, GpuNodeSpec
from repro_torch.core.fairqueue import FairSharePolicy, PartitionQueue
from repro_torch.core.managers.base import ResourceManager
from repro_torch.core.managers.basic import BasicResourceManager
from repro_torch.core.managers.cpu import CpuManager
from repro_torch.core.managers.gpu import GpuManager, ServiceSpec
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.remote import (
    LoopbackTransport,
    ProcessTransport,
    RemoteShardWorker,
)
from repro_torch.core import wire
from repro_torch.core.simulator import EventLoop


# ---------------------------------------------------------------------------
# workload factories (fresh managers + actions per run so every mode
# replays an identical event trace — mirrors tests/test_shards.py)
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
    return sorted(
        (r.name, r.task_id, r.trajectory_id, round(r.submit, 9), round(r.start, 9),
         round(r.finish, 9), tuple(sorted(r.units.items())), r.failed)
        for r in orch.telemetry.records
    )


def _run_mode(seed, tasks=("task0",), **kw):
    orch = _make_system(**kw)
    _submit_workload(orch, seed, tasks=tasks)
    orch.run()
    trace = _trace(orch)
    assert orch.queue_depth() == 0 and orch.in_flight() == 0
    for m in orch.managers.values():
        m.check_occupancy()
    orch.close()
    return orch, trace


# ---------------------------------------------------------------------------
# remote-plan trace identity (the acceptance rail)
# ---------------------------------------------------------------------------


class TestRemoteEquivalence:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6, 7])
    def test_remote_loopback_bit_identical_to_serial(self, seed):
        """8 seeds: plans computed through the full wire codec path must
        launch exactly what the serial loop (and in-process sharding)
        launches on conflict-free workloads."""
        _, serial = _run_mode(seed, shards=None)
        _, remote1 = _run_mode(seed, shards=1, plan_mode="remote")
        orch4, remote4 = _run_mode(seed, shards=4, plan_mode="remote")
        assert remote1 == serial, f"seed {seed}: remote shards=1 diverged"
        assert remote4 == serial, f"seed {seed}: remote shards=4 diverged"
        # the wire was actually exercised (multi-partition rounds exist)
        if orch4.stats["sharded_rounds"]:
            assert orch4.telemetry.wire_rounds > 0
            assert orch4.telemetry.wire_bytes > 0

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_remote_fairness_equivalence(self, seed):
        """Multi-tenant WFQ queues drain identically when plans cross
        the wire (weights, quota budgeting, history all serialize)."""
        tasks = ("heavy", "light")
        _, serial = _run_mode(seed, tasks=tasks, shards=None, fair=True)
        _, remote = _run_mode(seed, tasks=tasks, shards=4, plan_mode="remote",
                              fair=True)
        assert remote == serial

    @pytest.mark.parametrize("seed", [0, 1])
    def test_remote_full_reschedule_equivalence(self, seed):
        _, serial = _run_mode(seed, shards=None, incremental=False)
        _, remote = _run_mode(seed, shards=4, plan_mode="remote",
                              incremental=False)
        assert remote == serial

    def test_remote_serialization_accounted_separately(self):
        """Wire overhead lands in Telemetry.wire_*, never in the modeled
        critical-path plan cost (which is worker-measured arrange time)."""
        orch, _ = _run_mode(3, shards=4, plan_mode="remote")
        t = orch.telemetry
        if not t.wire_rounds:
            pytest.skip("workload produced no multi-partition rounds")
        summary = t.wire_summary()
        assert summary["bytes"] > 0
        assert summary["encode_s"] > 0 and summary["decode_s"] > 0
        # the critical path is plan compute only; wire cost is additive
        # and visible on its own
        assert t.plan_critical_s <= t.plan_wall_s + 1e-9
        assert t.wire_encode_s + t.wire_decode_s <= t.plan_wall_s + 1e-9


class TestProcessTransport:
    def test_real_worker_processes_bit_identical(self):
        """The plan phase in actual OS processes: same trace, clean
        shutdown."""
        _, serial = _run_mode(2, shards=None)
        orch = _make_system(2, plan_mode="remote", transport="process")
        _submit_workload(orch, 2)
        orch.run()
        assert _trace(orch) == serial
        orch.close()
        orch.close()  # idempotent

    def test_unknown_transport_rejected(self):
        with pytest.raises(ValueError, match="unknown transport"):
            _make_system(2, plan_mode="remote", transport="carrier-pigeon")


# ---------------------------------------------------------------------------
# forced commit conflicts over the wire
# ---------------------------------------------------------------------------


class TestRemoteConflicts:
    def _conflict_system(self, shards, **kw):
        loop = EventLoop()
        managers = {
            "a": ResourceManager("a", 4),
            "b": ResourceManager("b", 4),
            "shared": ResourceManager("shared", 2),
        }
        return Orchestrator(managers, loop=loop, shards=shards, **kw)

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

    def test_conflicts_converge_over_the_wire(self):
        """Two shards' remote plans claim the same shared pool off the
        same snapshot; the live commit refuses one, rolls it back, and
        the retry rail converges — no lost or double-launched action."""
        orch = self._conflict_system(shards=2, plan_mode="remote")
        futs = self._submit_contenders(orch)
        orch.run()
        assert orch.telemetry.commit_conflicts > 0
        assert all(f.done() for f in futs)
        records = [r for r in orch.telemetry.records if not r.failed]
        assert len(records) == 6
        assert len({r.trajectory_id for r in records}) == 6
        assert orch.queue_depth() == 0 and orch.in_flight() == 0
        for m in orch.managers.values():
            m.check_occupancy()
        orch.close()

    def test_conflict_trace_matches_in_process_sharding(self):
        """Remote and in-process sharding resolve the SAME conflicts the
        same way (the commit order is the global sorted partition walk
        either way)."""
        a = self._conflict_system(shards=2)
        b = self._conflict_system(shards=2, plan_mode="remote")
        self._submit_contenders(a)
        self._submit_contenders(b)
        a.run()
        b.run()
        assert _trace(a) == _trace(b)
        b.close()


# ---------------------------------------------------------------------------
# the worker protocol itself (deltas, errors)
# ---------------------------------------------------------------------------


class TestWorkerProtocol:
    def _request(self, policy=True, snapshots=None, waiting=(), now=0.0):
        from repro_torch.core.scheduler import ElasticScheduler

        return wire.envelope(
            "plan_request",
            {
                "shard": 0,
                "now": now,
                "incremental": True,
                "policy": wire.encode_policy(ElasticScheduler()) if policy else None,
                "fair_share": None,
                "history": {"avg": {}},
                "snapshots": snapshots or {},
                "executing": [],
                "partitions": [
                    {"part": "r", "waiting": [wire.encode_action(a) for a in waiting]}
                ],
            },
        )

    def test_snapshot_delta_refs_replan_identically(self):
        m = ResourceManager("r", 8)
        snap = wire.encode_snapshot(m)
        fp = wire.fingerprint(snap)
        a = Action(name="w", cost={"r": fixed("r", 2)}, trajectory_id="t0",
                   base_duration=1.0)
        worker = RemoteShardWorker()
        full = wire.loads(worker.handle(wire.dumps(
            self._request(snapshots={"r": snap}, waiting=[a])
        )))
        ref = wire.loads(worker.handle(wire.dumps(
            self._request(policy=False, snapshots={"r": {"ref": fp}}, waiting=[a])
        )))
        assert full["kind"] == ref["kind"] == "plan_response"
        strip = lambda p: [
            {k: v for k, v in d.items() if k != "wall_s"} for d in p["plans"]
        ]
        assert strip(full) == strip(ref)

    def test_stale_snapshot_ref_is_protocol_error(self):
        worker = RemoteShardWorker()
        resp = wire.loads(worker.handle(wire.dumps(
            self._request(snapshots={"r": {"ref": "deadbeef"}})
        )))
        assert resp["kind"] == "error"
        assert "does not match cached state" in resp["error"]

    def test_plan_before_policy_is_protocol_error(self):
        worker = RemoteShardWorker()
        resp = wire.loads(worker.handle(wire.dumps(self._request(policy=False))))
        assert resp["kind"] == "error"
        assert "before any policy" in resp["error"]

    def test_malformed_request_returns_error_payload(self):
        """The worker must survive garbage — the transport stays up and
        the client sees a typed error, not a dead pipe."""
        worker = RemoteShardWorker()
        resp = wire.loads(worker.handle("{not json"))
        assert resp["kind"] == "error"
        resp = wire.loads(worker.handle(wire.dumps({"v": 99, "kind": "plan_request"})))
        assert resp["kind"] == "error" and "wire version" in resp["error"]

    def test_history_survives_policy_refresh(self):
        """A re-sent policy config rebuilds a fresh policy on the
        worker; an unchanged history arriving as a ref must still
        repopulate it — otherwise unprofiled actions price at the
        default and remote plans silently diverge (regression)."""
        from repro_torch.core.scheduler import ElasticScheduler

        worker = RemoteShardWorker()
        hist_payload = {"avg": {"tool:slow": 7.5}}
        hist_fp = wire.fingerprint(hist_payload)
        req = self._request(snapshots={"r": wire.encode_snapshot(
            ResourceManager("r", 8))})
        req["history"] = hist_payload
        assert wire.loads(worker.handle(wire.dumps(req)))["kind"] == "plan_response"
        assert worker._policy.history._avg == {"tool:slow": 7.5}
        # now refresh the policy (knob change) with history as a ref
        policy = ElasticScheduler(depth=3)
        req2 = self._request(snapshots={"r": {"ref": wire.fingerprint(
            wire.encode_snapshot(ResourceManager("r", 8)))}})
        req2["policy"] = wire.encode_policy(policy)
        req2["history"] = {"ref": hist_fp}
        assert wire.loads(worker.handle(wire.dumps(req2)))["kind"] == "plan_response"
        assert worker._policy.depth == 3  # fresh policy adopted...
        assert worker._policy.history._avg == {"tool:slow": 7.5}  # ...with history

    def test_codec_bill_includes_request_parse(self):
        """codec_s must cover the wire.loads of the request (the
        dominant worker-side codec cost on big payloads), not just the
        object decoding."""
        m = ResourceManager("r", 8)
        waiting = [Action(name=f"w{i}", cost={"r": fixed("r")}, task_id="t",
                          trajectory_id=f"t{i}", base_duration=1.0)
                   for i in range(50)]
        worker = RemoteShardWorker()
        resp = wire.loads(worker.handle(wire.dumps(self._request(
            snapshots={"r": wire.encode_snapshot(m)}, waiting=waiting))))
        assert resp["codec_s"] > 0

    def test_loopback_recv_without_submit_raises(self):
        with pytest.raises(RuntimeError, match="without a submitted request"):
            LoopbackTransport().recv()

    def test_process_transport_survives_error_payloads(self):
        t = ProcessTransport()
        try:
            t.submit("{not json")
            resp = wire.loads(t.recv())
            assert resp["kind"] == "error"
        finally:
            t.close()


# ---------------------------------------------------------------------------
# sub-queue migration: WFQ order + clock monotonicity, orchestration
# ---------------------------------------------------------------------------


def _tagged_queue(tasks=("mover", "stay"), per_task=3):
    q = PartitionQueue(
        fair=True,
        weight_of=lambda a: 2.0 if a.task_id == "mover" else 1.0,
        cost_of=lambda a: 1.0,
    )
    actions = []
    for i in range(per_task):
        for t in tasks:
            a = Action(name=f"{t}{i}", cost={"r": fixed("r")}, task_id=t,
                       trajectory_id=f"{t}-{i}")
            q.push(a)
            actions.append(a)
    return q, actions


class TestMigrateThenMerge:
    def test_wfq_order_preserved_across_replicas(self):
        """Detached entries keep their tags, so after merging into a
        replica that has its own backlog the GLOBAL drain order is the
        WFQ order the tags encode — migration must not reset or re-tag."""
        src, _ = _tagged_queue()
        dst = PartitionQueue(fair=True, weight_of=lambda a: 1.0,
                             cost_of=lambda a: 1.0)
        # the replica has its own tenant already queued
        local = [
            Action(name=f"local{i}", cost={"r": fixed("r")}, task_id="local",
                   trajectory_id=f"l{i}")
            for i in range(2)
        ]
        for a in local:
            dst.push(a)
        mover_order = [a.uid for a in src.ordered() if a.task_id == "mover"]
        shard = src.detach_task("mover")
        dst.merge_shard(shard)
        merged = [a.uid for a in dst.ordered() if a.task_id == "mover"]
        assert merged == mover_order  # FCFS within the task survives
        # WFQ across tasks: mover's finish chain resumed, so its future
        # arrivals are charged from the carried tag, not from zero
        a_new = Action(name="late", cost={"r": fixed("r")}, task_id="mover",
                       trajectory_id="late")
        dst.push(a_new)
        assert dst.tag_of(a_new.uid)[0] >= shard.finish_tag - 1e-12

    def test_vclock_monotone_through_detach_merge(self):
        src, actions = _tagged_queue()
        # serve a few so the source clock advances
        for a in list(src.ordered())[:3]:
            src.remove(a.uid, served=True)
        v_src = src.vtime
        shard = src.detach_task("mover")
        assert shard is not None and shard.vtime == v_src
        dst = PartitionQueue(fair=True)
        v_dst_before = dst.vtime
        dst.merge_shard(shard)
        assert dst.vtime >= max(v_dst_before, v_src)  # never backward
        # and merging BACK into the source is also monotone + lossless
        back = dst.detach_task("mover")
        src.merge_shard(back)
        assert src.vtime >= v_src
        assert {a.uid for a in src.ordered() if a.task_id == "mover"} == {
            e[1].uid for e in shard.entries
        }

    def test_detach_is_not_a_busy_period_end(self):
        """Detaching the last sub-queue empties the partition but the
        work still exists elsewhere — the clock must NOT settle (that is
        the drain rule, reserved for served work)."""
        q = PartitionQueue(fair=True, cost_of=lambda a: 5.0)
        a = Action(name="x", cost={"r": fixed("r")}, task_id="t",
                   trajectory_id="t0")
        q.push(a)
        v = q.vtime
        shard = q.detach_task("t")
        assert len(q) == 0
        assert q.vtime == v  # unchanged, no settle
        assert shard.finish_tag > 0  # the debt travels with the shard


class TestOrchestratedMigration:
    def _fleet(self, pools=2, cores=2, fair=True):
        loop = EventLoop()
        managers = {
            f"pool{k}": ResourceManager(f"pool{k}", cores) for k in range(pools)
        }
        fs = FairSharePolicy(weights={"a": 2.0, "b": 1.0}) if fair else None
        return Orchestrator(managers, loop=loop, fair_share=fs)

    def _load(self, orch, part="pool0", n=12, scalable=False):
        futs = []
        for i in range(n):
            task = "a" if i % 2 == 0 else "b"
            if scalable and i % 3 == 0:
                cost = {part: ResourceRequest(part, (1, 2))}
                kw = dict(key_resource=part, elasticity=AmdahlElasticity(0.1))
            else:
                cost, kw = {part: fixed(part, 1)}, {}
            futs.append(orch.submit(Action(
                name=f"w{i}", cost=cost, base_duration=2.0, task_id=task,
                trajectory_id=f"t{i}", **kw)))
        return futs

    def test_migrated_backlog_runs_on_the_replica(self):
        orch = self._fleet()
        futs = self._load(orch, scalable=True)
        orch.run(until=0.01)
        assert orch.in_flight() > 0
        moved = orch.migrate_task("a", "pool0", "pool1")
        assert moved > 0
        assert orch.telemetry.migrations == 1
        assert orch.telemetry.migrated_actions == moved
        assert orch.telemetry.migration_wall_s > 0
        orch.run()
        assert all(f.done() for f in futs)
        assert orch.queue_depth() == 0 and orch.in_flight() == 0
        for m in orch.managers.values():
            m.check_occupancy()
        # the moved tenant really executed on the replica pool
        pools_used = {r.units and next(iter(r.units)) for r in
                      orch.telemetry.records if r.task_id == "a"}
        assert "pool1" in pools_used

    def test_migration_waits_for_running_actions(self):
        """In-flight actions keep their src allocations; only the queued
        sub-queue moves."""
        orch = self._fleet()
        self._load(orch)
        orch.run(until=0.01)
        running_before = orch.in_flight()
        orch.migrate_task("a", "pool0", "pool1")
        assert orch.in_flight() == running_before
        orch.run()
        orch.managers["pool0"].check_occupancy()
        orch.managers["pool1"].check_occupancy()

    def test_replica_contract_enforced(self):
        """A migration that cannot land its actions in dst's partition
        is refused before any mutation."""
        loop = EventLoop()
        managers = {
            "pool0": ResourceManager("pool0", 2),
            "pool1": ResourceManager("pool1", 2),
            "aaa": ResourceManager("aaa", 2),
        }
        orch = Orchestrator(managers, loop=loop)
        with pytest.raises(ValueError, match="unknown partition"):
            orch.migrate_task("mv", "pool0", "nope")
        # key_resource=None + multi-resource cost partitions by
        # min(cost): this action lives on "aaa".  Retargeting aaa->pool1
        # would leave min(cost) = "pool0" != "pool1" — not a replica
        # move for this cost vector, so it must refuse untouched.
        for i in range(2):  # saturate "aaa" so d stays queued
            orch.submit(Action(name=f"blk{i}", cost={"aaa": fixed("aaa")},
                               base_duration=50.0, trajectory_id=f"blk{i}",
                               task_id="blocker"))
        d = Action(name="q", cost={"pool0": fixed("pool0"), "aaa": fixed("aaa")},
                   base_duration=1.0, trajectory_id="t3", task_id="mv3")
        assert d.key_resource is None
        orch.submit(d)
        orch.run(until=0.01)
        assert d.uid in orch._queues["aaa"]
        with pytest.raises(ValueError, match="not replicas"):
            orch.migrate_task("mv3", "aaa", "pool1")
        # nothing was mutated by the refusal
        assert d.cost.keys() == {"pool0", "aaa"}
        assert d.uid in orch._queues["aaa"]

    def test_rebalance_is_deterministic_and_telemetered(self):
        def build():
            orch = self._fleet(pools=2)
            self._load(orch, n=18)
            orch.run(until=0.01)
            return orch

        orch = build()
        before = {p: len(orch._queues.get(p) or ()) for p in ("pool0", "pool1")}
        gap_before = before["pool0"] - before["pool1"]
        moved = orch.rebalance(["pool0", "pool1"])
        assert moved > 0
        depths = {p: len(orch._queues.get(p) or ()) for p in ("pool0", "pool1")}
        # a whole task sub-queue moved to the idle replica and the gap
        # strictly improved (whole-sub-queue granularity bounds how even
        # it can get)
        assert abs(depths["pool0"] - depths["pool1"]) < gap_before
        assert depths["pool1"] > 0
        assert orch.telemetry.migrated_actions == moved
        # deterministic: the same state rebalances the same way
        orch2 = build()
        assert orch2.rebalance(["pool0", "pool1"]) == moved
        orch.run()
        assert orch.queue_depth() == 0

    def test_rebalance_never_inverts_the_imbalance(self):
        """The best single move is the sub-queue sized closest to half
        the gap: with backlogs {A:9, B:5} vs an idle replica it must
        move B (one migration, gap 14 -> 4), never A (which would
        invert to 5/9 and trigger churn) — regression."""
        loop = EventLoop()
        managers = {  # zero capacity: everything stays queued
            "pool0": ResourceManager("pool0", 0),
            "pool1": ResourceManager("pool1", 0),
        }
        orch = Orchestrator(managers, loop=loop)
        for i in range(9):
            orch.submit(Action(name=f"a{i}", cost={"pool0": fixed("pool0")},
                               task_id="A", trajectory_id=f"a{i}",
                               base_duration=1.0))
        for i in range(5):
            orch.submit(Action(name=f"b{i}", cost={"pool0": fixed("pool0")},
                               task_id="B", trajectory_id=f"b{i}",
                               base_duration=1.0))
        orch.run(until=0.5)
        assert len(orch._queues["pool0"]) == 14
        moved = orch.rebalance(["pool0", "pool1"])
        assert moved == 5  # B moved, A stayed
        assert orch.telemetry.migrations == 1
        assert len(orch._queues["pool0"]) == 9
        assert len(orch._queues["pool1"]) == 5

    def test_migrate_noop_cases(self):
        orch = self._fleet()
        assert orch.migrate_task("a", "pool0", "pool0") == 0
        assert orch.migrate_task("a", "pool0", "pool1") == 0  # nothing queued
        assert orch.telemetry.migrations == 0

    def test_wire_round_trip_of_live_shard(self):
        """A detached sub-queue survives the wire and merges into a
        DIFFERENT orchestrator's replica queue (the cross-process
        migration story, minus the process)."""
        orch = self._fleet()
        self._load(orch)
        orch.run(until=0.01)
        src_q = orch._queues["pool0"]
        shard = src_q.detach_task("a")
        blob = wire.dumps(wire.encode_task_shard(shard))
        other = self._fleet()
        back = wire.decode_task_shard(wire.loads(blob))
        q = other._queues.setdefault("pool0", other._make_queue("pool0"))
        q.merge_shard(back)
        assert [a.uid for a in q.ordered()] == [e[1].uid for e in shard.entries]
        assert q.vtime >= shard.vtime


# ---------------------------------------------------------------------------
# auto plan mode (measured plan-cost EWMA -> inline vs threads)
# ---------------------------------------------------------------------------


class TestAutoPlanMode:
    def test_auto_trace_identical_and_logged(self):
        serial = _make_system(None)
        _submit_workload(serial, 7)
        serial.run()
        auto = _make_system(4, plan_mode="auto")
        _submit_workload(auto, 7)
        auto.run()
        assert _trace(auto) == _trace(serial)
        if auto.stats["sharded_rounds"]:
            # every sharded round logged its decision + the driving EWMA
            assert sum(auto.telemetry.plan_mode_rounds.values()) == (
                auto.stats["sharded_rounds"]
            )
            assert auto.telemetry.plan_cost_ewma_s > 0

    def test_cheap_plans_stay_inline(self):
        auto = _make_system(4, plan_mode="auto")
        _submit_workload(auto, 7)
        auto.run()
        # DES plan costs are far under the cutover: no pool dispatch
        assert auto.telemetry.plan_mode_rounds.get("threads", 0) == 0

    def test_expensive_ewma_dispatches_to_pool(self):
        auto = _make_system(4, plan_mode="auto")
        _submit_workload(auto, 7)
        # pretend history says partitions are expensive to plan
        auto._executor.plan_cost_ewma = 1.0
        auto.run(until=6.0)
        if auto.stats["sharded_rounds"]:
            assert auto.telemetry.plan_mode_rounds.get("threads", 0) > 0
        serial = _make_system(None)
        _submit_workload(serial, 7)
        serial.run(until=6.0)
        assert _trace(auto) == _trace(serial)

    def test_ewma_tracks_measured_cost(self):
        auto = _make_system(2, plan_mode="auto")
        _submit_workload(auto, 4)
        auto.run()
        ex = auto._executor
        assert ex.plan_cost_ewma is not None and ex.plan_cost_ewma > 0
        assert math.isfinite(ex.plan_cost_ewma)


# ---------------------------------------------------------------------------
# worker-owned two-phase commit (the fused plan_commit rail)
# ---------------------------------------------------------------------------


class TestWorkerCommit:
    """The worker-owned commit engine's acceptance rails: launch traces
    bit-identical to serial and to client-serial remote across seeds,
    dependent-pass batching equivalent to sequential passes, conflicts
    resolved worker-side on the authoritative replicas, cross-owner
    footprints declined to the client-serial walk — and the commit
    phase really off the wire (zero steady-state fallbacks)."""

    @pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6, 7])
    def test_worker_commit_bit_identical_to_serial(self, seed):
        _, serial = _run_mode(seed, shards=None)
        orch, worker = _run_mode(
            seed, shards=4, plan_mode="remote", commit_mode="worker"
        )
        assert worker == serial, f"seed {seed}: worker-owned commit diverged"
        s = orch.telemetry.wire_summary()
        if orch.stats["sharded_rounds"]:
            # the fused rail really carried the rounds, and steady state
            # needed no recovery: no fallbacks, no declines, no aborts
            assert s.get("prepares", 0) > 0
            assert s.get("fallbacks", 0) == 0
            assert s.get("commit_inline_rounds", 0) == 0
            assert s.get("commit_diverged", 0) == 0
            assert s.get("commit_aborts", 0) == 0
            # every managed rtype was granted exactly once
            assert s.get("lease_grants", 0) == len(orch.managers)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_batched_passes_equal_sequential(self, seed):
        """A fused round carrying up to 8 dependent fixpoint passes
        must launch exactly what one-pass-per-wire-round launches (and
        serial): the pass boundary is an optimization, never semantics."""
        _, serial = _run_mode(seed, shards=None)
        _, batched = _run_mode(seed, shards=4, plan_mode="remote",
                               commit_mode="worker", commit_max_passes=8)
        _, sequential = _run_mode(seed, shards=4, plan_mode="remote",
                                  commit_mode="worker", commit_max_passes=1)
        assert batched == serial
        assert sequential == serial

    @pytest.mark.parametrize("seed", [0, 1])
    def test_worker_commit_fairness_equivalence(self, seed):
        tasks = ("heavy", "light")
        _, serial = _run_mode(seed, tasks=tasks, shards=None, fair=True)
        _, worker = _run_mode(seed, tasks=tasks, shards=4, plan_mode="remote",
                              commit_mode="worker", fair=True)
        assert worker == serial

    def test_commit_phase_accounting(self):
        """Fused rounds charge the modeled fleet critical path (max
        worker plan + max worker commit) to sched_wall_s; the client's
        replay is mirror maintenance recorded separately in
        commit_apply_s; commit_wall_s (the client-serial commit wall)
        stays untouched — the wire left the commit path."""
        orch, _ = _run_mode(3, shards=4, plan_mode="remote",
                            commit_mode="worker")
        t = orch.telemetry
        if not t.wire_prepares:
            pytest.skip("workload produced no fused rounds")
        assert t.commit_critical_s >= 0.0
        assert t.commit_apply_s > 0.0
        assert t.wire_commit_acks == t.wire_prepares
        assert t.commit_wall_s == 0.0

    def test_worker_mode_requires_remote_plan(self):
        with pytest.raises(ValueError, match="commit_mode"):
            _make_system(4, commit_mode="worker")  # plan_mode defaults inline
        with pytest.raises(ValueError, match="commit_mode"):
            _make_system(None, plan_mode="remote", commit_mode="worker")

    def test_real_worker_processes_bit_identical(self):
        _, serial = _run_mode(2, shards=None)
        orch = _make_system(2, plan_mode="remote", transport="process",
                            commit_mode="worker")
        _submit_workload(orch, 2)
        orch.run()
        assert _trace(orch) == serial
        orch.close()


class TestWorkerCommitConflicts(TestRemoteConflicts):
    def test_conflict_resolved_on_authoritative_replicas(self):
        """Both contending partitions live in ONE owner's domain
        (shards=1): the worker's local passes hit the shared-pool
        conflict, roll the loser back through release_unlaunched on its
        own replicas, and converge — the client replay sees the same
        held/retry rail, so the trace matches client-serial remote."""
        a = self._conflict_system(shards=1, plan_mode="remote")
        b = self._conflict_system(shards=1, plan_mode="remote",
                                  commit_mode="worker")
        self._submit_contenders(a)
        self._submit_contenders(b)
        a.run()
        b.run()
        assert _trace(a) == _trace(b)
        assert b.telemetry.commit_conflicts > 0
        assert b.telemetry.wire_prepares > 0
        records = [r for r in b.telemetry.records if not r.failed]
        assert len({r.trajectory_id for r in records}) == 6
        assert b.queue_depth() == 0 and b.in_flight() == 0
        for m in b.managers.values():
            m.check_occupancy()
        a.close()
        b.close()

    def test_cross_owner_footprint_declines_to_client_serial(self):
        """With shards=2 the contenders' commit footprints span owners
        (each part touches its own pool AND the shared pool): the
        engine must decline those rounds to the client-serial walk —
        counted, and trace-identical to client-serial remote."""
        a = self._conflict_system(shards=2, plan_mode="remote")
        b = self._conflict_system(shards=2, plan_mode="remote",
                                  commit_mode="worker")
        self._submit_contenders(a)
        self._submit_contenders(b)
        a.run()
        b.run()
        assert _trace(a) == _trace(b)
        assert b.telemetry.commit_inline_rounds > 0
        assert b.telemetry.wire_prepares == 0
        b.close()
        a.close()


class TestPlanBatchCarriesCommit:
    def test_plan_batch_mixes_plan_and_plan_commit(self):
        """A plan_batch frame may carry plan_commit requests next to
        plain plan requests — each processed in arrival order, each
        answered by its own response kind inside plan_batch_response."""
        from repro_torch.core.action import ActionState
        from repro_torch.core.scheduler import ElasticScheduler

        m = ResourceManager("r", 8)
        act = Action(name="w", cost={"r": fixed("r", 2)}, trajectory_id="t0",
                     base_duration=1.0)
        act.state = ActionState.QUEUED  # as a submitted action arrives

        def body(commit):
            b = {
                "shard": 0,
                "now": 0.0,
                "incremental": True,
                "policy": wire.encode_policy(ElasticScheduler()),
                "fair_share": None,
                "history": {"avg": {}},
                "snapshots": {"r": wire.encode_snapshot(m)},
                "executing": [],
                "partitions": [
                    {"part": "r", "waiting": [wire.encode_action(act)]}
                ],
            }
            if commit:
                b["commit"] = {
                    "leases": [wire.encode_lease("r", 0, fresh=True)],
                    "max_passes": 4,
                    "tick": 0.0005,
                }
            return b

        worker = RemoteShardWorker()
        batch = wire.envelope("plan_batch", {"reqs": [
            wire.envelope("plan_commit", body(commit=True)),
            wire.envelope("plan_request", body(commit=False)),
        ]})
        resp = wire.loads(worker.handle(wire.dumps(batch)))
        assert resp["kind"] == "plan_batch_response"
        kinds = [r["kind"] for r in resp["resps"]]
        assert kinds == ["plan_commit_response", "plan_response"]
        fused = resp["resps"][0]
        # the fused round really committed: one pass, one launch outcome
        assert fused["passes"], "no committed passes in the ack"
        part, rows, failed, held = wire.decode_commit_outcome(
            fused["passes"][0]["outcomes"][0]
        )
        assert part == "r" and len(rows) == 1 and not failed and not held
        assert fused["fps"]["r"] != wire.fingerprint(wire.encode_snapshot(m))

"""The port's copy of the control plane (``repro_torch.core``) under the
reference suite ``tests/test_fairness.py``, imports rewritten, each case kept.

The reference suite's own description follows.

Multi-tenant fair-share layer: WFQ partition queues, single-task
bit-equivalence with the FCFS path, weighted shares under saturation,
the preempt-scalable shrink, quota caps, per-task telemetry, and the
SimClock relative-epsilon regression."""

import math
import random
import statistics

import pytest

from repro_torch.core.action import Action, AmdahlElasticity, ResourceRequest, fixed, ranged
from repro_torch.core.cluster import ApiResourceSpec, CpuNodeSpec, GpuNodeSpec
from repro_torch.core.fairqueue import FairSharePolicy, PartitionQueue, default_cost
from repro_torch.core.managers.base import ResourceManager
from repro_torch.core.managers.basic import BasicResourceManager
from repro_torch.core.managers.cpu import CpuManager
from repro_torch.core.managers.gpu import GpuManager, ServiceSpec
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.scheduler import ElasticScheduler
from repro_torch.core.telemetry import decision_trace
from repro_torch.core.simulator import EventLoop, SimClock


def _action(task, name="a", units=(1,), dur=1.0, elastic=False, **kw):
    return Action(
        name=name,
        cost={"cpu": ResourceRequest("cpu", tuple(units))},
        key_resource="cpu" if elastic else None,
        elasticity=AmdahlElasticity(0.05) if elastic else None,
        base_duration=dur,
        task_id=task,
        trajectory_id=kw.pop("trajectory_id", f"{task}-t"),
        **kw,
    )


def _trace(orch):
    return decision_trace(orch.telemetry.records)


# ---------------------------------------------------------------------------
# PartitionQueue unit behaviour
# ---------------------------------------------------------------------------


class TestPartitionQueue:
    def test_single_task_is_fcfs(self):
        q = PartitionQueue(fair=True, cost_of=lambda a: 1.0)
        acts = [_action("t0", name=f"a{i}") for i in range(10)]
        for a in acts:
            q.push(a)
        assert [a.name for a in q.ordered()] == [f"a{i}" for i in range(10)]

    def test_at_head_requeue_resumes_front(self):
        for fair in (False, True):
            q = PartitionQueue(fair=fair, cost_of=lambda a: 1.0)
            acts = [_action("t0", name=f"a{i}") for i in range(4)]
            for a in acts:
                q.push(a)
            q.remove(acts[2].uid)
            q.push(acts[2], at_head=True)
            assert [a.name for a in q.ordered()] == ["a2", "a0", "a1", "a3"]

    def test_fcfs_mode_ignores_tasks(self):
        q = PartitionQueue(fair=False)
        names = []
        for i, task in enumerate(["b", "a", "b", "c", "a"]):
            a = _action(task, name=f"x{i}")
            names.append(a.name)
            q.push(a)
        assert [a.name for a in q.ordered()] == names

    def test_weighted_interleave(self):
        """Service order tracks weights: w(A)=2, w(B)=1 with equal costs
        drains ~2 A per B."""
        w = {"A": 2.0, "B": 1.0}
        q = PartitionQueue(
            fair=True, weight_of=lambda a: w[a.task_id], cost_of=lambda a: 1.0
        )
        for i in range(12):
            q.push(_action("A", name=f"A{i}"))
        for i in range(6):
            q.push(_action("B", name=f"B{i}"))
        order = [a.task_id for a in q.ordered()]
        # in any prefix of 3k, A holds ~2/3 of the slots (±1 boundary)
        for k in (3, 6, 9, 12):
            a_count = order[:k].count("A")
            assert abs(a_count - 2 * k / 3) <= 1.0, (k, order)

    def test_served_removal_advances_vtime(self):
        q = PartitionQueue(fair=True, cost_of=lambda a: 1.0)
        a0, a1 = _action("t0"), _action("t0")
        q.push(a0)
        q.push(a1)
        assert q.vtime == 0.0
        q.remove(a1.uid, served=True)
        assert q.vtime == pytest.approx(1.0)  # a1's start tag

    def test_tombstone_compaction(self):
        q = PartitionQueue(fair=True, cost_of=lambda a: 1.0)
        acts = [_action("t0", name=f"a{i}") for i in range(64)]
        for a in acts:
            q.push(a)
        for a in acts[:48]:
            q.remove(a.uid)
        assert q.compactions >= 1
        assert [a.name for a in q.ordered()] == [f"a{i}" for i in range(48, 64)]
        assert len(q) == 16

    def test_default_cost_prices_elastic_min_allocation(self):
        rigid = _action("t", units=(2,), dur=3.0)
        assert default_cost(rigid, "cpu") == pytest.approx(6.0)
        elastic = _action("t", units=(2, 4), dur=3.0, elastic=True)
        # 2 units x dur at DoP 2 (sped up), NOT 2 x base
        expect = 2 * elastic.get_dur(2)
        assert default_cost(elastic, "cpu") == pytest.approx(expect)
        assert default_cost(_action("t"), None) == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# WFQ virtual-clock monotonicity across drain/refill (busy-period rule)
# ---------------------------------------------------------------------------


class TestDrainRefill:
    def _drain_all_served(self, q):
        while True:
            head = q.head()
            if head is None:
                return
            q.remove(head.uid, served=True)

    def test_busy_period_end_settles_clock_at_max_finish(self):
        """When the last sub-queue empties, V jumps to the largest finish
        tag charged (monotone) and the finish chains reset."""
        w = {"A": 1.0, "B": 1.0}
        q = PartitionQueue(fair=True, weight_of=lambda a: w[a.task_id],
                           cost_of=lambda a: 10.0)
        for i in range(3):
            q.push(_action("A", name=f"A{i}"))
        self._drain_all_served(q)
        # A was charged F=30; serving only advanced V to A2's START (20)
        # — the busy-period rule must settle the remaining debt
        assert q.vtime == pytest.approx(30.0)
        assert q._task_finish == {}

    def test_refill_after_drain_starts_level(self):
        """Post-drain arrivals start level: a task that burst heavily in
        the PREVIOUS busy period is not still paying its old finish
        chain, and a fresh task cannot back-date to the stale V and
        starve the returning one."""
        w = {"A": 1.0, "B": 1.0}
        q = PartitionQueue(fair=True, weight_of=lambda a: w[a.task_id],
                           cost_of=lambda a: 10.0)
        for i in range(3):
            q.push(_action("A", name=f"A{i}"))
        self._drain_all_served(q)
        v_settled = q.vtime
        a_return = _action("A", name="A-return")
        b_fresh = _action("B", name="B-fresh")
        q.push(a_return)
        q.push(b_fresh)
        sa, sb = q.tag_of(a_return.uid)[0], q.tag_of(b_fresh.uid)[0]
        assert sa == pytest.approx(v_settled)  # debt forgiven at idle
        assert sb == pytest.approx(v_settled)  # no stale back-dated tag
        # FCFS tie-break: the earlier arrival drains first
        assert [a.name for a in q.ordered()] == ["A-return", "B-fresh"]

    def test_vtime_never_leaps_backward_randomized(self):
        """Property test: under random pushes / serves / unserved drops /
        full drains across tasks, the virtual clock is monotone and every
        post-drain arrival's start tag is >= the settled clock."""
        rng = random.Random(42)
        weights = {"a": 2.0, "b": 1.0, "c": 0.5}
        q = PartitionQueue(
            fair=True,
            weight_of=lambda x: weights[x.task_id],
            cost_of=lambda x: x.base_duration,
        )
        live = []
        last_v = 0.0
        for step in range(600):
            op = rng.random()
            if op < 0.5 or not live:
                a = _action(rng.choice(list(weights)), name=f"s{step}",
                            dur=rng.uniform(0.1, 5.0))
                was_empty = len(q) == 0
                q.push(a)
                live.append(a)
                if was_empty:
                    # resume rule: nobody may start before the settled clock
                    assert q.tag_of(a.uid)[0] >= last_v - 1e-12
            elif op < 0.85:
                a = live.pop(rng.randrange(len(live)))
                q.remove(a.uid, served=True)
            else:
                a = live.pop(rng.randrange(len(live)))
                q.remove(a.uid, served=False)  # cancel/withdraw path
            assert q.vtime >= last_v - 1e-12, "virtual clock leapt backward"
            last_v = q.vtime
        assert len(q) == len(live)

    def test_single_task_fcfs_survives_drain_cycles(self):
        """The busy-period rule must not disturb single-tenant FCFS
        order (the bit-equivalence rail)."""
        q = PartitionQueue(fair=True, cost_of=lambda a: 1.0)
        order = []
        for cycle in range(3):
            acts = [_action("t", name=f"c{cycle}-{i}") for i in range(4)]
            for a in acts:
                q.push(a)
            while q.head() is not None:
                order.append(q.head().name)
                q.remove(q.head().uid, served=True)
        assert order == [f"c{c}-{i}" for c in range(3) for i in range(4)]


# ---------------------------------------------------------------------------
# sub-queue detach / merge + virtual-clock sync (the distribution seam)
# ---------------------------------------------------------------------------


class TestDetachMerge:
    def _mk(self):
        w = {"A": 2.0, "B": 1.0}
        return PartitionQueue(fair=True, weight_of=lambda a: w[a.task_id],
                              cost_of=lambda a: 1.0)

    def test_detach_merge_round_trip_preserves_order(self):
        q = self._mk()
        acts = []
        for i in range(6):
            a = _action("A" if i % 2 == 0 else "B", name=f"x{i}")
            acts.append(a)
            q.push(a)
        before = [a.name for a in q.ordered()]
        shard = q.detach_task("A")
        assert shard is not None and len(shard.entries) == 3
        assert all(a.name not in ("x0", "x2", "x4")
                   for a in q.ordered())
        q.merge_shard(shard)
        assert [a.name for a in q.ordered()] == before
        # the finish chain survived: a new A arrival continues it
        a_new = _action("A", name="x-new")
        q.push(a_new)
        assert q.tag_of(a_new.uid)[0] >= shard.finish_tag - 1e-12

    def test_merge_into_fresh_replica_syncs_clock(self):
        src = self._mk()
        for i in range(4):
            src.push(_action("A", name=f"a{i}"))
        src.remove(src.head().uid, served=True)
        src.remove(src.head().uid, served=True)
        shard = src.detach_task("A")
        dst = self._mk()
        dst.merge_shard(shard)
        # clock synced monotonically; tags carried verbatim
        assert dst.vtime >= shard.vtime - 1e-12
        assert [a.name for a in dst.ordered()] == ["a2", "a3"]
        # a local arrival on the replica cannot back-date behind the
        # merged sub-queue's virtual position
        b = _action("B", name="b0")
        dst.push(b)
        assert dst.tag_of(b.uid)[0] >= dst.vtime - 1e-12

    def test_detach_missing_or_empty_task(self):
        q = self._mk()
        assert q.detach_task("nope") is None
        a = _action("A")
        q.push(a)
        q.remove(a.uid, served=True)
        assert q.detach_task("A") is None

    def test_merge_never_double_admits(self):
        q = self._mk()
        a = _action("A", name="dup")
        q.push(a)
        shard = q.detach_task("A")
        q.push(a)  # re-queued locally while the shard was in transit
        q.merge_shard(shard)
        assert len(q) == 1
        assert [x.name for x in q.ordered()] == ["dup"]

    def test_sync_vtime_is_monotone(self):
        q = self._mk()
        q.sync_vtime(5.0)
        assert q.vtime == 5.0
        q.sync_vtime(2.0)  # never backward
        assert q.vtime == 5.0


# ---------------------------------------------------------------------------
# orchestrator equivalence: fairness must be a no-op for one tenant, and
# incremental rounds must stay equivalent to full rescheduling under WFQ
# ---------------------------------------------------------------------------


def _make_system(fair, incremental=True, cores=32, tasks=("task0",)):
    loop = EventLoop()
    managers = {
        "cpu": CpuManager([CpuNodeSpec("n0", cores=cores)]),
        "gpu": GpuManager([GpuNodeSpec("g0")], [ServiceSpec("rm0", 40.0)]),
        "api": BasicResourceManager(
            ApiResourceSpec("api", mode="quota", quota=4, period_s=5.0), loop.clock
        ),
    }
    fs = FairSharePolicy(weights={t: 1.0 + i for i, t in enumerate(tasks)}) if fair else None
    return Orchestrator(managers, loop=loop, incremental=incremental, fair_share=fs)


def _submit_mixed(orch, seed, tasks=("task0",), n=60):
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


class TestEquivalence:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_single_task_bit_identical_to_fcfs_path(self, seed):
        """With one tenant, WFQ order == FCFS order, so enabling the
        fairness layer must not change a single launch."""
        fair = _make_system(fair=True)
        fcfs = _make_system(fair=False)
        _submit_mixed(fair, seed)
        _submit_mixed(fcfs, seed)
        fair.run()
        fcfs.run()
        assert len(fair.telemetry.records) == 60
        assert _trace(fair) == _trace(fcfs)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_incremental_equals_full_under_fair_share(self, seed):
        """Dirty-tracked incremental rounds must launch exactly what full
        rescheduling would, with multi-tenant WFQ queues active."""
        tasks = ("heavy", "light")
        inc = _make_system(fair=True, incremental=True, tasks=tasks)
        full = _make_system(fair=True, incremental=False, tasks=tasks)
        _submit_mixed(inc, seed, tasks=tasks)
        _submit_mixed(full, seed, tasks=tasks)
        inc.run()
        full.run()
        assert _trace(inc) == _trace(full)
        assert inc.queue_depth() == 0 and inc.in_flight() == 0


# ---------------------------------------------------------------------------
# weighted shares + the WFQ no-starvation invariant
# ---------------------------------------------------------------------------


def _saturated_run(fair, weights, horizon=120.0, cores=8):
    loop = EventLoop()
    orch = Orchestrator(
        {"cpu": CpuManager([CpuNodeSpec("n0", cores=cores)])},
        loop=loop,
        fair_share=FairSharePolicy(weights=dict(weights)) if fair else None,
    )
    counters = {t: 0 for t in weights}

    def tenant_action(task, i):
        heavy = task.startswith("heavy")
        return Action(
            name=task[0],
            cost={"cpu": fixed("cpu", 2 if heavy else 1)},
            base_duration=2.0 if heavy else 0.5,
            task_id=task,
            trajectory_id=f"{task}-{i}",
        )

    def submit(task):
        i = counters[task]
        counters[task] += 1
        fut = orch.submit(tenant_action(task, i))

        def refill(_f):
            if orch.now < horizon:
                submit(task)

        fut.add_done_callback(refill)

    for t in weights:
        for _ in range(6):
            submit(t)
    orch.run(until=horizon * 1.5)
    return orch


WEIGHTS = {"heavy0": 2.0, "heavy1": 2.0, "light0": 1.0, "light1": 1.0}


class TestWeightedShares:
    def test_shares_track_weights_within_10pct(self):
        orch = _saturated_run(True, WEIGHTS)
        share = orch.telemetry.task_share("cpu", until=120.0)
        wsum = sum(WEIGHTS.values())
        for task, w in WEIGHTS.items():
            target = w / wsum
            assert abs(share.get(task, 0.0) - target) / target <= 0.10, (task, share)

    def test_fcfs_ablation_does_not_track_weights(self):
        orch = _saturated_run(False, WEIGHTS)
        share = orch.telemetry.task_share("cpu", until=120.0)
        wsum = sum(WEIGHTS.values())
        err = max(
            abs(share.get(t, 0.0) - w / wsum) / (w / wsum) for t, w in WEIGHTS.items()
        )
        assert err > 0.10  # the pathology the fairness layer removes

    def test_light_tenant_interference_drops_2x(self):
        fair = _saturated_run(True, WEIGHTS)
        fcfs = _saturated_run(False, WEIGHTS)
        light_fair = statistics.fmean(
            fair.telemetry.mean_act(t) for t in ("light0", "light1")
        )
        light_fcfs = statistics.fmean(
            fcfs.telemetry.mean_act(t) for t in ("light0", "light1")
        )
        assert light_fcfs / light_fair >= 2.0

    def test_no_unbounded_backlog_aging(self):
        """WFQ invariant: while a heavy tenant floods, a backlogged light
        tenant's worst queueing age stays bounded near its service period
        — it does not grow with the heavy backlog as under FCFS."""
        fair = _saturated_run(True, WEIGHTS)
        fcfs = _saturated_run(False, WEIGHTS)
        for t in ("light0", "light1"):
            assert fair.telemetry.max_queue_dur(t) < fcfs.telemetry.max_queue_dur(t) / 2
        # and no task ever launched more than weight-share while another
        # backlogged task starved: worst light age is a few service quanta
        assert max(fair.telemetry.max_queue_dur(t) for t in ("light0", "light1")) < 10.0


# ---------------------------------------------------------------------------
# preempt_scalable: shrink the rich before deferring the poor
# ---------------------------------------------------------------------------


def _elastic(task, units, dur):
    return Action(
        name=f"{task}-a", cost={"cpu": ResourceRequest("cpu", tuple(units))},
        key_resource="cpu", elasticity=AmdahlElasticity(0.05), base_duration=dur,
        task_id=task, trajectory_id=task,
    )


class TestPreemptScalable:
    def _arrange(self, preempt):
        mgr = ResourceManager("cpu", 8)
        mgr.note_allocated("rich", 6)  # rich already holds most of the pool
        sched = ElasticScheduler(fair_share=FairSharePolicy(preempt_scalable=preempt))
        running = _elastic("rich", (2,), 5.0)
        running.start_time, running.finish_time = 0.0, 4.0
        rich = _elastic("rich", (2, 4, 8), 100.0)
        poor = _elastic("poor", (2, 4), 3.0)
        return sched.arrange([rich, poor], [], [running], {"cpu": mgr}, 0.0)

    def test_without_preempt_poor_is_deferred(self):
        res = self._arrange(preempt=False)
        assert res.evicted == 1
        assert [(d.action.task_id, d.units["cpu"]) for d in res.decisions] == [
            ("rich", 8)
        ]

    def test_preempt_shrinks_rich_and_keeps_poor(self):
        res = self._arrange(preempt=True)
        assert res.evicted == 0
        got = {d.action.task_id: d.units["cpu"] for d in res.decisions}
        assert got["rich"] == 2  # clamped to min units
        assert got["poor"] == 4  # under-share work launches instead

    def test_share_bands(self):
        mgr = ResourceManager("cpu", 8)
        mgr.note_allocated("rich", 6)
        mgr.note_allocated("poor", 1)
        sched = ElasticScheduler(fair_share=FairSharePolicy())
        group = [_elastic("rich", (2, 4), 5.0), _elastic("poor", (2, 4), 5.0)]
        over, under = sched._share_bands(group, [], mgr)
        assert over == {"rich"} and under == {"poor"}
        # uniform usage -> nobody over-share
        mgr2 = ResourceManager("cpu", 8)
        mgr2.note_allocated("a", 2)
        mgr2.note_allocated("b", 2)
        over2, under2 = sched._share_bands(
            [_elastic("a", (2,), 1.0), _elastic("b", (2,), 1.0)], [], mgr2
        )
        assert over2 == set()

    def test_usage_accounting_roundtrip(self):
        mgr = ResourceManager("cpu", 8)
        mgr.note_allocated("a", 3)
        mgr.note_allocated("a", 2)
        assert mgr.task_usage() == {"a": 5}
        mgr.note_released("a", 3)
        assert mgr.task_usage() == {"a": 2}
        mgr.note_released("a", 2)
        assert mgr.task_usage() == {}


# ---------------------------------------------------------------------------
# weighted DPArrange: dense and reference stay bit-identical
# ---------------------------------------------------------------------------


class TestWeightedDP:
    def test_dense_matches_ref_with_weights(self):
        from repro_torch.core.dparrange import (
            BasicDPOperator,
            DPTask,
            dp_arrange_prefixes_dense,
            dp_arrange_prefixes_ref,
        )

        rng = random.Random(11)
        for _ in range(20):
            m = rng.randint(1, 5)
            tasks = []
            for i in range(m):
                units = tuple(sorted(rng.sample(range(1, 9), rng.randint(1, 3))))
                tasks.append(
                    DPTask(
                        name=str(i),
                        units=units,
                        durations=tuple(rng.uniform(0.5, 20.0) for _ in units),
                    )
                )
            weights = tuple(rng.choice((0.5, 1.0, 2.0, 3.0)) for _ in range(m))
            op = BasicDPOperator(rng.randint(4, 24))
            dense = dp_arrange_prefixes_dense(tasks, op, weights=weights)
            ref = dp_arrange_prefixes_ref(tasks, op, weights=weights)
            assert dense is not None
            for d, r in zip(dense, ref):
                assert (d is None) == (r is None)
                if d is not None:
                    assert d.total_duration == r.total_duration  # bit-identical
                    # reported durations are TRUE durations, not weighted
                    for name, k in d.allocation.items():
                        t = tasks[int(name)]
                        assert d.durations[name] == t.durations[t.units.index(k)]

    def test_uniform_weights_equal_unweighted(self):
        from repro_torch.core.dparrange import BasicDPOperator, DPTask, dp_arrange

        tasks = [
            DPTask(name="0", units=(1, 2, 4), durations=(8.0, 4.4, 2.6)),
            DPTask(name="1", units=(1, 2), durations=(3.0, 1.7)),
        ]
        op = BasicDPOperator(6)
        plain = dp_arrange(tasks, op)
        uniform = dp_arrange(tasks, op, weights=(1.0, 1.0))
        assert plain.total_duration == uniform.total_duration
        assert plain.allocation == uniform.allocation


# ---------------------------------------------------------------------------
# quota caps
# ---------------------------------------------------------------------------


class TestQuota:
    def test_quota_caps_concurrent_share(self):
        """quota=0.5 on an 8-core pool: the capped tenant never holds
        more than 4 cores even with the pool otherwise idle."""
        loop = EventLoop()
        orch = Orchestrator(
            {"cpu": CpuManager([CpuNodeSpec("n0", cores=8)])},
            loop=loop,
            fair_share=FairSharePolicy(quota={"greedy": 0.5}),
        )
        peak = [0]
        for i in range(6):
            fut = orch.submit(
                Action(name="g", cost={"cpu": fixed("cpu", 2)}, base_duration=1.0,
                       task_id="greedy", trajectory_id=f"g{i}")
            )
            fut.add_done_callback(
                lambda _f: peak.__setitem__(
                    0, max(peak[0], orch.managers["cpu"].task_usage().get("greedy", 0))
                )
            )
        orch.run()
        assert orch.queue_depth() == 0  # everything eventually runs
        assert peak[0] <= 4
        assert orch.stats["quota_deferrals"] > 0

    def test_sub_min_quota_degrades_to_serial_not_deadlock(self):
        """A quota smaller than an action's min requirement must run the
        actions one at a time, not strand them forever (review fix)."""
        loop = EventLoop()
        orch = Orchestrator(
            {"cpu": CpuManager([CpuNodeSpec("n0", cores=16)])},
            loop=loop,
            fair_share=FairSharePolicy(quota={"t": 0.1}),  # cap 1.6 < min 2
        )
        futs = [
            orch.submit(
                Action(name="a", cost={"cpu": fixed("cpu", 2)}, base_duration=1.0,
                       task_id="t", trajectory_id=f"t{i}")
            )
            for i in range(3)
        ]
        end = orch.run()
        assert all(f.done() for f in futs)
        assert orch.queue_depth() == 0
        # serialized: ~one at a time, so makespan spans >= 3 durations
        assert end >= 3.0

    def test_quota_clamps_elastic_scale_up(self):
        """The quota cap binds scalable grants too: a lone elastic action
        cannot scale past its task's budget (review fix)."""
        loop = EventLoop()
        orch = Orchestrator(
            {"cpu": CpuManager([CpuNodeSpec("n0", cores=16)])},
            loop=loop,
            fair_share=FairSharePolicy(quota={"t": 0.25}),  # cap = 4 units
        )
        orch.submit(
            Action(name="r", cost={"cpu": ResourceRequest("cpu", (1, 2, 4, 8, 16))},
                   key_resource="cpu", elasticity=AmdahlElasticity(0.05),
                   base_duration=4.0, task_id="t", trajectory_id="t0")
        )
        orch.run()
        (rec,) = orch.telemetry.records
        assert rec.units["cpu"] <= 4

    @pytest.mark.parametrize("shards", [None, 2])
    def test_quota_exact_under_concurrent_scale_up(self, shards):
        """Exact quota for scalable scale-up (ROADMAP item): several
        co-scheduled DoP-8-scalable actions of one quota'd tenant must
        never jointly exceed the cap mid-flight.  Before the fix, the
        first launch ate the whole budget and its siblings' min-unit
        progress rail pushed the task past the cap."""
        loop = EventLoop()
        mgr = CpuManager([CpuNodeSpec("n0", cores=16)])
        orch = Orchestrator(
            {"cpu": mgr}, loop=loop,
            fair_share=FairSharePolicy(quota={"t": 0.5}),  # cap = 8 units
            shards=shards,
        )
        peak = [0]
        orig = mgr.note_allocated

        def spy(task_id, units):
            orig(task_id, units)
            peak[0] = max(peak[0], mgr.task_usage().get("t", 0))

        mgr.note_allocated = spy
        futs = [
            orch.submit(
                Action(name=f"r{i}",
                       cost={"cpu": ResourceRequest("cpu", (1, 2, 4, 8))},
                       key_resource="cpu", elasticity=AmdahlElasticity(0.05),
                       base_duration=6.0, task_id="t", trajectory_id=f"t{i}")
            )
            for i in range(3)
        ]
        orch.run()
        assert all(f.done() for f in futs)
        assert peak[0] <= 8, f"quota cap exceeded mid-flight: {peak[0]} > 8"
        assert peak[0] >= 4  # the budget is still being used, not starved
        mgr.check_occupancy()


# ---------------------------------------------------------------------------
# per-task telemetry + live starvation ages
# ---------------------------------------------------------------------------


class TestPerTaskTelemetry:
    def test_per_task_breakdown(self):
        orch = _saturated_run(True, WEIGHTS, horizon=30.0)
        per = orch.telemetry.per_task("cpu")
        assert set(per) == set(WEIGHTS)
        for task, row in per.items():
            assert row["completed"] > 0
            assert not math.isnan(row["mean_act"])
            assert 0.0 < row["share"] < 1.0
            assert row["max_queue_dur"] >= 0.0
        # per-task mean ACT composes back to the global one
        acts = [orch.telemetry.mean_act(t) for t in WEIGHTS]
        assert min(acts) <= orch.telemetry.mean_act() <= max(acts)

    def test_live_starvation_ages(self):
        loop = EventLoop()
        orch = Orchestrator(
            {"cpu": CpuManager([CpuNodeSpec("n0", cores=2)])}, loop=loop,
            fair_share=FairSharePolicy(),
        )
        orch.submit(_action("busy", units=(2,), dur=50.0))
        orch.submit(_action("starved", units=(2,), dur=1.0))
        orch.run(until=10.0)
        ages = orch.starvation_ages()
        assert ages.get("starved", 0.0) == pytest.approx(10.0)
        assert "busy" not in ages  # running, not queued

    def test_task_share_until_window(self):
        orch = _saturated_run(True, WEIGHTS, horizon=30.0)
        inside = orch.telemetry.task_share("cpu", until=30.0)
        assert inside and abs(sum(inside.values()) - 1.0) < 1e-9


# ---------------------------------------------------------------------------
# SimClock relative-epsilon regression (satellite fix)
# ---------------------------------------------------------------------------


class TestSimClockEpsilon:
    def test_ulp_jitter_at_large_time_does_not_raise(self):
        """Coalesced same-timestamp events can disagree by a few ulps at
        large virtual times; the old absolute 1e-12 guard raised 'time
        went backwards' on them."""
        clock = SimClock()
        t = 1.0e6
        clock._advance(t)
        jitter = t - 5 * math.ulp(t)  # well beyond 1e-12, within rel eps
        clock._advance(jitter)  # must not raise
        assert clock.now() == t

    def test_true_backwards_still_raises(self):
        clock = SimClock()
        clock._advance(1.0e6)
        with pytest.raises(RuntimeError):
            clock._advance(1.0e6 - 1.0)

    def test_call_at_tolerates_ulp_past(self):
        loop = EventLoop()
        loop.clock._advance(1.0e6)
        fired = []
        loop.call_at(1.0e6 - 5 * math.ulp(1.0e6), lambda: fired.append(1))
        loop.run()
        assert fired == [1]
        with pytest.raises(ValueError):
            loop.call_at(1.0e6 - 1.0, lambda: None)

    def test_float_accumulation_round_trip(self):
        """Timestamps reached via different float-sum paths coalesce into
        one round instead of crashing the loop."""
        loop = EventLoop()
        base = 1.0e6  # long-run virtual time, ulp(base) >> 1e-12
        # two logically simultaneous timestamps whose float-sum paths
        # disagree by a few ulps (far more than the old 1e-12 guard)
        t2 = base + 0.3
        t1 = t2 - 3 * math.ulp(t2)
        assert t1 != t2 and abs(t1 - t2) > 1e-12
        order = []
        loop.call_at(t2, lambda: order.append("late"))
        loop.call_at(t1, lambda: order.append("early"))
        end = loop.run()
        assert order == ["early", "late"]
        assert end == pytest.approx(base + 0.3)

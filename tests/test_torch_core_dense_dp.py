"""The port's copy of the control plane (``repro_torch.core``) under the
reference suite ``tests/test_dense_dp.py``, imports rewritten, each case kept;
``test_jax_backend_matches_ref`` becomes ``test_torch_backend_matches_ref`` (the
port's dense scan is ``backend="torch"``), and ``test_jax_backend_raises_naming_a6``
holds that ``backend="jax"`` is refused.

The reference suite's own description follows.

Dense vectorized DPArrange vs the dict-based reference (PR 2).

Three layers of evidence that the fast path is safe to trust:

* seeded-random sweeps (always run, no dev deps) asserting the dense
  prefix DP is objective-identical to :func:`dp_arrange_prefixes_ref`
  over both operators, including fragmented GPU free-chunk
  configurations and infeasible prefixes;
* hypothesis property tests (skip without the dev dependency) over the
  same contract;
* regressions: the transition-table cache must invalidate when the GPU
  manager's free chunks change, the sorted-merge ESTIMATE replay must
  equal the heap simulation it replaced, and the incremental candidate
  window must equal the per-prefix rescan it replaced.
"""

import heapq
import random

import pytest

from _hypothesis_compat import given, settings, st

from repro_torch.core.action import Action, AmdahlElasticity, ResourceRequest, fixed
from repro_torch.core.cluster import CpuNodeSpec, GpuNodeSpec
from repro_torch.core.dparrange import (
    BasicDPOperator,
    DPTask,
    GpuChunkDPOperator,
    dp_arrange,
    dp_arrange_prefixes,
    dp_arrange_prefixes_dense,
    dp_arrange_prefixes_ref,
    dp_arrange_ref,
)
from repro_torch.core.managers.cpu import CpuManager
from repro_torch.core.managers.gpu import GpuManager, ServiceSpec
from repro_torch.core.scheduler import ElasticScheduler

np = pytest.importorskip("numpy")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _random_tasks(rng, n_tasks, unit_pool, max_units=4):
    tasks = []
    for i in range(n_tasks):
        units = tuple(
            sorted(rng.sample(unit_pool, rng.randint(1, min(max_units, len(unit_pool)))))
        )
        durs = tuple(round(rng.uniform(0.1, 60.0), 4) for _ in units)
        tasks.append(DPTask(f"t{i}", units, durs))
    return tasks


def _assert_prefixes_equivalent(tasks, ref, dense, capacity=None, feasible=None):
    assert dense is not None
    assert len(ref) == len(dense) == len(tasks) + 1
    for i, (r, d) in enumerate(zip(ref, dense)):
        assert (r is None) == (d is None), f"prefix {i}: feasibility mismatch"
        if r is None:
            continue
        # objectives are bit-identical (same float64 sums, same minima)
        assert d.total_duration == r.total_duration, f"prefix {i}"
        # the dense allocation must itself be valid and consistent
        total = 0
        recomputed = 0.0
        for t in range(i):
            k = d.allocation[tasks[t].name]
            assert k in tasks[t].units
            total += k
            recomputed += tasks[t].durations[tasks[t].units.index(k)]
        assert recomputed == pytest.approx(d.total_duration)
        if capacity is not None:
            assert total <= capacity
        if feasible is not None:
            counts = [0, 0, 0, 0]
            for t in range(i):
                dec = GpuChunkDPOperator.greedy_decompose(d.allocation[tasks[t].name])
                assert dec is not None
                counts = [x + y for x, y in zip(counts, dec)]
            assert feasible(tuple(counts))


# ---------------------------------------------------------------------------
# seeded-random equivalence sweeps (always run)
# ---------------------------------------------------------------------------


def test_dense_matches_ref_basic_operator_random():
    rng = random.Random(1)
    for _ in range(200):
        capacity = rng.randint(0, 24)
        tasks = _random_tasks(rng, rng.randint(1, 5), list(range(1, 9)))
        ref = dp_arrange_prefixes_ref(tasks, BasicDPOperator(capacity))
        dense = dp_arrange_prefixes_dense(tasks, BasicDPOperator(capacity))
        _assert_prefixes_equivalent(tasks, ref, dense, capacity=capacity)


def test_dense_matches_ref_gpu_operator_random_free_chunks():
    """Random fragmentation: allocate random chunks out of 1-2 GPU nodes,
    then the DP over the resulting free-chunk configuration must match
    the reference exactly (objective AND multiset feasibility)."""
    rng = random.Random(2)
    for _ in range(150):
        nodes = [GpuNodeSpec(f"g{i}") for i in range(rng.randint(1, 2))]
        mgr = GpuManager(nodes, [ServiceSpec("rm0", 10.0)])
        for _ in range(rng.randint(0, 5)):
            m = rng.choice([1, 2, 4, 8])
            a = Action(
                name="hold",
                cost={"gpu": ResourceRequest("gpu", (m,))},
                trajectory_id="t",
            )
            mgr.try_allocate(a, m)
        tasks = _random_tasks(rng, rng.randint(1, 4), [1, 2, 3, 4, 5, 6, 7, 8])
        ref = dp_arrange_prefixes_ref(tasks, mgr.dp_operator([]))
        dense = dp_arrange_prefixes_dense(tasks, mgr.dp_operator([]))
        _assert_prefixes_equivalent(
            tasks, ref, dense, feasible=mgr.feasible_multiset
        )


def test_infeasible_prefixes_match():
    """Once demand exceeds capacity, both paths report the same prefixes
    as infeasible (None) and keep the feasible ones identical."""
    tasks = [DPTask(f"t{i}", (2, 4), (6.0, 3.0)) for i in range(5)]
    op_ref = BasicDPOperator(5)
    op_dense = BasicDPOperator(5)
    ref = dp_arrange_prefixes_ref(tasks, op_ref)
    dense = dp_arrange_prefixes_dense(tasks, op_dense)
    _assert_prefixes_equivalent(tasks, ref, dense, capacity=5)
    assert ref[3] is None and dense[3] is None  # 3 tasks need >= 6 > 5
    assert ref[2] is not None and dense[2] is not None
    assert dp_arrange(tasks, BasicDPOperator(5)) is None
    assert dp_arrange_ref(tasks, BasicDPOperator(5)) is None


def test_dispatcher_uses_dense_and_falls_back():
    tasks = [DPTask("a", (1, 2), (2.0, 1.0))]

    class OpaqueOperator(BasicDPOperator):
        def transition_table(self, ks, limit=None):
            return None  # force the sparse reference

    got = dp_arrange_prefixes(tasks, OpaqueOperator(4))
    want = dp_arrange_prefixes_ref(tasks, BasicDPOperator(4))
    assert got[1].total_duration == want[1].total_duration
    # explicit table=None also forces the reference path
    got2 = dp_arrange_prefixes(tasks, BasicDPOperator(4), table=None)
    assert got2[1].total_duration == want[1].total_duration


def test_state_limit_falls_back_to_ref(monkeypatch):
    import repro_torch.core.dparrange as dpmod

    op = BasicDPOperator(10)
    assert op.transition_table((1, 2), limit=5) is None
    # with the module limit tightened below the state space, the dense
    # path reports "unsupported" and the dispatcher uses the reference
    monkeypatch.setattr(dpmod, "DENSE_STATE_LIMIT", 5)
    tasks = [DPTask("a", (1, 2), (2.0, 1.0))]
    assert dp_arrange_prefixes_dense(tasks, BasicDPOperator(10)) is None
    got = dp_arrange_prefixes(tasks, BasicDPOperator(10))
    want = dp_arrange_prefixes_ref(tasks, BasicDPOperator(10))
    assert got[1].total_duration == want[1].total_duration


def _torch_backend_cases():
    """``tests/test_dense_dp.py::test_jax_backend_matches_ref``'s cases: ten
    basic-operator instances, then one on the GPU chunk operator."""
    rng = random.Random(3)
    for _ in range(10):
        capacity = rng.randint(1, 16)
        tasks = _random_tasks(rng, rng.randint(1, 4), list(range(1, 9)))
        yield tasks, lambda c=capacity: BasicDPOperator(c), capacity
    tasks = _random_tasks(rng, 3, [1, 2, 4, 8])
    yield tasks, lambda: GpuChunkDPOperator((8, 4, 2, 1), total_devices=8), None


def test_torch_backend_matches_ref():
    """The float64 torch scan (on the CPU here) against the sparse reference,
    as the reference's jax backend is held, and against the NumPy path bit for
    bit: the same objectives and the same backtraced allocations."""
    for tasks, op, capacity in _torch_backend_cases():
        ref = dp_arrange_prefixes_ref(tasks, op())
        dense = dp_arrange_prefixes_dense(tasks, op(), backend="torch", device="cpu")
        _assert_prefixes_equivalent(tasks, ref, dense, capacity=capacity)
        assert dense == dp_arrange_prefixes_dense(tasks, op(), backend="numpy")


def test_jax_backend_raises_naming_a6(monkeypatch):
    """The reference's ``backend="jax"`` is the port's ``"torch"`` (ROADMAP
    A6): asking for jax, per call, through the scheduler or through
    REPRO_DP_BACKEND, raises a ValueError that names ``torch``; no call
    quietly takes the NumPy path instead."""
    import repro_torch.core.dparrange as dpmod

    rng = random.Random(3)
    tasks = _random_tasks(rng, 3, list(range(1, 9)))
    with pytest.raises(ValueError, match="torch"):
        dp_arrange_prefixes_dense(tasks, BasicDPOperator(8), backend="jax")
    with pytest.raises(ValueError, match="torch"):
        dp_arrange_prefixes(tasks, BasicDPOperator(8), backend="jax")
    # a small instance the dispatcher would send to the sparse reference
    with pytest.raises(ValueError, match="torch"):
        dp_arrange_prefixes(tasks[:1], BasicDPOperator(64), backend="jax")
    sched = ElasticScheduler()
    sched.dense_backend = "jax"
    gpu = GpuManager([GpuNodeSpec("g0")], [ServiceSpec("rm", 40.0)])
    acts = [
        Action(name=f"s{i}", cost={"gpu": ResourceRequest("gpu", (1, 2, 4, 8))},
               key_resource="gpu", elasticity=AmdahlElasticity(0.1),
               base_duration=10.0, service="rm")
        for i in range(3)
    ]
    with pytest.raises(ValueError, match="torch"):
        sched.schedule(acts, [], {"gpu": gpu}, 0.0)
    monkeypatch.setattr(dpmod, "DENSE_BACKEND", "jax")  # as REPRO_DP_BACKEND=jax sets it
    with pytest.raises(ValueError, match="torch"):
        dp_arrange_prefixes_dense(tasks, BasicDPOperator(8))
    with pytest.raises(ValueError, match="torch"):
        dp_arrange(tasks, BasicDPOperator(8))


def test_torch_backend_through_the_scheduler_and_env(monkeypatch):
    """``dense_backend="torch"`` on the scheduler, and REPRO_DP_BACKEND=torch
    with the scan's device set to the CPU, decide exactly as the NumPy path does."""
    import repro_torch.core.dparrange as dpmod

    def decide(backend):
        sched = ElasticScheduler()
        sched.dense_backend = backend
        gpu = GpuManager([GpuNodeSpec("g0")], [ServiceSpec("rm", 40.0)])
        acts = [
            Action(name=f"s{i}", cost={"gpu": ResourceRequest("gpu", (1, 2, 4, 8))},
                   key_resource="gpu", elasticity=AmdahlElasticity(0.1),
                   base_duration=10.0 + i, service="rm")
            for i in range(5)
        ]
        res = sched.schedule(acts, [], {"gpu": gpu}, 0.0)
        return [(d.action.name, d.units) for d in res.decisions]

    want = decide(None)
    tasks = _random_tasks(random.Random(5), 3, [1, 2, 4, 8])
    want_dp = dp_arrange_prefixes_dense(tasks, BasicDPOperator(8), backend="numpy")
    monkeypatch.setattr(dpmod, "DENSE_DEVICE", "cpu")
    scans = []
    scan = dpmod._torch_value_rows
    monkeypatch.setattr(dpmod, "_torch_value_rows",
                        lambda *a: scans.append(a[-1]) or scan(*a))
    assert decide("torch") == want
    assert scans and set(scans) == {"cpu"}  # the torch scan ran, on the CPU
    monkeypatch.setattr(dpmod, "DENSE_BACKEND", "torch")  # as REPRO_DP_BACKEND=torch sets it
    assert decide(None) == want
    assert dp_arrange(tasks, BasicDPOperator(8)) == want_dp[-1]


# ---------------------------------------------------------------------------
# hypothesis property tests (skip cleanly without the dev dependency)
# ---------------------------------------------------------------------------


@settings(max_examples=150, deadline=None)
@given(n_tasks=st.integers(1, 5), total=st.integers(0, 16), data=st.data())
def test_property_dense_matches_ref_basic(n_tasks, total, data):
    tasks = []
    for i in range(n_tasks):
        units = tuple(
            sorted(
                data.draw(st.sets(st.integers(1, 8), min_size=1, max_size=4), label=f"u{i}")
            )
        )
        durs = tuple(
            data.draw(st.floats(0.1, 100.0, allow_nan=False), label=f"d{i}{k}")
            for k in units
        )
        tasks.append(DPTask(f"t{i}", units, durs))
    ref = dp_arrange_prefixes_ref(tasks, BasicDPOperator(total))
    dense = dp_arrange_prefixes_dense(tasks, BasicDPOperator(total))
    _assert_prefixes_equivalent(tasks, ref, dense, capacity=total)


@settings(max_examples=80, deadline=None)
@given(n_tasks=st.integers(1, 3), n_held=st.integers(0, 4), data=st.data())
def test_property_dense_matches_ref_gpu(n_tasks, n_held, data):
    mgr = GpuManager([GpuNodeSpec("g0")], [ServiceSpec("rm0", 10.0)])
    for h in range(n_held):
        m = data.draw(st.sampled_from([1, 2, 4, 8]), label=f"h{h}")
        a = Action(
            name="hold", cost={"gpu": ResourceRequest("gpu", (m,))}, trajectory_id="t"
        )
        mgr.try_allocate(a, m)
    tasks = []
    for i in range(n_tasks):
        units = tuple(
            sorted(
                data.draw(st.sets(st.integers(1, 8), min_size=1, max_size=3), label=f"u{i}")
            )
        )
        durs = tuple(
            data.draw(st.floats(0.1, 50.0, allow_nan=False), label=f"d{i}{k}")
            for k in units
        )
        tasks.append(DPTask(f"t{i}", units, durs))
    ref = dp_arrange_prefixes_ref(tasks, mgr.dp_operator([]))
    dense = dp_arrange_prefixes_dense(tasks, mgr.dp_operator([]))
    _assert_prefixes_equivalent(tasks, ref, dense, feasible=mgr.feasible_multiset)


# ---------------------------------------------------------------------------
# transition-table cache regressions
# ---------------------------------------------------------------------------


class TestTableCache:
    def _tasks(self):
        return [DPTask("0", (1, 2, 4, 8), (8.0, 4.2, 2.3, 1.4))]

    def test_hit_on_unchanged_gpu_state(self):
        mgr = GpuManager([GpuNodeSpec("g0")], [ServiceSpec("rm0", 10.0)])
        s = ElasticScheduler()
        tasks = self._tasks()
        t1 = s._table_for(mgr.dp_operator([]), tasks, mgr.dp_cache_key([]))
        t2 = s._table_for(mgr.dp_operator([]), tasks, mgr.dp_cache_key([]))
        assert t1 is t2
        assert s.table_cache_hits == 1 and s.table_cache_misses == 1

    def test_invalidates_when_free_chunks_change(self):
        """REGRESSION: allocating (and releasing) GPU chunks must rotate
        dp_cache_key so a stale transition table is never reused."""
        mgr = GpuManager([GpuNodeSpec("g0")], [ServiceSpec("rm0", 10.0)])
        s = ElasticScheduler()
        tasks = self._tasks()
        key0 = mgr.dp_cache_key([])
        t1 = s._table_for(mgr.dp_operator([]), tasks, key0)
        # an 8-chunk consumption is feasible on the pristine node
        assert dp_arrange_prefixes_dense(
            [DPTask("0", (8,), (1.0,))], mgr.dp_operator([]), table=t1
        )[1] is not None

        a = Action(
            name="hold", cost={"gpu": ResourceRequest("gpu", (4,))}, trajectory_id="t"
        )
        alloc = mgr.try_allocate(a, 4)
        assert alloc is not None
        key1 = mgr.dp_cache_key([])
        assert key1 != key0
        t2 = s._table_for(mgr.dp_operator([]), tasks, key1)
        assert t2 is not t1
        assert s.table_cache_misses == 2
        # with 4 of 8 devices held, an 8-unit task is now infeasible
        assert dp_arrange_prefixes(
            [DPTask("0", (8,), (1.0,))], mgr.dp_operator([]), table=t2
        )[1] is None

        # releasing restores the original key -> the first table hits again
        mgr.release(a, alloc)
        assert mgr.dp_cache_key([]) == key0
        t3 = s._table_for(mgr.dp_operator([]), tasks, mgr.dp_cache_key([]))
        assert t3 is t1

    def test_unsupported_operator_verdict_cached(self):
        class NoTableOp(BasicDPOperator):
            def transition_table(self, ks, limit=None):
                return None

        s = ElasticScheduler()
        tasks = self._tasks()
        assert s._table_for(NoTableOp(8), tasks, ("x", 8)) is None
        assert s._table_for(NoTableOp(8), tasks, ("x", 8)) is None
        assert s.table_cache_hits == 1  # the None verdict itself is cached


# ---------------------------------------------------------------------------
# ESTIMATE sorted-merge replay == the heap simulation it replaced
# ---------------------------------------------------------------------------


def _heap_replay_reference(base, durs):
    heap = list(base)
    heapq.heapify(heap)
    obj = 0.0
    for t in durs:
        ts = heapq.heappop(heap) if heap else 0.0
        obj += ts + t
        heapq.heappush(heap, ts + t)
    return obj


def test_sorted_merge_replay_matches_heap_replay():
    rng = random.Random(4)
    for _ in range(300):
        base = sorted(round(rng.uniform(0.0, 20.0), 3) for _ in range(rng.randint(0, 12)))
        durs = [round(rng.uniform(0.01, 10.0), 3) for _ in range(rng.randint(1, 15))]
        want = _heap_replay_reference(base, durs)
        got = ElasticScheduler._replay(base, durs[0], durs[1:])
        assert got == pytest.approx(want, abs=1e-12)


def test_estimate_empty_rest_is_zero():
    s = ElasticScheduler()
    assert s._estimate([1.0, 2.0], []) == 0.0


# ---------------------------------------------------------------------------
# incremental candidate window == the per-prefix rescan it replaced
# ---------------------------------------------------------------------------


def test_candidate_window_incremental_matches_rescan():
    rng = random.Random(5)
    for _ in range(50):
        managers = {
            "cpu": CpuManager(
                [
                    CpuNodeSpec("n0", cores=rng.randint(2, 8), memory_gb=24.0),
                    CpuNodeSpec("n1", cores=rng.randint(2, 8), memory_gb=16.0),
                ]
            )
        }
        waiting = []
        for i in range(rng.randint(1, 14)):
            a = Action(
                name=f"a{i}",
                cost={"cpu": fixed("cpu", rng.randint(1, 4))},
                trajectory_id=f"t{i}",
                metadata={"traj_mem_gb": rng.choice([2.0, 4.0, 8.0])},
            )
            waiting.append(a)
        s = ElasticScheduler()
        fast = s._candidate_window(waiting, managers)
        # reference: the seed's per-prefix full rescan
        best = 0
        for i in range(1, len(waiting) + 1):
            prefix = waiting[:i]
            touched = {r for a in prefix for r in a.cost}
            ok = all(
                managers[r].can_accommodate([a for a in prefix if r in a.cost])
                for r in touched
                if r in managers
            )
            if ok:
                best = i
            else:
                break
        assert [a.uid for a in fast] == [a.uid for a in waiting[:best]]


# ---------------------------------------------------------------------------
# end-to-end: dense scheduling decisions == reference scheduling decisions
# ---------------------------------------------------------------------------


def test_schedule_decisions_identical_dense_vs_ref():
    rng = random.Random(6)
    for _ in range(25):
        n = rng.randint(1, 24)
        waiting = []
        for i in range(n):
            if rng.random() < 0.4:
                waiting.append(
                    Action(
                        name=f"s{i}",
                        cost={"cpu": ResourceRequest("cpu", (1, 2, 4, 8))},
                        key_resource="cpu",
                        elasticity=AmdahlElasticity(0.05),
                        base_duration=rng.uniform(1.0, 30.0),
                        trajectory_id=f"t{i}",
                    )
                )
            else:
                waiting.append(
                    Action(
                        name=f"r{i}",
                        cost={"cpu": fixed("cpu", rng.randint(1, 2))},
                        base_duration=1.0,
                        trajectory_id=f"t{i}",
                    )
                )
        cores = rng.choice([8, 16, 32])
        m_dense = {"cpu": CpuManager([CpuNodeSpec("n0", cores=cores)])}
        m_ref = {"cpu": CpuManager([CpuNodeSpec("n0", cores=cores)])}
        s_dense = ElasticScheduler(depth=2)
        s_ref = ElasticScheduler(depth=2)
        s_ref.use_dense = False
        r_dense = s_dense.schedule(waiting, [], m_dense, 0.0)
        r_ref = s_ref.schedule(waiting, [], m_ref, 0.0)
        assert r_dense.objective == r_ref.objective
        assert r_dense.evicted == r_ref.evicted
        assert [(d.action.uid, d.units) for d in r_dense.decisions] == [
            (d.action.uid, d.units) for d in r_ref.decisions
        ]

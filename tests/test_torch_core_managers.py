"""The port's copy of the control plane (``repro_torch.core``) under the
reference suite ``tests/test_managers.py``, imports rewritten, each case kept.

The reference suite's own description follows.

Resource managers (§5): chunk allocator, AOE CPU, EOE GPU, Basic."""


import pytest

from _hypothesis_compat import given, settings, st

from repro_torch.core.action import Action, AmdahlElasticity, fixed, ranged, ResourceRequest
from repro_torch.core.cluster import ApiResourceSpec, CpuNodeSpec, GpuNodeSpec
from repro_torch.core.managers.basic import BasicResourceManager
from repro_torch.core.managers.cpu import CpuManager
from repro_torch.core.managers.gpu import ChunkAllocator, GpuManager, ServiceSpec
from repro_torch.core.simulator import SimClock


# ---------------------------------------------------------------------------
# Chunk allocator (buddy, §5.3 Pool)
# ---------------------------------------------------------------------------


class TestChunkAllocator:
    def test_legal_chunks_only(self):
        a = ChunkAllocator(8)
        got = a.allocate(3, None, 0.0)
        assert got is not None
        start, level, hit = got
        assert level == 2 and start % 4 == 0  # 3 GPUs -> a 4-chunk
        a.check_invariants()

    def test_split_and_merge(self):
        a = ChunkAllocator(8)
        c1 = a.allocate(1, None, 0.0)
        c2 = a.allocate(1, None, 0.0)
        a.check_invariants()
        a.release(c1[0], c1[1], None, 1.0)
        a.release(c2[0], c2[1], None, 1.0)
        # full node reclaimable after merge
        c8 = a.allocate(8, None, 2.0)
        assert c8 is not None and c8[1] == 3
        a.check_invariants()

    def test_cache_hit_preferred(self):
        a = ChunkAllocator(8)
        c = a.allocate(2, ("rm", 2), 0.0)
        a.release(c[0], c[1], ("rm", 2), 1.0)
        c2 = a.allocate(2, ("rm", 2), 2.0)
        assert c2[2] is True  # cache hit
        assert c2[0] == c[0]

    def test_lru_eviction_victim(self):
        a = ChunkAllocator(8)
        chunks = []
        for i in range(4):
            chunks.append(a.allocate(2, (f"s{i}", 2), float(i)))
        for i, c in enumerate(chunks):
            a.release(c[0], c[1], (f"s{i}", 2), 10.0 + i)
        # all four 2-chunks cached; a new service must evict the LRU (s0)
        got = a.allocate(2, ("new", 2), 100.0)
        assert got is not None
        assert got[0] == chunks[0][0]  # s0's chunk was LRU

    def test_exhaustion(self):
        a = ChunkAllocator(8)
        assert a.allocate(8, None, 0.0) is not None
        assert a.allocate(1, None, 0.0) is None


@settings(max_examples=150, deadline=None)
@given(ops=st.lists(st.tuples(st.booleans(), st.sampled_from([1, 2, 3, 4, 5, 8])), max_size=30))
def test_chunk_allocator_invariants_hold(ops):
    """Random alloc/release interleavings never corrupt the buddy state."""
    a = ChunkAllocator(8)
    held = []
    t = 0.0
    for is_alloc, m in ops:
        t += 1.0
        if is_alloc or not held:
            got = a.allocate(m, ("svc", m), t)
            if got is not None:
                held.append(got)
        else:
            start, level, _ = held.pop()
            a.release(start, level, ("svc", 1 << level), t)
        a.check_invariants()
    for start, level, _ in held:
        a.release(start, level, None, t)
    a.check_invariants()
    assert a.free_capacity == 8


# ---------------------------------------------------------------------------
# CPU manager (AOE, §5.2)
# ---------------------------------------------------------------------------


def cpu_action(traj, lo=1, hi=8, mem=4.0):
    return Action(
        name="exec",
        cost={"cpu": ranged("cpu", lo, hi)},
        key_resource="cpu",
        elasticity=AmdahlElasticity(0.1),
        base_duration=5.0,
        trajectory_id=traj,
        metadata={"traj_mem_gb": mem},
    )


class TestCpuManager:
    def test_numa_affinity(self):
        mgr = CpuManager([CpuNodeSpec("n0", cores=16, numa_nodes=2)])
        a = cpu_action("t1", 1, 8)
        alloc = mgr.try_allocate(a, 6)
        assert alloc is not None
        assert len(alloc.detail["numa_domains"]) == 1  # fits one domain

    def test_trajectory_node_binding(self):
        mgr = CpuManager([CpuNodeSpec(f"n{i}", cores=16) for i in range(3)])
        a1, a2 = cpu_action("tA"), cpu_action("tA")
        al1 = mgr.try_allocate(a1, 2)
        al2 = mgr.try_allocate(a2, 2)
        assert al1.node == al2.node  # same trajectory -> same node

    def test_memory_load_balancing(self):
        mgr = CpuManager([CpuNodeSpec("n0", cores=16, memory_gb=100),
                          CpuNodeSpec("n1", cores=16, memory_gb=200)])
        a = cpu_action("tB", mem=50.0)
        alloc = mgr.try_allocate(a, 1)
        assert alloc.node == "n1"  # most free memory wins

    def test_memory_released_at_trajectory_end(self):
        mgr = CpuManager([CpuNodeSpec("n0", cores=16, memory_gb=10)])
        a = cpu_action("tC", mem=8.0)
        alloc = mgr.try_allocate(a, 1)
        assert alloc is not None
        mgr.release(a, alloc)
        # second trajectory cannot fit 8 GB until tC ends
        b = cpu_action("tD", mem=8.0)
        assert mgr.try_allocate(b, 1) is None
        mgr.trajectory_end("tC")
        assert mgr.try_allocate(b, 1) is not None

    def test_exclusive_cores(self):
        mgr = CpuManager([CpuNodeSpec("n0", cores=8, numa_nodes=1)])
        a1, a2 = cpu_action("t1"), cpu_action("t2")
        al1 = mgr.try_allocate(a1, 4)
        al2 = mgr.try_allocate(a2, 4)
        assert set(al1.detail["cores"]).isdisjoint(al2.detail["cores"])
        assert mgr.try_allocate(cpu_action("t3"), 1) is None

    def test_partition_per_node(self):
        mgr = CpuManager([CpuNodeSpec(f"n{i}", cores=8) for i in range(2)])
        acts = [cpu_action(f"t{i}") for i in range(4)]
        parts = mgr.partition(acts)
        assert sum(len(v) for v in parts.values()) == 4
        # every action's trajectory is bound after partitioning
        for a in acts:
            assert mgr.node_of(a.trajectory_id) is not None


# ---------------------------------------------------------------------------
# GPU manager (EOE, §5.3)
# ---------------------------------------------------------------------------


def gpu_action(svc, traj="g0", dops=(1, 2, 4, 8)):
    return Action(
        name=f"rm:{svc}",
        cost={"gpu": ResourceRequest("gpu", tuple(dops))},
        key_resource="gpu",
        elasticity=AmdahlElasticity(0.15),
        base_duration=4.0,
        service=svc,
        trajectory_id=traj,
    )


class TestGpuManager:
    def make(self, nodes=2):
        return GpuManager(
            [GpuNodeSpec(f"g{i}", devices=8, restore_bw_gbps=64.0) for i in range(nodes)],
            [ServiceSpec("rm0", 40.0), ServiceSpec("rm1", 40.0)],
        )

    def test_miss_then_hit(self):
        mgr = self.make()
        a = gpu_action("rm0")
        al = mgr.try_allocate(a, 2)
        assert al is not None and al.detail["hit"] is False
        assert al.overhead > 0.5  # 40 GB / 64 GBps restore
        mgr.release(a, al)
        b = gpu_action("rm0")
        al2 = mgr.try_allocate(b, 2)
        assert al2.detail["hit"] is True
        assert al2.overhead < 0.01

    def test_distinct_dop_is_distinct_service(self):
        mgr = self.make()
        a = gpu_action("rm0")
        al = mgr.try_allocate(a, 2)
        mgr.release(a, al)
        b = gpu_action("rm0")
        al2 = mgr.try_allocate(b, 4)  # different DoP -> miss
        assert al2.detail["hit"] is False

    def test_unknown_service_rejected(self):
        mgr = self.make()
        with pytest.raises(KeyError):
            mgr.try_allocate(gpu_action("never_deployed"), 2)

    def test_feasible_multiset(self):
        mgr = self.make(nodes=1)
        assert mgr.feasible_multiset((0, 0, 0, 1))  # one 8-chunk
        assert mgr.feasible_multiset((0, 0, 2, 0))  # split into two 4s
        assert not mgr.feasible_multiset((1, 0, 0, 1))  # 9 devices > 8

    def test_hit_rate_stats(self):
        mgr = self.make()
        for _ in range(3):
            a = gpu_action("rm0")
            al = mgr.try_allocate(a, 2)
            mgr.release(a, al)
        assert mgr.stats["hits"] == 2 and mgr.stats["misses"] == 1


# ---------------------------------------------------------------------------
# Basic manager (§5.1)
# ---------------------------------------------------------------------------


class TestBasicManager:
    def test_concurrency_mode(self):
        clock = SimClock()
        mgr = BasicResourceManager(
            ApiResourceSpec("api", mode="concurrency", max_concurrency=2), clock
        )
        a1 = Action("q", cost={"api": fixed("api")})
        a2 = Action("q", cost={"api": fixed("api")})
        a3 = Action("q", cost={"api": fixed("api")})
        al1, al2 = mgr.try_allocate(a1, 1), mgr.try_allocate(a2, 1)
        assert al1 and al2
        assert mgr.try_allocate(a3, 1) is None
        mgr.release(a1, al1)
        assert mgr.try_allocate(a3, 1) is not None

    def test_quota_mode_refills(self):
        clock = SimClock()
        mgr = BasicResourceManager(
            ApiResourceSpec("api", mode="quota", quota=2, period_s=60.0), clock
        )
        a = Action("q", cost={"api": fixed("api")})
        assert mgr.try_allocate(a, 1) is not None
        assert mgr.try_allocate(a, 1) is not None
        assert mgr.try_allocate(a, 1) is None  # quota spent
        clock._advance(61.0)
        assert mgr.try_allocate(a, 1) is not None  # refilled

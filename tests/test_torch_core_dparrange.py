"""The port's copy of the control plane (``repro_torch.core``) under the
reference suite ``tests/test_dparrange.py``, imports rewritten, each case kept.

The reference suite's own description follows.

DPArrange (Algorithms 3 & 4): unit + property tests vs brute force."""


import pytest

from _hypothesis_compat import given, settings, st

from repro_torch.core.dparrange import (
    BasicDPOperator,
    DPTask,
    GpuChunkDPOperator,
    brute_force_arrange,
    dp_arrange,
)


def make_task(name, units, t_ori, serial=0.1):
    durs = tuple(t_ori / (m / (1 + serial * (m - 1))) for m in units)
    return DPTask(name, tuple(units), durs)


class TestBasicOperator:
    def test_single_task_takes_best_units(self):
        t = make_task("a", (1, 2, 4, 8), 8.0, serial=0.0)  # perfect scaling
        res = dp_arrange([t], BasicDPOperator(8))
        assert res is not None
        assert res.allocation["a"] == 8
        assert res.total_duration == pytest.approx(1.0)

    def test_respects_capacity(self):
        tasks = [make_task(f"t{i}", (1, 2, 4), 4.0) for i in range(3)]
        res = dp_arrange(tasks, BasicDPOperator(4))
        assert res is not None
        assert sum(res.allocation.values()) <= 4
        assert all(res.allocation[t.name] >= 1 for t in tasks)

    def test_infeasible_returns_none(self):
        tasks = [make_task(f"t{i}", (2, 4), 1.0) for i in range(3)]
        assert dp_arrange(tasks, BasicDPOperator(5)) is None

    def test_inexact_total_is_handled(self):
        # sets {1,4} x2 with 7 units: exact-7 impossible, best feasible is 5
        tasks = [make_task("a", (1, 4), 8.0, 0.0), make_task("b", (1, 4), 8.0, 0.0)]
        res = dp_arrange(tasks, BasicDPOperator(7))
        assert res is not None
        assert sorted(res.allocation.values()) == [1, 4]

    def test_prefers_scaling_long_task(self):
        long = make_task("long", (1, 2, 4), 100.0, serial=0.0)
        short = make_task("short", (1, 2, 4), 1.0, serial=0.0)
        res = dp_arrange([long, short], BasicDPOperator(5))
        assert res.allocation["long"] == 4
        assert res.allocation["short"] == 1


@settings(max_examples=200, deadline=None)
@given(
    n_tasks=st.integers(1, 4),
    total=st.integers(1, 10),
    data=st.data(),
)
def test_basic_dp_matches_brute_force(n_tasks, total, data):
    tasks = []
    for i in range(n_tasks):
        units = tuple(
            sorted(
                data.draw(
                    st.sets(st.integers(1, 6), min_size=1, max_size=4),
                    label=f"units{i}",
                )
            )
        )
        durs = tuple(
            data.draw(
                st.floats(0.1, 100.0, allow_nan=False, allow_infinity=False),
                label=f"dur{i}_{k}",
            )
            for k in units
        )
        tasks.append(DPTask(f"t{i}", units, durs))
    got = dp_arrange(tasks, BasicDPOperator(total))
    want = brute_force_arrange(tasks, total)
    if want is None:
        assert got is None
    else:
        assert got is not None
        assert got.total_duration == pytest.approx(want.total_duration)
        # allocation must itself be feasible and consistent
        assert sum(got.allocation.values()) <= total
        recomputed = sum(
            t.durations[t.units.index(got.allocation[t.name])] for t in tasks
        )
        assert recomputed == pytest.approx(got.total_duration)


class TestGpuChunkOperator:
    def test_encode_decode_roundtrip(self):
        op = GpuChunkDPOperator((8, 4, 2, 1))
        for a in range(9):
            for b in range(5):
                for c in range(3):
                    for d in range(2):
                        assert op.decode(op.encode((a, b, c, d))) == (a, b, c, d)

    def test_greedy_decompose(self):
        gd = GpuChunkDPOperator.greedy_decompose
        assert gd(8) == (0, 0, 0, 1)
        assert gd(7) == (1, 1, 1, 0)
        assert gd(1) == (1, 0, 0, 0)
        assert gd(0) is None

    def test_prev_consumes_from_state(self):
        op = GpuChunkDPOperator((8, 4, 2, 1))
        j = op.encode((2, 1, 0, 0))  # consumed: two 1-chunks + one 2-chunk
        # allocating 2 more GPUs from predecessor: prev must remove a 2-chunk
        p = op.prev(j, 2)
        assert p is not None
        assert op.decode(p) == (2, 0, 0, 0)

    def test_prev_insufficient(self):
        op = GpuChunkDPOperator((8, 4, 2, 1))
        j = op.encode((1, 0, 0, 0))
        assert op.prev(j, 4) is None

    def test_dp_with_chunk_topology(self):
        # one 8-GPU node, two tasks wanting {1,2,4,8}: best is 4+4
        op = GpuChunkDPOperator((8, 4, 2, 1), total_devices=8)
        tasks = [make_task(f"t{i}", (1, 2, 4, 8), 8.0, serial=0.0) for i in range(2)]
        res = dp_arrange(tasks, op)
        assert res is not None
        assert sorted(res.allocation.values()) == [4, 4]
        assert res.total_duration == pytest.approx(4.0)

    def test_feasibility_callback_restricts(self):
        # feasible() rejects any use of 4-chunks -> forces 2+2
        def feas(counts):
            return counts[2] == 0 and counts[3] == 0

        op = GpuChunkDPOperator((8, 4, 2, 1), feasible=feas)
        tasks = [make_task(f"t{i}", (1, 2, 4), 8.0, serial=0.0) for i in range(2)]
        res = dp_arrange(tasks, op)
        assert res is not None
        assert max(res.allocation.values()) <= 2


@settings(max_examples=100, deadline=None)
@given(n_tasks=st.integers(1, 3), data=st.data())
def test_gpu_dp_matches_brute_force_on_pow2(n_tasks, data):
    """With power-of-two unit sets and a single node the chunk DP must
    equal the unconstrained brute force (an 8-device buddy pool can
    realize any power-of-two multiset that fits)."""
    tasks = []
    for i in range(n_tasks):
        units = tuple(
            sorted(
                data.draw(
                    st.sets(st.sampled_from([1, 2, 4, 8]), min_size=1, max_size=4),
                    label=f"units{i}",
                )
            )
        )
        durs = tuple(
            data.draw(st.floats(0.1, 50.0, allow_nan=False), label=f"d{i}{k}")
            for k in units
        )
        tasks.append(DPTask(f"t{i}", units, durs))

    def pool_feasible(counts):
        total = sum(c * s for c, s in zip(counts, (1, 2, 4, 8)))
        return total <= 8

    op = GpuChunkDPOperator((8, 4, 2, 1), feasible=pool_feasible)
    got = dp_arrange(tasks, op)
    want = brute_force_arrange(tasks, 8)
    if want is None:
        assert got is None
    else:
        assert got is not None
        assert got.total_duration == pytest.approx(want.total_duration)

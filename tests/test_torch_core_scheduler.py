"""The port's copy of the control plane (``repro_torch.core``) under the
reference suite ``tests/test_scheduler.py``, imports rewritten, each case kept.

The reference suite's own description follows.

Elastic scheduler (Algorithms 1 & 2): unit + property tests."""



from _hypothesis_compat import given, settings, st

from repro_torch.core.action import (
    Action,
    AmdahlElasticity,
    fixed,
    powers_of_two,
    ranged,
)
from repro_torch.core.managers.base import ResourceManager
from repro_torch.core.scheduler import ElasticScheduler


def scal(name, traj, base=10.0, lo=1, hi=8, serial=0.1):
    return Action(
        name=name,
        cost={"cpu": ranged("cpu", lo, hi)},
        key_resource="cpu",
        elasticity=AmdahlElasticity(serial),
        base_duration=base,
        trajectory_id=traj,
    )


def rigid(name, traj, units=1):
    return Action(name=name, cost={"cpu": fixed("cpu", units)}, trajectory_id=traj)


def mgr(capacity=16):
    return {"cpu": ResourceManager("cpu", capacity)}


class TestCandidateWindow:
    def test_fcfs_prefix(self):
        s = ElasticScheduler()
        waiting = [rigid(f"a{i}", f"t{i}", units=8) for i in range(4)]
        res = s.schedule(waiting, [], mgr(16), 0.0)
        # only the first two fit at min units
        assert len(res.decisions) == 2
        assert [d.action.name for d in res.decisions] == ["a0", "a1"]

    def test_empty_queue(self):
        s = ElasticScheduler()
        assert s.schedule([], [], mgr(), 0.0).decisions == []

    def test_head_blocks_window(self):
        """FCFS: an oversized head blocks later actions (anti-starvation)."""
        s = ElasticScheduler()
        waiting = [rigid("big", "t0", units=32), rigid("small", "t1", units=1)]
        res = s.schedule(waiting, [], mgr(16), 0.0)
        assert res.decisions == []


class TestElasticAllocation:
    def test_lone_scalable_action_gets_more_units(self):
        s = ElasticScheduler()
        res = s.schedule([scal("a", "t0", serial=0.0)], [], mgr(16), 0.0)
        assert len(res.decisions) == 1
        assert res.decisions[0].units["cpu"] == 8  # max feasible

    def test_constraints_never_violated(self):
        s = ElasticScheduler()
        waiting = [scal(f"a{i}", f"t{i}") for i in range(6)]
        res = s.schedule(waiting, [], mgr(16), 0.0)
        total = sum(d.units["cpu"] for d in res.decisions)
        assert total <= 16
        for d in res.decisions:
            assert d.units["cpu"] in d.action.cost["cpu"].units

    def test_greedy_eviction_defers_tail(self):
        """16 cores, 8 perfectly elastic long actions: evicting some tail
        candidates and scaling the head ones up should win."""
        s = ElasticScheduler()
        waiting = [scal(f"a{i}", f"t{i}", base=100.0, serial=0.0) for i in range(8)]
        res = s.schedule(waiting, [], mgr(16), 0.0)
        assert 1 <= len(res.decisions) <= 8
        assert res.evicted == 8 - len(res.decisions)
        # whatever is kept must use the full pool (perfect elasticity)
        assert sum(d.units["cpu"] for d in res.decisions) <= 16

    def test_mixed_scalable_and_rigid(self):
        s = ElasticScheduler()
        waiting = [rigid("r0", "t0"), scal("s0", "t1"), rigid("r1", "t2")]
        res = s.schedule(waiting, [], mgr(16), 0.0)
        names = {d.action.name for d in res.decisions}
        assert {"r0", "r1"} <= names  # rigid actions selected directly

    def test_unknown_duration_not_scaled(self):
        s = ElasticScheduler()
        a = Action(
            name="u",
            cost={"cpu": ranged("cpu", 1, 8)},
            key_resource="cpu",
            elasticity=AmdahlElasticity(0.1),
            base_duration=None,  # unknown -> treated as non-scalable
            trajectory_id="t0",
        )
        res = s.schedule([a], [], mgr(16), 0.0)
        assert res.decisions[0].units["cpu"] == 1


class TestDepthProbes:
    def test_depth_probes_bounded(self):
        s = ElasticScheduler(depth=2)
        probes = s._depth_probes(scal("a", "t"))
        assert len(probes) <= 2

    def test_rigid_probe_single(self):
        s = ElasticScheduler(depth=3)
        assert s._depth_probes(rigid("a", "t")) == [None]


@settings(max_examples=80, deadline=None)
@given(
    n=st.integers(1, 10),
    capacity=st.integers(1, 32),
    data=st.data(),
)
def test_schedule_never_violates_capacity(n, capacity, data):
    s = ElasticScheduler()
    waiting = []
    for i in range(n):
        if data.draw(st.booleans(), label=f"scalable{i}"):
            base = data.draw(st.floats(0.1, 100.0, allow_nan=False), label=f"b{i}")
            hi = data.draw(st.integers(1, 8), label=f"hi{i}")
            waiting.append(scal(f"a{i}", f"t{i}", base=base, hi=hi))
        else:
            units = data.draw(st.integers(1, 4), label=f"u{i}")
            waiting.append(rigid(f"a{i}", f"t{i}", units=units))
    res = s.schedule(waiting, [], mgr(capacity), 0.0)
    assert sum(d.units["cpu"] for d in res.decisions) <= capacity
    # FCFS relative order among decisions of the same kind is preserved
    uids = [d.action.uid for d in res.decisions]
    assert all(d.units["cpu"] in d.action.cost["cpu"].units for d in res.decisions)


@settings(max_examples=40, deadline=None)
@given(n=st.integers(2, 8), data=st.data())
def test_eviction_monotone_objective(n, data):
    """The kept set's approximated objective never exceeds the full set's."""
    s = ElasticScheduler()
    waiting = [
        scal(
            f"a{i}",
            f"t{i}",
            base=data.draw(st.floats(1.0, 50.0, allow_nan=False), label=f"b{i}"),
        )
        for i in range(n)
    ]
    managers = mgr(8)
    full_obj, _ = s._approx_objective(
        waiting, [], "cpu", managers["cpu"], [], 0.0
    )
    res = s.schedule(waiting, [], managers, 0.0)
    assert res.objective <= full_obj + 1e-9


class TestBeyondPaperModes:
    """Opt-in scheduler extensions (EXPERIMENTS.md §Perf, scheduler
    iterations): dp_avg deferred-action pricing, exhaustive eviction
    search, and the DoP floor."""

    def _burst(self, n=24, base=55.0):
        return [
            Action(
                name=f"r{i}",
                cost={"cpu": powers_of_two("cpu", 1, 32)},
                key_resource="cpu",
                elasticity=AmdahlElasticity(0.05),
                base_duration=base,
                trajectory_id=f"t{i}",
            )
            for i in range(n)
        ]

    def test_paper_default_spreads_min_units(self):
        """Paper-faithful Alg. 1/2 on a synchronized burst: min-unit
        pricing of deferred actions means eviction never engages and
        everyone runs thin."""
        s = ElasticScheduler()
        res = s.schedule(self._burst(), [], mgr(48), 0.0)
        assert len(res.decisions) == 24
        assert all(d.units["cpu"] <= 2 for d in res.decisions)

    def test_dp_avg_exhaustive_wave_forms(self):
        """dp_avg pricing + exhaustive prefix scan discovers the
        wave: keep a few candidates at high DoP, defer the rest."""
        s = ElasticScheduler(estimate_units="dp_avg")
        s.eviction_search = "exhaustive"
        res = s.schedule(self._burst(), [], mgr(48), 0.0)
        assert res.evicted > 0
        assert all(d.units["cpu"] >= 4 for d in res.decisions)

    def test_dop_floor_enforced_when_feasible(self):
        s = ElasticScheduler(estimate_units="dp_avg")
        s.eviction_search = "exhaustive"
        s.dop_floor = 4
        res = s.schedule(self._burst(n=8), [], mgr(48), 0.0)
        assert res.decisions
        assert all(d.units["cpu"] >= 4 for d in res.decisions)

    def test_dop_floor_falls_back_when_starved(self):
        """If not even one action can get the floor and no in-flight
        completion guarantees a future round, the scheduler falls back to
        paper behaviour (min units) rather than starving the FCFS head."""
        s = ElasticScheduler(estimate_units="dp_avg")
        s.eviction_search = "exhaustive"
        s.dop_floor = 4
        res = s.schedule(self._burst(n=2), [], mgr(2), 0.0)
        assert len(res.decisions) == 2
        assert all(d.units["cpu"] == 1 for d in res.decisions)

    def test_dop_floor_defers_with_inflight(self):
        """With an in-flight completion due, the floor defers the queue
        instead of grabbing sub-floor scraps."""
        inflight = scal("busy", "tb", base=10.0)
        inflight.finish_time = 5.0
        s = ElasticScheduler(estimate_units="dp_avg")
        s.eviction_search = "exhaustive"
        s.dop_floor = 4
        res = s.schedule(self._burst(n=2), [inflight], mgr(2), 0.0)
        assert res.decisions == []

"""The port's copy of the control plane (``repro_torch.core``) under the
reference suite ``tests/test_rebalance.py``, imports rewritten, each case kept.

The reference suite's own description follows.

Telemetry-driven rebalance: policy decisions and the DES cadence.

Two layers: :class:`RebalancePolicy.decide` is a pure function of one
tick's signals (unit-testable in isolation — source/sink selection,
hysteresis, move batching), and the orchestrator cadence wires it to
live telemetry on a virtual-time period (integration — measured ACT
improvement on an asymmetric fleet, determinism, clean termination).
"""

import pytest

from repro_torch.core.action import Action, fixed
from repro_torch.core.fairqueue import FairSharePolicy
from repro_torch.core.managers.base import ResourceManager
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.rebalance import RebalancePolicy, RebalanceSignals
from repro_torch.core.scenarios import (
    build_managers,
    install_scenario,
    straggler_fleet_spec,
)
from repro_torch.core.simulator import EventLoop
from repro_torch.core.transport import WorkerServer, socket_fleet


# ---------------------------------------------------------------------------
# policy unit tests
# ---------------------------------------------------------------------------


def _signals(depths, backlogs=None, **kw):
    sig = RebalanceSignals(now=kw.pop("now", 10.0))
    sig.depths = dict(depths)
    sig.backlogs = {p: dict(b) for p, b in (backlogs or {}).items()}
    for name in ("backlog_cost", "starvation", "utilization", "plan_cost_s"):
        setattr(sig, name, kw.pop(name, {}))
    assert not kw
    return sig


class TestRebalancePolicy:
    def test_moves_from_deepest_to_shallowest(self):
        sig = _signals(
            {"a": 8, "b": 0, "c": 4},
            backlogs={"a": {"t1": 4, "t2": 4}},
        )
        moves = RebalancePolicy(max_moves=1).decide(sig, ["a", "b", "c"])
        assert moves == [("t1", "a", "b")]

    def test_hysteresis_blocks_small_gaps(self):
        sig = _signals({"a": 3, "b": 1}, backlogs={"a": {"t": 1}})
        assert RebalancePolicy(min_gap=2).decide(sig, ["a", "b"]) == []
        # one deeper and the same shape moves
        sig = _signals({"a": 4, "b": 1}, backlogs={"a": {"t": 1}})
        assert RebalancePolicy(min_gap=2).decide(sig, ["a", "b"]) == [
            ("t", "a", "b")
        ]

    def test_saturated_sink_is_skipped(self):
        sig = _signals(
            {"a": 8, "b": 0, "c": 1},
            backlogs={"a": {"t": 4}},
            utilization={"b": 1.0, "c": 0.5},
        )
        moves = RebalancePolicy(max_moves=1).decide(sig, ["a", "b", "c"])
        assert moves == [("t", "a", "c")]  # b is busier than the ceiling

    def test_all_sinks_saturated_means_no_moves(self):
        sig = _signals(
            {"a": 8, "b": 0},
            backlogs={"a": {"t": 4}},
            utilization={"b": 0.99},
        )
        assert RebalancePolicy().decide(sig, ["a", "b"]) == []

    def test_subqueue_closest_to_half_gap_wins(self):
        """gap=8: a 4-action sub-queue evens the pair exactly; 1 and 7
        are worse; 8 would invert and is refused outright."""
        sig = _signals(
            {"a": 8, "b": 0},
            backlogs={"a": {"small": 1, "mid": 4, "big": 7}},
        )
        moves = RebalancePolicy(max_moves=1).decide(sig, ["a", "b"])
        assert moves == [("mid", "a", "b")]

    def test_move_that_inverts_the_gap_is_refused(self):
        sig = _signals({"a": 4, "b": 0}, backlogs={"a": {"t": 4}})
        assert RebalancePolicy().decide(sig, ["a", "b"]) == []

    def test_starvation_breaks_subqueue_ties(self):
        sig = _signals(
            {"a": 8, "b": 0},
            backlogs={"a": {"t1": 4, "t2": 4}},
            starvation={"a": {"t1": 1.0, "t2": 9.0}},
        )
        moves = RebalancePolicy(max_moves=1).decide(sig, ["a", "b"])
        assert moves == [("t2", "a", "b")]  # most starved moves first

    def test_starvation_breaks_source_ties(self):
        sig = _signals(
            {"a": 6, "b": 6, "c": 0},
            backlogs={"a": {"t": 3}, "b": {"u": 3}},
            starvation={"a": {"t": 2.0}, "b": {"u": 11.0}},
        )
        moves = RebalancePolicy(max_moves=1).decide(sig, ["a", "b", "c"])
        assert moves == [("u", "b", "c")]

    def test_plan_cost_breaks_remaining_ties(self):
        sig = _signals(
            {"a": 6, "b": 6, "c": 0},
            backlogs={"a": {"t": 3}, "b": {"u": 3}},
            plan_cost_s={"a": 0.5, "b": 0.1},
        )
        moves = RebalancePolicy(max_moves=1).decide(sig, ["a", "b", "c"])
        assert moves == [("t", "a", "c")]

    def test_batch_sees_earlier_moves(self):
        """max_moves=2 must not order the same move twice: the second
        decision sees the depths the first will produce."""
        sig = _signals(
            {"a": 12, "b": 0, "c": 0},
            backlogs={"a": {"t1": 4, "t2": 4, "t3": 4}},
        )
        moves = RebalancePolicy(max_moves=2).decide(sig, ["a", "b", "c"])
        assert len(moves) == 2
        assert moves[0][1] == "a" and moves[1][1] == "a"
        assert {m[2] for m in moves} == {"b", "c"}  # spread, not stacked
        assert len({m[0] for m in moves}) == 2  # two different sub-queues

    def test_decide_is_deterministic(self):
        sig = _signals(
            {"a": 9, "b": 2, "c": 4},
            backlogs={"a": {"x": 3, "y": 3, "z": 3}},
            starvation={"a": {"x": 1.0, "y": 1.0, "z": 1.0}},
        )
        p = RebalancePolicy(max_moves=3)
        assert p.decide(sig, ["a", "b", "c"]) == p.decide(sig, ["a", "b", "c"])

    def test_bad_period_rejected(self):
        with pytest.raises(ValueError):
            RebalancePolicy(period_s=0)


# ---------------------------------------------------------------------------
# orchestrator cadence
# ---------------------------------------------------------------------------


POOLS = [f"pool{k}" for k in range(4)]


def _fleet(rebalance, pools=4, cores=2, period_s=1.0):
    loop = EventLoop()
    managers = {p: ResourceManager(p, cores) for p in POOLS[:pools]}
    fs = FairSharePolicy(weights={"a": 2.0, "b": 1.0, "c": 1.0, "d": 1.0})
    orch = Orchestrator(managers, loop=loop, fair_share=fs)
    if rebalance:
        orch.enable_rebalance(POOLS[:pools], period_s=period_s)
    return orch


def _skewed_load(orch, n=48, duration=2.0):
    """Everything lands on pool0 — the asymmetric-fleet worst case."""
    futs = []
    for i in range(n):
        futs.append(orch.submit(Action(
            name=f"w{i}", cost={"pool0": fixed("pool0", 1)},
            base_duration=duration, task_id="abcd"[i % 4],
            trajectory_id=f"t{i}")))
    return futs


def _act(orch):
    recs = orch.telemetry.records
    return sum(r.finish - r.submit for r in recs) / len(recs)


class TestRebalanceCadence:
    def test_asymmetric_fleet_act_improves(self):
        """The acceptance rail: with all load keyed to one pool of a
        4-pool replica fleet, the cadence must spread it and win on ACT
        — by a lot, not at the margin."""
        base = _fleet(rebalance=False)
        _skewed_load(base)
        base.run()
        act_off = _act(base)
        base.close()

        orch = _fleet(rebalance=True)
        futs = _skewed_load(orch)
        orch.run()
        act_on = _act(orch)
        assert all(f.done() for f in futs)
        assert orch.telemetry.rebalance_ticks > 0
        assert orch.telemetry.rebalance_moves > 0
        assert orch.telemetry.migrations == orch.telemetry.rebalance_moves
        for m in orch.managers.values():
            m.check_occupancy()
        orch.close()
        assert act_on < act_off * 0.6  # >40% ACT win on this shape

    def test_migrated_work_really_runs_on_replicas(self):
        orch = _fleet(rebalance=True)
        _skewed_load(orch)
        orch.run()
        pools_used = {next(iter(r.units)) for r in orch.telemetry.records
                      if r.units}
        orch.close()
        assert len(pools_used) > 1  # not everything served by pool0

    def test_cadence_is_deterministic(self):
        def one_run():
            orch = _fleet(rebalance=True)
            _skewed_load(orch)
            orch.run()
            trace = sorted(
                (r.name, r.task_id, r.submit, r.start, r.finish)
                for r in orch.telemetry.records
            )
            stats = (orch.telemetry.rebalance_ticks,
                     orch.telemetry.rebalance_moves)
            orch.close()
            return trace, stats

        assert one_run() == one_run()

    def test_cadence_disarms_on_drain_and_rearms_on_enqueue(self):
        """run() must terminate (no immortal timer), and a second burst
        after the drain gets rebalanced too."""
        orch = _fleet(rebalance=True)
        _skewed_load(orch, n=24)
        orch.run()  # would hang here if the cadence never disarmed
        ticks_first = orch.telemetry.rebalance_ticks
        assert ticks_first > 0
        _skewed_load(orch, n=24)
        orch.run()
        assert orch.telemetry.rebalance_ticks > ticks_first
        assert orch.queue_depth() == 0
        orch.close()

    def test_balanced_load_makes_no_moves(self):
        orch = _fleet(rebalance=True)
        for i in range(24):
            pool = POOLS[i % 4]
            orch.submit(Action(
                name=f"w{i}", cost={pool: fixed(pool, 1)}, base_duration=2.0,
                task_id="abcd"[i % 4], trajectory_id=f"t{i}"))
        orch.run()
        assert orch.telemetry.rebalance_moves == 0
        orch.close()

    def test_unknown_replica_rejected(self):
        orch = _fleet(rebalance=False)
        with pytest.raises(ValueError):
            orch.enable_rebalance(["pool0", "nope"])
        orch.close()

    def test_custom_policy_and_period_override(self):
        orch = _fleet(rebalance=False)
        policy = RebalancePolicy(period_s=9.0, max_moves=1)
        orch.enable_rebalance(["pool0", "pool1"], policy=policy, period_s=0.5)
        assert policy.period_s == 0.5
        _skewed_load(orch, n=16)
        orch.run()
        assert orch.telemetry.rebalance_ticks > 0
        orch.close()

    def test_straggler_worker_flips_rebalance_source(self):
        """Remote-path straggler injection, end to end: the scenario
        fault schedule marks one socket worker a plan-phase straggler,
        the worker's inflated per-partition plan walls feed the
        client's plan-cost EWMA, and the rebalance source pick follows
        the EWMA off the straggled worker's pool.

        The non-vacuity gate is the symmetric flip.  Depth and
        starvation tie across the two loaded pools by construction, and
        the policy's final name tiebreak is *fixed* (``max`` on the
        name picks pool1) — so a first move sourced from **pool0** when
        worker 0 straggles is only reachable through the plan-cost
        signal, and the mirrored run (worker 1 -> pool1) proves the
        pick tracks the fault rather than any constant bias."""
        for straggled in (0, 1):
            moves, costs, served = self._run_straggled_fleet(straggled)
            src_pool = f"pool{straggled}"
            other_pool = f"pool{1 - straggled}"
            assert moves, "rebalance never moved anything"
            task, src, dst = moves[0]
            assert src == src_pool  # load migrates OFF the straggler
            assert dst == "pool2"  # ... onto the idle sink
            assert task.startswith(f"t{src_pool}")
            # the signal that decided it: the straggled worker's pool
            # shows an EWMA dominated by the injected delay, the healthy
            # worker's does not (4ms injected vs ~tens of us measured)
            assert costs[src_pool] > 10 * costs[other_pool]
            assert costs[src_pool] > 0.002
            # and the migration really ran: the sink served real work
            # while the straggled pool served less than the healthy one
            assert served.get("pool2", 0) > 0
            assert served[src_pool] < served[other_pool]

    @staticmethod
    def _run_straggled_fleet(straggler_worker):
        """One scenario-driven run over a two-worker socket fleet; the
        spec's fault schedule decides which endpoint straggles."""

        class _RecordingPolicy(RebalancePolicy):
            def __init__(self):
                super().__init__()
                self.moves = []
                self.first_costs = None

            def decide(self, sig, replicas):
                out = super().decide(sig, replicas)
                if out and self.first_costs is None:
                    self.first_costs = dict(sig.plan_cost_s)
                self.moves.extend(out)
                return out

        spec = straggler_fleet_spec(straggler_worker=straggler_worker)
        (fault,) = spec.stragglers()
        servers = [
            WorkerServer(
                plan_delay_s=fault.plan_delay_s if w == fault.worker else 0.0
            )
            for w in range(2)
        ]
        try:
            loop = EventLoop()
            orch = Orchestrator(
                build_managers(spec, loop), loop=loop, incremental=True,
                shards=2, plan_mode="remote",
                transport=socket_fleet([s.addr for s in servers]),
            )
            policy = _RecordingPolicy()
            orch.enable_rebalance([p.name for p in spec.pools], policy=policy)
            install_scenario(spec, orch)
            orch.run()
            served = {}
            for r in orch.telemetry.records:
                for pool in r.units:
                    served[pool] = served.get(pool, 0) + 1
            assert orch.queue_depth() == 0
            assert orch.telemetry.rebalance_moves == len(policy.moves)
            orch.close()
            return policy.moves, policy.first_costs or {}, served
        finally:
            for s in servers:
                s.close()

    def test_signals_snapshot_live_state(self):
        orch = _fleet(rebalance=True)
        _skewed_load(orch, n=12)
        orch.run(until=0.01)  # let the submit events enqueue
        sig = orch._rebalance_signals()
        assert sig.depths["pool0"] > 0
        assert sig.depths["pool1"] == 0
        assert set(sig.backlogs["pool0"]) <= {"a", "b", "c", "d"}
        assert all(v >= 0 for v in sig.starvation["pool0"].values())
        assert 0.0 <= sig.utilization["pool0"] <= 1.0
        assert sum(sig.backlog_cost["pool0"].values()) > 0
        orch.close()

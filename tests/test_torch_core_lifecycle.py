"""The port's copy of the control plane (``repro_torch.core``) under the
reference suite ``tests/test_lifecycle.py``, imports rewritten, each case kept.

The reference suite's own description follows.

Action lifecycle: deadlines, bounded retry, cancellation, and
failure propagation through managers, futures, and telemetry."""

import math

import pytest

from repro_torch.core.action import Action, ActionState, fixed
from repro_torch.core.cluster import CpuNodeSpec, GpuNodeSpec
from repro_torch.core.managers.base import ResourceManager
from repro_torch.core.managers.cpu import CpuManager
from repro_torch.core.managers.gpu import GpuManager, ServiceSpec
from repro_torch.core.orchestrator import (
    ActionCancelled,
    ActionTimeout,
    Orchestrator,
)
from repro_torch.core.simulator import EventLoop


def make_orch(cores=8):
    loop = EventLoop()
    return Orchestrator({"cpu": CpuManager([CpuNodeSpec("n0", cores=cores)])}, loop=loop)


def act(name="a", traj="t0", dur=1.0, units=1, **kw):
    return Action(
        name=name, cost={"cpu": fixed("cpu", units)}, base_duration=dur,
        trajectory_id=traj, **kw
    )


class TestTimeouts:
    def test_running_timeout_fails_and_releases(self):
        orch = make_orch()
        fut = orch.submit(act(dur=100.0, units=4, timeout_s=2.0))
        orch.run()
        assert fut.done()
        with pytest.raises(ActionTimeout):
            fut.result()
        # resources fully reclaimed via release_on_failure
        assert orch.managers["cpu"].available == 8
        assert orch.in_flight() == 0 and orch.queue_depth() == 0
        assert orch.telemetry.timeouts == 1
        assert orch.telemetry.failure_rate() == 1.0

    def test_queued_timeout_fails_without_start(self):
        orch = make_orch(cores=2)
        blocker = orch.submit(act(name="blocker", dur=50.0, units=2))
        fut = orch.submit(act(name="starved", traj="t1", dur=1.0, units=2,
                              timeout_s=5.0))
        orch.run()
        assert blocker.result() == pytest.approx(50.0)
        with pytest.raises(ActionTimeout):
            fut.result()
        rec = next(r for r in orch.telemetry.records if r.name == "starved")
        assert rec.failed and math.isnan(rec.start)

    def test_timeout_retry_then_success(self):
        """First attempt exceeds the deadline; the retry (faster sample)
        completes — the future resolves normally, telemetry counts one
        retry and one timeout."""
        orch = make_orch()
        durations = iter([100.0, 1.0])

        a = Action(
            name="flaky",
            cost={"cpu": fixed("cpu", 1)},
            duration_sampler=lambda m: next(durations),
            trajectory_id="t0",
            timeout_s=5.0,
            max_retries=2,
        )
        fut = orch.submit(a)
        orch.run()
        assert fut.result() == pytest.approx(1.0)
        assert a.state is ActionState.DONE
        assert a.attempts == 1
        assert orch.telemetry.timeouts == 1
        assert orch.telemetry.retries == 1
        rec = orch.telemetry.records[0]
        assert not rec.failed and rec.retries == 1
        assert rec.act == pytest.approx(5.0 + 1.0 + rec.sys_overhead)

    def test_bounded_retries_then_terminal_timeout(self):
        orch = make_orch()
        a = act(dur=100.0, timeout_s=1.0, max_retries=2)
        fut = orch.submit(a)
        orch.run()
        with pytest.raises(ActionTimeout):
            fut.result()
        assert a.state is ActionState.TIMEOUT
        assert a.attempts == 3  # initial + 2 retries
        assert orch.telemetry.timeouts == 3
        assert orch.telemetry.retries == 2
        rec = orch.telemetry.records[0]
        assert rec.failed and rec.retries == 2
        assert orch.managers["cpu"].available == 8

    def test_retry_requeues_at_fcfs_head(self):
        """After a timeout the retry goes back to the head of its
        partition, ahead of later arrivals."""
        orch = make_orch(cores=2)
        durations = iter([100.0, 1.0])
        flaky = Action(
            name="flaky",
            cost={"cpu": fixed("cpu", 2)},
            duration_sampler=lambda m: next(durations),
            trajectory_id="t0",
            timeout_s=2.0,
            max_retries=1,
        )
        orch.submit(flaky)
        later = orch.submit(act(name="later", traj="t1", dur=1.0, units=2), delay=0.5)
        orch.run()
        recs = {r.name: r for r in orch.telemetry.records}
        assert not recs["flaky"].failed
        # the retry launched before the younger action
        assert recs["flaky"].start < recs["later"].start

    def test_gpu_chunk_released_on_timeout(self):
        loop = EventLoop()
        gpu = GpuManager([GpuNodeSpec("g0")], [ServiceSpec("rm0", 40.0)])
        orch = Orchestrator({"gpu": gpu}, loop=loop)
        a = Action(
            name="rm", cost={"gpu": fixed("gpu", 4)}, base_duration=100.0,
            service="rm0", trajectory_id="t0", timeout_s=2.0,
        )
        fut = orch.submit(a)
        orch.run()
        assert fut.done()
        assert gpu.available == 8
        for alloc in gpu.allocators.values():
            alloc.check_invariants()


class TestCancellation:
    def test_cancel_queued(self):
        orch = make_orch(cores=2)
        orch.submit(act(name="run", dur=5.0, units=2))
        a = act(name="waiting", traj="t1", dur=1.0, units=2)
        fut = orch.submit(a)
        orch.run(until=1.0)
        assert a.state is ActionState.QUEUED
        assert orch.cancel(a)
        orch.run()
        with pytest.raises(ActionCancelled):
            fut.result()
        assert a.state is ActionState.CANCELLED
        assert orch.telemetry.cancellations == 1
        assert len(orch.telemetry.records) == 2  # blocker + cancelled

    def test_cancel_running_releases(self):
        orch = make_orch()
        a = act(dur=50.0, units=4)
        fut = orch.submit(a)
        orch.run(until=1.0)
        assert a.state is ActionState.RUNNING
        assert orch.cancel(a)
        assert orch.managers["cpu"].available == 8
        orch.run()
        with pytest.raises(ActionCancelled):
            fut.result()
        assert orch.in_flight() == 0

    def test_cancel_pending_delayed_submission(self):
        """Cancelling before the delayed submission lands must kill the
        pending enqueue — the action never resurrects, runs, or
        double-records."""
        orch = make_orch()
        a = act(dur=1.0)
        fut = orch.submit(a, delay=5.0)
        orch.run(until=1.0)
        assert orch.cancel(a)
        orch.run()
        with pytest.raises(ActionCancelled):
            fut.result()
        assert a.state is ActionState.CANCELLED
        recs = orch.telemetry.records
        assert len(recs) == 1 and recs[0].failed
        assert orch.queue_depth() == 0 and orch.in_flight() == 0

    def test_cancel_terminal_is_noop(self):
        orch = make_orch()
        a = act(dur=1.0)
        fut = orch.submit(a)
        orch.run()
        assert fut.result() == pytest.approx(1.0)
        assert not orch.cancel(a)
        assert orch.telemetry.cancellations == 0


class TestLifecycleSchedulingInteraction:
    def test_retry_releases_wake_other_partitions(self):
        """A timed-out multi-resource action whose retry re-queues
        blocked must still wake partitions waiting on the resources the
        withdrawn attempt freed (incremental == full)."""
        from repro_torch.core.cluster import ApiResourceSpec
        from repro_torch.core.managers.basic import BasicResourceManager

        def build(incremental):
            loop = EventLoop()
            quota = BasicResourceManager(
                ApiResourceSpec("a", mode="quota", quota=1, period_s=1000.0),
                loop.clock,
            )
            shared = ResourceManager("y", 1)
            orch = Orchestrator(
                {"a": quota, "y": shared}, loop=loop, incremental=incremental
            )
            # A consumes the only quota token AND the only y unit, hangs,
            # times out, and re-queues quota-blocked (token not refunded).
            hog = Action(
                name="hog",
                cost={"a": fixed("a"), "y": fixed("y")},
                key_resource="a",
                base_duration=100.0,
                trajectory_id="t0",
                timeout_s=5.0,
                max_retries=3,
            )
            orch.submit(hog)
            fut = orch.submit(
                Action(name="waiter", cost={"y": fixed("y")}, base_duration=1.0,
                       trajectory_id="t1"),
                delay=1.0,
            )
            orch.run(until=60.0)
            return fut

        for incremental in (True, False):
            fut = build(incremental)
            assert fut.done(), f"waiter starved (incremental={incremental})"

    def test_timeout_unblocks_queued_work(self):
        """A hung head action's timeout must free capacity for the queue
        behind it in the same virtual instant."""
        orch = make_orch(cores=2)
        orch.submit(act(name="hung", dur=1000.0, units=2, timeout_s=3.0))
        fut = orch.submit(act(name="next", traj="t1", dur=1.0, units=2))
        orch.run()
        assert fut.result() == pytest.approx(1.0)
        rec = next(r for r in orch.telemetry.records if r.name == "next")
        assert rec.start == pytest.approx(3.0, abs=0.01)

    def test_failure_rate_feeds_step_stats(self):
        from repro_torch.core.simulator import EventLoop as _Loop
        from repro_torch.rl.rollout import RolloutRunner
        from repro_torch.rl.tasks import ActionTemplate, TrajectorySpec, TurnSpec

        loop = _Loop()
        orch = Orchestrator(
            {"cpu": CpuManager([CpuNodeSpec("n0", cores=4)])}, loop=loop
        )

        def mk(timeout):
            return ActionTemplate(
                build=lambda task_id, traj_id: Action(
                    name="tool", cost={"cpu": fixed("cpu", 1)},
                    base_duration=10.0, trajectory_id=traj_id,
                    timeout_s=timeout,
                )
            )

        trajs = [
            TrajectorySpec(
                task_id="task", traj_id=f"t{i}", arrival_s=0.0,
                turns=[TurnSpec(gen_s=0.0, actions=[mk(1.0 if i == 0 else None)])],
                reward=[],
            )
            for i in range(3)
        ]
        runner = RolloutRunner({"*": orch, "cpu": orch}, loop)
        stats = runner.run_step(trajs)
        assert stats.failure_rate == pytest.approx(1 / 3)

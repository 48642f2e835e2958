"""The port's copy of the control plane (``repro_torch.core``) under the
reference suite ``tests/test_tangram.py``, imports rewritten, each case kept.

The reference suite's own description follows.

End-to-end Tangram system behaviour + baseline comparisons (DES)."""


import pytest

from repro_torch.core.action import Action, AmdahlElasticity, ResourceRequest, fixed, ranged
from repro_torch.core.baselines import (
    StaticGpuServiceSystem,
    TrajectoryStaticCpuSystem,
    UnmanagedApiSystem,
)
from repro_torch.core.cluster import ApiResourceSpec, CpuNodeSpec, GpuNodeSpec
from repro_torch.core.managers.basic import BasicResourceManager
from repro_torch.core.managers.cpu import CpuManager
from repro_torch.core.managers.gpu import GpuManager, ServiceSpec
from repro_torch.core.simulator import EventLoop
from repro_torch.core.tangram import Tangram


def make_tangram(cores=64, gpu_nodes=1, services=("rm0",)):
    loop = EventLoop()
    managers = {
        "cpu": CpuManager([CpuNodeSpec("n0", cores=cores)]),
        "gpu": GpuManager(
            [GpuNodeSpec(f"g{i}") for i in range(gpu_nodes)],
            [ServiceSpec(s, 40.0) for s in services],
        ),
        "api": BasicResourceManager(
            ApiResourceSpec("api", mode="concurrency", max_concurrency=8), loop.clock
        ),
    }
    return Tangram(managers, loop=loop)


def coding_action(traj, base=5.0, hi=8):
    return Action(
        name="reward:pytest",
        cost={"cpu": ranged("cpu", 1, hi)},
        key_resource="cpu",
        elasticity=AmdahlElasticity(0.08),
        base_duration=base,
        trajectory_id=traj,
    )


class TestTangramE2E:
    def test_all_actions_complete(self):
        tg = make_tangram()
        futs = [tg.submit(coding_action(f"t{i}"), delay=0.1 * i) for i in range(30)]
        tg.run()
        assert all(f.done() for f in futs)
        assert len(tg.telemetry.records) == 30
        assert tg.telemetry.failure_rate() == 0.0

    def test_act_decomposition(self):
        tg = make_tangram()
        tg.submit(coding_action("t0"))
        tg.run()
        r = tg.telemetry.records[0]
        assert r.act == pytest.approx(r.queue_dur + r.exec_dur + r.sys_overhead)
        assert r.exec_dur > 0

    def test_elastic_speedup_under_low_load(self):
        """With a lone action and a big pool, elasticity shortens execution."""
        tg = make_tangram(cores=64)
        tg.submit(coding_action("t0", base=10.0))
        tg.run()
        r = tg.telemetry.records[0]
        assert r.exec_dur < 10.0 / 4  # >=4x speedup from elastic DoP

    def test_resources_fully_released(self):
        tg = make_tangram()
        for i in range(20):
            tg.submit(coding_action(f"t{i}"), delay=0.05 * i)
        tg.run()
        assert tg.managers["cpu"].available == 64
        assert tg.managers["gpu"].available == 8
        for alloc in tg.managers["gpu"].allocators.values():
            alloc.check_invariants()

    def test_gpu_service_multiplexing(self):
        """Two services share one 8-GPU node under EOE."""
        tg = make_tangram(services=("rm0", "rm1"))

        def rm_action(svc, i):
            return Action(
                name=f"rm:{svc}",
                cost={"gpu": ResourceRequest("gpu", (1, 2, 4, 8))},
                key_resource="gpu",
                elasticity=AmdahlElasticity(0.15),
                base_duration=2.0,
                service=svc,
                trajectory_id=f"g{i}",
            )

        for i in range(16):
            tg.submit(rm_action("rm0" if i % 2 else "rm1", i), delay=0.2 * i)
        tg.run()
        assert len(tg.telemetry.records) == 16
        gpu = tg.managers["gpu"]
        assert gpu.stats["hits"] > 0  # EOE cache pays off

    def test_quota_blocked_actions_eventually_run(self):
        tg = make_tangram()
        api = BasicResourceManager(
            ApiResourceSpec("api", mode="quota", quota=2, period_s=10.0),
            tg.loop.clock,
        )
        tg.managers["api"] = api
        for i in range(5):
            a = Action(
                name="api:search",
                cost={"api": fixed("api")},
                base_duration=0.5,
                trajectory_id=f"q{i}",
            )
            tg.submit(a)
        tg.run()
        assert len(tg.telemetry.records) == 5
        # later actions waited for quota refills
        assert max(r.queue_dur for r in tg.telemetry.records) >= 9.0

    def test_trajectory_lifecycle_releases_memory(self):
        tg = make_tangram()
        cpu = tg.managers["cpu"]
        tg.trajectory_start("tX", {})
        tg.submit(coding_action("tX"))
        tg.run()
        assert "tX" in cpu._binding
        tg.trajectory_end("tX")
        assert "tX" not in cpu._binding


class TestVsBaselines:
    def test_tangram_beats_trajectory_baseline_when_bursty(self):
        """Paper Fig. 6/8a: under burst, action-level scheduling wins."""
        n_traj, cores = 64, 32

        def workload(system):
            for i in range(n_traj):
                system.trajectory_start(f"t{i}", {})
                a = coding_action(f"t{i}", base=8.0)
                system.submit(a, delay=0.01 * i)
            system.run()
            return system.telemetry.mean_act()

        tg_loop = EventLoop()
        tg = Tangram({"cpu": CpuManager([CpuNodeSpec("n0", cores=cores)])}, loop=tg_loop)
        act_tangram = workload(tg)

        base = TrajectoryStaticCpuSystem(total_cores=cores)
        act_base = workload(base)
        assert act_tangram < act_base  # Tangram strictly better under burst

    def test_static_gpu_baseline_queues_per_service(self):
        sys_ = StaticGpuServiceSystem({"rm0": 1, "rm1": 1}, tp=4)
        for i in range(8):
            a = Action(
                name="rm:infer",
                cost={"gpu": ResourceRequest("gpu", (1, 2, 4, 8))},
                key_resource="gpu",
                elasticity=AmdahlElasticity(0.15),
                base_duration=2.0,
                service="rm0",  # all hit one service; rm1 idles (over-prov.)
                trajectory_id=f"t{i}",
            )
            sys_.submit(a)
        sys_.run()
        acts = [r.act for r in sys_.telemetry.records]
        assert max(acts) > 4 * min(acts)  # serial queueing behind one replica

    def test_unmanaged_api_fails_under_overload(self):
        sys_ = UnmanagedApiSystem(rate_limit=4, seed=1)
        for i in range(64):
            a = Action(name="api:q", cost={"api": fixed("api")}, base_duration=1.0,
                       trajectory_id=f"t{i}")
            sys_.submit(a)
        sys_.run()
        assert sys_.telemetry.failure_rate() > 0.0  # rate-limit violations

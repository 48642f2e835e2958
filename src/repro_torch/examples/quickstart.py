"""Quickstart: ARL-Tangram in 60 lines.

Torch twin of ``examples/quickstart.py``.

Builds the paper's testbed (CPU + GPU pools + rate-limited APIs),
submits a small mixed burst of actions — elastic CPU test runs, GPU
reward-model calls with EOE caching, quota'd API calls — and prints the
ACT telemetry and scheduling decisions.

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart
"""

from repro_torch.core import (
    Action,
    AmdahlElasticity,
    EventLoop,
    ResourceRequest,
    Tangram,
    fixed,
    paper_testbed,
)
from repro_torch.core.managers.basic import BasicResourceManager
from repro_torch.core.managers.cpu import CpuManager
from repro_torch.core.managers.gpu import GpuManager, ServiceSpec


def main() -> None:
    cluster = paper_testbed(cpu_nodes=2, cores_per_node=64, gpu_nodes=2)
    loop = EventLoop()
    tangram = Tangram(
        {
            "cpu": CpuManager(cluster.cpu_nodes),
            "gpu": GpuManager(
                cluster.gpu_nodes,
                [ServiceSpec("judge", 40.0), ServiceSpec("teacher0", 40.0)],
            ),
            "google_search": BasicResourceManager(cluster.apis[0], loop.clock),
        },
        loop=loop,
    )

    # an AI-coding style trajectory: tools then an elastic reward
    for i in range(8):
        tangram.trajectory_start(f"traj{i}", {"traj_mem_gb": 4.0})
        tangram.submit(
            Action(name="tool:exec", cost={"cpu": fixed("cpu", 1)},
                   base_duration=1.0, trajectory_id=f"traj{i}"),
            delay=0.2 * i,
        )
        tangram.submit(
            Action(
                name="reward:tests",
                cost={"cpu": ResourceRequest("cpu", (1, 2, 4, 8, 16, 32))},
                key_resource="cpu",
                elasticity=AmdahlElasticity(0.05),
                base_duration=30.0,
                trajectory_id=f"traj{i}",
            ),
            delay=0.2 * i + 2.0,
        )
    # reward-model calls multiplexing one GPU pool (EOE)
    for i in range(8):
        tangram.submit(
            Action(
                name="reward:judge",
                cost={"gpu": ResourceRequest("gpu", (1, 2, 4, 8))},
                key_resource="gpu",
                elasticity=AmdahlElasticity(0.15),
                base_duration=4.0,
                service="judge" if i % 2 else "teacher0",
                trajectory_id=f"g{i}",
            ),
            delay=0.5 * i,
        )
    # rate-limited search calls
    for i in range(6):
        tangram.submit(
            Action(name="tool:google_search", cost={"google_search": fixed("google_search")},
                   base_duration=2.0, trajectory_id=f"s{i}"),
            delay=0.1 * i,
        )

    end = tangram.run()
    tel = tangram.telemetry
    print(f"simulated {len(tel.records)} actions in {end:.1f}s of virtual time")
    print(f"mean ACT: {tel.mean_act():.2f}s   p99: {tel.p(0.99):.2f}s")
    print(f"breakdown: {tel.breakdown()}")
    gpu = tangram.managers["gpu"]
    print(f"EOE cache hit rate: {gpu.hit_rate():.0%}  ({gpu.stats})")
    by_stage = tel.by_stage()
    for stage, act in sorted(by_stage.items()):
        print(f"  {stage:10s} mean ACT {act:6.2f}s")


if __name__ == "__main__":
    main()

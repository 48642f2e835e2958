"""Serve multiple (real) reward models on one GPU pool under EOE.

Torch twin of ``examples/serve_reward_models.py``.  The paper's §6.3 story:
10 reward services that a static deployment would give 40 dedicated GPUs
can share a small pool under ARL-Tangram's evict-on-execution manager.
Here three models share a 2-node pool; requests execute REAL scoring
inference; the DES accounts occupancy, restore overhead, and elastic DoP.

Run: PYTHONPATH=src python -m repro_torch.examples.serve_reward_models
(on the card; ``--device cpu`` for the CPU, ``--full`` for the published widths).
"""

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.action import Action, ResourceRequest
from repro_torch.core.cluster import paper_testbed
from repro_torch.rl.driver import build_tangram
from repro_torch.rl.tasks import GPU_ELASTICITY
from repro_torch.serving.reward_service import deploy_reward_service


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true", help="published widths, not reduced")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    services = {}
    for seed, (name, arch) in enumerate(
        (("judge", "llama3.2-1b"), ("teacher0", "smollm-360m"), ("teacher1", "glm4-9b"))
    ):
        cfg = get_config(arch) if args.full else get_config(arch).reduced()
        services[name] = deploy_reward_service(name, cfg, seed, device)
    cluster = paper_testbed(cpu_nodes=1, gpu_nodes=2)
    tangram = build_tangram(cluster, services=list(services), service_state_gb=1.0)

    rng = np.random.default_rng(0)
    names = list(services)
    results = {}

    def score_fn(svc_name, tokens, idx):
        def run(dop: int) -> float:
            t = time.perf_counter()
            # float() waits for the card, so the wall holds the judge's device time
            results[idx] = float(services[svc_name].score(tokens)[0])
            return time.perf_counter() - t

        return run

    for i in range(24):
        svc = names[i % len(names)]
        tokens = torch.as_tensor(rng.integers(0, 256, size=(1, 16)), device=device)
        tangram.submit(
            Action(
                name=f"reward:{svc}",
                cost={"gpu": ResourceRequest("gpu", (1, 2, 4, 8))},
                key_resource="gpu",
                elasticity=GPU_ELASTICITY,
                base_duration=0.05,
                duration_sampler=score_fn(svc, tokens, i),
                service=svc,
                trajectory_id=f"req{i}",
            ),
            delay=0.05 * i,
        )
    end = tangram.run()
    tel = tangram.telemetry
    gpu = tangram.managers["gpu"]
    print(f"served {len(results)} real scoring requests over {end:.1f}s virtual time")
    print(f"mean ACT {tel.mean_act()*1e3:.1f}ms  p99 {tel.p(0.99)*1e3:.1f}ms")
    print(f"EOE hit rate {gpu.hit_rate():.0%}  restores {gpu.stats['misses']} "
          f"({gpu.stats['restore_s']:.1f}s restore time)")
    print(f"pool: {cluster.total_devices} GPUs for {len(services)} services "
          f"(static baseline would pin {4*len(services)})")
    print(f"sample scores: { {k: round(v, 2) for k, v in list(results.items())[:4]} }")


if __name__ == "__main__":
    main()

"""End-to-end agentic RL: GRPO training with rewards through ARL-Tangram.

Torch twin of ``examples/agentic_rl_e2e.py``.  A policy model generates
groups of completions; a (real) judge model scores them — each scoring
call is an ARL-Tangram *action* on the GPU pool with elastic DoP and EOE
service caching; group-relative advantages drive a GRPO update.  This is
the paper's Figure-2 loop with real compute in the reward path.

Run: PYTHONPATH=src python -m repro_torch.examples.agentic_rl_e2e --steps 5
(on the card; ``--device cpu`` for the CPU, ``--full`` for the published widths).
"""

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.cluster import paper_testbed
from repro_torch.rl.driver import LiveGrpoDriver, build_tangram


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--group", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true", help="published widths, not reduced")
    args = ap.parse_args(argv)

    policy_cfg, judge_cfg = get_config("smollm-360m"), get_config("llama3.2-1b")
    if not args.full:
        policy_cfg, judge_cfg = policy_cfg.reduced(), judge_cfg.reduced()
    driver = LiveGrpoDriver(policy_cfg, judge_cfg, group_size=args.group, device=args.device)

    rng = np.random.default_rng(0)
    for step in range(args.steps):
        cluster = paper_testbed(cpu_nodes=1, gpu_nodes=1)
        tangram = build_tangram(cluster, services=["judge"], service_state_gb=1.0)
        prompts = rng.integers(0, policy_cfg.vocab_size, size=(args.batch, 8)).astype(
            np.int32
        )
        rep = driver.run_step(prompts, tangram)
        gpu = tangram.managers["gpu"]
        print(
            f"step {step}: grpo_loss={rep.grpo_loss:+.4f} "
            f"mean_reward={rep.mean_reward:.2f} mean_ACT={rep.mean_act:.3f}s "
            f"EOE_hits={gpu.stats['hits']}/{gpu.stats['hits']+gpu.stats['misses']} "
            f"rollout={rep.rollout_wall_s:.3f}s reward={rep.reward_wall_s:.3f}s "
            f"update={rep.update_wall_s:.3f}s",
            flush=True,
        )


if __name__ == "__main__":
    main()

from repro_torch.rl.rollout import RolloutRunner, StepStats
from repro_torch.rl.tasks import (
    make_coding_workload,
    make_deepsearch_workload,
    make_mopd_workload,
    workload_services,
)

__all__ = [
    "RolloutRunner",
    "StepStats",
    "make_coding_workload",
    "make_deepsearch_workload",
    "make_mopd_workload",
    "workload_services",
]

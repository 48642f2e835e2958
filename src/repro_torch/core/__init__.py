"""ARL-Tangram core: action-level external-resource orchestration.

The port's copy of ``repro.core``: plain Python and NumPy, decision for
decision the reference's, with live mode's payloads on CUDA streams of one
card and the dense DP scan in torch.

The paper's contribution, as a composable library:

* :mod:`repro_torch.core.action`     — unified action formulation (§4.1)
* :mod:`repro_torch.core.scheduler`  — elastic scheduling, Algorithms 1-2 (§4.2)
* :mod:`repro_torch.core.dparrange`  — topology-agnostic DPArrange, Alg. 3-4 (App. B)
* :mod:`repro_torch.core.managers`   — Basic / CPU(AOE) / GPU(EOE) managers (§5)
* :mod:`repro_torch.core.orchestrator` — event-driven control plane: partitioned
  queues, incremental rounds, policies, action lifecycle
* :mod:`repro_torch.core.shards`     — sharded plan/commit scheduling rounds
* :mod:`repro_torch.core.wire`       — versioned wire codecs (plans/snapshots/
  sub-queues across process boundaries, no pickle)
* :mod:`repro_torch.core.remote`     — out-of-process shard workers + transports
* :mod:`repro_torch.core.transport`  — TCP shard workers, chaos transports
* :mod:`repro_torch.core.scenarios`  — declarative, seeded workload generation
* :mod:`repro_torch.core.live`       — scenarios on wall time, RMSNorm payloads
  on one CUDA stream per pool
* :mod:`repro_torch.core.tangram`    — the system facade (§3)
* :mod:`repro_torch.core.baselines`  — k8s / SGLang / ServerlessLLM baselines (§6.1)
* :mod:`repro_torch.core.simulator`  — discrete-event engine
"""

from repro_torch.core.action import (
    Action,
    AmdahlElasticity,
    DurationHistory,
    Elasticity,
    LinearElasticity,
    ResourceRequest,
    TableElasticity,
    fixed,
    powers_of_two,
    ranged,
)
from repro_torch.core.cluster import ClusterSpec, paper_testbed, tpu_reward_pool
from repro_torch.core.dparrange import (
    BasicDPOperator,
    DPTask,
    GpuChunkDPOperator,
    TransitionTable,
    brute_force_arrange,
    dp_arrange,
    dp_arrange_prefixes,
    dp_arrange_ref,
)
from repro_torch.core.baselines import FcfsPolicy, StaticDopPolicy
from repro_torch.core.fairqueue import FairSharePolicy, PartitionQueue, TaskShard
from repro_torch.core.managers import BasicResourceManager, CpuManager, GpuManager
from repro_torch.core.managers.gpu import ChunkAllocator, ServiceSpec
from repro_torch.core.orchestrator import (
    ActionCancelled,
    ActionError,
    ActionTimeout,
    Orchestrator,
    SchedulingPolicy,
)
from repro_torch.core.remote import (
    LoopbackTransport,
    ProcessTransport,
    RemoteShardWorker,
    ShardTransport,
)
from repro_torch.core.scheduler import ElasticScheduler
from repro_torch.core.shards import PartitionPlan, RoundExecutor
from repro_torch.core.simulator import EventLoop, SimClock
from repro_torch.core.tangram import Tangram
from repro_torch.core.telemetry import Telemetry

__all__ = [
    "Action",
    "ActionCancelled",
    "ActionError",
    "ActionTimeout",
    "AmdahlElasticity",
    "BasicDPOperator",
    "BasicResourceManager",
    "ChunkAllocator",
    "ClusterSpec",
    "CpuManager",
    "DPTask",
    "DurationHistory",
    "Elasticity",
    "ElasticScheduler",
    "EventLoop",
    "FairSharePolicy",
    "FcfsPolicy",
    "GpuChunkDPOperator",
    "GpuManager",
    "LinearElasticity",
    "LoopbackTransport",
    "Orchestrator",
    "PartitionPlan",
    "PartitionQueue",
    "ProcessTransport",
    "RemoteShardWorker",
    "ResourceRequest",
    "RoundExecutor",
    "SchedulingPolicy",
    "ServiceSpec",
    "ShardTransport",
    "SimClock",
    "StaticDopPolicy",
    "Tangram",
    "TableElasticity",
    "TaskShard",
    "Telemetry",
    "TransitionTable",
    "brute_force_arrange",
    "dp_arrange",
    "dp_arrange_prefixes",
    "dp_arrange_ref",
    "fixed",
    "paper_testbed",
    "powers_of_two",
    "ranged",
    "tpu_reward_pool",
]

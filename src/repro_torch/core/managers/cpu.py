"""CPU manager via AOE — allocate-on-execution (paper §5.2).

**Breakdown**: instead of a pod holding cores for a trajectory's whole
lifetime (k8s baseline), AOE updates the container's cgroup (cpuset /
cpulimit) right before every ``docker.exec`` and reclaims the cores when
the forked process exits.  Trajectory-lifetime state is preserved by
pinning *memory only* (abundant in modern nodes).

**Pool**: cores and memory are jointly managed.  Core selection is
explicit (exclusive cpusets — no interference) and NUMA-aware: an
elastic action's cores are preferentially taken from one NUMA domain.
A trajectory's first action picks a node by a memory load-balancing
policy among nodes that can hold the action's cores *and* the whole
trajectory's memory; all later actions of that trajectory stay on that
node (container residency), so the manager schedules **per node**.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.action import Action
from repro_torch.core.cluster import CpuNodeSpec
from repro_torch.core.dparrange import BasicDPOperator, DPOperator
from repro_torch.core.managers.base import Allocation, ResourceManager

# AOE control-path cost: one docker-API cgroup update + fork (§5.2).
CGROUP_UPDATE_S = 0.002
FORK_EXEC_S = 0.004
DEFAULT_TRAJ_MEM_GB = 4.0


@dataclass
class _NodeState:
    spec: CpuNodeSpec
    free_cores: List[Set[int]] = field(default_factory=list)  # per NUMA domain
    free_mem_gb: float = 0.0
    trajectories: Dict[str, float] = field(default_factory=dict)  # traj -> mem

    def __post_init__(self) -> None:
        per = self.spec.cores_per_numa
        self.free_cores = [
            set(range(d * per, (d + 1) * per)) for d in range(self.spec.numa_nodes)
        ]
        self.free_mem_gb = self.spec.memory_gb

    @property
    def free_core_count(self) -> int:
        return sum(len(s) for s in self.free_cores)

    def take_cores(self, m: int) -> Optional[Tuple[int, ...]]:
        """Exclusive cores, preferring a single NUMA domain (§5.2)."""
        # 1) smallest NUMA domain that fits entirely
        fitting = [d for d in range(len(self.free_cores)) if len(self.free_cores[d]) >= m]
        if fitting:
            d = min(fitting, key=lambda i: len(self.free_cores[i]))
            picked = tuple(sorted(self.free_cores[d]))[:m]
            self.free_cores[d] -= set(picked)
            return picked
        # 2) spill across domains, largest-free first
        if self.free_core_count < m:
            return None
        picked: List[int] = []
        for d in sorted(range(len(self.free_cores)), key=lambda i: -len(self.free_cores[i])):
            grab = tuple(sorted(self.free_cores[d]))[: m - len(picked)]
            picked.extend(grab)
            self.free_cores[d] -= set(grab)
            if len(picked) == m:
                break
        return tuple(picked)

    def return_cores(self, cores: Sequence[int]) -> None:
        per = self.spec.cores_per_numa
        for c in cores:
            self.free_cores[c // per].add(c)

    def clone(self) -> "_NodeState":
        """Free-state copy for plan-phase snapshots (spec is shared —
        it is a frozen dataclass)."""
        c = copy.copy(self)
        c.free_cores = [set(s) for s in self.free_cores]
        c.trajectories = dict(self.trajectories)
        return c


class CpuManager(ResourceManager):
    rtype_mem = "cpu_mem"
    wire_impl = "cpu"
    # ``partition()`` binds trajectories (``_bind`` writes free memory +
    # the binding map), so planning over this family mutates it — a
    # resident worker replica must plan over a throwaway ``snapshot()``.
    plan_mutates = True

    def __init__(self, nodes: Sequence[CpuNodeSpec]) -> None:
        super().__init__("cpu", sum(n.cores for n in nodes))
        self.nodes: Dict[str, _NodeState] = {n.name: _NodeState(n) for n in nodes}
        self._binding: Dict[str, str] = {}  # trajectory -> node name

    # ------------------------------------------------------------------
    @property
    def available(self) -> int:
        return sum(n.free_core_count for n in self.nodes.values())

    def node_of(self, trajectory_id: str) -> Optional[str]:
        return self._binding.get(trajectory_id)

    def held_units(self) -> int:
        return self.capacity - self.available

    def snapshot(self) -> "CpuManager":
        """Plan-phase view: per-node free cores/memory, trajectory
        bindings, and the share ledger are copied, so ``partition()``'s
        trajectory binding during a shard's arrange mutates only the
        snapshot — the live binding happens at commit via
        ``try_allocate``."""
        clone = copy.copy(self)
        clone._task_use = dict(self._task_use)
        clone._binding = dict(self._binding)
        clone.nodes = {name: st.clone() for name, st in self.nodes.items()}
        return clone

    def snapshot_state(self) -> dict:
        """Wire twin of :meth:`snapshot` (see the base contract): node
        specs + per-NUMA free core ids + free memory + trajectory
        bindings, everything ``partition()``'s load-balanced ``_bind``
        and the admission cursor read.  Node ORDER is part of the state
        — ``_bind`` breaks free-memory ties by insertion order."""
        return {
            "nodes": [
                {
                    "spec": {
                        "name": st.spec.name,
                        "cores": st.spec.cores,
                        "numa_nodes": st.spec.numa_nodes,
                        "memory_gb": st.spec.memory_gb,
                    },
                    "free_cores": [sorted(s) for s in st.free_cores],
                    "free_mem_gb": st.free_mem_gb,
                    "trajectories": dict(st.trajectories),
                }
                for st in self.nodes.values()
            ],
            "binding": dict(self._binding),
            "task_use": dict(self._task_use),
        }

    @classmethod
    def restore_snapshot(cls, state: dict) -> "CpuManager":
        specs = [
            CpuNodeSpec(
                name=str(n["spec"]["name"]),
                cores=int(n["spec"]["cores"]),
                numa_nodes=int(n["spec"]["numa_nodes"]),
                memory_gb=float(n["spec"]["memory_gb"]),
            )
            for n in state["nodes"]
        ]
        m = CpuManager(specs)
        for n in state["nodes"]:
            st = m.nodes[str(n["spec"]["name"])]
            st.free_cores = [set(int(c) for c in dom) for dom in n["free_cores"]]
            st.free_mem_gb = float(n["free_mem_gb"])
            st.trajectories = {str(t): float(v) for t, v in n["trajectories"].items()}
        m._binding = {str(t): str(node) for t, node in state.get("binding", {}).items()}
        m._task_use = {str(k): int(v) for k, v in state.get("task_use", {}).items()}
        return m

    def apply_state(self, state: dict) -> bool:
        """In-place refresh (see the base contract): per-node free
        cores/memory/trajectories and the binding map are overwritten;
        node *objects* (and their frozen specs) are reused.  A topology
        change — node count, order, or any spec field — returns False
        for a full rebuild."""
        nodes = state.get("nodes", [])
        if len(nodes) != len(self.nodes):
            return False
        for st, n in zip(self.nodes.values(), nodes):
            spec = n["spec"]
            if (
                st.spec.name != str(spec["name"])
                or st.spec.cores != int(spec["cores"])
                or st.spec.numa_nodes != int(spec["numa_nodes"])
                or st.spec.memory_gb != float(spec["memory_gb"])
            ):
                return False
        if not super().apply_state(
            {"rtype": self.rtype, "capacity": self.capacity, **state}
        ):
            return False
        for st, n in zip(self.nodes.values(), nodes):
            st.free_cores = [set(int(c) for c in dom) for dom in n["free_cores"]]
            st.free_mem_gb = float(n["free_mem_gb"])
            st.trajectories = {str(t): float(v) for t, v in n["trajectories"].items()}
        self._binding = {
            str(t): str(node) for t, node in state.get("binding", {}).items()
        }
        return True

    # ------------------------------------------------------------------
    # structural snapshot deltas (per-node: a round touches few nodes)
    # ------------------------------------------------------------------
    @classmethod
    def snapshot_delta(cls, prev: dict, cur: dict) -> dict:
        """Per-node diff: node ORDER is part of the state (``_bind``'s
        tie-break), so nodes are addressed by position.  Each changed
        node contributes only its changed keys (usually ``free_cores`` /
        ``free_mem_gb`` / ``trajectories``); a topology change (node
        count) falls back to shipping the full node list."""
        pn, cn = prev.get("nodes", []), cur.get("nodes", [])
        delta = super().snapshot_delta(
            {k: v for k, v in prev.items() if k != "nodes"},
            {k: v for k, v in cur.items() if k != "nodes"},
        )
        if len(pn) != len(cn):
            delta.setdefault("set", {})["nodes"] = cn
            return delta
        nodes: dict = {}
        for i, (p, c) in enumerate(zip(pn, cn)):
            if p != c:
                nodes[str(i)] = {k: v for k, v in c.items() if p.get(k) != v}
        if nodes:
            delta["nodes"] = nodes
        return delta

    @classmethod
    def apply_delta(cls, base: dict, delta: dict) -> dict:
        state = super().apply_delta(base, delta)
        patches = delta.get("nodes")
        if patches:
            nodes = [dict(n) for n in state.get("nodes", [])]
            for idx, patch in patches.items():
                i = int(idx)
                if not 0 <= i < len(nodes):
                    from repro_torch.core.wire import WireError

                    raise WireError(f"cpu snapshot delta patches node {i} of {len(nodes)}")
                nodes[i].update(patch)
            state["nodes"] = nodes
        return state

    # ------------------------------------------------------------------
    # trajectory lifetime: bind node + pin memory (Breakdown keeps state)
    # ------------------------------------------------------------------
    def _bind(self, action: Action) -> Optional[str]:
        traj = action.trajectory_id
        if traj in self._binding:
            return self._binding[traj]
        mem = float(action.metadata.get("traj_mem_gb", DEFAULT_TRAJ_MEM_GB))
        need_cores = self.min_units(action)
        # filter: enough cores for the action + memory for the trajectory;
        # select by memory load balancing (most free memory).
        feasible = [
            n
            for n in self.nodes.values()
            if n.free_core_count >= need_cores and n.free_mem_gb >= mem
        ]
        if not feasible:
            return None
        node = max(feasible, key=lambda n: n.free_mem_gb)
        node.free_mem_gb -= mem
        node.trajectories[traj] = mem
        self._binding[traj] = node.spec.name
        return node.spec.name

    def trajectory_end(self, trajectory_id: str) -> None:
        name = self._binding.pop(trajectory_id, None)
        if name is None:
            return
        node = self.nodes[name]
        mem = node.trajectories.pop(trajectory_id, 0.0)
        node.free_mem_gb += mem

    # ------------------------------------------------------------------
    # scheduling hooks: per-node domains (§5.2 last paragraph)
    # ------------------------------------------------------------------
    def partition(self, actions: Sequence[Action]) -> Dict[str, List[Action]]:
        parts: Dict[str, List[Action]] = {}
        for a in actions:
            node = self._bind(a)
            key = node if node is not None else "__unbound__"
            parts.setdefault(key, []).append(a)
        return parts

    def dp_operator(self, actions: Sequence[Action], reserve: int = 0) -> DPOperator:
        # called per partition; all actions share one node after _bind.
        # Cores are fungible within the pool, so the operator is the
        # basic shift topology — its dense transition table is a trivial
        # (free+1)-state shift keyed by the free-core count below.
        nodes = {self._binding.get(a.trajectory_id) for a in actions}
        nodes.discard(None)
        if len(nodes) == 1:
            free = self.nodes[next(iter(nodes))].free_core_count
            return BasicDPOperator(max(0, free - reserve))
        return BasicDPOperator(max(0, self.available - reserve))

    def dp_cache_key(self, actions: Sequence[Action], reserve: int = 0):
        # keys both the DP-result memo and the dense transition-table
        # cache: the node's (or pool's) free-core count is the only state
        # BasicDPOperator reads, so equal keys reproduce equal tables.
        nodes = {self._binding.get(a.trajectory_id) for a in actions}
        nodes.discard(None)
        if len(nodes) == 1:
            name = next(iter(nodes))
            return ("cpu", name, max(0, self.nodes[name].free_core_count - reserve))
        return ("cpu", "*", max(0, self.available - reserve))

    # admission (greedy placement of min requirements respecting bindings);
    # ``can_accommodate`` is the inherited begin/admit loop over this cursor.
    def begin_admission(self) -> object:
        return (
            {n: s.free_core_count for n, s in self.nodes.items()},
            {n: s.free_mem_gb for n, s in self.nodes.items()},
        )

    def admit_one(self, state: object, action: Action) -> bool:
        free, mem = state  # type: ignore[misc]
        need = self.min_units(action)
        bound = self._binding.get(action.trajectory_id)
        if bound is not None:
            if free[bound] < need:
                return False
            free[bound] -= need
            return True
        tmem = float(action.metadata.get("traj_mem_gb", DEFAULT_TRAJ_MEM_GB))
        cands = [n for n in free if free[n] >= need and mem[n] >= tmem]
        if not cands:
            return False
        pick = max(cands, key=lambda n: mem[n])
        free[pick] -= need
        mem[pick] -= tmem
        return True

    # ------------------------------------------------------------------
    # placement (AOE)
    # ------------------------------------------------------------------
    def try_allocate(self, action: Action, units: int) -> Optional[Allocation]:
        name = self._bind(action)
        if name is None:
            return None
        node = self.nodes[name]
        cores = node.take_cores(units)
        if cores is None:
            return None
        numa_domains = {c // node.spec.cores_per_numa for c in cores}
        return Allocation(
            "cpu",
            units,
            node=name,
            detail={"cores": cores, "numa_domains": sorted(numa_domains)},
            overhead=CGROUP_UPDATE_S + FORK_EXEC_S,
        )

    def release(self, action: Action, allocation: Allocation) -> None:
        node = self.nodes[allocation.node]
        node.return_cores(allocation.detail["cores"])  # type: ignore[arg-type]

    def utilization(self) -> float:
        total = self.capacity
        return (total - self.available) / total if total else 0.0

    def memory_utilization(self) -> float:
        total = sum(n.spec.memory_gb for n in self.nodes.values())
        free = sum(n.free_mem_gb for n in self.nodes.values())
        return (total - free) / total if total else 0.0

"""GPU manager via EOE — evict-on-execution (paper §5.3).

**Breakdown**: every required service is deployed once at init and its
state snapshotted to host memory.  An action requesting service ``s``
with ``m`` devices gets a device *chunk*; if ``s`` (at that DoP) is
already resident on the chunk the action runs immediately (hit),
otherwise the manager restores ``s`` from host memory (miss — restore
latency = state bytes / restore bandwidth), evicting cached services as
needed.  Because service device-state is invariant across invocations,
eviction is *free*: just release device memory, the host copy stays
valid.  Elastic DoP falls out naturally: each DoP configuration of a
service is a distinct service key.

**Pool**: a multi-level *chunk* structure mitigates fragmentation.
A legal chunk is a contiguous device interval ``(start, start + 2^a)``
with ``start % 2^a == 0`` (levels a in {0, 1, 2, 3}).  Allocation of
``m`` devices takes the smallest free chunk of level >= ceil(log2 m),
splitting as needed; when several same-level chunks are free, the one
already caching the requested service is preferred, and otherwise the
**LRU**-cached chunk is the eviction victim (reduces service dithering).

The identical mechanics serve the TPU-slice adaptation (DESIGN.md §3):
a "node" is a v5e tray and chunks are ICI-contiguous slices.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.action import Action
from repro_torch.core.cluster import GpuNodeSpec
from repro_torch.core.dparrange import DPOperator, GpuChunkDPOperator
from repro_torch.core.managers.base import Allocation, ResourceManager

ServiceKey = Tuple[str, int]  # (service name, DoP)

# control-path cost of a cache-hit dispatch (routing + IPC)
DISPATCH_S = 0.001


@dataclass(frozen=True)
class ServiceSpec:
    """A deployable external service (reward model, judge, teacher)."""

    name: str
    state_gb: float  # device-state size at DoP=1 (weights + static buffers)
    dops: Tuple[int, ...] = (1, 2, 4, 8)

    def state_gb_at(self, dop: int) -> float:
        # TP shards weights across the chunk: per-device state shrinks,
        # total restored bytes stay ~constant (plus small per-shard overhead).
        return self.state_gb * (1.0 + 0.03 * (dop - 1))


@dataclass
class _Chunk:
    start: int
    level: int  # size = 2**level

    @property
    def size(self) -> int:
        return 1 << self.level

    def buddy_start(self) -> int:
        return self.start ^ self.size


class ChunkAllocator:
    """Buddy allocator over one node's devices with service-cache tags."""

    def __init__(self, devices: int) -> None:
        if devices & (devices - 1):
            raise ValueError("devices must be a power of two")
        self.devices = devices
        self.max_level = int(math.log2(devices))
        # free chunks: level -> set of starts
        self.free: Dict[int, Set[int]] = {l: set() for l in range(self.max_level + 1)}
        self.free[self.max_level].add(0)
        self.busy: Set[Tuple[int, int]] = set()  # (start, level)
        # cache tags: (start, level) -> (service key, last-used time)
        self.cache: Dict[Tuple[int, int], Tuple[ServiceKey, float]] = {}
        # memoized free_level_counts (invalidated on allocate/release) —
        # admission and DP feasibility hammer it between mutations
        self._level_counts: Optional[List[int]] = None

    # ------------------------------------------------------------------
    @property
    def free_capacity(self) -> int:
        return sum(len(s) << l for l, s in self.free.items())

    def free_level_counts(self) -> List[int]:
        """Free chunk counts per level under maximal buddy merging."""
        if self._level_counts is not None:
            return list(self._level_counts)
        counts = [len(self.free[l]) for l in range(self.max_level + 1)]
        # merging two level-l buddies yields a level-(l+1) chunk; emulate
        # canonical merge on counts using actual adjacency.
        frees = {l: set(s) for l, s in self.free.items()}
        for l in range(self.max_level):
            merged = True
            while merged:
                merged = False
                for start in sorted(frees[l]):
                    buddy = start ^ (1 << l)
                    if buddy in frees[l] and start < buddy:
                        frees[l] -= {start, buddy}
                        frees[l + 1].add(min(start, buddy))
                        merged = True
                        break
        self._level_counts = [len(frees[l]) for l in range(self.max_level + 1)]
        return list(self._level_counts)

    # ------------------------------------------------------------------
    def _evict(self, chunk_key: Tuple[int, int]) -> None:
        """Drop a cache tag (free by §5.3 — host copy is invariant)."""
        self.cache.pop(chunk_key, None)

    def _split(self, start: int, level: int, target: int) -> int:
        """Split a free chunk down to ``target`` level; returns start."""
        self.free[level].discard(start)
        self._evict((start, level))
        while level > target:
            level -= 1
            self.free[level].add(start + (1 << level))
            self.free[level].add(start)
            self.free[level].discard(start)  # keep left half in hand
        return start

    def _try_merge_to(self, target: int) -> Optional[int]:
        """Merge free buddies upward until a level->target chunk exists."""
        for l in range(target):
            for start in sorted(self.free[l]):
                buddy = start ^ (1 << l)
                if buddy in self.free[l]:
                    lo = min(start, buddy)
                    self.free[l] -= {start, buddy}
                    self._evict((start, l))
                    self._evict((buddy, l))
                    self.free[l + 1].add(lo)
        starts = self.free[target]
        return min(starts) if starts else None

    def allocate(
        self, m: int, service: Optional[ServiceKey], now: float
    ) -> Optional[Tuple[int, int, bool]]:
        """Allocate >=m devices; returns (start, level, cache_hit)."""
        if m <= 0 or m > self.devices:
            return None
        self._level_counts = None
        target = max(0, math.ceil(math.log2(m)))
        # 1) exact-level free chunk, preferring a cache hit, then untagged,
        #    then the LRU-tagged chunk (eviction victim).
        pool = self.free[target]
        if pool:
            hit = [
                s for s in pool if self.cache.get((s, target), (None, 0.0))[0] == service
            ]
            if hit and service is not None:
                start = min(hit)
                self.free[target].discard(start)
                self.busy.add((start, target))
                return start, target, True
            untagged = [s for s in pool if (s, target) not in self.cache]
            if untagged:
                start = min(untagged)
            else:
                start = min(pool, key=lambda s: self.cache[(s, target)][1])  # LRU
                self._evict((start, target))
            self.free[target].discard(start)
            self.busy.add((start, target))
            return start, target, False
        # 2) split a larger free chunk (smallest sufficient level first,
        #    untagged preferred to avoid eviction).
        for l in range(target + 1, self.max_level + 1):
            if self.free[l]:
                untagged = [s for s in self.free[l] if (s, l) not in self.cache]
                cand = (
                    min(untagged)
                    if untagged
                    else min(self.free[l], key=lambda s: self.cache[(s, l)][1])
                )
                start = self._split(cand, l, target)
                self.busy.add((start, target))
                return start, target, False
        # 3) merge smaller free buddies upward
        start = self._try_merge_to(target)
        if start is not None:
            self.free[target].discard(start)
            self.busy.add((start, target))
            return start, target, False
        return None

    def release(self, start: int, level: int, service: Optional[ServiceKey], now: float) -> None:
        key = (start, level)
        assert key in self.busy, f"releasing non-busy chunk {key}"
        self._level_counts = None
        self.busy.discard(key)
        self.free[level].add(start)
        if service is not None:
            self.cache[key] = (service, now)  # stays cached until evicted

    def touch(self, start: int, level: int, now: float) -> None:
        key = (start, level)
        if key in self.cache:
            svc, _ = self.cache[key]
            self.cache[key] = (svc, now)

    def clone(self) -> "ChunkAllocator":
        """Free-state copy for plan-phase snapshots."""
        c = copy.copy(self)
        c.free = {lvl: set(s) for lvl, s in self.free.items()}
        c.busy = set(self.busy)
        c.cache = dict(self.cache)
        return c

    # -- invariants (property-tested) -----------------------------------
    def check_invariants(self) -> None:
        covered: Set[int] = set()
        for l, starts in self.free.items():
            for s in starts:
                assert s % (1 << l) == 0, f"illegal chunk ({s},{l})"
                rng = set(range(s, s + (1 << l)))
                assert not (covered & rng), "overlapping free chunks"
                covered |= rng
        for s, l in self.busy:
            assert s % (1 << l) == 0, f"illegal busy chunk ({s},{l})"
            rng = set(range(s, s + (1 << l)))
            assert not (covered & rng), "busy overlaps"
            covered |= rng
        assert covered == set(range(self.devices)), "devices lost or duplicated"


class GpuManager(ResourceManager):
    wire_impl = "gpu"

    def __init__(self, nodes: Sequence[GpuNodeSpec], services: Sequence[ServiceSpec]) -> None:
        super().__init__("gpu", sum(n.devices for n in nodes))
        self.node_specs = {n.name: n for n in nodes}
        self.allocators = {n.name: ChunkAllocator(n.devices) for n in nodes}
        self.services = {s.name: s for s in services}
        # EOE init: deploy each service once, snapshot to host memory.
        host_need = sum(s.state_gb_at(max(s.dops)) for s in services)
        host_have = sum(n.host_memory_gb for n in nodes)
        if host_need > host_have:
            raise ValueError(
                f"host memory insufficient for snapshots: {host_need} > {host_have}"
            )
        self.stats = {"hits": 0, "misses": 0, "restore_s": 0.0}
        self._now = 0.0  # advanced by the Tangram loop for LRU ordering

    # ------------------------------------------------------------------
    def set_time(self, now: float) -> None:
        self._now = now

    @property
    def available(self) -> int:
        return sum(a.free_capacity for a in self.allocators.values())

    def held_units(self) -> int:
        return self.capacity - self.available

    def check_occupancy(self) -> None:
        """Chunk-granular variant of the occupancy invariant: a busy
        chunk rounds an allocation up to a power of two, so held devices
        may exceed the noted units — but never the reverse (noted units
        outliving their chunks is exactly the note_released leak), and
        the ledger must empty when the last chunk frees."""
        noted = sum(self._task_use.values())
        held = self.held_units()
        assert noted <= held, (
            f"{self.rtype}: occupancy leak — task_usage sums to {noted} "
            f"but only {held} device(s) are held ({dict(self._task_use)})"
        )
        assert (noted == 0) == (held == 0), (
            f"{self.rtype}: occupancy leak — noted {noted} vs held {held}"
        )

    def snapshot(self) -> "GpuManager":
        """Plan-phase view: chunk allocators (free/busy/cache tags) and
        the share ledger are copied; specs/services are shared
        (immutable).  ``stats`` stays shared — planning never calls
        ``try_allocate``, the only mutator of it."""
        clone = copy.copy(self)
        clone._task_use = dict(self._task_use)
        clone.allocators = {n: a.clone() for n, a in self.allocators.items()}
        return clone

    def snapshot_state(self) -> dict:
        """Wire twin of :meth:`snapshot` (see the base contract): node +
        service specs and each allocator's free/busy chunk sets and
        service-cache tags (the DP feasibility callback and admission
        read the free sets; cache tags matter only for commit-side
        placement but round-trip so the codec is lossless)."""
        return {
            "nodes": [
                {
                    "name": n.name,
                    "devices": n.devices,
                    "device_memory_gb": n.device_memory_gb,
                    "host_memory_gb": n.host_memory_gb,
                    "restore_bw_gbps": n.restore_bw_gbps,
                }
                for n in self.node_specs.values()
            ],
            "services": [
                {"name": s.name, "state_gb": s.state_gb, "dops": list(s.dops)}
                for s in self.services.values()
            ],
            "allocators": {
                name: {
                    "free": {str(lvl): sorted(starts) for lvl, starts in a.free.items()},
                    "busy": [[s, l] for s, l in sorted(a.busy)],
                    "cache": [
                        [s, l, svc[0], svc[1], t]
                        for (s, l), (svc, t) in sorted(a.cache.items())
                    ],
                }
                for name, a in self.allocators.items()
            },
            "now": self._now,
            "task_use": dict(self._task_use),
        }

    @classmethod
    def restore_snapshot(cls, state: dict) -> "GpuManager":
        nodes = [
            GpuNodeSpec(
                name=str(n["name"]),
                devices=int(n["devices"]),
                device_memory_gb=float(n["device_memory_gb"]),
                host_memory_gb=float(n["host_memory_gb"]),
                restore_bw_gbps=float(n["restore_bw_gbps"]),
            )
            for n in state["nodes"]
        ]
        services = [
            ServiceSpec(
                name=str(s["name"]),
                state_gb=float(s["state_gb"]),
                dops=tuple(int(d) for d in s["dops"]),
            )
            for s in state["services"]
        ]
        m = GpuManager(nodes, services)
        for name, st in state["allocators"].items():
            alloc = m.allocators[str(name)]
            alloc.free = {
                lvl: set(int(s) for s in st["free"].get(str(lvl), []))
                for lvl in range(alloc.max_level + 1)
            }
            alloc.busy = {(int(s), int(l)) for s, l in st["busy"]}
            alloc.cache = {
                (int(s), int(l)): ((str(svc), int(dop)), float(t))
                for s, l, svc, dop, t in st["cache"]
            }
            alloc._level_counts = None
        m._now = float(state.get("now", 0.0))
        m._task_use = {str(k): int(v) for k, v in state.get("task_use", {}).items()}
        return m

    def apply_state(self, state: dict) -> bool:
        """In-place refresh of a restored replica (base contract): each
        allocator's free/busy chunk sets and cache tags are overwritten
        and its memoized free-level counts invalidated; allocator shells,
        node specs, and service specs are reused.  Node or service
        topology changes return False for a full rebuild."""
        nodes = state.get("nodes", [])
        if [
            (n["name"], n["devices"], n["device_memory_gb"], n["host_memory_gb"],
             n["restore_bw_gbps"])
            for n in nodes
        ] != [
            (s.name, s.devices, s.device_memory_gb, s.host_memory_gb,
             s.restore_bw_gbps)
            for s in self.node_specs.values()
        ]:
            return False
        services = state.get("services", [])
        if [
            (s["name"], s["state_gb"], tuple(s["dops"])) for s in services
        ] != [(s.name, s.state_gb, s.dops) for s in self.services.values()]:
            return False
        if set(state.get("allocators", {})) != set(self.allocators):
            return False
        if not super().apply_state(
            {"rtype": self.rtype, "capacity": self.capacity, **state}
        ):
            return False
        for name, st in state["allocators"].items():
            alloc = self.allocators[str(name)]
            alloc.free = {
                lvl: set(int(s) for s in st["free"].get(str(lvl), []))
                for lvl in range(alloc.max_level + 1)
            }
            alloc.busy = {(int(s), int(l)) for s, l in st["busy"]}
            alloc.cache = {
                (int(s), int(l)): ((str(svc), int(dop)), float(t))
                for s, l, svc, dop, t in st["cache"]
            }
            alloc._level_counts = None
        self._now = float(state.get("now", 0.0))
        return True

    # ------------------------------------------------------------------
    # structural snapshot deltas (chunk-level: the free map dominates)
    # ------------------------------------------------------------------
    @classmethod
    def snapshot_delta(cls, prev: dict, cur: dict) -> dict:
        """Chunk-level diff.  The allocator free/busy/cache maps are the
        bytes-dominant part of a GPU snapshot and a round touches only
        the chunks it (de)allocated, so each allocator contributes
        per-level ``add``/``rm`` start lists (free), row add/removals
        (busy), and keyed upserts (cache).  Node/service specs are
        immutable and never re-travel; an allocator-set change (topology)
        falls back to the full map."""
        delta = super().snapshot_delta(
            {k: v for k, v in prev.items() if k != "allocators"},
            {k: v for k, v in cur.items() if k != "allocators"},
        )
        pa, ca = prev.get("allocators", {}), cur.get("allocators", {})
        if set(pa) != set(ca):
            delta.setdefault("set", {})["allocators"] = ca
            return delta
        allocs: dict = {}
        for name, c in ca.items():
            p = pa[name]
            if p == c:
                continue
            ad: dict = {}
            free: dict = {}
            for lvl in set(p.get("free", {})) | set(c.get("free", {})):
                ps = set(p.get("free", {}).get(lvl, ()))
                cs = set(c.get("free", {}).get(lvl, ()))
                if ps != cs:
                    lv: dict = {}
                    if cs - ps:
                        lv["add"] = sorted(cs - ps)
                    if ps - cs:
                        lv["rm"] = sorted(ps - cs)
                    free[lvl] = lv
            if free:
                ad["free"] = free
            pb = {(s, l) for s, l in p.get("busy", ())}
            cb = {(s, l) for s, l in c.get("busy", ())}
            if pb != cb:
                bd: dict = {}
                if cb - pb:
                    bd["add"] = [[s, l] for s, l in sorted(cb - pb)]
                if pb - cb:
                    bd["rm"] = [[s, l] for s, l in sorted(pb - cb)]
                ad["busy"] = bd
            pc = {(r[0], r[1]): r for r in p.get("cache", ())}
            cc = {(r[0], r[1]): r for r in c.get("cache", ())}
            add = [r for k, r in sorted(cc.items()) if pc.get(k) != r]
            rm = [[s, l] for s, l in sorted(pc) if (s, l) not in cc]
            if add or rm:
                cd: dict = {}
                if add:
                    cd["add"] = add
                if rm:
                    cd["rm"] = rm
                ad["cache"] = cd
            if ad:
                allocs[name] = ad
        if allocs:
            delta["alloc"] = allocs
        return delta

    @classmethod
    def apply_delta(cls, base: dict, delta: dict) -> dict:
        state = super().apply_delta(base, delta)
        patches = delta.get("alloc")
        if not patches:
            return state
        allocators = {n: dict(a) for n, a in state.get("allocators", {}).items()}
        for name, ad in patches.items():
            if name not in allocators:
                from repro_torch.core.wire import WireError

                raise WireError(f"gpu snapshot delta patches unknown allocator {name!r}")
            a = allocators[name]
            if "free" in ad:
                free = {lvl: list(starts) for lvl, starts in a.get("free", {}).items()}
                for lvl, lv in ad["free"].items():
                    starts = set(free.get(lvl, ()))
                    starts |= set(lv.get("add", ()))
                    starts -= set(lv.get("rm", ()))
                    free[lvl] = sorted(starts)
                a["free"] = free
            if "busy" in ad:
                busy = {(s, l) for s, l in a.get("busy", ())}
                busy |= {(s, l) for s, l in ad["busy"].get("add", ())}
                busy -= {(s, l) for s, l in ad["busy"].get("rm", ())}
                a["busy"] = [[s, l] for s, l in sorted(busy)]
            if "cache" in ad:
                cache = {(r[0], r[1]): r for r in a.get("cache", ())}
                for r in ad["cache"].get("add", ()):
                    cache[(r[0], r[1])] = r
                for s, l in ad["cache"].get("rm", ()):
                    cache.pop((s, l), None)
                a["cache"] = [r for _, r in sorted(cache.items())]
            allocators[name] = a
        state["allocators"] = allocators
        return state

    # ------------------------------------------------------------------
    def begin_admission(self) -> object:
        return [0, 0, 0, 0]  # accumulated chunk-consumption multiset

    def admit_one(self, state: object, action: Action) -> bool:
        need = self.min_units(action)
        if need == 0:
            return True
        dec = GpuChunkDPOperator.greedy_decompose(
            1 << max(0, math.ceil(math.log2(need)))
        )
        if dec is None:
            return False
        trial = [x + y for x, y in zip(state, dec)]  # type: ignore[arg-type]
        if not self.feasible_multiset(tuple(trial)):
            return False
        state[:] = trial  # type: ignore[index]
        return True

    def free_level_snapshot(self) -> Tuple[Tuple[int, ...], ...]:
        """Canonical per-node free-chunk level counts (maximal merging)."""
        return tuple(
            tuple(a.free_level_counts()) for a in self.allocators.values()
        )

    @staticmethod
    def _fit_multiset(
        snapshot: Tuple[Tuple[int, ...], ...], counts: Tuple[int, int, int, int]
    ) -> bool:
        """Pure first-fit of a consumption multiset against a free-chunk
        snapshot — the feasibility test behind the DP operator.  Pure so
        the operator (and any dense transition table enumerated from it)
        is a function of the snapshot alone, cacheable under
        ``dp_cache_key``."""
        node_levels = [list(levels) for levels in snapshot]
        for size_idx in (3, 2, 1, 0):  # large chunks first
            size_level = size_idx
            for _ in range(counts[size_idx]):
                placed = False
                # smallest-sufficient-level fit across nodes
                for lvl in range(size_level, 4):
                    for c in node_levels:
                        if len(c) > lvl and c[lvl] > 0:
                            c[lvl] -= 1
                            for l in range(size_level, lvl):  # split remainder
                                c[l] += 1
                            placed = True
                            break
                    if placed:
                        break
                if not placed:
                    return False
        return True

    def feasible_multiset(self, counts: Tuple[int, int, int, int]) -> bool:
        """Can the pooled free chunks satisfy this consumption multiset?"""
        return self._fit_multiset(self.free_level_snapshot(), counts)

    def dp_operator(self, actions: Sequence[Action], reserve: int = 0) -> DPOperator:
        free = max(0, self.available - reserve)
        max_counts = (free, free // 2, free // 4, free // 8)
        # close the feasibility callback over a SNAPSHOT (not live
        # allocator state): the dense transition table enumerated from
        # this operator is cached on dp_cache_key, and the snapshot is
        # exactly what that key captures.
        snapshot = self.free_level_snapshot()
        return GpuChunkDPOperator(
            max_counts,
            feasible=lambda counts: self._fit_multiset(snapshot, counts),
            total_devices=free,
        )

    def dp_cache_key(self, actions: Sequence[Action], reserve: int = 0):
        # the DP's feasibility callback reads only the canonical per-node
        # free-chunk level counts, so they (plus the unit budget) key it;
        # chunk allocate/release rotates the key, which is what expires
        # cached dense transition tables (regression-tested).
        return (
            "gpu",
            max(0, self.available - reserve),
            self.free_level_snapshot(),
        )

    # ------------------------------------------------------------------
    def try_allocate(self, action: Action, units: int) -> Optional[Allocation]:
        if action.service is not None and action.service not in self.services:
            raise KeyError(f"service {action.service!r} never deployed (EOE inits all)")
        key: Optional[ServiceKey] = (
            (action.service, units) if action.service is not None else None
        )
        # prefer a node whose allocator holds a cache hit at the right level
        target = max(0, math.ceil(math.log2(max(1, units))))
        ordered = sorted(
            self.allocators.items(),
            key=lambda kv: 0 if self._has_hit(kv[1], target, key) else 1,
        )
        for name, alloc in ordered:
            got = alloc.allocate(units, key, self._now)
            if got is None:
                continue
            start, level, hit = got
            overhead = DISPATCH_S
            if key is not None and not hit:
                spec = self.services[action.service]
                node = self.node_specs[name]
                restore = spec.state_gb_at(units) / node.restore_bw_gbps
                overhead += restore
                self.stats["misses"] += 1
                self.stats["restore_s"] += restore
            elif key is not None:
                self.stats["hits"] += 1
            return Allocation(
                "gpu",
                units,
                node=name,
                detail={"start": start, "level": level, "service": key, "hit": hit},
                overhead=overhead,
            )
        return None

    @staticmethod
    def _has_hit(alloc: ChunkAllocator, level: int, key: Optional[ServiceKey]) -> bool:
        if key is None or level > alloc.max_level:
            return False
        return any(
            alloc.cache.get((s, level), (None, 0.0))[0] == key for s in alloc.free[level]
        )

    def release(self, action: Action, allocation: Allocation) -> None:
        alloc = self.allocators[allocation.node]
        alloc.release(
            allocation.detail["start"],  # type: ignore[arg-type]
            allocation.detail["level"],  # type: ignore[arg-type]
            allocation.detail["service"],  # type: ignore[arg-type]
            self._now,
        )

    def utilization(self) -> float:
        total = self.capacity
        return (total - self.available) / total if total else 0.0

    def hit_rate(self) -> float:
        h, m = self.stats["hits"], self.stats["misses"]
        return h / (h + m) if h + m else 0.0

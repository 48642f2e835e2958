"""ACT / utilization telemetry shared by ARL-Tangram and the baselines."""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class ActionRecord:
    name: str
    task_id: str
    trajectory_id: str
    submit: float
    start: float
    finish: float
    sys_overhead: float
    units: Dict[str, int]
    failed: bool = False
    retries: int = 0

    @property
    def queue_dur(self) -> float:
        return self.start - self.submit

    @property
    def exec_dur(self) -> float:
        return self.finish - self.start - self.sys_overhead

    @property
    def act(self) -> float:
        return self.finish - self.submit


@dataclass
class ShardStats:
    """Per-shard plan-phase accounting for the sharded round engine.

    ``plan_s`` is the shard's own plan time — the cost a dedicated
    per-shard worker pays.  Exact when shards are planned inline
    (nothing else runs while one is measured); an upper bound (includes
    GIL waits) under the in-process thread pool."""

    rounds: int = 0
    partitions: int = 0
    plan_s: float = 0.0


@dataclass
class Telemetry:
    records: List[ActionRecord] = field(default_factory=list)
    sched_invocations: int = 0
    sched_wall_s: float = 0.0
    # -- action-lifecycle counters (orchestrator-maintained) ---------------
    timeouts: int = 0  # deadline expiries (each retry re-arms the deadline)
    retries: int = 0  # re-queues at the FCFS head after a timeout
    cancellations: int = 0
    # -- sharded-round counters (RoundExecutor-maintained) ------------------
    shards: Dict[int, ShardStats] = field(default_factory=dict)
    plan_wall_s: float = 0.0  # real wall clock of parallel plan phases
    plan_critical_s: float = 0.0  # sum of per-round max shard plan CPU
    # planned launches refused by live state during a sharded (plan/
    # commit) round's commit phase; refusals in serial-path rounds show
    # up only in the orchestrator's launch_failures stat
    commit_conflicts: int = 0
    # -- auto plan-mode decisions (plan_mode="auto") -------------------------
    # per-round inline/threads picks from the measured plan-cost EWMA;
    # the EWMA itself is exported so the decision is auditable
    plan_mode_rounds: Dict[str, int] = field(default_factory=dict)
    plan_cost_ewma_s: float = 0.0  # last per-partition plan-cost EWMA
    # -- wire counters (remote plan mode, repro.core.remote) -----------------
    # serialization overhead is accounted SEPARATELY from the modeled
    # critical-path decision latency so the two are never conflated:
    # encode/decode are orchestrator-side wall, worker_codec_s is the
    # worker-reported parse+encode cost (its side of the bill — kept
    # apart from client decode so the two sides are never conflated
    # either), bytes count both directions, transport_s is the full
    # dispatch->gather wall of remote plan phases (worker compute +
    # IPC + codec, overlapped across workers), and fallbacks counts
    # full-content re-sends after a recoverable typed worker error
    # (cache eviction / worker restart / stale delta base)
    wire_encode_s: float = 0.0
    wire_decode_s: float = 0.0
    wire_worker_codec_s: float = 0.0
    wire_transport_s: float = 0.0
    wire_bytes: int = 0
    wire_rounds: int = 0
    wire_fallbacks: int = 0
    # worker-loss rail (transport failures, repro.core.remote): losses
    # counts transport-level failures (dead worker, dropped socket,
    # timeout, truncated frame), inline_parts the partitions planned
    # locally on the loss-fallback path those rounds, reconnects the
    # workers that answered again after being down — every loss is
    # visible, never laundered into a silent retry
    wire_worker_losses: int = 0
    wire_reconnects: int = 0
    wire_inline_parts: int = 0
    # overlap-aware critical path of pipelined dispatch: per round, the
    # head request's encode + the slowest worker's codec bill + the
    # round's decode — the part of the wire bill that CANNOT hide behind
    # worker compute or other shards' encodes.  Reported beside the
    # serialized sums above, never in place of them.
    wire_overlap_s: float = 0.0
    # frames sent (a coalesced same-instant batch is one accounting
    # round but several frames; wire_frames >= wire_rounds)
    wire_frames: int = 0
    # client-side encode memoization: one hit/miss per cache
    # consultation (action segment, snapshot segment, shared-section
    # segment) — the steady-state hit rate is the CI-gated floor
    wire_memo_hits: int = 0
    wire_memo_misses: int = 0
    # worker-reported cache effectiveness, aggregated over plan
    # responses (intern/snapshot/resident-state hit counters plus
    # rebuild-vs-reset wall time); keys documented in remote.py
    wire_worker_cache: Dict[str, float] = field(default_factory=dict)
    # -- two-phase worker-owned commit (repro.core.remote) -------------------
    # the commit wall is split three ways so the critical-path model
    # stays honest: commit_wall_s is the CLIENT-side serial commit wall
    # (the client-serial engine's whole bill; in worker mode the
    # client's mirror replay lands in commit_apply_s instead),
    # commit_critical_s is the modeled worker-parallel commit critical
    # path (per fused round, the max worker-reported commit wall — what
    # the owning workers actually measured committing authoritatively),
    # and commit_apply_s is the client's mirror-apply + fingerprint-
    # verify wall (DES bookkeeping, never charged to decision latency).
    commit_wall_s: float = 0.0
    commit_critical_s: float = 0.0
    commit_apply_s: float = 0.0
    # two-phase frame counters: prepares dispatched (fused plan_commit
    # frames), acks verified clean, aborts decided (divergence, fence,
    # or mismatched fixpoint passes)
    wire_prepares: int = 0
    wire_commit_acks: int = 0
    wire_commit_aborts: int = 0
    # ownership-lease lifecycle: grants (first issue to a worker),
    # regrants (stale_epoch answered with a re-grant + full state),
    # adoptions (orphaned leases taken back inline after worker loss
    # mid-prepare), and fenced intents (handoff aborted an open window)
    wire_lease_grants: int = 0
    wire_lease_regrants: int = 0
    wire_lease_adoptions: int = 0
    wire_fenced_intents: int = 0
    # rounds the worker-owned engine declined (cross-owner footprints,
    # down workers, samplers) and committed client-serial instead
    commit_inline_rounds: int = 0
    # worker-committed state that failed client fingerprint verification
    # (the divergence rail: abort + regrant; client state stands)
    wire_commit_diverged: int = 0
    # -- sub-queue migration (Orchestrator.migrate_task/rebalance) -----------
    migrations: int = 0  # detach->merge moves between partition replicas
    migrated_actions: int = 0
    migration_wall_s: float = 0.0  # control-plane cost of the moves
    # telemetry-driven rebalance cadence (Orchestrator.enable_rebalance)
    rebalance_ticks: int = 0  # policy evaluations on the cadence
    rebalance_moves: int = 0  # sub-queue migrations those ticks ordered

    def record(self, rec: ActionRecord) -> None:
        self.records.append(rec)

    def note_plan_mode(self, mode: str, ewma_s: Optional[float]) -> None:
        """Log one auto plan-mode decision (and the EWMA that drove it)."""
        self.plan_mode_rounds[mode] = self.plan_mode_rounds.get(mode, 0) + 1
        if ewma_s is not None:
            self.plan_cost_ewma_s = ewma_s

    def note_migration(self, actions: int, wall_s: float) -> None:
        self.migrations += 1
        self.migrated_actions += actions
        self.migration_wall_s += wall_s

    def note_wire_round(
        self,
        encode_s: float,
        transport_s: float,
        decode_s: float,
        nbytes: int,
        worker_codec_s: float = 0.0,
        overlap_s: float = 0.0,
        frames: int = 1,
        new_round: bool = True,
    ) -> None:
        """One remote plan round's serialization accounting.

        ``new_round=False`` merges a same-instant frame batch into the
        previous accounting round: every cost still accrues, frames
        still count, but ``wire_rounds`` does not advance — so per-round
        derived figures (bytes/round) reflect scheduling instants, not
        frame count."""
        if new_round:
            self.wire_rounds += 1
        self.wire_frames += frames
        self.wire_encode_s += encode_s
        self.wire_transport_s += transport_s
        self.wire_decode_s += decode_s
        self.wire_worker_codec_s += worker_codec_s
        self.wire_overlap_s += overlap_s
        self.wire_bytes += nbytes

    def note_wire_memo(self, hits: int, misses: int) -> None:
        """Client encode-memo consultations for one round."""
        self.wire_memo_hits += hits
        self.wire_memo_misses += misses

    def note_worker_cache(self, stats: Dict[str, float]) -> None:
        """Fold one worker plan-response's cache counters into the
        run-wide aggregate (all keys are summable counts or seconds)."""
        acc = self.wire_worker_cache
        for k, v in stats.items():
            acc[k] = acc.get(k, 0.0) + float(v)

    def note_commit_round(
        self, worker_commit_s: float, apply_s: float, prepares: int, acks: int
    ) -> None:
        """One fused worker-owned commit round's accounting: the modeled
        worker-parallel commit critical path (max worker commit wall),
        the client mirror-apply/verify wall, and the frame counts."""
        self.commit_critical_s += worker_commit_s
        self.commit_apply_s += apply_s
        self.wire_prepares += prepares
        self.wire_commit_acks += acks

    def reset_wire(self) -> None:
        """Zero every wire + commit-phase counter (bench warm-up
        discards)."""
        self.commit_wall_s = 0.0
        self.commit_critical_s = 0.0
        self.commit_apply_s = 0.0
        self.wire_prepares = 0
        self.wire_commit_acks = 0
        self.wire_commit_aborts = 0
        self.wire_lease_grants = 0
        self.wire_lease_regrants = 0
        self.wire_lease_adoptions = 0
        self.wire_fenced_intents = 0
        self.commit_inline_rounds = 0
        self.wire_commit_diverged = 0
        self.wire_encode_s = 0.0
        self.wire_decode_s = 0.0
        self.wire_worker_codec_s = 0.0
        self.wire_transport_s = 0.0
        self.wire_bytes = 0
        self.wire_rounds = 0
        self.wire_fallbacks = 0
        self.wire_worker_losses = 0
        self.wire_reconnects = 0
        self.wire_inline_parts = 0
        self.wire_overlap_s = 0.0
        self.wire_frames = 0
        self.wire_memo_hits = 0
        self.wire_memo_misses = 0
        self.wire_worker_cache = {}

    def wire_summary(self) -> Dict[str, float]:
        """Aggregate wire overhead of remote plan phases ({} when the
        round engine never left the process)."""
        if not self.wire_rounds:
            return {}
        out = {
            "rounds": float(self.wire_rounds),
            "frames": float(self.wire_frames),
            "encode_s": self.wire_encode_s,
            "decode_s": self.wire_decode_s,
            "worker_codec_s": self.wire_worker_codec_s,
            "transport_s": self.wire_transport_s,
            "overlap_s": self.wire_overlap_s,
            "bytes": float(self.wire_bytes),
            "fallbacks": float(self.wire_fallbacks),
            "worker_losses": float(self.wire_worker_losses),
            "reconnects": float(self.wire_reconnects),
            "inline_parts": float(self.wire_inline_parts),
            "memo_hits": float(self.wire_memo_hits),
            "memo_misses": float(self.wire_memo_misses),
        }
        consulted = self.wire_memo_hits + self.wire_memo_misses
        if consulted:
            out["memo_hit_rate"] = self.wire_memo_hits / consulted
        if self.wire_prepares or self.wire_lease_grants:
            out["prepares"] = float(self.wire_prepares)
            out["commit_acks"] = float(self.wire_commit_acks)
            out["commit_aborts"] = float(self.wire_commit_aborts)
            out["lease_grants"] = float(self.wire_lease_grants)
            out["lease_regrants"] = float(self.wire_lease_regrants)
            out["lease_adoptions"] = float(self.wire_lease_adoptions)
            out["fenced_intents"] = float(self.wire_fenced_intents)
            out["commit_inline_rounds"] = float(self.commit_inline_rounds)
            out["commit_diverged"] = float(self.wire_commit_diverged)
            out["commit_critical_s"] = self.commit_critical_s
            out["commit_apply_s"] = self.commit_apply_s
        for k, v in sorted(self.wire_worker_cache.items()):
            out[f"worker_{k}"] = float(v)
        return out

    def note_shard_round(self, shard: int, partitions: int, plan_s: float) -> None:
        st = self.shards.setdefault(shard, ShardStats())
        st.rounds += 1
        st.partitions += partitions
        st.plan_s += plan_s

    def shard_summary(self) -> Dict[str, float]:
        """Aggregate shard balance: total/critical plan cost and the
        imbalance ratio (max shard plan time over the mean — 1.0 is a
        perfectly balanced fleet)."""
        if not self.shards:
            return {}
        costs = [s.plan_s for s in self.shards.values()]
        mean = statistics.fmean(costs)
        return {
            "shards": float(len(costs)),
            "plan_total_s": sum(costs),
            "plan_critical_s": self.plan_critical_s,
            "plan_wall_s": self.plan_wall_s,
            "imbalance": max(costs) / mean if mean > 0 else 1.0,
            "commit_conflicts": float(self.commit_conflicts),
        }

    # -- aggregates ---------------------------------------------------------
    def mean_act(self, task_id: Optional[str] = None) -> float:
        """Mean ACT; ``task_id`` restricts to one tenant's actions."""
        ok = [
            r.act
            for r in self.records
            if not r.failed and (task_id is None or r.task_id == task_id)
        ]
        return statistics.fmean(ok) if ok else math.nan

    # -- multi-tenant breakdowns -------------------------------------------
    def task_share(
        self, rtype: Optional[str] = None, until: Optional[float] = None
    ) -> Dict[str, float]:
        """Share of allocated resource-seconds per task (unit-seconds of
        ``rtype``, or of all resources when None), normalized to sum to
        1 over the recorded actions.  Under saturation this is the
        quantity weighted fair queueing drives toward ``w_i / sum w``;
        ``until`` restricts to actions finished by that time (use it to
        measure shares inside the saturated window — over a fully
        drained run the share is fixed by total work, not policy)."""
        acc: Dict[str, float] = {}
        for r in self.records:
            if r.failed or (until is not None and r.finish > until):
                continue
            units = r.units.get(rtype, 0) if rtype is not None else sum(r.units.values())
            if units <= 0:
                continue
            acc[r.task_id] = acc.get(r.task_id, 0.0) + units * max(0.0, r.exec_dur)
        total = sum(acc.values())
        if total <= 0:
            return {}
        return {t: v / total for t, v in acc.items()}

    def max_queue_dur(self, task_id: Optional[str] = None) -> float:
        """Worst observed queueing delay (recorded starvation age)."""
        qs = [
            r.queue_dur
            for r in self.records
            if not r.failed and (task_id is None or r.task_id == task_id)
        ]
        return max(qs) if qs else math.nan

    def per_task(self, rtype: Optional[str] = None) -> Dict[str, Dict[str, float]]:
        """One summary row per task: mean ACT, share-of-allocation,
        worst queueing delay (starvation age), and completed count."""
        share = self.task_share(rtype)
        tasks = sorted({r.task_id for r in self.records})
        return {
            t: {
                "mean_act": self.mean_act(t),
                "share": share.get(t, 0.0),
                "max_queue_dur": self.max_queue_dur(t),
                "completed": float(
                    sum(1 for r in self.records if r.task_id == t and not r.failed)
                ),
            }
            for t in tasks
        }

    def p(self, q: float) -> float:
        ok = sorted(r.act for r in self.records if not r.failed)
        if not ok:
            return math.nan
        idx = min(len(ok) - 1, int(q * len(ok)))
        return ok[idx]

    def breakdown(self) -> Dict[str, float]:
        ok = [r for r in self.records if not r.failed]
        if not ok:
            return {"exec": math.nan, "queue": math.nan, "overhead": math.nan}
        return {
            "exec": statistics.fmean(r.exec_dur for r in ok),
            "queue": statistics.fmean(r.queue_dur for r in ok),
            "overhead": statistics.fmean(r.sys_overhead for r in ok),
        }

    def failure_rate(self) -> float:
        if not self.records:
            return 0.0
        return sum(r.failed for r in self.records) / len(self.records)

    def act_timeline(self, window: float) -> List[Tuple[float, float]]:
        """Mean ACT per consecutive time window (paper Fig. 6)."""
        ok = sorted((r for r in self.records if not r.failed), key=lambda r: r.finish)
        out: List[Tuple[float, float]] = []
        if not ok:
            return out
        lo = ok[0].finish
        bucket: List[float] = []
        for r in ok:
            while r.finish >= lo + window:
                if bucket:
                    out.append((lo + window / 2, statistics.fmean(bucket)))
                    bucket = []
                lo += window
            bucket.append(r.act)
        if bucket:
            out.append((lo + window / 2, statistics.fmean(bucket)))
        return out

    def by_stage(self, stage_key: str = "stage") -> Dict[str, float]:
        """Mean ACT grouped by a metadata stage label (Fig. 7)."""
        groups: Dict[str, List[float]] = {}
        for r in self.records:
            if r.failed:
                continue
            stage = r.name.split(":")[0]
            groups.setdefault(stage, []).append(r.act)
        return {k: statistics.fmean(v) for k, v in groups.items()}


def decision_trace(records) -> List[Tuple]:
    """A run's scheduling decisions, insensitive to uid numbering: each record's
    (name, task, trajectory, submit, start, finish, units, failed), times rounded
    to 1e-9 s, sorted.  Two runs decided alike when their traces are equal."""
    return sorted(
        (r.name, r.task_id, r.trajectory_id, round(r.submit, 9), round(r.start, 9),
         round(r.finish, 9), tuple(sorted(r.units.items())), r.failed)
        for r in records
    )

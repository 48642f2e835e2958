"""Elastic resource scheduling (paper §4.2, Algorithms 1 & 2).

Objective: minimize the sum of Action Completion Times

    ACTs = sum_i (T_i^q + T_i)                                   (Eq. 2)

Ordering is FCFS (starvation invalidates whole trajectories, so the
paper fixes ordering and optimizes *allocation*).  Each scheduling round:

1. take the largest FCFS prefix of the waiting queue whose *minimum*
   vectorized requirements every touched manager can accommodate
   (Alg. 1 line 2);
2. split candidates by their **key elasticity resource** (scaling along
   the key resource does not disturb other dimensions — §4.1 assumption);
3. groups with unknown/zero elasticity are selected directly at
   least-required units;
4. scalable groups run **greedy eviction**: starting from the full
   group, repeatedly evict the latest-arrived candidate and re-arrange
   the rest optimally (DPArrange); stop as soon as eviction no longer
   lowers the approximated ΣACT.  The approximation (Alg. 2) =
   exact ACTs of candidates under the DP allocation + estimated ACTs of
   the remaining queue inserted min-allocation into a completion-time
   heap, with ``depth`` letting the first remaining action probe several
   DoPs (depth 2–3 suffices per the paper).

Implementation notes kept faithful to the pseudo code, with two
reconciliations (flagged in-line): Alg. 2 line 13 pops from the scratch
heap (the paper's ``heap`` is a typo — popping the original would leak
state across depth probes), and eviction is capped at ``|C_j| - 1`` so
the FCFS head always schedules (Alg. 1 line 12's ``C_j[:-t+1]`` is empty
under Python slicing but plainly means "keep at least the head").
"""

from __future__ import annotations

import heapq
import itertools
import math
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

from repro_torch.core.action import Action, DurationHistory
from repro_torch.core.dparrange import (
    DPResult,
    DPTask,
    TransitionTable,
    dp_arrange,
    dp_arrange_prefixes,
)
from repro_torch.core.fairqueue import FairSharePolicy
from repro_torch.core.managers.base import ResourceManager

INF = math.inf


def candidate_window(
    waiting: Sequence[Action],
    managers: Dict[str, ResourceManager],
    limit: int = 128,
) -> List[Action]:
    """Largest FCFS prefix admissible at min units, in one O(window) pass.

    Equivalent to re-testing ``can_accommodate`` on every prefix (the
    seed's O(n²) scan): each manager's admission cursor sees exactly the
    subsequence of prefix actions that touch it.
    """
    out: List[Action] = []
    cursors: Dict[str, object] = {}
    for action in waiting[: min(len(waiting), limit)]:
        ok = True
        for rtype in action.cost:
            manager = managers.get(rtype)
            if manager is None:
                continue
            cur = cursors.get(rtype)
            if cur is None:
                cur = cursors[rtype] = manager.begin_admission()
            if not manager.admit_one(cur, action):
                ok = False
                break
        if not ok:
            break
        out.append(action)
    return out


@dataclass
class Decision:
    """One scheduled action with concrete per-resource unit counts."""

    action: Action
    units: Dict[str, int]


@dataclass
class ScheduleResult:
    decisions: List[Decision] = field(default_factory=list)
    objective: float = 0.0
    evicted: int = 0  # candidates deferred by greedy eviction this round


class ElasticScheduler:
    def __init__(
        self,
        depth: int = 2,
        candidate_limit: int = 128,
        history: Optional[DurationHistory] = None,
        estimate_units: str = "min",  # "min" (paper Alg. 2) | "dp_avg"
        cache_dp: Optional[bool] = None,
        fair_share: Optional[FairSharePolicy] = None,
    ) -> None:
        self.depth = depth
        self.candidate_limit = candidate_limit
        self.history = history or DurationHistory()
        # Multi-tenant fairness (None = single-tenant, pre-fairness
        # behaviour, bit-identical): per-task weights scale the DP
        # objective and the Alg. 2 estimate (weighted ΣACT), and
        # ``preempt_scalable`` lets an over-share task's scalable
        # allocations shrink to min units before an under-share task's
        # actions are deferred by eviction.  The orchestrator assigns
        # this when constructed with a FairSharePolicy.
        self.fair_share = fair_share
        # Prefix-DP memo for incremental rounds: keyed on the manager's
        # dp_cache_key (free state) + the exact task tuple, so a round
        # whose resource group did not change reuses the arrangement.
        # None = off (seed-faithful direct use); the Orchestrator enables
        # it when running incrementally.
        self.cache_dp = cache_dp
        self.dp_cache_max = 512
        self._dp_cache: "OrderedDict[Hashable, List[Optional[DPResult]]]" = OrderedDict()
        self.dp_cache_hits = 0
        self.dp_cache_misses = 0
        # Sharded rounds run arrange() concurrently from a thread pool;
        # the two LRU caches below are the only cross-partition mutable
        # state the policy touches during planning, so they are guarded
        # by one small lock (never held across a DP compute — concurrent
        # misses on the same key recompute deterministically and the
        # last write wins).
        self._cache_lock = threading.Lock()
        # Dense DPArrange (PR 2): run the DP as vectorized array sweeps
        # over precomputed operator transition tables instead of the
        # dict-of-dicts reference.  Tables are pure functions of the
        # manager's free state, so they are LRU-cached on dp_cache_key
        # and shared across rounds AND across different task profiles
        # (unlike the prefix-result memo above, which also keys the task
        # tuple).  ``dense_backend``: None -> numpy; "torch" -> float64
        # segment-min scan for large state spaces, on the card.
        self.use_dense = True
        self.dense_backend: Optional[str] = None
        self.table_cache_max = 256
        self._table_cache: "OrderedDict[Hashable, Optional[TransitionTable]]" = (
            OrderedDict()
        )
        self.table_cache_hits = 0
        self.table_cache_misses = 0
        # BEYOND-PAPER (EXPERIMENTS.md §Perf, scheduler iterations): the
        # paper's Alg. 2 prices evicted/remaining actions at MIN-unit
        # durations, so under a burst eviction never engages (deferring a
        # 50 s-at-1-core action "costs" its full 50 s even though the next
        # round would grant it a large DoP) and the head of the burst
        # hogs the pool.  ``estimate_units="dp_avg"`` prices deferred
        # scalable actions at the average DoP the current DP granted —
        # value-consistent with the policy's own future behaviour.
        # Default "min" = paper-faithful reproduction baseline.
        self.estimate_units = estimate_units
        # BEYOND-PAPER: Alg. 1 stops at the FIRST eviction that fails to
        # improve the objective; under a burst the payoff of wave-forming
        # (keep few at max DoP) lies past that local bump.  "exhaustive"
        # scans every prefix — O(n) extra heap estimates on top of the
        # single prefix-DP pass, so the asymptotic cost is unchanged.
        self.eviction_search = "greedy"
        # BEYOND-PAPER (EXPERIMENTS.md §Perf): under steady saturated flow
        # a lone arriving scalable action grabs whatever 1-2 cores are
        # free *now* instead of waiting one completion for an efficient
        # DoP — the Alg. 2 completion heap abstracts away *how many* units
        # each completion frees, so "wait for 4 cores" is inexpressible
        # and the myopic grab always wins the comparison.  ``dop_floor``
        # removes sub-floor unit choices from the DP's feasible sets; an
        # infeasible prefix prices as +inf and (with exhaustive search)
        # eviction defers the tail until the floor is affordable.  When
        # even one action cannot get the floor the round keeps the paper
        # fallback (min units) so the FCFS head is never starved.
        # ``floor_pressure`` < inf auto-disengages the floor when queued
        # min-unit demand exceeds that multiple of the free units (deep
        # queue = throughput mode, where min units maximize aggregate
        # efficiency).  Measured (EXPERIMENTS.md §Perf): on the original
        # hand-written scenarios the gate could not distinguish mid-
        # from deep-congestion — the candidate window fills to capacity
        # at min units in both.  The generated deep_congestion scenario
        # (scenarios.py) now produces that separation: 1.21x mean-ACT
        # win at depth vs exactly 1.00x at mid, benched and CI-gated in
        # BENCH_generated.json (generated_gate_win_*).  The knobs stay
        # default-off; scenarios opt in via ScenarioSpec.policy.
        self.dop_floor: Optional[int] = None
        self.floor_pressure: float = INF

    # ------------------------------------------------------------------
    # Alg. 1
    # ------------------------------------------------------------------
    def schedule(
        self,
        waiting: Sequence[Action],
        executing: Sequence[Action],
        managers: Dict[str, ResourceManager],
        now: float,
    ) -> ScheduleResult:
        if not waiting:
            return ScheduleResult()
        candidates = self._candidate_window(waiting, managers)
        remaining = list(waiting[len(candidates) :])
        return self.arrange(candidates, remaining, executing, managers, now)

    # ------------------------------------------------------------------
    # Alg. 1 lines 3+ — SchedulingPolicy protocol entry point: the caller
    # (the Orchestrator) has already picked the FCFS candidate window.
    # ------------------------------------------------------------------
    def arrange(
        self,
        candidates: Sequence[Action],
        remaining: Sequence[Action],
        executing: Sequence[Action],
        managers: Dict[str, ResourceManager],
        now: float,
    ) -> ScheduleResult:
        result = ScheduleResult()
        if not candidates:
            return result

        # split by key elasticity resource (Alg. 1 line 4)
        groups: Dict[Optional[str], List[Action]] = {}
        for a in candidates:
            key = a.key_resource if a.scalable else None
            groups.setdefault(key, []).append(a)

        # units already committed this round per resource type — elastic
        # scale-up must never spill into co-scheduled actions' shares.
        committed: Dict[str, int] = {}

        def commit(units: Dict[str, int]) -> None:
            for r, u in units.items():
                committed[r] = committed.get(r, 0) + u

        # non-scalable / unknown-elasticity: select directly at min units
        for a in groups.pop(None, []):
            units = a.min_cost()
            commit(units)
            result.decisions.append(Decision(a, units))

        for rtype, group in groups.items():
            manager = managers[rtype]
            # per-node sub-domains (CPU manager schedules per node, §5.2)
            for _, part in manager.partition(group).items():
                kept, alloc, obj, evicted = self._greedy_eviction(
                    part,
                    rtype,
                    manager,
                    remaining,
                    executing,
                    now,
                    reserve=committed.get(rtype, 0),
                )
                result.evicted += evicted
                result.objective += obj
                for a in kept:
                    units = a.min_cost()
                    units[rtype] = alloc.get(str(a.uid), units[rtype])
                    commit(units)
                    result.decisions.append(Decision(a, units))

        return result

    # ------------------------------------------------------------------
    def _candidate_window(
        self, waiting: Sequence[Action], managers: Dict[str, ResourceManager]
    ) -> List[Action]:
        """Largest FCFS prefix accommodatable at min units (Alg. 1 line 2).

        Incremental: one admission cursor per touched manager accumulates
        the per-resource prefix state action by action — O(window) total,
        where the former per-prefix ``can_accommodate`` rescan was
        O(window²).  This is the same cursor protocol the orchestrator's
        round loop uses, so standalone ``schedule()`` and orchestrated
        ``arrange()`` compute identical windows.
        """
        return candidate_window(waiting, managers, self.candidate_limit)

    # ------------------------------------------------------------------
    def _greedy_eviction(
        self,
        group: List[Action],
        rtype: str,
        manager: ResourceManager,
        remaining: Sequence[Action],
        executing: Sequence[Action],
        now: float,
        reserve: int = 0,
    ) -> Tuple[List[Action], Dict[str, int], float, int]:
        """Alg. 1 lines 7-12.  Returns (kept, allocation, objective, #evicted).

        Multi-tenant fairness (``fair_share``): per-task weights scale
        both the exact DP part and the Alg. 2 estimate (weighted ΣACT);
        uniform weights reduce exactly to the unweighted objective.  When
        the greedy pass would defer an *under-share* task's actions while
        an *over-share* task holds scalable DoP>1 allocations,
        ``preempt_scalable`` re-runs the pass with the over-share tasks
        clamped to minimum units — shrinking the rich tenant before the
        poor one is evicted — and adopts the re-run iff it strictly keeps
        more actions.
        """
        # remaining actions contending for this resource (Alg. 2 line 2:
        # W.split(R_j) - C_j); evicted candidates are prepended as they
        # re-enter the queue ahead of ``remaining``.
        rest_same = [a for a in remaining if a.key_resource == rtype or rtype in a.cost]

        floor = self.dop_floor
        if floor:
            # adaptive: a deep queue means throughput mode — min units
            # maximize aggregate efficiency (E(m) <= 1), so disengage the
            # floor when demand at min units already swamps what's free.
            demand = sum(a.key_units()[0] for a in group) + sum(
                a.key_units()[0] if a.scalable else 1 for a in rest_same
            )
            free = max(1, manager.available - reserve)
            if demand > self.floor_pressure * free:
                floor = None

        fs = self.fair_share
        gw: Optional[Tuple[float, ...]] = None
        rw: Optional[Tuple[float, ...]] = None
        if fs is not None:
            gw = tuple(fs.weight_of(a) for a in group)
            rw = tuple(fs.weight_of(a) for a in rest_same)
            if len(set(gw) | set(rw)) <= 1:
                # uniform weights scale every term identically — the
                # argmin (and hence every decision) equals the unweighted
                # objective, so keep the bit-identical single-tenant path.
                gw = rw = None

        tasks = self._dp_tasks(group, floor)
        best_kept, best_alloc, obj = self._evict_pass(
            tasks, group, rest_same, rtype, manager, executing, now, reserve,
            gw, rw, floor,
        )

        if (
            fs is not None
            and fs.preempt_scalable
            and best_kept < len(group)
        ):
            over, under = self._share_bands(group, rest_same, manager)
            deferred_tasks = {a.task_id for a in group[best_kept:]}
            clampable = any(
                a.task_id in over and len(tasks[i].units) > 1
                for i, a in enumerate(group)
            )
            if (deferred_tasks & under) and clampable:
                clamped = self._dp_tasks(group, floor, clamp_tasks=over)
                kept2, alloc2, obj2 = self._evict_pass(
                    clamped, group, rest_same, rtype, manager, executing, now,
                    reserve, gw, rw, floor,
                )
                # the two passes optimize over different feasible sets, so
                # their objectives are not comparable — adopt the clamped
                # arrangement iff shrinking the over-share tenants lets
                # strictly more (under-share) work launch this round.
                if kept2 > best_kept:
                    best_kept, best_alloc, obj = kept2, alloc2, obj2

        kept = group[:best_kept]
        # translate positional task names back to action uids for callers
        uid_alloc = {str(group[int(k)].uid): v for k, v in best_alloc.items()}
        return kept, uid_alloc, obj, len(group) - best_kept

    # ------------------------------------------------------------------
    def _dp_tasks(
        self,
        group: List[Action],
        floor: Optional[int],
        clamp_tasks: frozenset = frozenset(),
    ) -> List[DPTask]:
        """DPTask rows for ``group``.  Tasks are named POSITIONALLY
        ("0".."m-1"), not by uid: the DP result depends only on the
        ordered (units, durations) profiles, so positional names let
        ``_prefixes_cached`` share arrangements across rounds whose task
        multiset recurs with fresh actions.  ``clamp_tasks``: tenants
        whose scalable unit choices collapse to min units (the
        preempt_scalable shrink)."""
        tasks = []
        for i, a in enumerate(group):
            units = a.key_units()
            if floor:
                floored = tuple(m for m in units if m >= floor)
                if floored:
                    units = floored
            # per-action duration-vector memo: the elasticity curve is
            # immutable, and the same action re-enters _greedy_eviction on
            # every round it stays queued.
            memo = a.metadata.get("_dp_durs")
            if memo is None or memo[0] != units:
                memo = (units, tuple(a.get_dur(m) for m in units))
                a.metadata["_dp_durs"] = memo
            units, durs = memo
            if a.task_id in clamp_tasks and len(units) > 1:
                units, durs = units[:1], durs[:1]
            tasks.append(DPTask(name=str(i), units=units, durations=durs))
        return tasks

    # ------------------------------------------------------------------
    def _share_bands(
        self,
        group: Sequence[Action],
        rest_same: Sequence[Action],
        manager: ResourceManager,
    ) -> Tuple[set, set]:
        """(over-share, under-share) tenants by live occupancy vs the
        weighted fair share over the tasks currently active (holding
        units or waiting) on this manager."""
        fs = self.fair_share
        usage = manager.task_usage()
        total = sum(usage.values())
        active = (
            {a.task_id for a in group}
            | {a.task_id for a in rest_same}
            | set(usage)
        )
        if fs is None or total <= 0 or len(active) < 2:
            return set(), set()
        wsum = sum(fs.weight_of(t) for t in active)
        over: set = set()
        under: set = set()
        for t in active:
            target = fs.weight_of(t) / wsum
            share = usage.get(t, 0) / total
            if share > target * (1.0 + fs.share_slack):
                over.add(t)
            elif share < target:
                under.add(t)
        return over, under

    # ------------------------------------------------------------------
    def _evict_pass(
        self,
        tasks: List[DPTask],
        group: List[Action],
        rest_same: List[Action],
        rtype: str,
        manager: ResourceManager,
        executing: Sequence[Action],
        now: float,
        reserve: int,
        gw: Optional[Tuple[float, ...]],
        rw: Optional[Tuple[float, ...]],
        floor: Optional[int] = None,
    ) -> Tuple[int, Dict[str, int], float]:
        """One greedy-eviction sweep over the prefix DP; returns
        (#kept, positional allocation, objective)."""
        # ONE DP pass yields the exact-part objective of every prefix
        # (greedy eviction only ever evaluates prefixes).
        prefixes = self._prefixes_cached(tasks, group, manager, reserve, gw)

        exec_tail = [
            max(0.0, e.finish_time - now)
            for e in executing
            if rtype in e.cost and not math.isnan(e.finish_time)
        ]

        # Estimate-part durations are prefix-invariant in the default
        # ("min") pricing mode and without a DoP floor (a floored row's
        # durations[0] is the floored, not the true, min-unit duration):
        # hoist them out of the eviction loop so each prefix probe is
        # pure heap arithmetic instead of re-deriving every remaining
        # action's duration.  A preempt-clamped row keeps hoisting —
        # clamping truncates to the TRUE min-unit choice.
        hoist = self.estimate_units != "dp_avg" and floor is None
        if hoist:
            group_min_durs = [t.durations[0] for t in tasks]
            rest_same_durs = [self._dur(a, None) for a in rest_same]

        def objective(n_keep: int) -> Tuple[float, Dict[str, int]]:
            dp = prefixes[n_keep] if n_keep < len(prefixes) else None
            if dp is None:
                return INF, {}
            # pre-sorted completion array: ESTIMATE's sorted-merge replay
            # consumes it via a cursor, shared across all depth probes
            # (no per-probe heap copy / heapify)
            base = sorted(
                [dp.durations[t.name] for t in tasks[:n_keep]] + exec_tail
            )
            rest = list(group[n_keep:]) + rest_same  # evicted rejoin the queue
            rest_w = None if gw is None else list(gw[n_keep:]) + list(rw or ())
            est_units = None
            if self.estimate_units == "dp_avg" and dp.allocation:
                est_units = int(
                    sum(dp.allocation.values()) / max(1, len(dp.allocation))
                )
            rest_durs = group_min_durs[n_keep:] + rest_same_durs if hoist else None
            return (
                dp.total_duration
                + self._estimate(base, rest, est_units, rest_durs, rest_w),
                dp.allocation,
            )

        obj, best_alloc = objective(len(group))
        best_kept = len(group)
        # evict the last (latest-arrived) candidate while it helps.  Full
        # eviction (defer even the head rather than run it at
        # starvation-level DoP) is allowed ONLY when in-flight completions
        # guarantee a future scheduling round — otherwise keep >= 1 so the
        # FCFS head can never be starved.
        max_evict = len(group) if exec_tail else len(group) - 1
        for t in range(1, max_evict + 1):
            new_obj, new_alloc = objective(len(group) - t)
            if new_obj >= obj:
                if self.eviction_search == "greedy":
                    break
                continue  # exhaustive: keep scanning past local bumps
            obj, best_kept, best_alloc = new_obj, len(group) - t, new_alloc
        return best_kept, best_alloc, obj

    # ------------------------------------------------------------------
    def _prefixes_cached(
        self,
        tasks: List[DPTask],
        group: List[Action],
        manager: ResourceManager,
        reserve: int,
        weights: Optional[Tuple[float, ...]] = None,
    ) -> List[Optional[DPResult]]:
        """dp_arrange_prefixes, memoized on (manager free-state key, task
        tuple).  DPTask captures the unit sets *and* durations, and the
        manager key captures everything its dp_operator reads, so equal
        keys are guaranteed to reproduce the same DP — results are shared
        across rounds whose group and free resources did not change.

        Two cache levels: the prefix-result memo above (``cache_dp``,
        incremental rounds only), and the dense transition-table LRU
        (always on with ``use_dense``) — tables depend only on the
        manager's free state + the distinct unit choices, so they hit
        even when durations or group composition change every round."""
        mkey = manager.dp_cache_key(group, reserve)

        def compute() -> List[Optional[DPResult]]:
            # operator construction stays on the miss path — a DP-memo
            # hit must not pay for manager state snapshots
            operator = manager.dp_operator(group, reserve)
            if not self.use_dense:
                return dp_arrange_prefixes(tasks, operator, table=None, weights=weights)
            table = self._table_for(operator, tasks, mkey)
            return dp_arrange_prefixes(
                tasks, operator, table=table, backend=self.dense_backend,
                weights=weights,
            )

        if not self.cache_dp or mkey is None:
            return compute()
        # weights scale the memoized objectives, so they are part of the key
        key = (mkey, tuple(tasks), weights)
        with self._cache_lock:
            hit = self._dp_cache.get(key)
            if hit is not None:
                self.dp_cache_hits += 1
                self._dp_cache.move_to_end(key)
                return hit
            self.dp_cache_misses += 1
        prefixes = compute()
        with self._cache_lock:
            self._dp_cache[key] = prefixes
            if len(self._dp_cache) > self.dp_cache_max:
                self._dp_cache.popitem(last=False)
        return prefixes

    # ------------------------------------------------------------------
    def _table_for(
        self,
        operator,
        tasks: Sequence[DPTask],
        mkey: Optional[Hashable],
    ) -> Optional[TransitionTable]:
        """Transition table for ``operator`` over the tasks' distinct unit
        choices, LRU-cached on (manager free-state key, choice tuple).

        ``dp_cache_key`` captures everything the operator's transitions
        and validity read (e.g. the GPU manager's free-chunk level
        counts), so a free-state change rotates the key and the stale
        table simply ages out — the invalidation regression test pins
        this.  ``mkey is None`` (state-dependent manager) builds fresh.
        A cached ``None`` records that the operator cannot export a table
        (unsupported topology or over the state limit) so the round falls
        straight back to the sparse reference without re-probing."""
        ks = tuple(sorted({k for t in tasks for k in t.units}))
        if mkey is None:
            return operator.transition_table(ks)
        key = (mkey, ks)
        with self._cache_lock:
            if key in self._table_cache:
                self.table_cache_hits += 1
                self._table_cache.move_to_end(key)
                return self._table_cache[key]
            self.table_cache_misses += 1
        table = operator.transition_table(ks)
        with self._cache_lock:
            self._table_cache[key] = table
            if len(self._table_cache) > self.table_cache_max:
                self._table_cache.popitem(last=False)
        return table

    # ------------------------------------------------------------------
    # Alg. 2
    # ------------------------------------------------------------------
    def _approx_objective(
        self,
        kept: List[Action],
        rest: Sequence[Action],
        rtype: str,
        manager: ResourceManager,
        executing: Sequence[Action],
        now: float,
        reserve: int = 0,
    ) -> Tuple[float, Dict[str, int]]:
        """getApproximatedObjective: exact DP part + heap estimate part.

        Queue time already incurred is identical across strategies within
        a round and is dropped from the comparison (constant shift).
        """
        if not kept:
            return INF, {}
        tasks = [
            DPTask(
                name=str(a.uid),
                units=a.key_units(),
                durations=tuple(a.get_dur(m) for m in a.key_units()),
            )
            for a in kept
        ]
        dp = dp_arrange(tasks, manager.dp_operator(kept, reserve))
        if dp is None:
            return INF, {}
        exact_obj = dp.total_duration

        # completions: candidates' completions + in-flight completions,
        # pre-sorted once for ESTIMATE's sorted-merge replay
        completions: List[float] = [dp.durations[t.name] for t in tasks]
        for e in executing:
            if rtype in e.cost and not math.isnan(e.finish_time):
                completions.append(max(0.0, e.finish_time - now))
        completions.sort()

        approx_obj = self._estimate(completions, list(rest))
        return exact_obj + approx_obj, dp.allocation

    def _estimate(
        self,
        completions: List[float],
        rest: List[Action],
        est_units: Optional[int] = None,
        rest_durs: Optional[List[float]] = None,
        rest_weights: Optional[List[float]] = None,
    ) -> float:
        """Alg. 2 ESTIMATE: insert the remaining queue min-allocation into
        the completion schedule; the *first* remaining action probes up
        to ``depth`` unit choices.  ``completions`` must be sorted
        ascending — it is shared READ-ONLY across all depth probes, so
        the former per-probe ``list(heap)`` copy + O(k) ``heapify``
        replay collapses into one sorted-merge (:meth:`_replay`) whose
        only mutable state is the small heap of newly generated
        completion times.  ``est_units`` (beyond-paper "dp_avg" mode)
        prices scalable actions at that DoP instead of min.
        ``rest_durs``, when given, are the precomputed min-allocation
        durations aligned with ``rest`` (callers hoist them out of the
        eviction loop — they do not depend on the kept prefix).
        ``rest_weights`` (multi-tenant fairness) weights each remaining
        action's completion-time contribution — the estimate part of the
        weighted ΣACT objective."""
        if not rest:
            return 0.0
        first = rest[0]
        probes = self._depth_probes(first)
        if rest_durs is None:
            tail_durs = [self._dur(a, est_units) for a in rest[1:]]
        else:
            tail_durs = rest_durs[1:]
        w0, tail_weights = 1.0, None
        if rest_weights is not None:
            w0, tail_weights = rest_weights[0], rest_weights[1:]
        best = INF
        for d in probes:
            t0 = self._dur(first, d if est_units is None else max(d or 1, est_units))
            best = min(best, self._replay(completions, t0, tail_durs, w0, tail_weights))
        return best

    @staticmethod
    def _replay(
        completions: List[float],
        t0: float,
        tail_durs: List[float],
        w0: float = 1.0,
        tail_weights: Optional[List[float]] = None,
    ) -> float:
        """One ESTIMATE replay as a sorted merge.

        Equivalent to the heap simulation (pop the earliest completion,
        start the next queued action on it, push its completion): because
        every generated completion is >= the value popped for it, the pop
        sequence is non-decreasing, so the pre-sorted base array can be
        consumed with a cursor and only *generated* completions need a
        heap.  Identical objective to the heap replay — ties between the
        cursor head and the generated heap pick the same value either
        way.  ``w0``/``tail_weights`` weight each contribution (weighted
        ΣACT); the defaults multiply by exactly 1.0, which is the
        identity in IEEE-754, so the unweighted objective is bit-identical
        to the pre-fairness code."""
        i = 0
        n = len(completions)
        gen: List[float] = []
        obj = 0.0
        ws = itertools.chain((w0,), tail_weights or itertools.repeat(1.0))
        for dur, w in zip(itertools.chain((t0,), tail_durs), ws):
            if i < n and (not gen or completions[i] <= gen[0]):
                ts = completions[i]
                i += 1
            elif gen:
                ts = heapq.heappop(gen)
            else:
                ts = 0.0
            c = ts + dur
            obj += w * c
            heapq.heappush(gen, c)
        return obj

    def _depth_probes(self, action: Action) -> List[Optional[int]]:
        if not action.scalable:
            return [None]
        feasible = action.key_units()
        probes = [m for m in feasible if m <= max(self.depth, feasible[0])]
        return probes[: self.depth] or [feasible[0]]

    def _dur(self, action: Action, m: Optional[int]) -> float:
        if action.base_duration is None:
            return self.history.estimate(action)
        feasible = action.key_units()
        if m is None:
            m = feasible[0]
        # snap to the largest feasible unit count <= m
        m = max((u for u in feasible if u <= m), default=feasible[0])
        return action.get_dur(m)

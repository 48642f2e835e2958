"""Topology-agnostic DPArrange (paper Appendix B, Algorithms 3 & 4).

Given a set of *scalable* candidate actions, their supported unit sets
``S_i`` and per-allocation durations ``T_i(k)``, DPArrange finds the
discrete allocation minimizing the total execution time subject to the
resource's **topology**, abstracted behind a DP *operator* providing
``Start / End / Prev / IsValid`` primitives:

* :class:`BasicDPOperator` — fungible units (CPU cores within a node,
  concurrency slots): state = units consumed so far.
* :class:`GpuChunkDPOperator` — power-of-two chunk topology (paper
  Algorithm 4): state = mixed-radix-encoded counts of consumed chunks of
  sizes {1, 2, 4, 8}; ``Prev`` greedily decomposes an allocation into
  chunks from largest to smallest.  Where the paper bounds states by
  fixed maximum chunk counts ``(N1, N2, N4, N8)``, we additionally accept
  an exact feasibility callback from the chunk allocator (buddy-splitting
  aware) — the operator interface the paper prescribes, with a sharper
  validity test.  The same operator serves the TPU-slice adaptation
  (ICI-contiguous 1/2/4/8-chip slices), demonstrating topology-agnosticism.

Deviation note: Algorithm 3 line 25 returns ``dp[m][n]`` (exactly-n
consumption).  With discrete unit sets an exact-n composition may not
exist (e.g. sets {1,4}x2, n=7), so we return the best *feasible* final
state ``argmin_j dp[m][j]`` — identical when exact-n is feasible, and
well-defined otherwise.

Dense fast path (PR 2)
----------------------
The original hash-map DP (kept below as :func:`dp_arrange_ref` /
:func:`dp_arrange_prefixes_ref`, the property-test reference) spends the
scheduler's whole hot-path budget on Python dict traffic.  The dense
path factors the topology out of the inner loop entirely:

1. each operator exports a precomputed **transition table**
   (:meth:`DPOperator.transition_table`): for every distinct unit choice
   ``k``, an int array ``next[k_idx, state] -> next_state`` with ``-1``
   as the invalid sentinel, plus a per-state validity mask.
   :class:`BasicDPOperator` is a trivial shift; :class:`GpuChunkDPOperator`
   enumerates its mixed-radix state space once per free-chunk
   configuration (callers cache the table on the owning manager's
   ``dp_cache_key``, which captures exactly the state the table reads);
2. :func:`dp_arrange_prefixes` then runs each task row as one vectorized
   scatter-min over ``(states x choices)`` — NumPy by default, with a
   float64 torch scan of ``scatter_reduce(reduce="amin")`` segment-mins
   behind ``backend="torch"`` (on :data:`DENSE_DEVICE`, the card;
   :func:`dp_arrange_prefixes_dense` takes ``device="cpu"``) for large
   state spaces — emitting every prefix
   objective and a dense backtrace in a single pass.

The dense rows visit exactly the reachable-state sums the reference DP
visits (same float64 additions, same min over the same multisets), so
objectives are **bit-identical**; only argmin tie-breaking (and hence
the reported, equally-optimal allocation) may differ.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, Dict, List, Optional, Sequence, Tuple

try:  # the dense fast path degrades to the dict reference without numpy
    import numpy as np
except ImportError:  # pragma: no cover - numpy is a core dependency
    np = None  # type: ignore[assignment]

INF = math.inf

#: Largest dense state-space an operator will enumerate; beyond it the
#: caller falls back to the sparse dict reference (which only visits
#: reachable states).  Overridable for tests / huge pools.
DENSE_STATE_LIMIT = int(os.environ.get("REPRO_DP_DENSE_STATE_LIMIT", 200_000))

#: Default dense backend ("numpy" | "torch").  The torch path is opt-in:
#: a float64 scan of segment-mins, one step per task row, which only wins
#: on large state spaces; its objectives stay bit-identical to NumPy's
#: (the same IEEE float64 adds, and min is exact).
DENSE_BACKEND = os.environ.get("REPRO_DP_BACKEND", "numpy")

#: Device of the torch backend's scan where a call names none: the card.
DENSE_DEVICE = "cuda"

_AUTO = object()  # sentinel: "build the transition table yourself"


@dataclass(frozen=True)
class DPTask:
    """One scalable candidate: supported unit set + duration model."""

    name: str
    units: Tuple[int, ...]  # S_i, sorted ascending
    durations: Tuple[float, ...]  # T_i(k) for each k in units


@dataclass
class TransitionTable:
    """Precomputed dense transition structure of one operator state.

    ``next[k_index[k], j]`` is the state reached from ``j`` by allocating
    ``k`` units, or ``-1`` when the transition is invalid (target out of
    topology bounds, infeasible under the operator's validity test, or
    ``k`` not decomposable).  ``valid[j]`` is the operator's ``IsValid``
    over the full dense state space; ``valid[0]`` gates the DP's start
    state.  A table is immutable and pure: it must be rebuilt (or
    re-fetched under a changed cache key) whenever the operator's backing
    resource state changes — managers guarantee this by keying cached
    tables on ``dp_cache_key``.
    """

    num_states: int
    ks: Tuple[int, ...]
    k_index: Dict[int, int]
    next: "np.ndarray"  # (len(ks), num_states) int64, -1 = invalid
    valid: "np.ndarray"  # (num_states,) bool
    shift: bool = False  # fungible-unit shift topology (BasicDPOperator)

    @property
    def start_valid(self) -> bool:
        return bool(self.valid[0])

    def covers(self, units: Sequence[int]) -> bool:
        return all(k in self.k_index for k in units)


class DPOperator:
    """Paper's "Basic DP Operator" interface (Algorithm 3 requirements).

    Dense contract (PR 2): operators that can enumerate their state
    space additionally implement :meth:`transition_table`, returning a
    :class:`TransitionTable` over the distinct unit choices ``ks`` (or
    ``None`` when enumeration is unsupported / over ``limit`` states, in
    which case callers use the sparse reference DP).  The table must
    agree exactly with ``prev``/``is_valid``: ``next[k, j] == j'`` iff
    ``is_valid(j')`` and ``prev(j', k) == j`` under greedy decomposition.
    """

    def start(self, unit_sets: Sequence[Tuple[int, ...]]) -> int:
        raise NotImplementedError

    def end(self, unit_sets: Sequence[Tuple[int, ...]]) -> int:
        """Largest state index worth visiting."""
        raise NotImplementedError

    def prev(self, j: int, k: int) -> Optional[int]:
        """Predecessor state before allocating ``k`` units; None if invalid."""
        raise NotImplementedError

    def is_valid(self, j: int) -> bool:
        raise NotImplementedError

    def transition_table(
        self, ks: Sequence[int], limit: Optional[int] = None
    ) -> Optional[TransitionTable]:
        """Dense ``state x unit-choice -> next-state`` export; None = use
        the sparse reference DP.  ``limit`` caps the enumerated state
        space (default: module-level ``DENSE_STATE_LIMIT``, resolved at
        call time so tests/operators can tighten it)."""
        return None


class BasicDPOperator(DPOperator):
    """Fungible-unit topology: state ``j`` = units consumed so far."""

    def __init__(self, total_units: int) -> None:
        self.total_units = int(total_units)

    def start(self, unit_sets: Sequence[Tuple[int, ...]]) -> int:
        return sum(min(s) for s in unit_sets)

    def end(self, unit_sets: Sequence[Tuple[int, ...]]) -> int:
        return min(self.total_units, sum(max(s) for s in unit_sets))

    def prev(self, j: int, k: int) -> Optional[int]:
        p = j - k
        return p if p >= 0 else None

    def is_valid(self, j: int) -> bool:
        return 0 <= j <= self.total_units

    def transition_table(
        self, ks: Sequence[int], limit: Optional[int] = None
    ) -> Optional[TransitionTable]:
        if np is None:
            return None
        num_states = self.total_units + 1
        if num_states > (DENSE_STATE_LIMIT if limit is None else limit):
            return None
        ks = tuple(sorted(set(int(k) for k in ks)))
        states = np.arange(num_states, dtype=np.int64)
        nxt = np.empty((len(ks), num_states), dtype=np.int64)
        for i, k in enumerate(ks):
            tgt = states + k
            nxt[i] = np.where(tgt <= self.total_units, tgt, -1)
        return TransitionTable(
            num_states=num_states,
            ks=ks,
            k_index={k: i for i, k in enumerate(ks)},
            next=nxt,
            valid=np.ones(num_states, dtype=bool),
            shift=True,
        )


class GpuChunkDPOperator(DPOperator):
    """Paper Algorithm 4: chunk-count states over sizes {1, 2, 4, 8}.

    State ``(a, b, c, d)`` counts *consumed* chunks of sizes 1/2/4/8,
    linearized with mixed-radix encoding (collision-free, finite).
    ``feasible`` — supplied by the chunk allocator — answers whether the
    current free-chunk configuration can yield that consumption multiset
    (buddy splitting allowed).  ``feasible`` must be **pure over the
    free-chunk snapshot the operator was built from** (the GPU manager
    closes it over a snapshot) so that :meth:`transition_table` output is
    cacheable under the manager's ``dp_cache_key``.
    """

    SIZES = (1, 2, 4, 8)

    def __init__(
        self,
        max_counts: Tuple[int, int, int, int],
        feasible: Optional[Callable[[Tuple[int, int, int, int]], bool]] = None,
        total_devices: Optional[int] = None,
    ) -> None:
        self.max_counts = tuple(int(n) for n in max_counts)
        self._radix = tuple(n + 1 for n in self.max_counts)
        self.total_devices = total_devices
        self._feasible = feasible
        # memoize feasibility — the DP revisits states heavily
        if feasible is not None:
            self._feasible = lru_cache(maxsize=None)(feasible)

    # -- mixed-radix encoding (Algorithm 4 Encode/Decode) -----------------
    def encode(self, counts: Tuple[int, int, int, int]) -> int:
        a, b, c, d = counts
        r1, r2, r4, _ = self._radix
        return a + r1 * (b + r2 * (c + r4 * d))

    def decode(self, j: int) -> Tuple[int, int, int, int]:
        r1, r2, r4, _ = self._radix
        a = j % r1
        j //= r1
        b = j % r2
        j //= r2
        c = j % r4
        j //= r4
        return (a, b, c, j)

    @staticmethod
    def greedy_decompose(k: int) -> Optional[Tuple[int, int, int, int]]:
        """Decompose ``k`` devices into chunk counts, largest first."""
        if k <= 0:
            return None
        counts = [0, 0, 0, 0]
        need = k
        for idx in (3, 2, 1, 0):
            size = GpuChunkDPOperator.SIZES[idx]
            counts[idx] = need // size
            need -= counts[idx] * size
        if need:
            return None
        return tuple(counts)  # type: ignore[return-value]

    # -- operator primitives ----------------------------------------------
    def start(self, unit_sets: Sequence[Tuple[int, ...]]) -> int:
        counts = [0, 0, 0, 0]
        for s in unit_sets:
            dec = self.greedy_decompose(min(s))
            if dec is None:
                return 0
            counts = [x + y for x, y in zip(counts, dec)]
        counts = [min(x, n) for x, n in zip(counts, self.max_counts)]
        return self.encode(tuple(counts))  # type: ignore[arg-type]

    def end(self, unit_sets: Sequence[Tuple[int, ...]]) -> int:
        r1, r2, r4, r8 = self._radix
        return r1 * r2 * r4 * r8 - 1

    def prev(self, j: int, k: int) -> Optional[int]:
        a, b, c, d = self.decode(j)
        need = k
        use_d = min(d, need // 8)
        need -= 8 * use_d
        use_c = min(c, need // 4)
        need -= 4 * use_c
        use_b = min(b, need // 2)
        need -= 2 * use_b
        use_a = min(a, need)
        need -= use_a
        if need > 0:
            return None  # not enough chunks in-state to satisfy k
        return self.encode((a - use_a, b - use_b, c - use_c, d - use_d))

    def is_valid(self, j: int) -> bool:
        counts = self.decode(j)
        if any(x < 0 or x > n for x, n in zip(counts, self.max_counts)):
            return False
        if self.total_devices is not None:
            used = sum(c * s for c, s in zip(counts, self.SIZES))
            if used > self.total_devices:
                return False
        if self._feasible is not None and not self._feasible(counts):
            return False
        return True

    def transition_table(
        self, ks: Sequence[int], limit: Optional[int] = None
    ) -> Optional[TransitionTable]:
        """Enumerate the full mixed-radix state space once.

        Cheap mask tests (radix bounds are implicit, ``total_devices`` is
        vectorized) prune the state set before the Python ``feasible``
        callback runs, so the callback only sees states that could hold
        devices at all.
        """
        if np is None:
            return None
        r1, r2, r4, r8 = self._radix
        num_states = r1 * r2 * r4 * r8
        if num_states > (DENSE_STATE_LIMIT if limit is None else limit):
            return None
        js = np.arange(num_states, dtype=np.int64)
        a = js % r1
        t = js // r1
        b = t % r2
        t //= r2
        c = t % r4
        d = t // r4
        valid = np.ones(num_states, dtype=bool)
        if self.total_devices is not None:
            valid &= (a + 2 * b + 4 * c + 8 * d) <= self.total_devices
        if self._feasible is not None:
            idx = np.flatnonzero(valid)
            feas = self._feasible  # lru-cached
            valid[idx] = np.fromiter(
                (
                    feas((int(a[j]), int(b[j]), int(c[j]), int(d[j])))
                    for j in idx
                ),
                dtype=bool,
                count=idx.size,
            )
        ks = tuple(sorted(set(int(k) for k in ks)))
        nxt = np.full((len(ks), num_states), -1, dtype=np.int64)
        for i, k in enumerate(ks):
            dec = self.greedy_decompose(k)
            if dec is None:
                continue
            na, nb, nc, nd = a + dec[0], b + dec[1], c + dec[2], d + dec[3]
            # guard the mixed radix: digit overflow would alias a state
            ok = (na < r1) & (nb < r2) & (nc < r4) & (nd < r8)
            tgt = na + r1 * (nb + r2 * (nc + r4 * nd))
            safe = np.where(ok, tgt, 0)
            ok &= valid[safe]
            nxt[i] = np.where(ok, tgt, -1)
        return TransitionTable(
            num_states=num_states,
            ks=ks,
            k_index={k: i for i, k in enumerate(ks)},
            next=nxt,
            valid=valid,
        )


@dataclass
class DPResult:
    total_duration: float
    allocation: Dict[str, int]  # task name -> units
    durations: Dict[str, float]  # task name -> T_i(k_i)


# ---------------------------------------------------------------------------
# Dense vectorized DP (the scheduler's fast path)
# ---------------------------------------------------------------------------


def _resolve_backend(backend: Optional[str]) -> str:
    """``backend`` (or ``REPRO_DP_BACKEND``): "numpy" or "torch"."""
    backend = backend or DENSE_BACKEND
    if backend not in ("numpy", "torch"):
        raise ValueError(
            f"dparrange backend {backend!r}: the dense backends are 'numpy' and 'torch' "
            "(the float64 segment-min scan)"
        )
    return backend


def _torch_value_rows(nxt_pad, durs_pad, start_valid, num_states, device):
    """All DP value rows by a float64 scan of segment-mins, one step per
    task row: ``cand = prev + durs`` scattered by ``amin`` into
    ``num_states + 1`` buckets, the last one the dump of invalid moves."""
    import torch

    S = num_states
    dev = torch.device(device)
    nxt = torch.as_tensor(nxt_pad, device=dev)
    durs = torch.as_tensor(durs_pad, dtype=torch.float64, device=dev)
    seg = torch.where(nxt >= 0, nxt, S).flatten(1)  # (m, K*S); S = dump bucket
    prev = torch.full((S,), INF, dtype=torch.float64, device=dev)
    if start_valid:
        prev[0] = 0.0
    rows = torch.empty((len(nxt_pad), S), dtype=torch.float64, device=dev)
    for i in range(len(nxt_pad)):
        cand = prev[None, :] + durs[i][:, None]
        buckets = torch.full((S + 1,), INF, dtype=torch.float64, device=dev)
        prev = buckets.scatter_reduce_(0, seg[i], cand.flatten(), reduce="amin")[:S]
        rows[i] = prev
    return rows.cpu().numpy()


def dp_arrange_prefixes_dense(
    tasks: Sequence[DPTask],
    operator: DPOperator,
    table: Optional[TransitionTable] = None,
    backend: Optional[str] = None,
    weights: Optional[Sequence[float]] = None,
    device: Optional[str] = None,
) -> Optional[List[Optional[DPResult]]]:
    """Vectorized :func:`dp_arrange_prefixes_ref`: one scatter-min per
    task row over the operator's dense transition table.

    Returns ``None`` when the dense path is unavailable (no numpy, the
    operator cannot export a table, or the table does not cover the task
    unit sets) — callers fall back to the sparse reference.  Otherwise
    the result is objective-identical to the reference: the same float64
    sums are formed and minimized, so every prefix's ``total_duration``
    matches bit-for-bit (ties may back-track to a different, equally
    optimal allocation).

    ``weights`` (multi-tenant fairness): optional per-task multipliers —
    the objective becomes ``sum_i w_i * T_i(k_i)`` so a heavy-weight
    tenant's completion time counts for more when trading allocations
    off, while the reported per-task ``durations`` stay the TRUE
    durations (callers feed them to the completion-time estimate).
    ``None`` is the unweighted paper objective, bit-identical to the
    pre-fairness code path.
    """
    backend = _resolve_backend(backend)
    if np is None:
        return None
    m = len(tasks)
    if table is None:
        ks = sorted({k for t in tasks for k in t.units})
        table = operator.transition_table(tuple(ks))
    if table is None or not table.covers([k for t in tasks for k in t.units]):
        return None
    S = table.num_states

    results: List[Optional[DPResult]] = [DPResult(0.0, {}, {})]
    value = np.full(S, INF)
    if table.start_valid:
        value[0] = 0.0

    # Optional torch backend: compute all value rows in one scan, then
    # share the numpy backtrace below.  Heterogeneous unit-set sizes are
    # padded with invalid transitions (duration slot unused).
    torch_rows = None
    if backend == "torch" and m > 0:
        kmax = max(len(t.units) for t in tasks)
        nxt_pad = np.full((m, kmax, S), -1, dtype=np.int64)
        durs_pad = np.zeros((m, kmax), dtype=np.float64)
        for i, task in enumerate(tasks):
            kidx = [table.k_index[k] for k in task.units]
            nxt_pad[i, : len(kidx)] = table.next[kidx]
            durs_pad[i, : len(kidx)] = task.durations
            if weights is not None:
                durs_pad[i, : len(kidx)] *= float(weights[i])
        torch_rows = _torch_value_rows(
            nxt_pad, durs_pad, table.start_valid, S, device or DENSE_DEVICE
        )

    backptrs: List["np.ndarray"] = []  # per row: state -> flat (choice*S+prev)
    for i, task in enumerate(tasks):
        kidx = [table.k_index[k] for k in task.units]
        nxt = table.next[kidx]  # (K, S)
        durs = np.asarray(task.durations, dtype=np.float64)
        if weights is not None:
            durs = durs * float(weights[i])  # objective-side only
        cand = value[None, :] + durs[:, None]  # (K, S)
        if torch_rows is not None:
            new = torch_rows[i]
        elif table.shift:
            # fungible units: transition k is a pure shift — use sliced
            # minimums instead of a scatter (same sums, much faster)
            new = np.full(S, INF)
            for ci, k in enumerate(task.units):
                if k < S:
                    np.minimum(new[k:], cand[ci, : S - k], out=new[k:])
        else:
            ok = (nxt >= 0) & np.isfinite(cand)
            new = np.full(S, INF)
            if ok.any():
                np.minimum.at(new, nxt[ok], cand[ok])
        # dense backtrace: the first (choice-major) contributor achieving
        # each state's minimum.  Exact float equality is sound — ``new``
        # values are drawn from ``cand`` verbatim.
        safe = np.where(nxt >= 0, nxt, 0)
        ach = (nxt >= 0) & (cand == new[safe])
        flat = np.flatnonzero(ach.ravel())  # ascending (choice-major)
        bp = np.full(S, -1, dtype=np.int64)
        bp[nxt.ravel()[flat][::-1]] = flat[::-1]  # smallest index wins
        backptrs.append(bp)
        value = new

        finite = np.isfinite(new)
        if not finite.any():
            results.append(None)
            continue
        best_state = int(np.argmin(new))
        alloc: Dict[str, int] = {}
        durs_out: Dict[str, float] = {}
        state = best_state
        feasible = True
        for t in range(i, -1, -1):
            f = int(backptrs[t][state])
            if f < 0:
                feasible = False
                break
            choice, state = divmod(f, S)
            tk = tasks[t]
            alloc[tk.name] = tk.units[choice]
            durs_out[tk.name] = tk.durations[choice]
        results.append(
            DPResult(float(new[best_state]), alloc, durs_out) if feasible else None
        )
    return results


#: Cost-model constants for the dense-vs-sparse dispatch, in units of
#: "one sparse dict transition" (~0.2us of Python).  A dense task row
#: costs a fixed ~10 numpy calls (DENSE_ROW_OVERHEAD_OPS) plus work
#: linear in the full (choices x states) sweep (DENSE_CELL_COST each,
#: cheap vectorized element ops).  Both paths produce bit-identical
#: objectives, so the dispatch is purely a latency decision.
DENSE_ROW_OVERHEAD_OPS = 90
DENSE_CELL_COST = 0.07


def _dense_worthwhile(tasks: Sequence[DPTask], table: TransitionTable) -> bool:
    """Predict whether the vectorized sweep beats the sparse dict DP.

    The sparse DP touches ``reachable_states x choices`` per row, where
    reachability is bounded by the product of choice counts and (for the
    shift topology) by the span of attainable unit sums; the dense sweep
    always pays the full ``choices x states`` row.  Small instances
    (few tasks against a large pool) are faster sparse."""
    S = table.num_states
    reach = 1
    span = 1
    ref_ops = 0
    dense_ops = 0.0
    for t in tasks:
        K = len(t.units)
        ref_ops += reach * K
        dense_ops += DENSE_ROW_OVERHEAD_OPS + DENSE_CELL_COST * K * S
        reach = min(S, reach * K)
        if table.shift:
            span += t.units[-1] - t.units[0]
            reach = min(reach, span)
    return ref_ops > dense_ops


def dp_arrange_prefixes(
    tasks: Sequence[DPTask],
    operator: DPOperator,
    table: object = _AUTO,
    backend: Optional[str] = None,
    weights: Optional[Sequence[float]] = None,
) -> List[Optional[DPResult]]:
    """DPResult for every prefix ``tasks[:i]`` (i = 0..m) in ONE DP pass.

    Greedy eviction (Alg. 1) always evicts the LAST candidate, so the
    objective of every kept-set it evaluates is a prefix of the same DP —
    one pass over the rows serves the whole eviction loop (this is what
    keeps the scheduler inside the paper's O(k n^2 m^2) bound).

    Dispatches to the dense vectorized path when the operator exports a
    transition table (``table``: pass a pre-built/cached
    :class:`TransitionTable`, or ``None`` to force the sparse reference)
    AND the instance is big enough for vectorization to pay
    (:func:`_dense_worthwhile`); otherwise runs
    :func:`dp_arrange_prefixes_ref`.  Both paths return bit-identical
    objectives.
    """
    backend = _resolve_backend(backend)
    if table is not None:
        resolved: Optional[TransitionTable]
        if table is _AUTO:
            ks = sorted({k for t in tasks for k in t.units})
            resolved = operator.transition_table(tuple(ks))
        else:
            resolved = table  # type: ignore[assignment]
        if resolved is not None and (
            backend == "torch" or _dense_worthwhile(tasks, resolved)
        ):
            dense = dp_arrange_prefixes_dense(
                tasks, operator, resolved, backend, weights=weights
            )
            if dense is not None:
                return dense
    return dp_arrange_prefixes_ref(tasks, operator, weights=weights)


def dp_arrange(
    tasks: Sequence[DPTask],
    operator: DPOperator,
    weights: Optional[Sequence[float]] = None,
) -> Optional[DPResult]:
    """Algorithm 3.  Returns None when even minimal allocation is infeasible.

    Uses the dense fast path when available and worthwhile (see
    :func:`dp_arrange_prefixes`); :func:`dp_arrange_ref` is the sparse
    dict-based reference."""
    if not tasks:
        return DPResult(0.0, {}, {})
    return dp_arrange_prefixes(tasks, operator, weights=weights)[-1]


# ---------------------------------------------------------------------------
# Sparse dict-based reference (the original implementation; property
# tests assert the dense path is objective-identical to it)
# ---------------------------------------------------------------------------


def dp_arrange_ref(
    tasks: Sequence[DPTask],
    operator: DPOperator,
    weights: Optional[Sequence[float]] = None,
) -> Optional[DPResult]:
    """Reference Algorithm 3 over a sparse dict of reachable states."""
    m = len(tasks)
    if m == 0:
        return DPResult(0.0, {}, {})
    unit_sets = [t.units for t in tasks]
    n = operator.end(unit_sets)
    if n < 0:
        return None

    # dp maps state -> best total duration for the first i tasks; we keep
    # two rolling rows plus a choice table for backtracking.
    prev_row: Dict[int, float] = {}
    start0 = 0
    if operator.is_valid(start0):
        prev_row[start0] = 0.0
    if not prev_row:
        return None
    choice: List[Dict[int, Tuple[int, int]]] = []  # [i] state -> (k, prev_state)

    for i, task in enumerate(tasks):
        w = None if weights is None else float(weights[i])
        cur_row: Dict[int, float] = {}
        cur_choice: Dict[int, Tuple[int, int]] = {}
        for jp, base in prev_row.items():
            for k, dur in zip(task.units, task.durations):
                # forward transition: state jp --(allocate k to task i)--> j
                j = _forward(operator, jp, k)
                if j is None or j > n or not operator.is_valid(j):
                    continue
                total = base + (dur if w is None else dur * w)
                if total < cur_row.get(j, INF):
                    cur_row[j] = total
                    cur_choice[j] = (k, jp)
        if not cur_row:
            return None
        prev_row = cur_row
        choice.append(cur_choice)

    best_state = min(prev_row, key=lambda s: prev_row[s])
    best = prev_row[best_state]

    # backtrack
    alloc: Dict[str, int] = {}
    durs: Dict[str, float] = {}
    state = best_state
    for i in range(m - 1, -1, -1):
        k, pstate = choice[i][state]
        alloc[tasks[i].name] = k
        kidx = tasks[i].units.index(k)
        durs[tasks[i].name] = tasks[i].durations[kidx]
        state = pstate
    return DPResult(best, alloc, durs)


def dp_arrange_prefixes_ref(
    tasks: Sequence[DPTask],
    operator: DPOperator,
    weights: Optional[Sequence[float]] = None,
) -> List[Optional[DPResult]]:
    """Reference prefix DP over sparse dict rows (see
    :func:`dp_arrange_prefixes` for the contract)."""
    m = len(tasks)
    results: List[Optional[DPResult]] = [DPResult(0.0, {}, {})]
    rows: List[Dict[int, float]] = [{0: 0.0} if operator.is_valid(0) else {}]
    choices: List[Dict[int, Tuple[int, int]]] = []
    unit_sets = [t.units for t in tasks]
    n = operator.end(unit_sets)
    for i, task in enumerate(tasks):
        w = None if weights is None else float(weights[i])
        prev_row = rows[-1]
        cur_row: Dict[int, float] = {}
        cur_choice: Dict[int, Tuple[int, int]] = {}
        for jp, base in prev_row.items():
            for k, dur in zip(task.units, task.durations):
                j = _forward(operator, jp, k)
                if j is None or j > n or not operator.is_valid(j):
                    continue
                total = base + (dur if w is None else dur * w)
                if total < cur_row.get(j, INF):
                    cur_row[j] = total
                    cur_choice[j] = (k, jp)
        rows.append(cur_row)
        choices.append(cur_choice)
        if not cur_row:
            results.append(None)
            continue
        best_state = min(cur_row, key=lambda s: cur_row[s])
        alloc: Dict[str, int] = {}
        durs: Dict[str, float] = {}
        state = best_state
        feasible = True
        for t in range(i, -1, -1):
            if state not in choices[t]:
                feasible = False
                break
            k, pstate = choices[t][state]
            alloc[tasks[t].name] = k
            durs[tasks[t].name] = tasks[t].durations[tasks[t].units.index(k)]
            state = pstate
        results.append(
            DPResult(cur_row[best_state], alloc, durs) if feasible else None
        )
    return results


def _forward(operator: DPOperator, jp: int, k: int) -> Optional[int]:
    """Invert ``Prev``: the state reached from ``jp`` by allocating ``k``.

    For the basic operator this is ``jp + k``; for the chunk operator we
    add the greedy decomposition (the exact inverse of Algorithm 4's
    ``Prev`` whenever the decomposition chunks are all present, which the
    validity check enforces)."""
    if isinstance(operator, BasicDPOperator):
        return jp + k
    if isinstance(operator, GpuChunkDPOperator):
        dec = GpuChunkDPOperator.greedy_decompose(k)
        if dec is None:
            return None
        counts = operator.decode(jp)
        new_counts = tuple(x + y for x, y in zip(counts, dec))
        # guard the mixed radix: digit overflow would alias another state
        if any(x > n for x, n in zip(new_counts, operator.max_counts)):
            return None
        return operator.encode(new_counts)  # type: ignore[arg-type]
    raise TypeError(f"unknown operator {type(operator)!r}")


def brute_force_arrange(
    tasks: Sequence[DPTask],
    total_units: int,
    feasible: Optional[Callable[[Sequence[int]], bool]] = None,
) -> Optional[DPResult]:
    """Exhaustive reference for property tests (small instances only)."""
    best: Optional[DPResult] = None

    def rec(i: int, used: int, alloc: List[int], total: float) -> None:
        nonlocal best
        if i == len(tasks):
            if feasible is not None and not feasible(alloc):
                return
            if best is None or total < best.total_duration:
                best = DPResult(
                    total,
                    {t.name: a for t, a in zip(tasks, alloc)},
                    {
                        t.name: t.durations[t.units.index(a)]
                        for t, a in zip(tasks, alloc)
                    },
                )
            return
        for k, dur in zip(tasks[i].units, tasks[i].durations):
            if used + k > total_units:
                continue
            alloc.append(k)
            rec(i + 1, used + k, alloc, total + dur)
            alloc.pop()

    rec(0, 0, [], 0.0)
    return best

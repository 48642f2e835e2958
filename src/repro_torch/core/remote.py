"""Out-of-process shard workers: the plan phase over the wire.

The sharded round engine (:mod:`repro_torch.core.shards`) proved a round can
be split into side-effect-free per-shard *plan* phases over manager
snapshots plus one serialized validated *commit*.  This module moves the
plan phase out of the orchestrator's process:

* :class:`RemoteShardWorker` — the worker side: decodes a plan request
  (policy config, manager snapshots, queue contents), runs the **same**
  plan core the in-process engine runs
  (:func:`repro_torch.core.shards.plan_partition` — one implementation, zero
  drift), and returns serialized :class:`~repro_torch.core.shards.PartitionPlan`
  payloads.  Stateless across requests except for caches keyed by
  content fingerprint (snapshot bases for structural deltas, interned
  action payloads, policy config, duration history) — every cache is a
  byte-budget LRU, and a worker can be restarted at any time: the next
  request that names state it no longer holds gets a *typed* error and
  the client re-primes it with full content.
* :class:`ShardTransport` — the byte-level boundary, deliberately tiny
  (``submit``/``recv``/``close`` over opaque byte frames): anything that
  can move bytes (a pipe, a socket, an RPC stack) can carry shards.
  :class:`LoopbackTransport` runs the worker in-process but pushes every
  payload through the full encode/decode path — the determinism rail
  proving wire fidelity without process overhead;
  :class:`ProcessTransport` runs the worker in a real OS process over a
  ``multiprocessing`` pipe.
* :class:`RemoteRoundClient` — the orchestrator side: builds per-shard
  requests, dispatches to every worker, gathers, and re-binds decoded
  decisions to the **live** Action objects for the unchanged
  single-threaded commit.  Conflict rollback and the retry rail are
  exactly the in-process ones — the commit phase cannot tell where a
  plan was computed.

Three mechanisms keep the wire bill proportional to *what changed*,
not to fleet size (all additive within ``WIRE_VERSION`` 1 — a worker
still accepts the plain full-payload forms):

* **structural snapshot deltas** — an unchanged snapshot travels as
  ``{"ref": fp}``; a changed one travels as a ``snapshot_delta``
  envelope (per-manager structural diff, fingerprint-verified on
  reconstruction) whenever the worker holds the base, and only falls
  back to the full payload when it does not;
* **compact binary framing** — requests/responses are
  :func:`repro_torch.core.wire.encode_frame` byte frames; ``codec="binary"``
  packs tag/varint values with frame-level string interning, while
  ``codec="json"`` keeps the UTF-8 JSON text path as the v1
  compatibility reference (a worker answers in the codec it was asked
  in — the first frame byte says which).  json is the default: the C
  ``json`` module costs ~2x less CPU per event than the pure-Python
  binary packer, while binary ships ~1.6x fewer bytes — pick binary
  when the transport, not the codec, is the bottleneck;
* **cross-round interning** — action payloads travel once as
  ``{"idef": fp, "val": ...}`` and afterwards as ``{"iref": fp}``
  references into a bounded LRU intern table the client mirrors
  deterministically (same budget, same touch order); a lifecycle
  transition travels as a **patch-define** (``{"idef", "base", "d"}``)
  cloning the interned base with the changed fields applied.  A missed
  reference — worker restart, budget divergence — produces a typed
  ``stale_intern`` error and one full re-send, never a wrong plan.

Three more take the wire off the critical path (this, too, all within
``WIRE_VERSION`` 1):

* **encode memoization** — the client caches the encoded *bytes* of
  fingerprint-stable sections (full action defines, full snapshots,
  policy/fairness/history configs) and splices them into request frames
  (:class:`~repro_torch.core.wire.Encoded`): the same content sent to N
  workers is serialized once, and encode time tracks bytes that
  actually change, not state size;
* **resident worker plan state** — each worker keeps one long-lived
  plan-capable manager replica per resource type, refreshed in place
  from structural deltas (``apply_state``) with a cheap copy-on-plan
  for the families planning mutates — decode-time structures stay warm
  instead of being rebuilt every request;
* **pipelined dispatch** — requests are submitted as soon as each frame
  is encoded, so shard i+1's encode overlaps shard i's worker compute;
  response-encode cost is carried off the reported plan path, and
  same-instant frames coalesce into one accounting round.

Accounting is honest by construction: the modeled critical-path
decision latency stays ``max(per-shard plan) + commit`` with per-shard
plan cost *measured on the worker* (what a dedicated worker pays), and
every serialization cost — client encode, client decode, worker codec,
transport wall, bytes, fallback re-sends — is recorded separately in
``Telemetry.wire_*`` so wire overhead is never laundered into decision
latency (``bench_scheduler --suite remote`` reports each component,
side by side).

No pickle crosses the boundary: requests and responses are
:func:`repro_torch.core.wire.encode_frame` byte frames (JSON text or the
tagged binary codec — both self-describing).
"""

from __future__ import annotations

import atexit
import inspect
import math
import time
import weakref
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core import wire
from repro_torch.core.action import Action, ActionState
from repro_torch.core.shards import (
    PartitionPlan,
    SnapshotMap,
    classify_after_commit,
    commit_decision,
    duration_of,
    plan_partition,
    quota_reservations,
)

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.orchestrator import Orchestrator

#: Byte budget of the worker-side caches (intern table, snapshot bases)
#: and of the client's per-worker intern mirror.  Client and worker
#: MUST agree on the intern budget for the mirror to predict evictions
#: exactly; a divergence is recoverable (typed error + full re-send)
#: but costs a round trip.
CACHE_BUDGET_BYTES = 8 << 20

#: Typed error codes the client recovers from by re-sending that
#: worker's request with full content (cleared fingerprint/intern
#: state).  Anything else is a real protocol failure and raises.
RECOVERABLE_CODES = frozenset(
    {"stale_ref", "stale_base", "delta_mismatch", "stale_intern", "stale_epoch"}
)

#: Ceiling on the round-based reconnect backoff after worker loss: a
#: down worker is retried after skipping 0, 1, 3, 7, ... rounds, capped
#: here.  Round-based (not wall-clock) so recovery behaviour is
#: deterministic under the virtual-time DES harness.
MAX_BACKOFF_ROUNDS = 7


class ProtocolStateError(wire.WireError):
    """The worker lacks state the request referenced (evicted cache,
    restarted worker, stale base).  Carries a machine-readable ``code``
    so the client can distinguish "re-send full content" from a real
    schema violation."""

    def __init__(self, code: str, message: str, **extra: Any) -> None:
        super().__init__(message)
        self.code = code
        self.extra = extra


# ---------------------------------------------------------------------------
# the worker side
# ---------------------------------------------------------------------------


class _WaitingView:
    """Truthiness + ``head()`` over a remaining-waiting list — the queue
    shape :func:`repro_torch.core.shards.classify_after_commit` expects,
    without a live PartitionQueue (the worker only ever sees the wire's
    already-service-ordered lists)."""

    __slots__ = ("_acts",)

    def __init__(self, acts: Sequence[Action]) -> None:
        self._acts = acts

    def __bool__(self) -> bool:
        return bool(self._acts)

    def head(self) -> Optional[Action]:
        return self._acts[0] if self._acts else None


class RemoteShardWorker:
    """Executes serialized plan requests; lives wherever the transport
    puts it (the orchestrator's process for loopback, a separate OS
    process for :class:`ProcessTransport`, a remote host once an RPC
    transport exists).

    Per-request inputs arrive in full, as ``{"ref": fp}`` references,
    as ``snapshot_delta`` structural diffs against a cached base, or as
    ``{"iref": fp}`` intern references.  Manager state is *resident*:
    one long-lived plan-capable replica per resource type, tagged with
    the fingerprint of the state it embodies.  A request whose snapshot
    fingerprint matches reuses the replica as-is; a changed snapshot is
    applied **in place** (:meth:`~repro_torch.core.managers.base.
    ResourceManager.apply_state`) so decode-time structures (the DP
    duration memos riding interned actions, allocator shells, node-state
    objects) stay warm; only a topology change rebuilds from scratch.
    Planning still never dirties the resident: families whose plan phase
    mutates them (``plan_mutates`` — the CPU manager's trajectory
    binding) are planned over a throwaway ``snapshot()`` clone taken
    once per request, the *plan-scope reset*.  All byte caches are
    byte-budget LRUs (:class:`~repro_torch.core.wire.LruBytes`): a long run
    cannot grow worker memory without bound, and an eviction surfaces as
    a typed error the client answers with a full re-send.  (The resident
    table itself holds exactly one live manager per resource type —
    bounded by the managed fleet, not by history.)"""

    def __init__(self, cache_budget: int = CACHE_BUDGET_BYTES,
                 plan_delay_s: float = 0.0) -> None:
        # straggler injection (scenario fault schedules): a positive
        # delay is real wall time slept inside each partition's plan
        # window, so the per-partition ``wall_s`` the worker reports —
        # and hence the client's plan-cost EWMA that feeds the rebalance
        # cadence — honestly reflects the slow worker.
        self.plan_delay_s = plan_delay_s
        self._policy: Optional[Any] = None
        self._policy_fp: Optional[str] = None
        self._fair_share: Optional[Any] = None
        self._fair_share_fp: Optional[str] = None
        self._history_fp: Optional[str] = None
        self._history_avg: Dict[str, float] = {}
        # rtype -> (fingerprint, full snapshot envelope): the delta base
        self._snap_cache = wire.LruBytes(cache_budget)
        # rtype -> (fingerprint, live manager replica): resident plan
        # state — one replica per resource type, refreshed in place
        # (bounded by the fleet, so not an LRU)
        self._resident: Dict[str, Tuple[str, Any]] = {}
        # per-request cache-effectiveness counters, returned in the
        # plan response ("cache") so the client can aggregate hit rates
        self._stats: Dict[str, float] = self._fresh_stats()
        # fingerprint -> resolved action payload (cross-round interning)
        self._interns = wire.LruBytes(cache_budget)
        # (list fp, [(member fp, Action)]): the executing-list delta
        # base — sized by the live running set, so inherently bounded
        self._exec_cache: Optional[Tuple[str, List[Tuple[str, Action]]]] = None
        # part -> (list fp, [(member fp, Action)]): waiting-list delta
        # bases, each replaced wholesale — bounded by the live queues
        self._part_cache: Dict[str, Tuple[str, List[Tuple[str, Action]]]] = {}
        # dumps() cost of the previous response, folded into the NEXT
        # response's codec_s (we cannot time a serialization inside the
        # payload it produces; carrying it forward keeps the aggregate
        # wire bill honest without double-serializing)
        self._carry_dump_s = 0.0
        # worker-owned commit: rtype -> ownership-lease epoch.  A
        # ``plan_commit`` asserting an epoch this table does not hold is
        # refused with a typed ``stale_epoch`` error BEFORE any replica
        # mutation — a restarted worker (amnesia) can therefore never
        # double-launch on stale state.
        self._leases: Dict[str, int] = {}
        # pre-round replica states of the last UNCONFIRMED plan_commit:
        # rtype -> (fingerprint, full snapshot envelope).  Dropped on
        # confirm (the client verified and adopted the outcome);
        # restored on an explicit ``commit_decide`` abort or implicitly
        # when the next frame arrives without a confirm (the client
        # never acked — deterministic abort, never a half-applied round)
        self._stash: Optional[Dict[str, Tuple[str, Dict[str, Any]]]] = None

    @staticmethod
    def _fresh_stats() -> Dict[str, float]:
        """Zeroed per-request cache counters (every key is summable, so
        the client folds responses straight into a run-wide aggregate)."""
        return {
            "intern_hits": 0,
            "intern_defs": 0,
            "intern_patches": 0,
            "snap_refs": 0,
            "snap_deltas": 0,
            "snap_fulls": 0,
            "resident_hits": 0,
            "resident_patches": 0,
            "resident_rebuilds": 0,
            "rebuild_s": 0.0,
            "reset_s": 0.0,
        }

    # ------------------------------------------------------------------
    def handle_bytes(self, request: bytes) -> bytes:
        """One plan round-trip: byte frame in, byte frame out, answered
        in the codec the request arrived in.  Any
        :class:`~repro_torch.core.wire.WireError` (or other failure) is
        returned as an ``error`` payload rather than raised — the
        transport stays alive and the client decides what to do; a
        :class:`ProtocolStateError` additionally carries its ``code``
        so the client knows a full re-send recovers it."""
        codec = wire.frame_codec(request)
        try:
            t0 = time.perf_counter()
            payload = wire.decode_frame(request)
            parse_s = time.perf_counter() - t0
            body = self._handle(payload, parse_s)
            t1 = time.perf_counter()
            blob = wire.encode_frame(body, codec)
            self._carry_dump_s += time.perf_counter() - t1
            return blob
        except Exception as e:  # noqa: BLE001 - protocol boundary
            err: Dict[str, Any] = {"error": f"{type(e).__name__}: {e}"}
            if isinstance(e, ProtocolStateError):
                err["code"] = e.code
                err.update(e.extra)
            return wire.encode_frame(wire.envelope("error", err), codec)

    def handle(self, request: str) -> str:
        """String-frame convenience wrapper (UTF-8 JSON in and out)."""
        return self.handle_bytes(request.encode("utf-8")).decode("utf-8")

    # ------------------------------------------------------------------
    def _snapshot(self, rtype: str, snap: Any) -> Tuple[str, Dict[str, Any]]:
        """Materialize one (fingerprint, full snapshot envelope) pair
        from whichever form it arrived in (full / ``{"ref": fp}`` /
        ``snapshot_delta``), and keep the cache pointing at the newest
        base.  The fingerprint is what the resident-replica layer keys
        on, so it rides along instead of being recomputed."""
        if isinstance(snap, dict) and "ref" in snap:
            cached = self._snap_cache.get(rtype)
            if cached is None or cached[0] != snap["ref"]:
                raise ProtocolStateError(
                    "stale_ref",
                    f"snapshot ref for {rtype!r} does not match cached state",
                )
            self._stats["snap_refs"] += 1
            return cached
        if isinstance(snap, dict) and snap.get("kind") == "snapshot_delta":
            d = wire.expect(snap, "snapshot_delta")
            base_fp = d.get("base")
            cached = self._snap_cache.get(rtype)
            if cached is None or cached[0] != base_fp:
                raise ProtocolStateError(
                    "stale_base",
                    f"snapshot delta base for {rtype!r} does not match cached state",
                )
            try:
                full = wire.apply_snapshot_delta(d, cached[1])
            except wire.WireError as e:
                # the base is unusable (corrupt or mis-diffed) — drop it
                # so the recovery round re-primes from a full snapshot
                self._snap_cache.pop(rtype)
                raise ProtocolStateError("delta_mismatch", str(e)) from None
            fp = str(d.get("fp"))
            self._snap_cache.put(rtype, (fp, full), wire.payload_nbytes(full))
            self._stats["snap_deltas"] += 1
            return fp, full
        fp = wire.fingerprint(snap)
        self._snap_cache.put(rtype, (fp, snap), wire.payload_nbytes(snap))
        self._stats["snap_fulls"] += 1
        return fp, snap

    def _manager(self, rtype: str, fp: str, full: Dict[str, Any]) -> Any:
        """The resident replica for ``rtype`` at state ``fp``: reused
        as-is on a fingerprint match, refreshed **in place** when the
        family supports it (keeping decode-time structures warm), rebuilt
        from the full envelope only on a topology change or first
        sight.  Timing lands in the per-request stats so rebuild-vs-reset
        cost is auditable from the client."""
        st = self._stats
        res = self._resident.get(rtype)
        if res is not None and res[0] == fp:
            st["resident_hits"] += 1
            return res[1]
        if res is not None:
            t0 = time.perf_counter()
            if res[1].apply_state(full["state"]):
                st["resident_patches"] += 1
                st["reset_s"] += time.perf_counter() - t0
                self._resident[rtype] = (fp, res[1])
                return res[1]
        t0 = time.perf_counter()
        mgr = wire.decode_snapshot(full)
        st["resident_rebuilds"] += 1
        st["rebuild_s"] += time.perf_counter() - t0
        self._resident[rtype] = (fp, mgr)
        return mgr

    def _resolve_action(self, node: Any, missing: List[str]) -> Optional[Action]:
        """One wire entry of an action list: an intern reference (table
        lookup; a miss collects into ``missing``), an intern definition
        (decode once, cache the Action under its fingerprint with the
        sender's byte accounting), a patch-define (clone the interned
        base with the mutable-field diff applied — a missing base is
        exactly a missed reference), or a plain envelope (legacy form —
        decoded fresh, never cached)."""
        if isinstance(node, dict):
            if "iref" in node and len(node) == 1:
                a = self._interns.get(str(node["iref"]))
                if a is None:
                    missing.append(str(node["iref"]))
                else:
                    self._stats["intern_hits"] += 1
                return a
            if "idef" in node and "base" in node:
                base = self._interns.get(str(node["base"]))
                if base is None:
                    # the recovery full re-send defines the NEW
                    # fingerprint from scratch, so that is what we
                    # report missing — not the base we happen to lack
                    missing.append(str(node["idef"]))
                    return None
                a = wire.patch_action(base, node.get("d") or {})
                nbytes = node.get("n") or wire.payload_nbytes(node.get("d"))
                self._interns.put(str(node["idef"]), a, int(nbytes))
                self._stats["intern_patches"] += 1
                return a
            if "idef" in node and "val" in node:
                a = wire.decode_action(node["val"])
                nbytes = node.get("n") or wire.payload_nbytes(node["val"])
                self._interns.put(str(node["idef"]), a, int(nbytes))
                self._stats["intern_defs"] += 1
                return a
        return wire.decode_action(node)

    def _exec_pairs(
        self, nodes: Sequence[Any], missing: List[str]
    ) -> List[Tuple[str, Optional[Action]]]:
        """Resolve action nodes into (fingerprint, Action) pairs — the
        fingerprint rides the intern envelope when there is one and is
        computed only for plain legacy envelopes."""
        pairs: List[Tuple[str, Optional[Action]]] = []
        for node in nodes:
            a = self._resolve_action(node, missing)
            if isinstance(node, dict) and "iref" in node and len(node) == 1:
                fp = str(node["iref"])
            elif isinstance(node, dict) and "idef" in node:
                fp = str(node["idef"])
            else:
                fp = wire.fingerprint(node)
            pairs.append((fp, a))
        return pairs

    def _resolve_list(
        self,
        node: Any,
        cached: Optional[Tuple[str, List[Tuple[str, Action]]]],
        missing: List[str],
        what: str,
    ) -> Tuple[List[Optional[Action]], Any]:
        """One action list (executing set or a partition's waiting
        queue) in any wire form: legacy plain list, ``ref`` (unchanged),
        ``delta`` (removals by member fingerprint + positional inserts
        into the kept order), or ``full``.  Returns (actions, commit):
        the caller applies ``commit`` to its cache slot only after the
        request's atomic missing-intern check passes, so a failed
        request never leaves a half-resolved list behind — ``False``
        means drop the slot (legacy form), ``None`` means keep it.

        A reconstructed delta is verified against the sender's list
        fingerprint; a mismatch is a typed, recoverable error — the
        client re-sends full content, never plans on a wrong queue.
        These caches are bounded by construction: each slot holds
        exactly one live list (replaced wholesale), never history."""
        if isinstance(node, list):
            # legacy form: a plain per-action list, uncached
            return [self._resolve_action(a, missing) for a in node], False
        if not isinstance(node, dict):
            raise wire.WireError(f"plan_request: malformed {what} entry")
        kind = str(node.get("k", ""))
        if kind == "ref":
            if cached is None or cached[0] != str(node.get("fp")):
                raise ProtocolStateError(
                    "stale_ref", f"{what} ref does not match cached list"
                )
            return [a for _, a in cached[1]], None
        if kind == "full":
            pairs = self._exec_pairs(node.get("items", []), missing)
            if missing:
                return [a for _, a in pairs], None
            return [a for _, a in pairs], (str(node.get("fp")), pairs)
        if kind == "delta":
            if cached is None or cached[0] != str(node.get("base")):
                raise ProtocolStateError(
                    "stale_base", f"{what} delta base does not match cached list"
                )
            inserts = [
                (int(pos), self._exec_pairs([n], missing)[0])
                for pos, n in node.get("ins", [])
            ]
            if missing:
                return [], None
            rm = {str(f) for f in node.get("rm", [])}
            pairs = [(f, a) for f, a in cached[1] if f not in rm]
            for pos, pair in inserts:  # ascending: client emits in order
                pairs.insert(pos, pair)
            fp = str(node.get("fp"))
            if wire.list_fingerprint([f for f, _ in pairs]) != fp:
                raise ProtocolStateError(
                    "delta_mismatch",
                    f"{what} delta did not reproduce the sender's list",
                )
            return [a for _, a in pairs], (fp, pairs)
        raise wire.WireError(f"plan_request: unknown {what} form {kind!r}")

    def _handle(self, payload: Any, parse_s: float = 0.0) -> Dict[str, Any]:
        """Dispatch one decoded frame by kind: ``plan_request`` (one
        plan round), ``plan_commit`` (a fused plan+commit round against
        the leased authoritative replicas — the two-phase commit's
        *prepare*, answered by the ``plan_commit_response`` ack),
        ``commit_decide`` (the explicit commit/abort verdict for an
        unconfirmed prepared round, also the fence/revocation vehicle),
        ``plan_batch`` (several plan/plan_commit requests processed in
        arrival order against the evolving cache state — one frame, one
        framing overhead), or ``drain`` (flush the carried response-dump
        cost so a run's LAST response encode is billed before the
        transport closes)."""
        kind = payload.get("kind") if isinstance(payload, dict) else None
        if kind == "drain":
            wire.expect(payload, "drain")
            codec_s = parse_s + self._carry_dump_s
            self._carry_dump_s = 0.0
            return wire.envelope("drain_response", {"codec_s": codec_s})
        if kind == "commit_decide":
            return self._commit_decide(payload)
        if kind == "plan_batch":
            batch = wire.expect(payload, "plan_batch")
            resps = [
                (
                    self._plan_commit(r, parse_s if i == 0 else 0.0)
                    if isinstance(r, dict) and r.get("kind") == "plan_commit"
                    else self._plan(r, parse_s if i == 0 else 0.0)
                )
                for i, r in enumerate(batch.get("reqs", []))
            ]
            return wire.envelope("plan_batch_response", {"resps": resps})
        if kind == "plan_commit":
            return self._plan_commit(payload, parse_s)
        return self._plan(payload, parse_s)

    def _decode_plan_request(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """The decode preamble shared by ``plan_request`` and
        ``plan_commit``: sync policy/fairness/history, reconstruct
        snapshots and refresh the resident replicas, resolve every
        interned action list atomically.  Returns a context dict with
        the *plan view* managers (``plan_mutates`` families copied), the
        resident authoritative replicas as ``(fp, full, mgr)`` triples,
        the resolved waiting/executing lists, and the preamble's codec
        wall — the caller adds its own encode cost on top."""
        self._stats = self._fresh_stats()
        t_codec = time.perf_counter()

        if req.get("policy") is not None:
            self._policy = wire.decode_policy(req["policy"])
            self._policy_fp = wire.fingerprint(req["policy"])
        if self._policy is None:
            # a restarted worker sees a policy-omitted request: typed
            # and recoverable — the client's full re-send carries it
            raise ProtocolStateError(
                "stale_ref", "plan_request before any policy was sent"
            )

        fs = req.get("fair_share", {"ref": self._fair_share_fp})
        if not (isinstance(fs, dict) and "ref" in fs):
            self._fair_share = wire.decode_fair_share(fs)
            self._fair_share_fp = wire.fingerprint(fs)
        elif fs["ref"] != self._fair_share_fp:
            raise ProtocolStateError(
                "stale_ref", "fair_share ref does not match cached state"
            )

        hist = req.get("history")
        if hist is not None:
            if isinstance(hist, dict) and "ref" in hist:
                if hist["ref"] != self._history_fp:
                    raise ProtocolStateError(
                        "stale_ref", "history ref does not match cached state"
                    )
            else:
                self._history_avg = {
                    str(k): float(v) for k, v in hist.get("avg", {}).items()
                }
                self._history_fp = wire.fingerprint(hist)
            # apply the cached table even on a ref hit: a policy refresh
            # above rebuilt a FRESH policy (empty history), and an
            # unchanged-history ref must still repopulate it — otherwise
            # unprofiled actions price at the default and remote plans
            # silently diverge from serial ones
            history = getattr(self._policy, "history", None)
            if history is not None:
                history._avg = dict(self._history_avg)

        if req.get("reset_interns"):
            # recovery round: the client cleared its mirror, so drop the
            # table too — both sides restart from the same empty state
            self._interns.clear()
            self._exec_cache = None
            self._part_cache.clear()

        # resident replicas: fingerprint hit -> reuse, state change ->
        # in-place refresh, topology change -> rebuild.  The plan-scope
        # reset is a throwaway snapshot() of exactly the families whose
        # plan phase mutates them, taken ONCE per request and shared
        # across this request's partitions — matching the one-decode-
        # per-request semantics the rebuild path had.
        managers: Dict[str, Any] = {}
        resident: Dict[str, Tuple[str, Dict[str, Any], Any]] = {}
        for rtype, snap in req.get("snapshots", {}).items():
            rt = str(rtype)
            fp, full = self._snapshot(rt, snap)
            mgr = self._manager(rt, fp, full)
            resident[rt] = (fp, full, mgr)
            if type(mgr).plan_mutates:
                t_reset = time.perf_counter()
                mgr = mgr.snapshot()
                self._stats["reset_s"] += time.perf_counter() - t_reset
            managers[rt] = mgr

        # resolve interned actions BEFORE planning over any of them: a
        # stale reference must fail the whole request atomically (one
        # typed error naming every missing payload), never plan with a
        # partial queue.  The intern table holds *decoded* Action
        # objects, so a referenced action costs a dict lookup instead of
        # a full decode — and its ``_dp_durs`` duration memo persists
        # across the rounds it stays queued, exactly as a live action's
        # does on the serial path (the memo depends only on immutable
        # fields, so reuse is sound; any mutable-field change produces a
        # new fingerprint and a fresh decode).
        missing: List[str] = []
        executing, exec_commit = self._resolve_list(
            req.get("executing", []), self._exec_cache, missing, "executing"
        )
        waiting_by_part: Dict[str, List[Action]] = {}
        part_commits: List[Tuple[str, Any]] = []
        for p in req.get("partitions", []):
            part = str(p["part"])
            acts, commit = self._resolve_list(
                p.get("waiting", []),
                self._part_cache.get(part),
                missing,
                f"partition {part!r}",
            )
            waiting_by_part[part] = acts
            if commit is not None:
                part_commits.append((part, commit))
        if missing:
            raise ProtocolStateError(
                "stale_intern",
                f"{len(missing)} interned payload(s) not in table",
                missing=sorted(set(missing)),
            )
        if exec_commit is False:
            self._exec_cache = None
        elif exec_commit is not None:
            self._exec_cache = exec_commit
        for part, commit in part_commits:
            if commit is False:
                self._part_cache.pop(part, None)
            else:
                self._part_cache[part] = commit
        return {
            "managers": managers,
            "resident": resident,
            "waiting_by_part": waiting_by_part,
            "executing": executing,
            "now": float(req.get("now", 0.0)),
            "incremental": bool(req.get("incremental", True)),
            "shard": int(req.get("shard", 0)),
            "codec_s": time.perf_counter() - t_codec,
        }

    def _plan(self, payload: Any, parse_s: float = 0.0) -> Dict[str, Any]:
        req = wire.expect(payload, "plan_request")
        ctx = self._decode_plan_request(req)
        managers = ctx["managers"]
        shard = ctx["shard"]

        t_plan = time.perf_counter()
        plans = []
        for part, waiting in ctx["waiting_by_part"].items():
            p = plan_partition(
                part,
                waiting,
                ctx["executing"],
                managers,
                self._policy,
                self._fair_share,
                ctx["now"],
                ctx["incremental"],
                shard=shard,
            )
            if self.plan_delay_s > 0.0:
                t_straggle = time.perf_counter()
                time.sleep(self.plan_delay_s)
                p.wall_s += time.perf_counter() - t_straggle
            plans.append(p)
        plan_s = time.perf_counter() - t_plan

        t_enc = time.perf_counter()
        plan_payloads = [wire.encode_plan(p) for p in plans]
        codec_s = ctx["codec_s"] + parse_s + self._carry_dump_s + (
            time.perf_counter() - t_enc
        )
        self._carry_dump_s = 0.0
        body = {
            "shard": shard,
            "plans": plan_payloads,
            "plan_s": plan_s,
            "codec_s": codec_s,
            "cache": self._stats,
        }
        return wire.envelope("plan_response", body)

    # -- worker-owned two-phase commit ---------------------------------
    def _restore_stash(self) -> int:
        """Abort the unconfirmed prepared round: rebuild every touched
        replica from its stashed pre-round snapshot (the existing
        decode rail — byte-identical state, no half-applied commits
        survive).  Returns the number of replicas restored."""
        stash, self._stash = self._stash, None
        if not stash:
            return 0
        for rt, (fp, full) in stash.items():
            self._resident[rt] = (fp, wire.decode_snapshot(full))
            self._snap_cache.put(rt, (fp, full), wire.payload_nbytes(full))
        return len(stash)

    def _commit_decide(self, payload: Any) -> Dict[str, Any]:
        """The coordinator's explicit verdict on the unconfirmed
        prepared round: ``commit=True`` finalizes it (drop the stash),
        ``commit=False`` deterministically aborts it (restore the
        pre-round replica states).  ``revoke`` lists rtypes whose
        ownership lease is withdrawn (handoff fence / adoption after a
        presumed loss) — a later ``plan_commit`` asserting the revoked
        epoch gets a typed ``stale_epoch`` refusal."""
        req = wire.expect(payload, "commit_decide")
        restored = 0
        if bool(req.get("commit", False)):
            self._stash = None
        else:
            restored = self._restore_stash()
        for rt in req.get("revoke", []):
            self._leases.pop(str(rt), None)
        return wire.envelope(
            "commit_decide_response",
            {"restored": restored, "leases": len(self._leases)},
        )

    def _plan_commit(self, payload: Any, parse_s: float = 0.0) -> Dict[str, Any]:
        """One fused plan+commit round — the two-phase exchange's
        *prepare*.  The worker validates its ownership leases (epoch
        assertions fail typed BEFORE any mutation), stashes the
        pre-round replica states, then runs up to ``max_passes``
        dependent fixpoint passes entirely locally: plan the dirty
        partitions (same plan core), commit each pass's intents against
        the **authoritative resident replicas** in global sorted
        partition order through the same shared commit core the
        client-serial engine uses (:func:`repro_torch.core.shards.
        commit_decision`), re-dirty via the shared classification, and
        feed the next pass.  Conflicts are resolved worker-side: a
        refused intent rolls back through ``release_unlaunched`` and
        its partition stays queued — exactly the client-serial rail.
        The response is the *ack*: per-pass plans + committed outcomes
        plus the post-commit replica fingerprints the coordinator
        verifies its replay against."""
        req = wire.expect(payload, "plan_commit")
        commit_req = req.get("commit") or {}

        # 1) settle the previous round's stash: an explicit confirm
        # finalizes it; any new frame without one means the coordinator
        # never adopted that round — deterministic implicit abort.
        if commit_req.get("confirm"):
            self._stash = None
        elif self._stash is not None:
            self._restore_stash()

        # 2) ownership leases — validated before ANY replica mutation,
        # so a stale-epoch worker (restart amnesia, fenced handoff) can
        # never double-launch: it refuses typed and the coordinator
        # re-grants.
        stale: List[str] = []
        for node in commit_req.get("leases", []):
            rt, epoch, fresh, _fp = wire.decode_lease(node)
            if fresh:
                self._leases[rt] = epoch
            elif self._leases.get(rt) != epoch:
                stale.append(rt)
        if stale:
            raise ProtocolStateError(
                "stale_epoch",
                f"{len(stale)} ownership lease(s) stale or not held",
                rtypes=sorted(stale),
            )

        # 3) shared decode preamble (same rails as plan_request)
        ctx = self._decode_plan_request(req)
        resident = ctx["resident"]
        now = ctx["now"]
        shard = ctx["shard"]
        t_codec_extra = 0.0

        # 4) stash pre-round state for the abort rail
        self._stash = {rt: (fp, full) for rt, (fp, full, _m) in resident.items()}
        replicas = {rt: m for rt, (_fp, _full, m) in resident.items()}

        max_passes = max(1, int(commit_req.get("max_passes", 1)))
        tick = float(commit_req.get("tick", 0.0005))
        history = getattr(self._policy, "history", None)
        waiting = {p: list(acts) for p, acts in ctx["waiting_by_part"].items()}
        exec_view = list(ctx["executing"])

        passes_out: List[Dict[str, Any]] = []
        plan_s_total = 0.0
        commit_s_total = 0.0
        # pass 1 plans every partition the frame carried (empty ones
        # included — the coordinator's replay needs their plans for the
        # same watch-list bookkeeping the client-serial path performs);
        # later passes re-plan only the re-dirtied set
        keys = sorted(waiting)
        for _pass in range(max_passes):
            if not keys:
                break
            t_plan = time.perf_counter()
            plan_view: Dict[str, Any] = {}
            for rt, m in replicas.items():
                plan_view[rt] = m.snapshot() if type(m).plan_mutates else m
            plans = [
                plan_partition(
                    part,
                    waiting[part],
                    exec_view,
                    plan_view,
                    self._policy,
                    self._fair_share,
                    now,
                    ctx["incremental"],
                    shard=shard,
                )
                for part in keys
            ]
            plan_s_total += time.perf_counter() - t_plan

            t_commit = time.perf_counter()
            outcomes: List[Dict[str, Any]] = []
            next_keys: List[str] = []
            for plan in plans:  # keys sorted -> global sorted commit order
                part = plan.part
                acts = waiting.get(part, [])
                launched_rows: List[Tuple[int, Dict[str, int]]] = []
                failed = 0
                if plan.planned and acts and plan.result is not None:
                    quota_pending = quota_reservations(
                        plan.result.decisions, replicas, self._fair_share
                    )
                    launched_uids = set()
                    for decision in plan.result.decisions:
                        granted = commit_decision(
                            decision, replicas, self._fair_share, quota_pending
                        )
                        if granted is None:
                            failed += 1
                            continue
                        units, allocs = granted
                        a = decision.action
                        overhead = tick + sum(al.overhead for al in allocs)
                        key_units = units.get(a.key_resource or "", None)
                        dur = duration_of(a, key_units, history)
                        # the launched action joins the next pass's
                        # executing view as a CLONE — interned Actions
                        # are shared across rounds and must never be
                        # mutated worker-side
                        exec_view.append(
                            wire.patch_action(
                                a,
                                {
                                    "state": ActionState.RUNNING.value,
                                    "start_time": now,
                                    "finish_time": now + overhead + dur,
                                    "sys_overhead": overhead,
                                },
                            )
                        )
                        launched_uids.add(a.uid)
                        launched_rows.append((a.uid, units))
                    if launched_uids:
                        waiting[part] = acts = [
                            x for x in acts if x.uid not in launched_uids
                        ]
                evicted = 0 if plan.result is None else plan.result.evicted
                cls = classify_after_commit(
                    _WaitingView(acts), evicted, failed, plan.held, replicas
                )
                if cls == "dirty":
                    next_keys.append(part)
                outcomes.append(
                    wire.encode_commit_outcome(part, launched_rows, failed, plan.held)
                )
            commit_s_total += time.perf_counter() - t_commit

            t_enc = time.perf_counter()
            passes_out.append(
                {
                    "plans": [wire.encode_plan(p) for p in plans],
                    "outcomes": outcomes,
                }
            )
            t_codec_extra += time.perf_counter() - t_enc
            keys = next_keys

        # 5) post-commit fingerprints: the resident replicas now embody
        # the committed state; re-key them (and the delta bases) so the
        # next round's refs/deltas match WITHOUT re-shipping the state —
        # the whole point of worker-owned commit.  The fp computation is
        # worker commit cost and is billed as such.
        t_fp = time.perf_counter()
        fps: Dict[str, str] = {}
        for rt, m in replicas.items():
            full = wire.encode_snapshot(m)
            fp = wire.fingerprint(full)
            self._resident[rt] = (fp, m)
            self._snap_cache.put(rt, (fp, full), wire.payload_nbytes(full))
            fps[rt] = fp
        commit_s_total += time.perf_counter() - t_fp

        codec_s = (
            ctx["codec_s"] + parse_s + self._carry_dump_s + t_codec_extra
        )
        self._carry_dump_s = 0.0
        body = {
            "shard": shard,
            "passes": passes_out,
            "more": bool(keys),
            "fps": fps,
            "plan_s": plan_s_total,
            "commit_s": commit_s_total,
            "codec_s": codec_s,
            "cache": self._stats,
        }
        return wire.envelope("plan_commit_response", body)


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------


class ShardTransport:
    """Byte-boundary to one shard worker.

    The contract is a single in-flight request per transport:
    ``submit(request)`` hands the worker a byte frame, ``recv()``
    blocks for its response.  The client overlaps workers by submitting
    to all transports before receiving from any.  Implementations move
    opaque byte frames only — never pickled objects — so an RPC
    transport can slot in without touching the protocol."""

    def submit(self, request: bytes) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def recv(self) -> bytes:  # pragma: no cover - interface
        raise NotImplementedError

    def close(self) -> None:  # pragma: no cover - interface
        pass

    def __enter__(self) -> "ShardTransport":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @staticmethod
    def _as_bytes(request) -> bytes:
        """Coerce a str frame to UTF-8 (JSON text is a legal frame)."""
        return request.encode("utf-8") if isinstance(request, str) else request


class LoopbackTransport(ShardTransport):
    """In-process worker behind the full wire codec path.

    Every request and response crosses :func:`repro_torch.core.wire.
    encode_frame` / :func:`~repro_torch.core.wire.decode_frame` exactly as
    over a real transport — loopback proves plan-over-wire fidelity
    (and measures serialization cost) deterministically, without
    process scheduling noise.  The worker computes during
    :meth:`submit`; :meth:`recv` just returns."""

    def __init__(self) -> None:
        self._worker = RemoteShardWorker()
        self._response: Optional[bytes] = None

    def submit(self, request: bytes) -> None:
        self._response = self._worker.handle_bytes(self._as_bytes(request))

    def recv(self) -> bytes:
        resp, self._response = self._response, None
        if resp is None:
            raise RuntimeError("recv() without a submitted request")
        return resp


def _worker_main(conn) -> None:
    """Entry point of a :class:`ProcessTransport` worker process: serve
    plan requests off the pipe until the empty shutdown frame (or EOF).
    Module-level so it is importable under any multiprocessing start
    method (spawn pickles the callable by reference, never by value)."""
    worker = RemoteShardWorker()
    while True:
        try:
            blob = conn.recv_bytes()
        except (EOFError, OSError):
            break
        if not blob:
            break
        conn.send_bytes(worker.handle_bytes(blob))
    conn.close()


#: Every live ProcessTransport, swept at interpreter exit: a transport
#: abandoned without close() (test failure paths, leaked orchestrators)
#: must not leave worker processes behind.  Daemonic workers die with
#: the parent anyway, but only at hard exit — the sweep (and __del__)
#: reaps them as soon as the transport is collected or atexit runs.
_LIVE_PROCESS_TRANSPORTS: "weakref.WeakSet[ProcessTransport]" = weakref.WeakSet()


def _sweep_process_transports() -> None:  # pragma: no cover - atexit path
    for t in list(_LIVE_PROCESS_TRANSPORTS):
        try:
            t.close()
        except Exception:  # noqa: BLE001 - exit path, best effort
            pass


atexit.register(_sweep_process_transports)


class ProcessTransport(ShardTransport):
    """A shard worker in a separate OS process over a multiprocessing
    pipe.  Frames are opaque bytes (``send_bytes``/``recv_bytes`` — no
    object pickling); an empty frame is the shutdown signal (a real
    frame is never empty: JSON text has at least one byte and binary
    frames start with the magic byte).  Workers are daemonic: they can
    never outlive the orchestrator — and they do not linger either:
    ``close()`` is idempotent, runs from ``__del__`` when a transport
    is garbage-collected unclosed, and an atexit sweep reaps any still
    alive at interpreter exit.  A dead worker (killed process, broken
    pipe) surfaces as :class:`~repro_torch.core.wire.TransportError`
    (``"reset"``) so the round client's loss-fallback rail handles it
    like any other carrier."""

    def __init__(self, start_method: Optional[str] = None) -> None:
        import multiprocessing as mp

        if start_method is None:
            start_method = (
                "fork" if "fork" in mp.get_all_start_methods() else "spawn"
            )
        ctx = mp.get_context(start_method)
        self._closed = False
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(target=_worker_main, args=(child,), daemon=True)
        self._proc.start()
        child.close()
        _LIVE_PROCESS_TRANSPORTS.add(self)

    def submit(self, request: bytes) -> None:
        try:
            self._conn.send_bytes(self._as_bytes(request))
        except (OSError, ValueError) as e:
            raise wire.TransportError(
                "reset", f"shard worker pipe broken at submit: {e}"
            ) from None

    def recv(self) -> bytes:
        try:
            return self._conn.recv_bytes()
        except EOFError:
            raise wire.TransportError(
                "truncated_frame", "shard worker died holding the request"
            ) from None
        except (OSError, ValueError) as e:
            raise wire.TransportError(
                "reset", f"shard worker pipe broken at recv: {e}"
            ) from None

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        _LIVE_PROCESS_TRANSPORTS.discard(self)
        try:
            self._conn.send_bytes(b"")
        except (OSError, ValueError):
            pass
        try:
            self._conn.close()
        except (OSError, ValueError):
            pass
        self._proc.join(timeout=5)
        if self._proc.is_alive():  # pragma: no cover - defensive
            self._proc.terminate()

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


_TRANSPORTS = {"loopback": LoopbackTransport, "process": ProcessTransport}


def _per_shard(factory: Callable) -> Callable[[int], "ShardTransport"]:
    """Normalize a transport callable to ``shard_idx -> transport``.

    Fleet factories (:func:`repro_torch.core.transport.socket_fleet`) take
    the shard index; plain transport classes and zero-argument
    factories (``LoopbackTransport``, test doubles) do not — probe the
    signature once and wrap the latter so each shard still gets its
    own instance."""
    try:
        inspect.signature(factory).bind(0)
    except TypeError:
        return lambda shard_idx: factory()
    except ValueError:  # uninspectable (C callable): assume new-style
        pass
    return factory


# ---------------------------------------------------------------------------
# the orchestrator side
# ---------------------------------------------------------------------------


def _nk(x: Any) -> Any:
    """NaN-stable cache-key atom (NaN != NaN would defeat every hit)."""
    return None if isinstance(x, float) and math.isnan(x) else x


class _ActEnc:
    """One action's cached wire identity.

    The fingerprint and byte estimate are computed from the mutable-field
    key alone; the full envelope (``payload``) is materialized lazily —
    only when some worker actually needs a full define.  ``prev_fp`` /
    ``patch`` remember the previous version of this uid and the field
    diff against it, so a lifecycle transition can travel as a
    patch-define to any worker still holding the old version."""

    __slots__ = ("key", "fp", "nbytes", "action", "payload", "prev_fp", "patch")

    def __init__(
        self,
        key: tuple,
        fp: str,
        nbytes: int,
        action: Action,
        prev_fp: Optional[str],
        patch: Optional[Dict[str, Any]],
    ) -> None:
        self.key = key
        self.fp = fp
        self.nbytes = nbytes
        self.action = action
        self.payload: Optional[Dict[str, Any]] = None
        self.prev_fp = prev_fp
        self.patch = patch


class RemoteRoundClient:
    """Drives one remote plan phase per sharded round.

    Owns one transport (one worker) per shard index, created lazily.
    Per worker it tracks the fingerprints of the policy config, fairness
    config, duration history, and each manager snapshot it last sent —
    unchanged payloads travel as ``{"ref": fp}``, changed snapshots as
    structural :func:`~repro_torch.core.wire.encode_snapshot_delta` diffs
    against the worker's cached base — plus a deterministic mirror of
    the worker's intern table, so repeated action payloads travel as
    ``{"iref": fp}`` references and mutated ones as patch-defines
    against the version the worker still holds.  Encoded action
    payloads are cached across rounds keyed on the mutable field tuple,
    so an unchanged action costs neither encode CPU nor wire bytes; the
    encoded *byte segments* of full sections are memoized by
    fingerprint and spliced into frames, so even a changed round only
    serializes what actually changed.

    Recovery: a typed worker error in :data:`RECOVERABLE_CODES` (cache
    eviction, worker restart, delta base mismatch) resets that worker's
    sent-state and re-sends its request with full content, exactly
    once per round — counted in ``Telemetry.wire_fallbacks``, never a
    silently wrong plan.

    Worker loss: any :class:`~repro_torch.core.wire.TransportError` (dead
    process, dropped socket, read timeout, truncated frame) marks that
    worker down and plans its partitions **inline** for the round —
    through the same :func:`repro_torch.core.shards.plan_partition` core over
    fresh manager snapshots, so the round's plans (and the launch
    trace) are identical to what the worker would have produced.  The
    failed transport is torn down and rebuilt lazily; reconnection is
    retried with bounded round-based exponential backoff (skip 0, 1,
    3, then at most :data:`MAX_BACKOFF_ROUNDS` rounds between
    attempts), and a worker that answers again is re-primed through
    the existing full-resend + ``reset_interns`` rail.  Losses,
    reconnects, and inline-planned partitions are counted in
    ``Telemetry.wire_worker_losses`` / ``wire_reconnects`` /
    ``wire_inline_parts`` — a loss is never silent and never a lost or
    double launch.

    ``transport`` is either a registered name (``"loopback"`` /
    ``"process"``) or a callable: a ``shard_idx -> ShardTransport``
    factory (e.g. :func:`repro_torch.core.transport.socket_fleet` for a
    multi-host fleet), or a zero-argument factory/transport class —
    each shard still gets its own instance."""

    def __init__(
        self,
        orch: "Orchestrator",
        transport: Union[str, Callable[[int], ShardTransport]] = "loopback",
        codec: str = "json",
    ) -> None:
        if callable(transport):
            self._factory: Callable[[int], ShardTransport] = _per_shard(transport)
            self.transport_kind = getattr(transport, "__name__", "custom")
        else:
            named = _TRANSPORTS.get(transport)
            if named is None:
                raise ValueError(
                    f"unknown transport {transport!r} (have {sorted(_TRANSPORTS)})"
                )
            self._factory = lambda shard_idx: named()
            self.transport_kind = transport
        if codec not in wire.WIRE_CODECS:
            raise ValueError(
                f"unknown wire codec {codec!r} (have {list(wire.WIRE_CODECS)})"
            )
        self.orch = orch
        self.codec = codec
        self._transports: List[Optional[ShardTransport]] = []
        # worker-loss state: shard_idx -> [consecutive_failures,
        # rounds_to_skip]; presence marks the worker down (next
        # successful round-trip clears it and counts a reconnect)
        self._down: Dict[int, List[int]] = {}
        # workers whose next request must carry reset_interns (their
        # mirror was cleared after a loss; the worker we reach next —
        # fresh or survivor — must drop its table to stay in sync)
        self._need_intern_reset: set = set()
        self._sent: List[Dict[str, Any]] = []  # per-worker fingerprint state
        self._mirrors: List[wire.LruBytes] = []  # per-worker intern mirrors
        # client-side delta bases: rtype -> (fp, full snapshot envelope)
        self._prev_snaps: Dict[str, Tuple[str, Dict[str, Any]]] = {}
        # uid -> _ActEnc: re-encoding an unchanged action is pure waste
        # — skip it entirely (payload materialized lazily, see _ActEnc)
        self._act_cache: Dict[int, _ActEnc] = {}
        # fingerprint-keyed pre-encoded byte segments ("a:"/"s:"/"p:"/
        # "f:"/"h:" + fp), spliced into request frames instead of
        # re-serializing the payload tree; governed by the same byte
        # budget as every other wire cache
        self._segments = wire.LruBytes(CACHE_BUDGET_BYTES)
        # per-round encode-memo consultations (act cache, queue cache,
        # segment cache) — flushed to Telemetry after each round
        self._memo_hits = 0
        self._memo_misses = 0
        # last scheduling instant a wire round was accounted at: frames
        # for the same instant merge into one accounting round
        self._last_now: Optional[float] = None
        # slot -> (payload, fp): policy/fairness/history digest memo
        self._shared_cache: Dict[str, Tuple[Any, str]] = {}
        # uid -> frozenset of managed rtypes its cost touches (immutable
        # per action) — drives the per-shard executing subset
        self._act_rsets: Dict[int, frozenset] = {}
        # part -> (queue.version, {uid: action}, enc, fps, list fp,
        # rtypes, {uid: queue tag}): whole-partition encoded view,
        # exact while the version holds; on a version change, members
        # with surviving tags reuse their encodings (see plan_round)
        self._queue_cache: Dict[str, tuple] = {}
        # uids seen executing last round: a member of two consecutive
        # executing sets was not mutated in between (transitions always
        # move an action out of the set for at least one round)
        self._exec_prev_uids: set = set()

    # ------------------------------------------------------------------
    def close(self) -> None:
        # flush each worker's carried response-dump cost before closing:
        # the LAST plan response's encode was timed but never reported
        # (it rides the NEXT response by design) — a drain round-trip
        # folds that tail into the telemetry so a finished run's wire
        # bill is complete.  A worker that cannot answer (already dead,
        # mid-restart test transport) just loses its tail.
        tel = getattr(self.orch, "telemetry", None)
        for t in self._transports:
            if t is None:  # down worker: nothing to drain or close
                continue
            try:
                blob = wire.encode_frame(wire.envelope("drain", {}), self.codec)
                t.submit(blob)
                resp = t.recv()
                payload = wire.decode_frame(resp)
                if (
                    tel is not None
                    and isinstance(payload, dict)
                    and payload.get("kind") == "drain_response"
                ):
                    tel.wire_worker_codec_s += float(payload.get("codec_s", 0.0))
                    tel.wire_bytes += len(blob) + len(resp)
                    tel.wire_frames += 1
            except Exception:  # noqa: BLE001 - best-effort flush
                pass
            t.close()
        self._transports.clear()
        self._sent.clear()
        self._mirrors.clear()
        self._prev_snaps.clear()
        self._act_cache.clear()
        self._shared_cache.clear()
        self._queue_cache.clear()
        self._exec_prev_uids.clear()
        self._act_rsets.clear()
        self._segments.clear()
        self._last_now = None
        self._down.clear()
        self._need_intern_reset.clear()

    def _ensure_slots(self, n: int) -> None:
        while len(self._transports) < n:
            self._transports.append(None)
            self._sent.append({"snaps": {}})
            self._mirrors.append(wire.LruBytes(CACHE_BUDGET_BYTES))

    def _transport(self, i: int) -> ShardTransport:
        self._ensure_slots(i + 1)
        t = self._transports[i]
        if t is None:
            t = self._transports[i] = self._factory(i)
        return t

    def _reset_worker(self, i: int) -> None:
        """Forget everything we believe worker ``i`` holds; the next
        request built for it carries full content (and tells the worker
        to drop its intern table so the mirror restarts in sync)."""
        self._sent[i] = {"snaps": {}}
        self._mirrors[i].clear()

    # -- worker-loss rail ----------------------------------------------
    def _note_worker_loss(self, i: int) -> None:
        """Record a transport failure on worker ``i``: tear the
        transport down (rebuilt lazily on the next attempt), reset the
        client's view of the worker (mirror/sent state may have been
        mutated mid-encode), and advance the round-based backoff."""
        self.orch.telemetry.wire_worker_losses += 1
        t = None
        if i < len(self._transports):
            t, self._transports[i] = self._transports[i], None
        if t is not None:
            try:
                t.close()
            except Exception:  # noqa: BLE001 - already failing
                pass
        self._reset_worker(i)
        self._need_intern_reset.add(i)
        state = self._down.get(i)
        if state is None:
            self._down[i] = [1, 0]  # retry on the very next round
        else:
            state[0] += 1
            state[1] = min(2 ** (state[0] - 1) - 1, MAX_BACKOFF_ROUNDS)

    def _skip_down_worker(self, i: int) -> bool:
        """True when worker ``i`` is in a backoff window this round (the
        skip counter is consumed; at zero the caller attempts the
        normal path — that attempt IS the reconnect probe)."""
        state = self._down.get(i)
        if state is None or state[1] <= 0:
            return False
        state[1] -= 1
        return True

    def _note_worker_ok(self, i: int) -> None:
        """A full round-trip succeeded: clear loss state (counting a
        reconnect if the worker had been down) and the pending
        intern-reset flag."""
        self._need_intern_reset.discard(i)
        if self._down.pop(i, None) is not None:
            self.orch.telemetry.wire_reconnects += 1

    def _plan_inline(
        self, shard_idx: int, parts_enc: Sequence[tuple]
    ) -> Tuple[List[PartitionPlan], float]:
        """Plan a lost worker's partitions locally — the loss-fallback
        rail.  Runs the identical plan core over fresh manager
        snapshots (exactly what an in-process shard does), so the plans
        this round commits are the ones the worker would have returned:
        worker loss costs local plan CPU, never trace divergence."""
        orch = self.orch
        t0 = time.perf_counter()
        snapshots = SnapshotMap(orch.managers)
        plans = [
            orch._plan_partition(entry[0], snapshots, shard=shard_idx)
            for entry in parts_enc
        ]
        plan_s = time.perf_counter() - t0
        orch.telemetry.wire_inline_parts += len(plans)
        orch.telemetry.note_shard_round(shard_idx, len(plans), plan_s)
        return plans, plan_s

    # ------------------------------------------------------------------
    def _segment(self, skey: str, payload: Any) -> wire.Encoded:
        """The pre-encoded byte segment for a fingerprint-keyed payload:
        encoded at most once per content version, then spliced verbatim
        into every frame that carries it (all workers this round, every
        later full re-send while it lives in the budget)."""
        seg = self._segments.get(skey)
        if seg is not None:
            self._memo_hits += 1
            return seg
        self._memo_misses += 1
        seg = wire.encode_segment(payload, self.codec)
        self._segments.put(skey, seg, len(seg))
        return seg

    def _encode_action_cached(self, a: Action) -> _ActEnc:
        """The cached wire identity of one action, re-keyed only when a
        mutable field changed since the cached round.  Truly immutable
        fields (elasticity, ids) never re-key; the scalar metadata
        slice does, because planning reads it — and so does the cost
        *targeting* (rtype set + key_resource), because ``migrate_task``
        retargets those in place and a stale-cost reference would plan
        a migrated action against its pre-handoff pool.  A re-key
        computes the *field diff* against the previous version — the
        payload a patch-define ships — and defers the full envelope
        until some worker needs one; a retarget re-key forces a full
        define instead (the patch schema does not carry cost).
        Counting: an unchanged key is a memo hit, a re-key or a first
        sighting is a miss."""
        meta = a.metadata
        mkey: tuple = ()
        if meta:
            pairs = [
                (k, _nk(v))
                for k, v in meta.items()
                if not k.startswith("_") and isinstance(v, wire._SCALARS)
            ]
            if pairs:
                pairs.sort()
                mkey = tuple(pairs)
        key = (
            a.state.value,
            a.attempts,
            _nk(a.submit_time),
            _nk(a.start_time),
            _nk(a.finish_time),
            a.sys_overhead,
            mkey,
            (a.key_resource, tuple(sorted(a.cost))),
        )
        hit = self._act_cache.get(a.uid)
        if hit is not None and hit.key == key:
            self._memo_hits += 1
            return hit
        self._memo_misses += 1
        prev_fp: Optional[str] = None
        patch: Optional[Dict[str, Any]] = None
        if hit is not None:
            prev_fp = hit.fp
            patch = {}
            old = hit.key
            if old[0] != key[0]:
                patch["state"] = a.state.value
            if old[1] != key[1]:
                patch["attempts"] = a.attempts
            for i, field in (
                (2, "submit_time"),
                (3, "start_time"),
                (4, "finish_time"),
                (5, "sys_overhead"),
            ):
                if old[i] != key[i]:
                    patch[field] = getattr(a, field)
            if old[6] != mkey:
                patch["metadata"] = wire._wire_metadata(meta)
            if old[7] != key[7]:
                # a migration retargeted the cost vector: the patch
                # schema has no cost field, so ship a full define
                patch = None
        # identity hashes the uid plus the mutable-field key: immutable
        # fields can never differ for a uid, so this is exactly as
        # collision-free as hashing the whole payload at a fraction of
        # the canonicalization cost (uids are process-unique, and a
        # fresh client re-DEFINES everything it sends, so a warm worker
        # table can never alias a previous client's entries)
        fp = wire.fingerprint(["act", a.uid, key])
        # schema-based size estimate for intern byte budgeting — the
        # define ships it ("n"), so both tables account identically
        # without a serialization pass per encode
        nbytes = 300 + 60 * len(a.cost) + 24 * len(mkey)
        for s in (a.name, a.task_id, a.trajectory_id, a.key_resource, a.service):
            if isinstance(s, str):
                nbytes += len(s)
        enc = _ActEnc(key, fp, nbytes, a, prev_fp, patch)
        self._act_cache[a.uid] = enc
        return enc

    def _wire_action(self, mirror: wire.LruBytes, enc: _ActEnc) -> Any:
        """Intern decision for one action on one worker: a reference if
        the mirror says the worker holds this version, a patch-define if
        it holds the immediately-previous version, a full define (as a
        memoized byte segment) otherwise.  Mirror touches replicate the
        worker's table touches in the same order with the same byte
        accounting, so evictions match — a miss probe does not reorder
        either table."""
        if mirror.get(enc.fp) is not None:
            return wire.intern_ref(enc.fp)
        if (
            enc.patch is not None
            and enc.prev_fp is not None
            and mirror.get(enc.prev_fp) is not None
        ):
            mirror.put(enc.fp, True, enc.nbytes)
            return wire.intern_patch(enc.fp, enc.prev_fp, enc.patch, enc.nbytes)
        mirror.put(enc.fp, True, enc.nbytes)
        if enc.payload is None:
            enc.payload = wire.encode_action(enc.action)
        return self._segment(
            "a:" + enc.fp, wire.intern_def(enc.fp, enc.payload, enc.nbytes)
        )

    def _wire_list(
        self,
        mirror: wire.LruBytes,
        prev: Optional[Tuple[str, List[str]]],
        enc: List[_ActEnc],
        fps: List[str],
        lfp: str,
    ) -> Dict[str, Any]:
        """One action list as the cheapest wire form the worker can
        reconstruct: a bare reference when unchanged since last send, a
        removals-plus-positional-inserts delta when the kept members'
        relative order survived (always true for tag-ordered queues —
        tags are fixed at admission — and for the dict-ordered executing
        set), else the full list.  ``prev`` is (list fp, member fps)
        from the last send to this worker."""
        if prev is not None and prev[0] == lfp:
            return {"k": "ref", "fp": lfp}
        if prev is not None:
            prev_fps = prev[1]
            cur_set = set(fps)
            prev_set = set(prev_fps)
            kept = [f for f in prev_fps if f in cur_set]
            ins: List[Tuple[int, _ActEnc]] = []
            ki, ok = 0, True
            for i, e in enumerate(enc):
                f = e.fp
                if ki < len(kept) and f == kept[ki]:
                    ki += 1
                elif f not in prev_set:
                    ins.append((i, e))
                else:
                    ok = False  # kept members reordered — delta can't say it
                    break
            if ok and ki == len(kept):
                return {
                    "k": "delta",
                    "base": prev[0],
                    "fp": lfp,
                    "rm": [f for f in prev_fps if f not in cur_set],
                    "ins": [[i, self._wire_action(mirror, e)] for i, e in ins],
                }
        return {
            "k": "full",
            "fp": lfp,
            "items": [self._wire_action(mirror, e) for e in enc],
        }

    # ------------------------------------------------------------------
    def plan_round(
        self, groups: Sequence[Sequence[str]]
    ) -> Tuple[List[PartitionPlan], float]:
        """Plan every shard's partitions on its worker; returns the
        decoded plans (decisions re-bound to live actions) plus the
        round's critical-path plan cost: the max worker-measured plan
        time.  Dispatch is pipelined — every request is submitted before
        any response is awaited, so worker compute overlaps."""
        orch = self.orch
        telemetry = orch.telemetry
        # worker startup (process fork/spawn, socket objects) happens
        # here, outside the serialization accounting — a deployment cost
        # paid once, not a per-round wire cost.  Workers in a backoff
        # window keep their slot but get no transport built.
        self._ensure_slots(len(groups))
        for shard_idx in range(len(groups)):
            state = self._down.get(shard_idx)
            if state is None or state[1] <= 0:
                self._transport(shard_idx)
        t_round = time.perf_counter()

        # ---- encode phase (client-side serialization cost) ------------
        ctx = self._encode_round(groups)
        plans: List[PartitionPlan] = ctx["plans"]
        by_uid: Dict[int, Action] = ctx["by_uid"]
        shard_parts = ctx["shard_parts"]
        executing_enc = ctx["executing_enc"]
        exec_rsets = ctx["exec_rsets"]
        seen_uids = ctx["seen_uids"]
        shared = ctx["shared"]
        encode_s = ctx["encode_s"]
        nbytes = 0

        # ---- pipelined dispatch (encode shard i+1 while i is in
        # flight) -------------------------------------------------------
        # each request is submitted the moment its frame exists, so a
        # process-backed worker parses and plans shard i while the
        # client is still encoding shard i+1 — only the HEAD request's
        # encode is inherently serial with worker compute.  encode_s
        # stays the pure-encode sum and transport_s the submit+recv
        # wall sum, so the components remain comparable with the
        # serialized model; the overlap-aware critical path is reported
        # separately (overlap_s).
        requests: List[Tuple[int, Any, Any]] = []
        # workers lost this round (transport failure at any point) —
        # their partitions fall back to inline planning below
        lost: List[Tuple[int, Any]] = []
        transport_s = 0.0
        e_head = 0.0
        for shard_idx, parts_enc, rtypes in shard_parts:
            if self._skip_down_worker(shard_idx):
                lost.append((shard_idx, parts_enc))
                continue
            t0 = time.perf_counter()
            exec_sub = self._exec_subset(ctx, rtypes)
            blob = wire.encode_frame(
                self._request(
                    shard_idx, parts_enc, rtypes, exec_sub, shared,
                    reset_interns=shard_idx in self._need_intern_reset,
                ),
                self.codec,
            )
            t1 = time.perf_counter()
            encode_s += t1 - t0
            if not requests:
                e_head = t1 - t0
            nbytes += len(blob)
            try:
                self._transport(shard_idx).submit(blob)
            except wire.TransportError:
                transport_s += time.perf_counter() - t1
                self._note_worker_loss(shard_idx)
                lost.append((shard_idx, parts_enc))
                continue
            transport_s += time.perf_counter() - t1
            requests.append((shard_idx, (parts_enc, exec_sub), rtypes))
        # drop encode-cache entries for actions that left the system —
        # everything alive was just seen, so this is exact (runs while
        # the workers compute, off any per-request path)
        encode_s += self._prune_caches(seen_uids)

        # ---- gather (in submit order) ---------------------------------
        responses: List[Tuple[int, Any, Any, bytes]] = []
        for shard_idx, rctx, rtypes in requests:
            t0 = time.perf_counter()
            try:
                blob = self._transport(shard_idx).recv()
            except wire.TransportError:
                transport_s += time.perf_counter() - t0
                self._note_worker_loss(shard_idx)
                lost.append((shard_idx, rctx[0]))
                continue
            transport_s += time.perf_counter() - t0
            responses.append((shard_idx, rctx, rtypes, blob))

        # ---- decode phase (client-side cost; worker codec separate) ---
        t_dec = time.perf_counter()
        critical = 0.0
        decode_s = 0.0
        worker_codec_s = 0.0
        max_codec = 0.0
        for shard_idx, rctx, rtypes, blob in responses:
            nbytes += len(blob)
            payload = wire.decode_frame(blob)
            if isinstance(payload, dict) and payload.get("kind") == "error":
                parts_enc, exec_sub = rctx
                try:
                    payload, extra = self._recover(
                        shard_idx, payload, parts_enc, rtypes, exec_sub, shared
                    )
                except wire.TransportError:
                    self._note_worker_loss(shard_idx)
                    lost.append((shard_idx, parts_enc))
                    continue
                nbytes += extra
            resp = wire.expect(payload, "plan_response")
            plan_s = float(resp.get("plan_s", 0.0))
            codec_s = float(resp.get("codec_s", 0.0))
            worker_codec_s += codec_s
            max_codec = max(max_codec, codec_s)
            cache = resp.get("cache")
            if cache:
                telemetry.note_worker_cache(cache)
            shard_plans = [wire.decode_plan(p, by_uid) for p in resp["plans"]]
            critical = max(critical, plan_s)
            telemetry.note_shard_round(shard_idx, len(shard_plans), plan_s)
            plans.extend(shard_plans)
            self._note_worker_ok(shard_idx)
        decode_s += time.perf_counter() - t_dec

        # ---- loss fallback: plan lost workers' partitions inline ------
        # (same plan core over fresh snapshots — identical plans, so the
        # launch trace cannot diverge; the local plan cost is charged to
        # the round's critical path, where it actually ran)
        for shard_idx, parts_enc in lost:
            shard_plans, plan_s = self._plan_inline(shard_idx, parts_enc)
            critical = max(critical, plan_s)
            plans.extend(shard_plans)

        telemetry.plan_critical_s += critical
        telemetry.plan_wall_s += time.perf_counter() - t_round
        # overlap-aware wire critical path of this round: only the head
        # request's encode is serial with worker compute, the slowest
        # worker's codec bill gates the last response, and the client
        # decode tail is serial again.  Frames fired at the SAME
        # scheduling instant (multi-pass rounds coalesced by the round
        # engine) merge into the previous accounting round.
        overlap_s = e_head + max_codec + decode_s
        new_round = self._last_now is None or orch.now != self._last_now
        self._last_now = orch.now
        telemetry.note_wire_round(
            encode_s,
            transport_s,
            decode_s,
            nbytes,
            worker_codec_s,
            overlap_s=overlap_s,
            frames=len(requests),
            new_round=new_round,
        )
        telemetry.note_wire_memo(self._memo_hits, self._memo_misses)
        self._memo_hits = 0
        self._memo_misses = 0
        return plans, critical

    def _encode_round(self, groups: Sequence[Sequence[str]]) -> Dict[str, Any]:
        """The round's encode phase, shared by the plan-only path
        (:meth:`plan_round`) and the worker-owned fused plan+commit path
        (:class:`WorkerCommitEngine`): memo-encode the executing set and
        every non-empty partition queue, group them per shard, and
        encode the shard-independent payloads once.  Returns the round
        context — empty partitions come back as ``planned=False`` plans
        in ``plans`` (resolved client-side, off the wire)."""
        orch = self.orch
        t_enc = time.perf_counter()
        plans: List[PartitionPlan] = []
        by_uid: Dict[int, Action] = {}
        shard_parts: List[Tuple[int, list, set]] = []
        union_rtypes: set = set()
        executing = list(orch._executing.values())
        exec_prev = self._exec_prev_uids
        act_cache = self._act_cache
        rsets = self._act_rsets
        executing_enc: List[_ActEnc] = []
        exec_rsets = []
        for a in executing:
            hit = act_cache.get(a.uid)
            if hit is not None and a.uid in exec_prev:
                # two consecutive executing sets: not mutated in between
                # — skip even the key computation
                self._memo_hits += 1
                executing_enc.append(hit)
            else:
                executing_enc.append(self._encode_action_cached(a))
            rs = rsets.get(a.uid)
            if rs is None:
                rs = frozenset(r for r in a.cost if r in orch.managers)
                rsets[a.uid] = rs
            exec_rsets.append(rs)
        seen_uids = {a.uid for a in executing}
        self._exec_prev_uids = seen_uids.copy()
        nbytes = 0
        for shard_idx, group in enumerate(groups):
            parts_enc: List[Tuple[str, List[_ActEnc], List[str], str]] = []
            rtypes: set = set()
            for part in group:
                queue = orch._queues.get(part)
                if not queue:
                    # nothing to plan — resolved client-side, off the wire
                    plans.append(
                        PartitionPlan(part, planned=False, shard=shard_idx)
                    )
                    continue
                # queue.version gates a whole-partition encode cache:
                # membership mutations bump it, and the plan-then-commit
                # discipline guarantees queued actions only mutate
                # alongside a queue operation (retry = remove + push),
                # so an unchanged version means the encoded view is
                # still exact — the common idle partition costs O(1)
                # instead of O(depth) per round
                cached = self._queue_cache.get(part)
                if cached is not None and cached[0] == queue.version:
                    # section-level memo hit: one consultation covered
                    # the whole partition's encoded view
                    self._memo_hits += 1
                    _, members, enc, fps, lfp, part_rtypes, tags = cached
                else:
                    # version changed: re-enumerate, but re-key only the
                    # members whose queue tag moved — a surviving tag
                    # means the action was never removed/re-pushed, and
                    # queued actions only mutate alongside a queue op,
                    # so its cached encoding is still exact
                    waiting = queue.ordered()
                    prev_tags = cached[6] if cached is not None else {}
                    act_cache = self._act_cache
                    members = {a.uid: a for a in waiting}
                    tag_of = queue.tag_of
                    tags = {uid: tag_of(uid) for uid in members}
                    enc = []
                    for a in waiting:
                        uid = a.uid
                        hit = act_cache.get(uid)
                        if hit is not None and prev_tags.get(uid) == tags[uid]:
                            self._memo_hits += 1
                            enc.append(hit)
                        else:
                            enc.append(self._encode_action_cached(a))
                    fps = [e.fp for e in enc]
                    lfp = wire.list_fingerprint(fps)
                    part_rtypes = frozenset(
                        r for a in waiting for r in a.cost if r in orch.managers
                    )
                    self._queue_cache[part] = (
                        queue.version, members, enc, fps, lfp, part_rtypes, tags,
                    )
                by_uid.update(members)
                seen_uids.update(members)
                rtypes |= part_rtypes
                if part in orch.managers:
                    rtypes.add(part)
                parts_enc.append((part, enc, fps, lfp))
            if parts_enc:
                shard_parts.append((shard_idx, parts_enc, rtypes))
                union_rtypes |= rtypes
        # shard-independent payloads (policy config, fairness, history,
        # manager snapshots + their structural deltas) are encoded +
        # fingerprinted ONCE per round and shared across every worker's
        # request — only the per-worker ref/delta/full decision differs
        shared = self._encode_shared(union_rtypes)
        return {
            "plans": plans,
            "by_uid": by_uid,
            "shard_parts": shard_parts,
            "executing_enc": executing_enc,
            "exec_rsets": exec_rsets,
            "seen_uids": seen_uids,
            "shared": shared,
            "encode_s": time.perf_counter() - t_enc,
        }

    @staticmethod
    def _exec_subset(ctx: Dict[str, Any], rtypes: set) -> Tuple[list, List[str], str]:
        """One worker's executing-set view: only the in-flight actions
        whose cost touches the shard's resource types — planning
        consults the in-flight set strictly through per-rtype filters,
        so the subset plans identically while the fan-out (and the
        define traffic behind it) shrinks by the shard count."""
        sub_enc = [
            e
            for rs, e in zip(ctx["exec_rsets"], ctx["executing_enc"])
            if not rtypes.isdisjoint(rs)
        ]
        sub_fps = [e.fp for e in sub_enc]
        return (sub_enc, sub_fps, wire.list_fingerprint(sub_fps))

    def _prune_caches(self, seen_uids: set) -> float:
        """Drop encode-cache entries for actions that left the system —
        everything alive was just seen, so this is exact (runs while the
        workers compute, off any per-request path).  Returns the wall
        spent, billed to the round's encode phase."""
        t0 = time.perf_counter()
        rsets = self._act_rsets
        if len(self._act_cache) > len(seen_uids):
            for uid in [u for u in self._act_cache if u not in seen_uids]:
                del self._act_cache[uid]
        if len(rsets) > len(seen_uids):
            for uid in [u for u in rsets if u not in seen_uids]:
                del rsets[uid]
        return time.perf_counter() - t0

    # ------------------------------------------------------------------
    def _recover(
        self,
        shard_idx: int,
        error: Dict[str, Any],
        parts_enc: Any,
        rtypes: set,
        exec_sub: Any,
        shared: Dict[str, Any],
    ) -> Tuple[Any, int]:
        """One full-content retry for a recoverable typed error (the
        worker lost cached state: eviction, restart, stale base).  The
        retry's encode/transport cost lands in the decode phase's wall
        — recovery is rare and charged where it happens, not smeared.
        A second failure is a real protocol error and raises."""
        if error.get("code") not in RECOVERABLE_CODES:
            raise RuntimeError(
                f"remote shard worker {shard_idx} failed: {error.get('error')}"
            )
        self.orch.telemetry.wire_fallbacks += 1
        self._reset_worker(shard_idx)
        req = self._request(
            shard_idx, parts_enc, rtypes, exec_sub, shared,
            reset_interns=True,
        )
        blob = wire.encode_frame(req, self.codec)
        t = self._transport(shard_idx)
        t.submit(blob)
        resp = t.recv()
        payload = wire.decode_frame(resp)
        if isinstance(payload, dict) and payload.get("kind") == "error":
            raise RuntimeError(
                f"remote shard worker {shard_idx} failed after full re-send: "
                f"{payload.get('error')}"
            )
        return payload, len(blob) + len(resp)

    # ------------------------------------------------------------------
    def _encode_shared(self, rtypes: set) -> Dict[str, Any]:
        """Encode + fingerprint the shard-independent request inputs
        once per round: the policy / fairness / history configs and one
        snapshot per needed resource type, plus — when the previous
        round's snapshot is known — the structural delta against it.
        ``_request`` then makes the per-worker ref-vs-delta-vs-full call
        against each worker's sent-state."""
        orch = self.orch
        policy_payload = wire.encode_policy(orch.policy)
        fs_payload = wire.encode_fair_share(orch.fair_share)
        hist = getattr(orch.policy, "history", None)
        hist_payload = None if hist is None else {"avg": dict(hist._avg)}
        snaps: Dict[str, Tuple[Dict[str, Any], str, Optional[str], Optional[Dict[str, Any]]]] = {}
        for rtype in sorted(rtypes):
            snap = wire.encode_snapshot(orch.managers[rtype])
            prev = self._prev_snaps.get(rtype)
            prev_fp: Optional[str] = None
            delta: Optional[Dict[str, Any]] = None
            if prev is not None and prev[1] == snap:
                # unchanged since last round: reuse the cached digest
                # instead of re-hashing the whole snapshot (the common
                # case for idle managers dominates fingerprint cost)
                snaps[rtype] = (snap, prev[0], prev[0], None)
                continue
            fp = wire.fingerprint(snap)
            if prev is not None:
                prev_fp = prev[0]
                if prev_fp != fp:
                    delta = wire.encode_snapshot_delta(
                        orch.managers[rtype],
                        prev[1]["state"],
                        snap["state"],
                        prev_fp,
                        fp,
                    )
            self._prev_snaps[rtype] = (fp, snap)
            snaps[rtype] = (snap, fp, prev_fp, delta)
        return {
            "policy": self._shared_fp("policy", policy_payload),
            "fair_share": self._shared_fp("fair_share", fs_payload),
            "history": (
                None
                if hist_payload is None
                else self._shared_fp("history", hist_payload)
            ),
            "snaps": snaps,
        }

    def _shared_fp(self, slot: str, payload: Any) -> Tuple[Any, str]:
        """(payload, fingerprint) with the digest memoized by payload
        equality — policy/fairness/history configs rarely change, so
        re-hashing them every round is pure waste."""
        cached = self._shared_cache.get(slot)
        if cached is not None and cached[0] == payload:
            return cached
        entry = (payload, wire.fingerprint(payload))
        self._shared_cache[slot] = entry
        return entry

    def _request(
        self,
        shard_idx: int,
        parts_enc: List[Tuple[str, List[Tuple[str, Dict[str, Any], int]]]],
        rtypes: set,
        exec_sub: Tuple[List[Tuple[str, Dict[str, Any], int]], List[str], str],
        shared: Dict[str, Any],
        reset_interns: bool = False,
    ) -> Dict[str, Any]:
        """One worker's plan request: unchanged policy/fairness/history
        payloads travel as fingerprint references, snapshots as
        ref/structural-delta/full (cheapest form the worker can
        reconstruct from), and every action as an intern define or
        reference against this worker's mirrored table."""
        orch = self.orch
        sent = self._sent[shard_idx]
        mirror = self._mirrors[shard_idx]

        # full payloads travel as memoized byte segments keyed on the
        # fingerprint delta-suppression already computed — the same
        # content sent to N workers (or re-sent after a fallback) is
        # serialized once and spliced N times.  refs and deltas stay
        # plain: they are tiny and never repeat.
        policy_payload, policy_fp = shared["policy"]
        policy = (
            None
            if sent.get("policy") == policy_fp
            else self._segment("p:" + policy_fp, policy_payload)
        )
        sent["policy"] = policy_fp

        fs_payload, fs_fp = shared["fair_share"]
        fair_share: Any = (
            {"ref": fs_fp}
            if sent.get("fair_share") == fs_fp
            else self._segment("f:" + fs_fp, fs_payload)
        )
        sent["fair_share"] = fs_fp

        history: Any = None
        if shared["history"] is not None:
            hist_payload, hist_fp = shared["history"]
            history = (
                {"ref": hist_fp}
                if sent.get("history") == hist_fp
                else self._segment("h:" + hist_fp, hist_payload)
            )
            sent["history"] = hist_fp

        snapshots: Dict[str, Any] = {}
        for rtype in sorted(rtypes):
            snap, fp, prev_fp, delta = shared["snaps"][rtype]
            sent_fp = sent["snaps"].get(rtype)
            if sent_fp == fp:
                snapshots[rtype] = {"ref": fp}
            elif delta is not None and sent_fp == prev_fp:
                snapshots[rtype] = delta
            else:
                snapshots[rtype] = self._segment("s:" + fp, snap)
            sent["snaps"][rtype] = fp

        # action lists travel as cross-round list deltas (ref / delta /
        # full — see _wire_list).  Intern decisions inside them follow
        # the worker's resolution order (executing first, then
        # partitions in request order) so the mirror's LRU touches line
        # up exactly.
        executing_enc, exec_fps, exec_fp = exec_sub
        executing_wire = self._wire_list(
            mirror, sent.get("exec"), executing_enc, exec_fps, exec_fp
        )
        sent["exec"] = (exec_fp, exec_fps)

        parts = []
        sent_parts: Dict[str, Tuple[str, List[str]]] = sent.setdefault("parts", {})
        for part, enc, fps, lfp in parts_enc:
            node = self._wire_list(mirror, sent_parts.get(part), enc, fps, lfp)
            sent_parts[part] = (lfp, fps)
            parts.append({"part": part, "waiting": node})

        body: Dict[str, Any] = {
            "shard": shard_idx,
            "now": orch.now,
            "incremental": orch.incremental,
            "policy": policy,
            "fair_share": fair_share,
            "history": history,
            "snapshots": snapshots,
            "executing": executing_wire,
            "partitions": parts,
        }
        if reset_interns:
            body["reset_interns"] = True
        return wire.envelope("plan_request", body)


# ---------------------------------------------------------------------------
# the worker-owned commit engine (coordinator side)
# ---------------------------------------------------------------------------

# module-level on purpose: remote -> orchestrator -> shards completes
# without a cycle (neither orchestrator nor shards imports this module
# at module level; the orchestrator constructs the engine lazily)
from repro_torch.core.orchestrator import SCHED_TICK_S, CommitEngine  # noqa: E402


class WorkerCommitEngine(CommitEngine):
    """Two-phase worker-owned commit: each remote worker holds the
    *authoritative* manager replicas for the resource types it owns
    under epoch-stamped ownership leases, and a whole fixpoint pass —
    plan AND commit, up to ``commit_max_passes`` dependent passes — runs
    in one fused ``plan_commit`` exchange per owner worker.

    The exchange is prepare → intent/ack → commit|abort:

    * **prepare** — the ordinary plan request, promoted to a
      ``plan_commit`` frame carrying the round's ownership leases, the
      pass budget, and the previous round's confirm.  The worker
      validates every lease epoch *before* touching a replica (a
      restarted worker's amnesia surfaces as a typed ``stale_epoch``,
      never a double-launch), stashes the pre-round replica states, and
      commits its passes locally on the shared commit core.
    * **ack** — the response: per-pass plans + committed outcomes + the
      post-commit replica fingerprints.  The coordinator *replays* the
      plans through the unchanged client-serial walk
      (``Orchestrator._commit_partition``) in global sorted partition
      order — the launch trace is identical to client-serial **by
      construction**, because it is produced by the same code over the
      same plans — then verifies its post-commit state against the
      worker's fingerprints and cross-checks launched uids against the
      reported outcomes.
    * **commit|abort** — a verified round's confirm rides the next
      fused frame (or an explicit ``commit_decide``); any divergence,
      fence, or un-adopted trailing pass aborts the worker's stash back
      to its pre-round state — the coordinator's replay remains the
      authority, so a worker abort costs wire state, never trace
      damage.

    Rounds the engine cannot own outright decline to the client-serial
    walk (counted in ``commit_inline_rounds``): a partition whose commit
    footprint spans owners, a worker in its loss backoff window, or
    real-latency charging (worker plan walls are not the client's).
    Worker loss mid-prepare rides the ordinary loss rail plus lease
    *adoption*: the coordinator bumps the orphaned epochs and commits
    the partitions inline from fallback plans — zero lost launches, and
    a zombie's late ack can never land."""

    mode = "worker"

    def __init__(self, orch: "Orchestrator", client: RemoteRoundClient) -> None:
        super().__init__(orch)
        self.client = client
        # rtype -> current ownership epoch; bumped on every revocation,
        # regrant, or adoption, so exactly one holder is ever current
        self._epochs: Dict[str, int] = {}
        # shard -> {rtype: epoch} that worker currently holds
        self._granted: Dict[int, Dict[str, int]] = {}
        # shards with a verified-but-unconfirmed prepared round; the
        # confirm rides the next fused frame or a commit_decide flush
        self._pending_confirm: set = set()
        # shard -> leased rtypes of the round currently in flight (the
        # open prepare window a reentrant fence targets)
        self._inflight: Dict[int, frozenset] = {}
        self._fence_aborts: set = set()
        self._deferred_revokes: set = set()
        self._round_open = False
        # part -> (queue.version, footprint rtypes, any duration sampler)
        self._foot_cache: Dict[str, Tuple[int, frozenset, bool]] = {}
        # static ownership map: managed rtypes striped over shards in
        # sorted order — deterministic and derivable by every participant
        self._owner_idx: Dict[str, int] = {
            rt: i for i, rt in enumerate(sorted(orch.managers))
        }

    # -- eligibility ----------------------------------------------------
    def _footprint(self, part: str) -> Tuple[frozenset, bool]:
        """The rtypes committing ``part`` can touch — every queued
        action's managed cost rtypes plus the partition's own manager —
        and whether any queued action carries a host-local duration
        sampler.  Version-gated on the partition queue, so idle
        partitions cost O(1) per round."""
        orch = self.orch
        queue = orch._queues.get(part)
        if not queue:
            return frozenset(), False
        hit = self._foot_cache.get(part)
        if hit is not None and hit[0] == queue.version:
            return hit[1], hit[2]
        managed = orch.managers
        foot = set()
        sampler = False
        for a in queue.ordered():
            if a.duration_sampler is not None:
                sampler = True
            for r in a.cost:
                if r in managed:
                    foot.add(r)
        if part in managed:
            foot.add(part)
        entry = (queue.version, frozenset(foot), sampler)
        self._foot_cache[part] = entry
        return entry[1], entry[2]

    def _decline(self) -> None:
        """Fall back to the ordinary plan_round + client-serial commit
        for this round.  The stash protocol is settled first: a plain
        plan_request never consumes a confirm, and the NEXT fused
        frame's implicit abort must never restore a round the
        coordinator already adopted."""
        self._flush_confirms()
        self.orch.telemetry.commit_inline_rounds += 1
        return None

    def fused_round(self, keys: Sequence[str]) -> Optional[bool]:
        orch = self.orch
        client = self.client
        n = int(orch.shards or 1)
        if orch.charge_real_sched_latency:
            # per-partition plan walls measured on the worker are not
            # the client-serial walls this mode charges — decline
            return self._decline()
        # group each dirty partition under the single worker owning its
        # whole commit footprint; a cross-owner footprint makes the
        # round ineligible (the client-serial walk is the correct rail)
        groups: List[List[str]] = [[] for _ in range(n)]
        lease_rts: List[set] = [set() for _ in range(n)]
        sampler = False
        owner_idx = self._owner_idx
        for part in keys:
            foot, has_sampler = self._footprint(part)
            sampler = sampler or has_sampler
            owners = {owner_idx[rt] % n for rt in foot}
            if len(owners) > 1:
                return self._decline()
            owner = owners.pop() if owners else 0
            groups[owner].append(part)
            lease_rts[owner] |= foot
        # a worker inside its loss-backoff window cannot hold
        # authoritative state this round; the serial walk adopts
        for shard in range(n):
            if groups[shard]:
                state = client._down.get(shard)
                if state is not None and state[1] > 0:
                    return self._decline()
        passes_cap = max(1, int(orch.commit_max_passes))
        if sampler or orch.history is not getattr(orch.policy, "history", None):
            # host-local samplers never cross the wire, and a detached
            # history table would price pass>=2 plans off a different
            # estimate — one pass per wire round is still exact (commit
            # itself never consults durations)
            passes_cap = 1
        self._round_open = True
        try:
            return self._fused(groups, lease_rts, passes_cap)
        finally:
            self._round_open = False
            self._inflight.clear()
            self._fence_aborts.clear()
            if self._deferred_revokes:
                rts, self._deferred_revokes = self._deferred_revokes, set()
                self.fence(sorted(rts))

    # -- the fused round ------------------------------------------------
    def _arm(
        self, req: Dict[str, Any], shard: int, rts: set, passes_cap: int
    ) -> None:
        """Promote one worker's encoded plan request into the fused
        ``plan_commit`` frame: ownership leases for the rtypes this
        round touches (fresh grants where the worker does not hold the
        current epoch), the fixpoint pass budget, the virtual scheduling
        tick launch overhead charges, and the previous prepared round's
        confirm when one is pending."""
        telemetry = self.orch.telemetry
        granted = self._granted.setdefault(shard, {})
        leases = []
        for rt in sorted(rts):
            epoch = self._epochs.setdefault(rt, 0)
            if granted.get(rt) == epoch:
                leases.append(wire.encode_lease(rt, epoch))
            else:
                granted[rt] = epoch
                telemetry.wire_lease_grants += 1
                leases.append(wire.encode_lease(rt, epoch, fresh=True))
        req["kind"] = "plan_commit"
        commit: Dict[str, Any] = {
            "leases": leases,
            "max_passes": passes_cap,
            "tick": SCHED_TICK_S,
        }
        if shard in self._pending_confirm:
            commit["confirm"] = True
            self._pending_confirm.discard(shard)
        req["commit"] = commit

    def _lose(self, shard: int) -> None:
        """Transport loss on a preparing/prepared worker: the ordinary
        loss rail plus ownership *adoption* — every lease the worker
        held is revoked by epoch bump (a zombie's late ack can never
        land) and the round's partitions fall back to inline plans
        committed by the coordinator: orphaned intents are adopted,
        never lost."""
        self.client._note_worker_loss(shard)
        self._pending_confirm.discard(shard)
        self._inflight.pop(shard, None)
        granted = self._granted.pop(shard, None)
        if granted:
            for rt in granted:
                self._epochs[rt] = self._epochs.get(rt, 0) + 1
            self.orch.telemetry.wire_lease_adoptions += len(granted)

    def _abort_worker(self, shard: int) -> None:
        """Explicitly abort a worker's unconfirmed prepared round
        (restores its pre-round replicas) and revoke every lease it
        holds.  Loss during the abort just rides the adoption rail."""
        client = self.client
        self.orch.telemetry.wire_commit_aborts += 1
        granted = self._granted.pop(shard, {})
        for rt in granted:
            self._epochs[rt] = self._epochs.get(rt, 0) + 1
        self._pending_confirm.discard(shard)
        body = {"commit": False, "revoke": sorted(granted)}
        try:
            t = client._transport(shard)
            t.submit(
                wire.encode_frame(wire.envelope("commit_decide", body), client.codec)
            )
            wire.expect(wire.decode_frame(t.recv()), "commit_decide_response")
        except (wire.TransportError, wire.WireError):
            client._note_worker_loss(shard)

    def _recover_fused(
        self,
        shard: int,
        error: Dict[str, Any],
        parts_enc: Any,
        rtypes: set,
        exec_sub: Any,
        shared: Dict[str, Any],
        rts: set,
        passes_cap: int,
    ) -> Tuple[Any, int]:
        """One full-content retry of a fused frame after a recoverable
        typed error.  ``stale_epoch`` is the ownership rail's answer to
        amnesia (restarted worker, fenced handoff): the coordinator
        re-grants every lease fresh at the current epoch alongside the
        full state re-send — the worker never plans or commits on stale
        ownership.  A second failure is a real protocol error."""
        code = error.get("code")
        if code not in RECOVERABLE_CODES:
            raise RuntimeError(
                f"remote shard worker {shard} failed: {error.get('error')}"
            )
        telemetry = self.orch.telemetry
        client = self.client
        if code == "stale_epoch":
            telemetry.wire_lease_regrants += len(error.get("rtypes") or ()) or 1
        else:
            telemetry.wire_fallbacks += 1
        client._reset_worker(shard)
        self._granted.pop(shard, None)  # everything re-grants fresh
        req = client._request(
            shard, parts_enc, rtypes, exec_sub, shared, reset_interns=True
        )
        self._arm(req, shard, rts, passes_cap)
        blob = wire.encode_frame(req, client.codec)
        t = client._transport(shard)
        t.submit(blob)
        resp = t.recv()
        payload = wire.decode_frame(resp)
        if isinstance(payload, dict) and payload.get("kind") == "error":
            raise RuntimeError(
                f"remote shard worker {shard} failed after full re-send: "
                f"{payload.get('error')}"
            )
        return payload, len(blob) + len(resp)

    def _fused(
        self,
        groups: List[List[str]],
        lease_rts: List[set],
        passes_cap: int,
    ) -> bool:
        orch = self.orch
        client = self.client
        telemetry = orch.telemetry
        client._ensure_slots(len(groups))
        for shard in range(len(groups)):
            if groups[shard]:
                client._transport(shard)  # startup outside the accounting
        t_round = time.perf_counter()

        # ---- encode + pipelined dispatch (same rails as plan_round) ---
        ctx = client._encode_round(groups)
        shared = ctx["shared"]
        by_uid = ctx["by_uid"]
        encode_s = ctx["encode_s"]
        nbytes = 0
        requests: List[Tuple[int, Any, Any, set]] = []
        lost: List[Tuple[int, Any]] = []
        transport_s = 0.0
        e_head = 0.0
        for shard, parts_enc, rtypes in ctx["shard_parts"]:
            t0 = time.perf_counter()
            exec_sub = client._exec_subset(ctx, rtypes)
            req = client._request(
                shard, parts_enc, rtypes, exec_sub, shared,
                reset_interns=shard in client._need_intern_reset,
            )
            self._arm(req, shard, lease_rts[shard], passes_cap)
            blob = wire.encode_frame(req, client.codec)
            t1 = time.perf_counter()
            encode_s += t1 - t0
            if not requests:
                e_head = t1 - t0
            nbytes += len(blob)
            try:
                client._transport(shard).submit(blob)
            except wire.TransportError:
                transport_s += time.perf_counter() - t1
                self._lose(shard)
                lost.append((shard, parts_enc))
                continue
            transport_s += time.perf_counter() - t1
            self._inflight[shard] = frozenset(lease_rts[shard])
            requests.append((shard, parts_enc, exec_sub, rtypes))
        encode_s += client._prune_caches(ctx["seen_uids"])

        # ---- gather (in submit order) ---------------------------------
        responses = []
        for shard, parts_enc, exec_sub, rtypes in requests:
            t0 = time.perf_counter()
            try:
                blob = client._transport(shard).recv()
            except wire.TransportError:
                transport_s += time.perf_counter() - t0
                self._lose(shard)
                lost.append((shard, parts_enc))
                continue
            transport_s += time.perf_counter() - t0
            responses.append((shard, parts_enc, exec_sub, rtypes, blob))

        # ---- decode ---------------------------------------------------
        t_dec = time.perf_counter()
        acks: List[Tuple[int, List[List[PartitionPlan]], Dict[str, Any]]] = []
        decode_s = 0.0
        worker_codec_s = 0.0
        max_codec = 0.0
        max_plan = 0.0
        max_commit = 0.0
        for shard, parts_enc, exec_sub, rtypes, blob in responses:
            nbytes += len(blob)
            payload = wire.decode_frame(blob)
            if isinstance(payload, dict) and payload.get("kind") == "error":
                try:
                    payload, extra = self._recover_fused(
                        shard, payload, parts_enc, rtypes, exec_sub, shared,
                        lease_rts[shard], passes_cap,
                    )
                except wire.TransportError:
                    self._lose(shard)
                    lost.append((shard, parts_enc))
                    continue
                nbytes += extra
            resp = wire.expect(payload, "plan_commit_response")
            codec_s = float(resp.get("codec_s", 0.0))
            worker_codec_s += codec_s
            max_codec = max(max_codec, codec_s)
            plan_s = float(resp.get("plan_s", 0.0))
            max_plan = max(max_plan, plan_s)
            max_commit = max(max_commit, float(resp.get("commit_s", 0.0)))
            cache = resp.get("cache")
            if cache:
                telemetry.note_worker_cache(cache)
            passes = [
                [wire.decode_plan(p, by_uid) for p in pas.get("plans", [])]
                for pas in resp.get("passes", [])
            ]
            telemetry.note_shard_round(
                shard, len(passes[0]) if passes else 0, plan_s
            )
            client._note_worker_ok(shard)
            acks.append((shard, passes, resp))
        decode_s += time.perf_counter() - t_dec
        telemetry.plan_wall_s += time.perf_counter() - t_round

        # ---- loss/fence fallback plans --------------------------------
        # a lost worker's partitions are planned inline and committed by
        # the coordinator below — identical plans from the same core, so
        # adoption of orphaned intents cannot bend the trace.  A FENCED
        # shard's partitions are NOT adopted at all (a handoff moved
        # state under them); they re-dirty and replan next round.
        fallback_plans: List[PartitionPlan] = []
        fallback_parts: set = set()
        for shard, parts_enc in lost:
            if shard in self._fence_aborts:
                orch._dirty.update(e[0] for e in parts_enc)
                continue
            shard_plans, plan_s = client._plan_inline(shard, parts_enc)
            max_plan = max(max_plan, plan_s)
            fallback_plans.extend(shard_plans)
            fallback_parts.update(p.part for p in shard_plans)

        # ---- adopt: replay the committed passes through the unchanged
        # client-serial walk, pass by pass in global sorted partition
        # order — the same plans through the same commit core in the
        # same order IS the client-serial trace ------------------------
        t_apply = time.perf_counter()
        conflicts = 0
        adopted = 0
        diverged = False
        while True:
            k = adopted
            pass_plans: List[PartitionPlan] = []
            expected_uids: set = set()
            for shard, passes, resp in acks:
                if shard in self._fence_aborts or k >= len(passes):
                    continue
                pass_plans.extend(passes[k])
                for out in resp["passes"][k].get("outcomes", []):
                    _, rows, _, _ = wire.decode_commit_outcome(out)
                    expected_uids.update(uid for uid, _ in rows)
            if k == 0:
                pass_plans.extend(ctx["plans"])
                pass_plans.extend(fallback_plans)
            if not pass_plans:
                break
            if k > 0:
                # a dependent pass is adopted only when the re-dirtied
                # set the workers planned against matches live state
                # exactly; any residue (fallbacks, divergence) stops
                # adoption — the leftover dirty set replans next round
                expected = sorted({p.part for p in pass_plans})
                dirty_now = sorted(
                    x for x in orch._dirty if orch._queues.get(x)
                )
                if expected != dirty_now:
                    break
                orch._dirty.clear()
            pass_plans.sort(key=lambda p: p.part)
            before = set(orch._executing)
            for plan in pass_plans:
                conflicts += orch._commit_partition(plan)
            adopted += 1
            launched = set(orch._executing) - before
            missing = expected_uids - launched
            extra = {
                uid
                for uid in launched - expected_uids
                if orch._partition_of(orch._executing[uid])
                not in fallback_parts
            }
            if missing or extra:
                # a worker's committed outcome does not match the
                # authoritative replay (e.g. an action withdrawn between
                # prepare and adopt): stop adopting — the replay stands,
                # the diverged stashes abort below
                telemetry.wire_commit_diverged += 1
                diverged = True
                break

        # ---- verify + settle ------------------------------------------
        for shard, passes, resp in acks:
            if shard in self._fence_aborts:
                self._abort_worker(shard)
                orch._dirty.update(groups[shard])
                continue
            if diverged or len(passes) > adopted:
                # un-adopted trailing passes (or a diverged outcome):
                # the worker's replicas ran ahead of the adopted state —
                # restore them to pre-round; the snapshot rail re-syncs
                self._abort_worker(shard)
                continue
            fps = resp.get("fps") or {}
            post: Dict[str, Tuple[str, Dict[str, Any]]] = {}
            match = True
            for rt, want in fps.items():
                snap = wire.encode_snapshot(orch.managers[rt])
                afp = wire.fingerprint(snap)
                post[rt] = (afp, snap)
                if afp != want:
                    match = False
            if not match:
                telemetry.wire_commit_diverged += 1
                self._abort_worker(shard)
                continue
            # verified: the worker's post-commit replicas ARE next
            # round's state — pre-warm the delta bases so the committed
            # state is never re-shipped (the wire leaves the commit
            # path), and hold the confirm for the next fused frame
            sent = client._sent[shard]["snaps"]
            for rt, (afp, snap) in post.items():
                client._prev_snaps[rt] = (afp, snap)
                sent[rt] = afp
            self._pending_confirm.add(shard)
        self._inflight.clear()
        apply_s = time.perf_counter() - t_apply

        # ---- accounting (mirrors plan_round's wire rails) -------------
        overlap_s = e_head + max_codec + decode_s
        new_round = client._last_now is None or orch.now != client._last_now
        client._last_now = orch.now
        telemetry.note_wire_round(
            encode_s,
            transport_s,
            decode_s,
            nbytes,
            worker_codec_s,
            overlap_s=overlap_s,
            frames=len(requests),
            new_round=new_round,
        )
        telemetry.note_wire_memo(client._memo_hits, client._memo_misses)
        client._memo_hits = 0
        client._memo_misses = 0
        telemetry.plan_critical_s += max_plan
        telemetry.note_commit_round(
            max_commit, apply_s, prepares=len(requests), acks=len(acks)
        )
        # the modeled decision latency of a fused round: the slowest
        # worker's plan + commit — the client's replay/verify is mirror
        # maintenance off the decision path (commit_apply_s), which is
        # exactly the resource-efficiency claim this engine exists for
        telemetry.sched_wall_s += max_plan + max_commit
        if conflicts:
            telemetry.commit_conflicts += conflicts
        return conflicts > 0

    # -- protocol settlement --------------------------------------------
    def _flush_confirms(self) -> None:
        """Finalize every verified-but-unconfirmed prepared round with
        an explicit ``commit_decide``: plain plan_request frames never
        settle a stash, and the next fused frame's implicit abort must
        never restore a round the coordinator already adopted."""
        client = self.client
        for shard in sorted(self._pending_confirm):
            try:
                t = client._transport(shard)
                t.submit(
                    wire.encode_frame(
                        wire.envelope("commit_decide", {"commit": True}),
                        client.codec,
                    )
                )
                wire.expect(wire.decode_frame(t.recv()), "commit_decide_response")
            except (wire.TransportError, wire.WireError):
                self._pending_confirm.discard(shard)
                self._lose(shard)
        self._pending_confirm.clear()

    def fence(self, rtypes: Optional[Sequence[str]] = None) -> int:
        """Fence ownership covering ``rtypes`` (None = all) before a
        handoff (``migrate_task``/``rebalance``): any open prepare
        window touching them is deterministically aborted — its ack is
        never adopted and the worker restores its pre-round replicas —
        pending verified rounds are finalized (the coordinator already
        applied them), and the covered leases are revoked by epoch bump
        so a stale holder can never ack again.  Returns the number of
        fenced in-flight intents."""
        rset = None if rtypes is None else set(rtypes)
        fenced = 0
        for shard, leased in self._inflight.items():
            if shard in self._fence_aborts:
                continue
            if rset is None or not rset.isdisjoint(leased):
                self._fence_aborts.add(shard)
                fenced += 1
        self.orch.telemetry.wire_fenced_intents += fenced
        if self._round_open:
            # reentrant call (a handoff fired from inside the round's
            # own gather): no wire traffic here — interleaved frames
            # would desynchronize the FIFO transports.  The round's
            # finale aborts the fenced shards; the revokes run after.
            if rset is not None:
                self._deferred_revokes |= rset
            else:
                for granted in self._granted.values():
                    self._deferred_revokes |= set(granted)
            return fenced
        client = self.client
        for shard in sorted(self._granted):
            granted = self._granted[shard]
            revoke = sorted(rt for rt in granted if rset is None or rt in rset)
            pending = shard in self._pending_confirm
            if not revoke and not pending:
                continue
            for rt in revoke:
                del granted[rt]
                self._epochs[rt] = self._epochs.get(rt, 0) + 1
            self._pending_confirm.discard(shard)
            body: Dict[str, Any] = {"commit": bool(pending), "revoke": revoke}
            try:
                t = client._transport(shard)
                t.submit(
                    wire.encode_frame(
                        wire.envelope("commit_decide", body), client.codec
                    )
                )
                wire.expect(wire.decode_frame(t.recv()), "commit_decide_response")
            except (wire.TransportError, wire.WireError):
                client._note_worker_loss(shard)
        return fenced

    def close(self) -> None:
        """Settle the protocol (confirm flushes) and drop all ownership
        state; idempotent."""
        self._flush_confirms()
        self._granted.clear()
        self._inflight.clear()
        self._epochs.clear()
        self._foot_cache.clear()

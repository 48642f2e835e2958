"""The port's copy of the control plane (``repro_torch.core``) under the
reference suite ``tests/test_wire_bill.py``, imports rewritten, each case kept.

The reference suite's own description follows.

The wire bill: canonical fingerprints, binary framing, byte-budget
LRU caches, cross-round list deltas, and typed-error recovery.

These are the rails for the delta/interning protocol: equal payloads
must always collide (fingerprints are delta suppression), both codecs
must decode to identical payloads (json is the property-test
reference), caches must stay bounded, and every stale-state path must
end in a full re-send — never a silently wrong plan."""

import math
import random

import pytest

from repro_torch.core import wire
from repro_torch.core.action import (
    Action,
    AmdahlElasticity,
    ResourceRequest,
    fixed,
    ranged,
)
from repro_torch.core.cluster import GpuNodeSpec
from repro_torch.core.fairqueue import PartitionQueue
from repro_torch.core.managers.base import ResourceManager
from repro_torch.core.managers.gpu import GpuManager, ServiceSpec
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.remote import (
    LoopbackTransport,
    RemoteShardWorker,
)
from repro_torch.core.simulator import EventLoop


# ---------------------------------------------------------------------------
# canonical fingerprints (satellite b: equal payloads always collide)
# ---------------------------------------------------------------------------


class TestCanonicalFingerprint:
    def test_key_order_invariant(self):
        a = {"x": 1, "y": [1, 2, {"p": 3.5, "q": None}]}
        b = {"y": [1, 2, {"q": None, "p": 3.5}], "x": 1}
        assert wire.fingerprint(a) == wire.fingerprint(b)

    def test_negative_zero_collides_with_zero(self):
        """A JSON round trip may turn -0.0 into 0 — the two sides must
        still agree the payload is unchanged (regression: ref misses on
        every idle round when a manager clock serializes as -0.0)."""
        assert wire.fingerprint({"t": -0.0}) == wire.fingerprint({"t": 0})

    def test_integral_float_collides_with_int(self):
        """json.loads(dumps(2.0)) == 2.0 but a recompute may produce the
        int 2; both canonical forms must hash identically."""
        assert wire.fingerprint([2.0, 10.0]) == wire.fingerprint([2, 10])
        # ...but only within the exact-integer range
        assert wire.fingerprint(2.5) != wire.fingerprint(2)

    def test_nan_and_infinities(self):
        assert wire.fingerprint(float("nan")) == wire.fingerprint(float("nan"))
        assert wire.fingerprint(float("inf")) != wire.fingerprint(float("-inf"))
        assert wire.fingerprint(float("inf")) != wire.fingerprint(float("nan"))

    def test_bool_is_not_int(self):
        assert wire.fingerprint(True) != wire.fingerprint(1)
        assert wire.fingerprint(False) != wire.fingerprint(0)

    def test_string_length_prefix_prevents_aliasing(self):
        """Strings are length-prefixed in the canonical form, so a
        string containing canonical-form syntax cannot alias a
        structure (regression for the json.dumps-free fast path)."""
        assert wire.fingerprint(["ab"]) != wire.fingerprint(["a", "b"])
        assert wire.fingerprint({"a:b": 1}) != wire.fingerprint({"a": "b1"})
        assert wire.fingerprint('{"k":1}') != wire.fingerprint({"k": 1})

    def test_non_jsonable_rejected(self):
        with pytest.raises(wire.WireError, match="non-JSON-able"):
            wire.fingerprint({"f": object()})

    def test_list_fingerprint_is_order_sensitive(self):
        assert wire.list_fingerprint(["a", "b"]) != wire.list_fingerprint(["b", "a"])
        assert wire.list_fingerprint(["a", "b"]) == wire.list_fingerprint(["a", "b"])
        assert wire.list_fingerprint([]) != wire.list_fingerprint(["a"])


# ---------------------------------------------------------------------------
# byte-budget LRU (satellite a: worker caches cannot grow unbounded)
# ---------------------------------------------------------------------------


class TestLruBytes:
    def test_evicts_least_recently_touched_under_byte_budget(self):
        lru = wire.LruBytes(100)
        lru.put("a", 1, 40)
        lru.put("b", 2, 40)
        assert lru.get("a") == 1  # refresh a: b is now the oldest
        lru.put("c", 3, 40)  # 120 > 100: evict b, not a
        assert "b" not in lru and lru.get("b") is None
        assert lru.get("a") == 1 and lru.get("c") == 3
        assert lru.evictions == 1
        assert lru.nbytes == 80

    def test_replacement_adjusts_byte_total(self):
        lru = wire.LruBytes(100)
        lru.put("a", 1, 60)
        lru.put("a", 2, 10)
        assert lru.nbytes == 10 and lru.get("a") == 2 and len(lru) == 1

    def test_single_over_budget_entry_is_kept(self):
        """The table must stay usable even when one payload exceeds the
        whole budget — evicting it would livelock define/ref."""
        lru = wire.LruBytes(50)
        lru.put("big", "x", 500)
        assert lru.get("big") == "x" and lru.nbytes == 500
        lru.put("big2", "y", 600)  # now the older one can go
        assert "big" not in lru and lru.get("big2") == "y"

    def test_pop_and_clear(self):
        lru = wire.LruBytes(100)
        lru.put("a", 1, 30)
        lru.pop("a")
        assert lru.nbytes == 0 and "a" not in lru
        lru.pop("a")  # absent: no-op
        lru.put("b", 2, 30)
        lru.clear()
        assert lru.nbytes == 0 and len(lru) == 0

    def test_zero_budget_rejected(self):
        with pytest.raises(ValueError):
            wire.LruBytes(0)


# ---------------------------------------------------------------------------
# binary framing (tentpole layer 2: json is the decode-equivalence
# reference)
# ---------------------------------------------------------------------------


def _random_payload(rng, depth=0):
    """Random JSON-able payload (NaN excluded — equality-compared;
    NaN framing is asserted separately)."""
    kinds = "int float str bool none"
    if depth < 3:
        kinds += " list dict ints floats"
    kind = rng.choice(kinds.split())
    if kind == "int":
        return rng.randint(-(2**40), 2**40)
    if kind == "float":
        return rng.uniform(-1e6, 1e6)
    if kind == "str":
        return "".join(rng.choice("abcé☃:{}[]\"") for _ in range(rng.randint(0, 12)))
    if kind == "bool":
        return rng.random() < 0.5
    if kind == "none":
        return None
    if kind == "ints":  # packed-column shape: homogeneous int list
        return [rng.randint(0, 1000) for _ in range(rng.randint(1, 8))]
    if kind == "floats":
        return [rng.uniform(0, 1) for _ in range(rng.randint(1, 8))]
    if kind == "list":
        return [_random_payload(rng, depth + 1) for _ in range(rng.randint(0, 5))]
    return {
        f"k{i}": _random_payload(rng, depth + 1) for i in range(rng.randint(0, 5))
    }


class TestBinaryFrame:
    @pytest.mark.parametrize("seed", range(8))
    def test_binary_decodes_equal_to_json(self, seed):
        """8 seeds: the two codecs must decode to identical payloads —
        the JSON text path is the v1 reference the binary codec is held
        to."""
        rng = random.Random(seed)
        for _ in range(25):
            p = _random_payload(rng)
            via_json = wire.decode_frame(wire.encode_frame(p, "json"))
            via_bin = wire.decode_frame(wire.encode_frame(p, "binary"))
            assert via_bin == via_json == p

    def test_nan_and_infinities_survive_binary(self):
        blob = wire.encode_frame([float("nan"), float("inf"), float("-inf")], "binary")
        nan, pos, neg = wire.decode_frame(blob)
        assert math.isnan(nan) and pos == math.inf and neg == -math.inf

    def test_magic_byte_discriminates(self):
        p = {"v": 1, "kind": "x"}
        bj = wire.encode_frame(p, "json")
        bb = wire.encode_frame(p, "binary")
        assert wire.frame_codec(bj) == "json"
        assert wire.frame_codec(bb) == "binary"
        assert bb[0] == wire.WIRE_MAGIC and bj[0] != wire.WIRE_MAGIC

    def test_repeated_strings_intern_within_frame(self):
        """Frame-level string interning: a payload repeating one long
        key must cost far less than the JSON text repeating it."""
        key = "a-rather-long-repeated-field-name"
        p = [{key: i} for i in range(50)]
        bb = wire.encode_frame(p, "binary")
        bj = wire.encode_frame(p, "json")
        assert len(bb) < len(bj) / 2

    def test_malformed_binary_frames_rejected(self):
        with pytest.raises(wire.WireError, match="empty"):
            wire.decode_frame(b"")
        good = wire.encode_frame([1, 2], "binary")
        with pytest.raises(wire.WireError, match="trailing"):
            wire.decode_frame(good + b"\x00")
        with pytest.raises(wire.WireError, match="unknown value tag|truncated"):
            wire.decode_frame(bytes([wire.WIRE_MAGIC, 0xEE]))
        with pytest.raises(wire.WireError, match="unknown wire codec"):
            wire.encode_frame({}, "msgpack")

    def test_worker_answers_in_the_request_codec(self):
        """A binary request gets a binary response (and errors stay in
        kind too) — the client never has to guess."""
        worker = RemoteShardWorker()
        bad = wire.envelope("plan_request", {"snapshots": {}, "partitions": []})
        for codec in wire.WIRE_CODECS:
            resp = worker.handle_bytes(wire.encode_frame(bad, codec))
            assert wire.frame_codec(resp) == codec
            assert wire.decode_frame(resp)["kind"] == "error"


# ---------------------------------------------------------------------------
# structural snapshot deltas: edge cases (satellite d)
# ---------------------------------------------------------------------------


def _gpu_manager():
    return GpuManager([GpuNodeSpec("g0")], [ServiceSpec("rm0", 40.0)])


def _gpu_action(i, units=(1, 2)):
    return Action(
        name=f"rm:score{i}",
        cost={"gpu": ResourceRequest("gpu", units)},
        key_resource="gpu",
        base_duration=1.0,
        service="rm0",
        trajectory_id=f"g{i}",
    )


class TestSnapshotDeltaEdges:
    def test_empty_delta_is_a_noop(self):
        m = _gpu_manager()
        snap = wire.encode_snapshot(m)
        fp = wire.fingerprint(snap)
        delta = wire.encode_snapshot_delta(m, snap["state"], snap["state"], fp, fp)
        rebuilt = wire.apply_snapshot_delta(delta, snap)
        assert rebuilt == snap
        assert wire.fingerprint(rebuilt) == fp

    def test_chunk_churn_diffs_stay_small(self):
        """A round that (de)allocates a few chunks must travel as a
        delta much smaller than the full snapshot — the whole point of
        structural diffs on the bytes-dominant GPU free map."""
        m = GpuManager(
            [GpuNodeSpec(f"g{i}") for i in range(16)], [ServiceSpec("rm0", 40.0)]
        )
        snap1 = wire.encode_snapshot(m)
        fp1 = wire.fingerprint(snap1)
        a0, a1 = _gpu_action(0), _gpu_action(1)
        alloc0 = m.try_allocate(a0, 2)
        alloc1 = m.try_allocate(a1, 1)
        assert alloc0 is not None and alloc1 is not None
        m.release(a1, alloc1)
        snap2 = wire.encode_snapshot(m)
        fp2 = wire.fingerprint(snap2)
        assert fp2 != fp1
        delta = wire.encode_snapshot_delta(m, snap1["state"], snap2["state"], fp1, fp2)
        assert wire.apply_snapshot_delta(delta, snap1) == snap2
        delta_bytes = wire.payload_nbytes(delta)
        full_bytes = wire.payload_nbytes(snap2)
        assert delta_bytes < full_bytes / 3, (delta_bytes, full_bytes)

    def test_mismatched_base_raises_wire_error(self):
        """Applying a delta to the wrong base must fail the fingerprint
        verification loudly — apply never returns a state the sender
        did not hash."""
        m = _gpu_manager()
        snap1 = wire.encode_snapshot(m)
        fp1 = wire.fingerprint(snap1)
        a0 = _gpu_action(0)
        alloc = m.try_allocate(a0, 2)
        assert alloc is not None
        snap2 = wire.encode_snapshot(m)
        delta = wire.encode_snapshot_delta(
            m, snap1["state"], snap2["state"], fp1, wire.fingerprint(snap2)
        )
        m2 = _gpu_manager()
        assert m2.try_allocate(_gpu_action(9), 4) is not None
        other = wire.encode_snapshot(m2)
        with pytest.raises(wire.WireError):
            wire.apply_snapshot_delta(delta, other)

    def test_worker_recovers_from_bad_base_via_full_snapshot(self):
        """End to end through a worker: a delta naming a base the worker
        does not hold is a typed ``stale_base``; the follow-up full
        snapshot plans normally (the recovery round the client drives)."""
        from repro_torch.core.scheduler import ElasticScheduler

        m = ResourceManager("r", 8)
        snap = wire.encode_snapshot(m)

        def req(snapshots, policy):
            return wire.envelope(
                "plan_request",
                {
                    "shard": 0,
                    "now": 0.0,
                    "incremental": True,
                    "policy": wire.encode_policy(ElasticScheduler()) if policy else None,
                    "fair_share": None,
                    "history": None,
                    "snapshots": snapshots,
                    "executing": [],
                    "partitions": [{"part": "r", "waiting": []}],
                },
            )

        worker = RemoteShardWorker()
        bad_delta = wire.envelope(
            "snapshot_delta",
            {"rtype": "r", "impl": snap["impl"], "base": "no-such-base",
             "fp": "whatever", "delta": {}},
        )
        resp = wire.decode_frame(worker.handle_bytes(wire.encode_frame(
            req({"r": bad_delta}, policy=True), "json")))
        assert resp["kind"] == "error" and resp["code"] == "stale_base"
        resp = wire.decode_frame(worker.handle_bytes(wire.encode_frame(
            req({"r": snap}, policy=True), "json")))
        assert resp["kind"] == "plan_response"


# ---------------------------------------------------------------------------
# cross-round list deltas + interning at the worker protocol level
# ---------------------------------------------------------------------------


def _exec_action(i):
    return Action(
        name=f"run{i}",
        cost={"r": fixed("r", 1)},
        base_duration=1.0,
        trajectory_id=f"e{i}",
    )


class TestWorkerListProtocol:
    def _worker_and_req(self):
        from repro_torch.core.scheduler import ElasticScheduler

        m = ResourceManager("r", 8)
        snap = wire.encode_snapshot(m)
        fp = wire.fingerprint(snap)
        worker = RemoteShardWorker()

        def req(executing, first=False):
            return wire.envelope(
                "plan_request",
                {
                    "shard": 0,
                    "now": 0.0,
                    "incremental": True,
                    "policy": (
                        wire.encode_policy(ElasticScheduler()) if first else None
                    ),
                    "fair_share": None,
                    "history": None,
                    "snapshots": {"r": snap if first else {"ref": fp}},
                    "executing": executing,
                    "partitions": [{"part": "r", "waiting": []}],
                },
            )

        def ask(executing, first=False):
            return wire.decode_frame(
                worker.handle_bytes(wire.encode_frame(req(executing, first), "json"))
            )

        return worker, ask

    def _nodes(self, actions):
        enc = [wire.encode_action(a) for a in actions]
        fps = [wire.fingerprint(n) for n in enc]
        return enc, fps, wire.list_fingerprint(fps)

    def test_full_then_ref_then_delta(self):
        worker, ask = self._worker_and_req()
        a, b, c = (_exec_action(i) for i in range(3))
        enc, fps, lfp = self._nodes([a, b])
        assert ask({"k": "full", "fp": lfp, "items": enc}, first=True)[
            "kind"] == "plan_response"
        assert ask({"k": "ref", "fp": lfp})["kind"] == "plan_response"
        # delta: drop a, append c after the kept b
        enc_c = wire.encode_action(c)
        fp_c = wire.fingerprint(enc_c)
        new_lfp = wire.list_fingerprint([fps[1], fp_c])
        resp = ask({"k": "delta", "base": lfp, "fp": new_lfp,
                    "rm": [fps[0]], "ins": [[1, enc_c]]})
        assert resp["kind"] == "plan_response"
        # the delta committed: the new list is now ref-able
        assert ask({"k": "ref", "fp": new_lfp})["kind"] == "plan_response"

    def test_stale_ref_and_stale_base_are_typed(self):
        worker, ask = self._worker_and_req()
        enc, fps, lfp = self._nodes([_exec_action(0)])
        assert ask({"k": "full", "fp": lfp, "items": enc}, first=True)[
            "kind"] == "plan_response"
        resp = ask({"k": "ref", "fp": "not-the-list"})
        assert resp["kind"] == "error" and resp["code"] == "stale_ref"
        resp = ask({"k": "delta", "base": "not-the-list", "fp": lfp,
                    "rm": [], "ins": []})
        assert resp["kind"] == "error" and resp["code"] == "stale_base"

    def test_delta_mismatch_does_not_poison_the_cache(self):
        """A delta whose reconstruction misses the sender's fingerprint
        is a typed error, and the worker's cached base survives — the
        next valid ref still hits."""
        worker, ask = self._worker_and_req()
        enc, fps, lfp = self._nodes([_exec_action(0), _exec_action(1)])
        assert ask({"k": "full", "fp": lfp, "items": enc}, first=True)[
            "kind"] == "plan_response"
        resp = ask({"k": "delta", "base": lfp, "fp": "wrong-target",
                    "rm": [fps[0]], "ins": []})
        assert resp["kind"] == "error" and resp["code"] == "delta_mismatch"
        assert ask({"k": "ref", "fp": lfp})["kind"] == "plan_response"

    def test_missing_intern_fails_atomically_with_names(self):
        """An intern miss must fail the whole request BEFORE any list
        commit, naming every missing fingerprint — the client re-sends
        full content once, and the worker never plans a partial queue."""
        worker, ask = self._worker_and_req()
        a = _exec_action(0)
        enc_a = wire.encode_action(a)
        fp_a = wire.fingerprint(enc_a)
        lfp = wire.list_fingerprint([fp_a])
        resp = ask({"k": "full", "fp": lfp, "items": [{"iref": fp_a}]}, first=True)
        assert resp["kind"] == "error" and resp["code"] == "stale_intern"
        assert resp["missing"] == [fp_a]
        # the failed full did NOT commit the list cache
        resp = ask({"k": "ref", "fp": lfp})
        assert resp["kind"] == "error" and resp["code"] == "stale_ref"
        # define + use in one round works and commits
        resp = ask({"k": "full", "fp": lfp,
                    "items": [{"idef": fp_a, "val": enc_a, "n": 300}]})
        assert resp["kind"] == "plan_response"
        assert ask({"k": "full", "fp": lfp, "items": [{"iref": fp_a}]})[
            "kind"] == "plan_response"
        assert ask({"k": "ref", "fp": lfp})["kind"] == "plan_response"


# ---------------------------------------------------------------------------
# end-to-end recovery: restarted / evicting workers mid-run
# ---------------------------------------------------------------------------


def _make_system(shards, pools=3, cores=4, **kw):
    loop = EventLoop()
    managers = {
        f"pool{k}": ResourceManager(f"pool{k}", cores) for k in range(pools)
    }
    return Orchestrator(managers, loop=loop, shards=shards, **kw)


def _submit_workload(orch, seed, pools=3, waves=8, per_pool=6, period=2.0):
    """Wave-style churn: every wave submits to all pools at one
    timestamp, so rounds are genuinely multi-partition (= sharded, =
    over the wire) and the queues stay deep enough for cross-round
    refs/deltas to matter."""
    rng = random.Random(seed)
    wave_no = [0]

    def wave():
        w = wave_no[0]
        wave_no[0] += 1
        for k in range(pools):
            for i in range(per_pool):
                orch.submit(
                    Action(
                        name=f"a{w}-{i}",
                        cost={f"pool{k}": ranged(f"pool{k}", 1, 3)},
                        key_resource=f"pool{k}",
                        elasticity=AmdahlElasticity(0.1),
                        base_duration=rng.uniform(0.5, 3.0),
                        task_id="t",
                        trajectory_id=f"p{k}-w{w}-{i}",
                    )
                )
        if w + 1 < waves:
            orch.loop.call_after(period, wave)

    wave()


def _trace(orch):
    return sorted(
        (r.name, r.trajectory_id, round(r.submit, 9), round(r.start, 9),
         round(r.finish, 9), tuple(sorted(r.units.items())), r.failed)
        for r in orch.telemetry.records
    )


class _RestartingLoopback(LoopbackTransport):
    """Loopback whose worker silently restarts after N requests — the
    client's sent-state (snapshot fps, list bases, intern mirror) now
    describes a worker that remembers nothing."""

    restart_after = 10
    _count = 0

    def submit(self, request):
        cls = _RestartingLoopback
        cls._count += 1
        if cls._count == cls.restart_after:
            self._worker = RemoteShardWorker()
        super().submit(request)


class _EvictingLoopback(LoopbackTransport):
    """Loopback whose worker runs a far smaller intern budget than the
    client mirrors — worker-side evictions the mirror cannot predict."""

    def __init__(self):
        super().__init__()
        self._worker._interns = wire.LruBytes(2048)


class TestRecovery:
    def _run(self, shards, transport=None, seed=7, **kw):
        if transport is not None:
            kw["transport"] = transport
        orch = _make_system(shards, **kw)
        _submit_workload(orch, seed)
        orch.run()
        trace = _trace(orch)
        assert orch.queue_depth() == 0 and orch.in_flight() == 0
        orch.close()
        return orch, trace

    def test_worker_restart_recovers_bit_identically(self):
        _, serial = self._run(None)
        _RestartingLoopback._count = 0
        orch, trace = self._run(
            2, transport=_RestartingLoopback, plan_mode="remote"
        )
        assert trace == serial
        assert orch.telemetry.wire_fallbacks >= 1

    def test_intern_budget_divergence_recovers_bit_identically(self):
        """The worker evicts payloads the client's (bigger) mirror still
        holds; every miss is a typed stale_intern + one full re-send —
        counted, and never a wrong plan."""
        _, serial = self._run(None)
        orch, trace = self._run(
            2, transport=_EvictingLoopback, plan_mode="remote"
        )
        assert trace == serial
        assert orch.telemetry.wire_fallbacks >= 1

    def test_normal_run_has_no_fallbacks(self):
        """With same-budget mirrors and healthy workers the delta
        protocol must never need a recovery round — fallbacks are a
        telemetry signal, not a steady-state subsidy."""
        _, serial = self._run(None)
        orch, trace = self._run(2, plan_mode="remote")
        assert trace == serial
        if orch.telemetry.wire_rounds:
            assert orch.telemetry.wire_fallbacks == 0


# ---------------------------------------------------------------------------
# the wire bill shrinks across rounds (deltas + interning, observable)
# ---------------------------------------------------------------------------


class _RecordingLoopback(LoopbackTransport):
    frames = []

    def submit(self, request):
        _RecordingLoopback.frames.append(bytes(request))
        super().submit(request)


class TestCrossRoundShrink:
    def test_steady_state_requests_are_references(self):
        """After the first sharded round, repeated content travels as
        refs/deltas/irefs: later requests must be materially smaller
        than the priming ones, and must actually contain reference
        forms (not re-sent payloads)."""
        _RecordingLoopback.frames = []
        orch = _make_system(2, plan_mode="remote", transport=_RecordingLoopback)
        _submit_workload(orch, seed=3)
        orch.run()
        orch.close()
        frames = _RecordingLoopback.frames
        _RecordingLoopback.frames = []
        if len(frames) < 6:
            pytest.skip("workload produced too few sharded rounds")
        sizes = [len(f) for f in frames]
        first = max(sizes[:2])
        # completion-triggered rounds between waves change almost
        # nothing: they must travel as refs/deltas, a fraction of the
        # priming frame (wave rounds legitimately define new actions)
        assert min(sizes[2:]) < first / 3, (first, sorted(sizes[2:])[:3])
        tail_text = b"".join(frames[2:])
        assert b'"k":"ref"' in tail_text
        assert b'"k":"delta"' in tail_text
        # each action's payload travels when it changes, not once per
        # round it sits in a queue: total defines stay proportional to
        # the action count (arrival + a few mutations each), never to
        # queue-depth x rounds as full re-sends would be
        total_actions = 3 * 8 * 6  # pools x waves x per_pool
        defines = tail_text.count(b'"idef"')
        assert defines < 4 * total_actions, defines


# ---------------------------------------------------------------------------
# fairqueue version counter (drives the client's per-partition cache)
# ---------------------------------------------------------------------------


class TestQueueVersion:
    def _queue(self):
        return PartitionQueue("cpu")

    def _act(self, i, task="t"):
        return Action(
            name=f"q{i}", cost={"cpu": fixed("cpu", 1)}, base_duration=1.0,
            task_id=task, trajectory_id=f"{task}-{i}",
        )

    def test_membership_mutations_bump_version(self):
        q = self._queue()
        v0 = q.version
        a = self._act(0)
        q.push(a)
        assert q.version > v0
        v1 = q.version
        q.remove(a.uid)
        assert q.version > v1

    def test_ordered_is_stable_between_versions(self):
        q = self._queue()
        acts = [self._act(i) for i in range(5)]
        for a in acts:
            q.push(a)
        v = q.version
        first = [a.uid for a in q.ordered()]
        assert [a.uid for a in q.ordered()] == first
        assert q.version == v  # reads never bump
        q.remove(acts[2].uid)
        assert q.version > v
        assert [a.uid for a in q.ordered()] == [
            u for u in first if u != acts[2].uid
        ]


# ---------------------------------------------------------------------------
# encode memoization primitives: spliced segments, patch-defines,
# batched frames and the drain flush
# ---------------------------------------------------------------------------


class TestEncodedSegments:
    PAYLOAD = {
        "kind": "x", "vals": [1, 2.5, "s", None, {"k": [3, 4]}], "t": True,
    }

    def test_json_splice_is_byte_identical(self):
        """A frame assembled from cached json segments must be byte-for-
        byte the frame a plain dumps would have produced — splicing is
        an encode shortcut, never a wire dialect."""
        seg = wire.encode_segment(self.PAYLOAD, "json")
        framed = {"v": 1, "body": seg, "tail": [seg, 7]}
        plain = {"v": 1, "body": self.PAYLOAD, "tail": [self.PAYLOAD, 7]}
        assert wire.encode_frame(framed, "json") == wire.encode_frame(
            plain, "json"
        )

    def test_binary_blob_round_trips(self):
        """A binary segment is a standalone sub-frame with its own
        string table; strings repeated inside and outside the segment
        must not confuse either table."""
        seg = wire.encode_segment(self.PAYLOAD, "binary")
        framed = {"v": 1, "kind": "outer", "body": seg, "again": "kind"}
        blob = wire.encode_frame(framed, "binary")
        assert wire.decode_frame(blob) == {
            "v": 1, "kind": "outer", "body": self.PAYLOAD, "again": "kind",
        }

    def test_codec_mismatch_is_typed(self):
        jseg = wire.encode_segment(self.PAYLOAD, "json")
        bseg = wire.encode_segment(self.PAYLOAD, "binary")
        with pytest.raises(wire.WireError):
            wire.encode_frame({"x": bseg}, "json")
        with pytest.raises(wire.WireError):
            wire.encode_frame({"x": jseg}, "binary")

    def test_truncated_segment_is_typed(self):
        blob = wire.encode_frame(
            {"x": wire.encode_segment(self.PAYLOAD, "binary")}, "binary"
        )
        with pytest.raises(wire.WireError):
            wire.decode_frame(blob[:-1])


class TestPatchDefineResolution:
    def _act(self):
        return Action(
            name="r", cost={"cpu": ranged("cpu", 1, 4)}, key_resource="cpu",
            base_duration=2.0, task_id="t", trajectory_id="t-0",
        )

    def test_patch_define_through_a_real_worker(self):
        """Lifecycle transition as a patch-define: the worker clones its
        interned base, applies the diff, and the result is field-for-
        field the action a full re-send would have defined."""
        w = RemoteShardWorker()
        a = self._act()
        enc = wire.encode_action(a)
        fp0 = wire.fingerprint(enc)
        missing = []
        r0 = w._resolve_action(wire.intern_def(fp0, enc), missing)
        assert missing == [] and r0.uid == a.uid

        a.state = type(a.state)("running")
        a.start_time = 1.5
        a.attempts = 1
        d = {"state": a.state.value, "start_time": 1.5, "attempts": 1}
        fp1 = wire.fingerprint(wire.encode_action(a))
        r1 = w._resolve_action(wire.intern_patch(fp1, fp0, d), missing)
        assert missing == []
        assert wire.fingerprint(wire.encode_action(r1)) == fp1
        assert r1 is not r0  # the interned base was cloned, not mutated
        assert r0.state.value == "pending" and math.isnan(r0.start_time)
        assert w._stats["intern_patches"] == 1
        # the patched action is interned under the NEW fingerprint
        assert w._resolve_action({"iref": fp1}, missing) is r1

    def test_missing_base_reports_the_new_fingerprint(self):
        """A patch against an evicted base is exactly a missed ref — and
        what the worker asks to be re-sent is the NEW fingerprint (what
        the recovery full-send will define), not the base it lacks."""
        w = RemoteShardWorker()
        missing = []
        out = w._resolve_action(
            wire.intern_patch("fp-new", "fp-gone", {"start_time": 1.0}),
            missing,
        )
        assert out is None and missing == ["fp-new"]


class _StreamRecorder(LoopbackTransport):
    streams = []

    def __init__(self):
        super().__init__()
        self._frames = []
        _StreamRecorder.streams.append(self._frames)

    def submit(self, request):
        self._frames.append(bytes(request))
        super().submit(request)


class TestPlanBatchAndDrain:
    def _real_requests(self, seed=5):
        """Record one worker's full request stream from a healthy run —
        batching semantics are only meaningful against real frames whose
        refs/deltas/interns assume in-order application."""
        _StreamRecorder.streams = []
        orch = _make_system(2, plan_mode="remote", transport=_StreamRecorder)
        _submit_workload(orch, seed=seed)
        orch.run()
        orch.close()
        streams = _StreamRecorder.streams
        _StreamRecorder.streams = []
        frames = max(streams, key=len)
        reqs = [wire.decode_frame(f) for f in frames]
        return [r for r in reqs if r.get("kind") == "plan_request"]

    def test_plan_batch_equals_sequential_frames(self):
        """One plan_batch frame must produce exactly the plans the same
        requests produce as individual frames: each batched request is
        applied against the cache state its predecessors left behind."""
        reqs = self._real_requests()
        if len(reqs) < 4:
            pytest.skip("workload produced too few sharded rounds")

        def strip(plans):  # wall_s is a measured duration, not a plan
            return [
                {k: v for k, v in p.items() if k != "wall_s"} for p in plans
            ]

        w_seq = RemoteShardWorker()
        seq_plans = [strip(w_seq._handle(r)["plans"]) for r in reqs]

        w_bat = RemoteShardWorker()
        blob = wire.encode_frame(
            wire.envelope("plan_batch", {"reqs": reqs}), "json"
        )
        resp = wire.expect(
            wire.decode_frame(w_bat.handle_bytes(blob)), "plan_batch_response"
        )
        assert [strip(r["plans"]) for r in resp["resps"]] == seq_plans

    def test_drain_flushes_carried_dump_cost(self):
        """The run's LAST response-encode cost is carried, not dropped:
        a drain message flushes it into an accounted reply, and the
        carry starts over from just the drain's own (tiny) dump."""
        w = RemoteShardWorker()
        w._carry_dump_s = 0.125
        out = w.handle_bytes(
            wire.encode_frame(wire.envelope("drain", {}), "json")
        )
        resp = wire.expect(wire.decode_frame(out), "drain_response")
        assert resp["codec_s"] >= 0.125
        assert w._carry_dump_s < 0.125

"""The port's copy of the control plane (``repro_torch.core``) under the
reference suite ``tests/test_commit_handoff.py``, imports rewritten, each case kept.

The reference suite's own description follows.

Ownership handoff under the two-phase worker-owned commit.

The rails under test:

* **fence during an open prepare window** — a ``migrate_task`` /
  ``fence`` that fires while a ``plan_commit`` frame is in flight must
  deterministically abort the fenced intents (the ack is never adopted,
  the worker restores its pre-round replicas) and the round must stay
  trace-identical to the serial loop when the fence itself moves no
  state;
* **amnesia** — a silently restarted worker holds no leases; its next
  epoch assertion must fail with a *typed* ``stale_epoch`` BEFORE any
  replica mutation (never a double launch), and the coordinator's
  re-grant + full re-send must recover the round;
* **loss mid-prepare** — a connection that dies between prepare and
  ack rides the adoption rail: the orphaned leases are revoked by
  epoch bump and the partitions commit inline from fallback plans —
  zero lost launches, and the zombie's late ack can never land.
"""

import random

import pytest

from repro_torch.core import wire
from repro_torch.core.action import Action, AmdahlElasticity, ResourceRequest, fixed
from repro_torch.core.fairqueue import FairSharePolicy
from repro_torch.core.managers.base import ResourceManager
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.remote import (
    RECOVERABLE_CODES,
    LoopbackTransport,
    RemoteShardWorker,
)
from repro_torch.core.scheduler import ElasticScheduler
from repro_torch.core.simulator import EventLoop
from repro_torch.core.wire import TransportError

from test_torch_remote import _make_system, _submit_workload, _trace


# ---------------------------------------------------------------------------
# a loopback transport with frame-kind hooks (the interleaving probe)
# ---------------------------------------------------------------------------


class HookTransport:
    """Loopback transport that exposes the prepare window: hooks fire
    keyed on the decoded frame kind, between submit and recv — exactly
    where a concurrent handoff or a worker death lands."""

    def __init__(self, shard, hooks):
        self.shard = shard
        self.hooks = hooks
        self._inner = LoopbackTransport()
        self._last_kind = None

    def _kind(self, request):
        blob = request if isinstance(request, bytes) else request.encode("utf-8")
        try:
            payload = wire.decode_frame(blob)
        except wire.WireError:
            return None
        return payload.get("kind") if isinstance(payload, dict) else None

    def amnesia(self):
        """Silently replace the worker (fresh process, no leases)."""
        self._inner = LoopbackTransport()

    def submit(self, request):
        self._last_kind = self._kind(request)
        on_submit = self.hooks.get("on_submit")
        if on_submit is not None:
            on_submit(self, self._last_kind)
        self._inner.submit(request)

    def recv(self):
        on_recv = self.hooks.get("on_recv")
        if on_recv is not None:
            on_recv(self, self._last_kind)
        return self._inner.recv()

    def close(self):
        self._inner.close()


def _hook_factory(hooks):
    return lambda shard: HookTransport(shard, hooks)


def _assert_clean(orch, trace):
    assert orch.queue_depth() == 0 and orch.in_flight() == 0
    for m in orch.managers.values():
        m.check_occupancy()
    uids = [(r[0], r[1], r[2]) for r in trace]
    assert len(uids) == len(set(uids)), "double launch"


def _run_hooked(seed, hooks, **kw):
    orch = _make_system(
        shards=4, plan_mode="remote", commit_mode="worker",
        transport=_hook_factory(hooks), **kw,
    )
    hooks["orch"] = orch
    _submit_workload(orch, seed)
    orch.run()
    trace = _trace(orch)
    _assert_clean(orch, trace)
    summary = orch.telemetry.wire_summary()
    orch.close()
    return trace, summary


# ---------------------------------------------------------------------------
# fence during the open prepare window
# ---------------------------------------------------------------------------


class TestFenceMidPrepare:
    def test_fence_aborts_open_intents_and_trace_holds(self):
        """A full fence fired between prepare and ack: the in-flight
        intents are fenced (never adopted, worker stash restored), the
        parts re-dirty and replan at the same virtual instant — so a
        fence that moves no state is trace-neutral."""
        _, serial = (None, None)
        orch0 = _make_system(shards=None)
        _submit_workload(orch0, 5)
        orch0.run()
        serial = _trace(orch0)
        orch0.close()

        fired = [0]

        def on_recv(t, kind):
            if kind == "plan_commit" and not fired[0]:
                fired[0] = 1
                hooks["orch"]._commit_engine.fence()

        hooks = {"on_recv": on_recv}
        trace, summary = _run_hooked(5, hooks)
        assert fired[0] == 1
        assert trace == serial
        assert summary.get("fenced_intents", 0) >= 1
        assert summary.get("commit_aborts", 0) >= 1

    @pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
    def test_randomized_fence_interleavings_stay_serial(self, seed):
        """Property over random interleavings: fences of random scope at
        random points inside the prepare window never bend the trace,
        lose a launch, or double-launch — the fenced rounds abort
        deterministically and replan."""
        orch0 = _make_system(shards=None)
        _submit_workload(orch0, seed)
        orch0.run()
        serial = _trace(orch0)
        orch0.close()

        rng = random.Random(7000 + seed)
        targets = sorted(rng.sample(range(1, 12), k=3))
        scopes = [
            rng.choice([None, ["cpu"], ["gpu"], ["api"], ["cpu", "api"]])
            for _ in targets
        ]
        seen = [0]

        def on_recv(t, kind):
            if kind != "plan_commit":
                return
            seen[0] += 1
            if seen[0] in targets:
                scope = scopes[targets.index(seen[0])]
                hooks["orch"]._commit_engine.fence(scope)

        hooks = {"on_recv": on_recv}
        trace, _summary = _run_hooked(seed, hooks)
        assert trace == serial

    def test_fence_between_rounds_settles_pending_confirms(self):
        """A fence with no round open finalizes verified-but-unconfirmed
        stashes with an explicit commit (the coordinator already applied
        them) and revokes by epoch bump — the next round re-grants."""
        orch = _make_system(shards=4, plan_mode="remote", commit_mode="worker")
        _submit_workload(orch, 3)
        orch.run(until=6.0)
        engine = orch._commit_engine
        fenced = engine.fence()  # nothing in flight -> 0 fenced intents
        assert fenced == 0
        assert not engine._pending_confirm
        assert all(not g for g in engine._granted.values())
        orch.run()
        trace = _trace(orch)
        _assert_clean(orch, trace)
        orch.close()

        orch0 = _make_system(shards=None)
        _submit_workload(orch0, 3)
        orch0.run()
        assert trace == _trace(orch0)
        orch0.close()


# ---------------------------------------------------------------------------
# migrate_task against an open prepare window
# ---------------------------------------------------------------------------


def _pool_fleet(transport=None, **kw):
    loop = EventLoop()
    managers = {f"pool{k}": ResourceManager(f"pool{k}", 2) for k in range(2)}
    fs = FairSharePolicy(weights={"a": 2.0, "b": 1.0})
    extra = {}
    if transport is not None:
        extra = dict(plan_mode="remote", commit_mode="worker",
                     transport=transport)
    return Orchestrator(
        managers, loop=loop, fair_share=fs, shards=2, **extra, **kw
    )


def _pool_load(orch, n=12):
    futs = []
    for i in range(n):
        part = "pool0" if i % 3 else "pool1"
        task = "a" if i % 2 == 0 else "b"
        if i % 4 == 0:
            cost = {part: ResourceRequest(part, (1, 2))}
            kws = dict(key_resource=part, elasticity=AmdahlElasticity(0.1))
        else:
            cost, kws = {part: fixed(part, 1)}, {}
        futs.append(orch.submit(Action(
            name=f"w{i}", cost=cost, base_duration=2.0, task_id=task,
            trajectory_id=f"t{i}", **kws)))
    return futs


class TestMigrateMidPrepare:
    def _run_migrating(self, migrate_at):
        """One worker-commit run where migrate_task fires from INSIDE
        the prepare window of the ``migrate_at``-th plan_commit ack."""
        seen = [0]
        done = [0]

        def on_recv(t, kind):
            if kind != "plan_commit" or done[0]:
                return
            seen[0] += 1
            if seen[0] == migrate_at:
                done[0] = 1
                hooks["orch"].migrate_task("a", "pool0", "pool1")

        hooks = {"on_recv": on_recv}
        orch = _pool_fleet(transport=_hook_factory(hooks))
        hooks["orch"] = orch
        futs = _pool_load(orch)
        orch.run()
        assert done[0] == 1, "migration never interleaved with a prepare"
        assert all(f.done() for f in futs)
        trace = _trace(orch)
        _assert_clean(orch, trace)
        summary = orch.telemetry.wire_summary()
        orch.close()
        return trace, summary

    @pytest.mark.parametrize("migrate_at", [1, 2, 3])
    def test_migration_fences_and_is_deterministic(self, migrate_at):
        """The handoff fences the open intents (they abort, never adopt)
        and the interleaving is deterministic: the same virtual-time
        migration produces the same launch trace every run."""
        t1, s1 = self._run_migrating(migrate_at)
        t2, s2 = self._run_migrating(migrate_at)
        assert t1 == t2
        assert s1.get("fenced_intents", 0) >= 1
        assert s1.get("fenced_intents") == s2.get("fenced_intents")
        # the migrated tenant really ran on the destination replica
        pools = {u[0] for r in t1 for u in r[6]}
        assert "pool1" in pools


class TestRetargetEncodeMemo:
    """Regression: ``migrate_task`` retargets action cost vectors IN
    PLACE, so the client encode memo must re-key on the cost targeting
    (rtype set + key_resource) and ship a full re-define — a stale
    reference would make workers plan the migrated backlog against the
    pre-handoff pool (KeyError on the replica set, or silent
    divergence)."""

    def _run(self, plan_mode=None, commit_mode=None):
        kw = {}
        if plan_mode is not None:
            kw["plan_mode"] = plan_mode
        if commit_mode is not None:
            kw["commit_mode"] = commit_mode
        loop = EventLoop()
        managers = {f"pool{k}": ResourceManager(f"pool{k}", 2) for k in range(2)}
        fs = FairSharePolicy(weights={"a": 2.0, "b": 1.0})
        orch = Orchestrator(managers, loop=loop, fair_share=fs, shards=2, **kw)
        _pool_load(orch)
        orch.loop.call_after(0.5, lambda: orch.migrate_task("a", "pool0", "pool1"))
        orch.run()
        trace = _trace(orch)
        _assert_clean(orch, trace)
        orch.close()
        return trace

    def test_migration_over_the_wire_matches_inline(self):
        inline = self._run()
        remote = self._run(plan_mode="remote")
        worker = self._run(plan_mode="remote", commit_mode="worker")
        assert remote == inline
        assert worker == inline


# ---------------------------------------------------------------------------
# amnesia: restarted worker, stale epoch
# ---------------------------------------------------------------------------


class TestAmnesia:
    def test_restarted_worker_regrants_never_double_launches(self):
        """Swap a worker for a blank one right before its SECOND fused
        frame (its leases are epoch asserts by then): the blank worker
        must refuse typed — stale_epoch, before any replica mutation —
        and the re-grant + full re-send recovers the very same round."""
        orch0 = _make_system(shards=None)
        _submit_workload(orch0, 2)
        orch0.run()
        serial = _trace(orch0)
        orch0.close()

        counts = {}

        def on_submit(t, kind):
            if kind != "plan_commit":
                return
            counts[t.shard] = counts.get(t.shard, 0) + 1
            if counts[t.shard] == 2:
                t.amnesia()

        hooks = {"on_submit": on_submit}
        trace, summary = _run_hooked(2, hooks)
        assert trace == serial
        assert summary.get("lease_regrants", 0) >= 1
        assert summary.get("commit_diverged", 0) == 0
        assert summary.get("worker_losses", 0) == 0

    def test_stale_epoch_is_typed_and_recoverable(self):
        """Protocol-level: an epoch assertion a worker does not hold is
        refused with a typed, recoverable ``stale_epoch`` naming the
        stale rtypes — raised BEFORE the decode preamble, so no replica
        state can have been touched."""
        assert "stale_epoch" in RECOVERABLE_CODES
        worker = RemoteShardWorker()
        req = wire.envelope("plan_commit", {
            "shard": 0,
            "now": 0.0,
            "incremental": True,
            "policy": wire.encode_policy(ElasticScheduler()),
            "fair_share": None,
            "history": {"avg": {}},
            "snapshots": {},
            "executing": [],
            "partitions": [],
            "commit": {
                "leases": [wire.encode_lease("cpu", 3)],
                "max_passes": 2,
                "tick": 0.0005,
            },
        })
        resp = wire.loads(worker.handle(wire.dumps(req)))
        assert resp["kind"] == "error"
        assert resp["code"] == "stale_epoch"
        assert resp["rtypes"] == ["cpu"]
        # nothing was planned, stashed, or committed
        assert worker._stash is None
        assert worker._resident == {}

    def test_fresh_grant_then_revoke_then_assert_is_stale(self):
        """The fence's revocation really invalidates the lease: grant
        fresh, revoke via commit_decide, then the same epoch assert is
        stale — a fenced worker can never ack an old round again."""
        m = ResourceManager("r", 8)
        worker = RemoteShardWorker()
        base = {
            "shard": 0,
            "now": 0.0,
            "incremental": True,
            "policy": wire.encode_policy(ElasticScheduler()),
            "fair_share": None,
            "history": {"avg": {}},
            "snapshots": {"r": wire.encode_snapshot(m)},
            "executing": [],
            "partitions": [{"part": "r", "waiting": []}],
        }
        grant = dict(base)
        grant["commit"] = {
            "leases": [wire.encode_lease("r", 0, fresh=True)],
            "max_passes": 1, "tick": 0.0005,
        }
        resp = wire.loads(worker.handle(wire.dumps(
            wire.envelope("plan_commit", grant))))
        assert resp["kind"] == "plan_commit_response"
        # revoke (fence): commit the stash, withdraw the lease
        resp = wire.loads(worker.handle(wire.dumps(wire.envelope(
            "commit_decide", {"commit": True, "revoke": ["r"]}))))
        assert resp["kind"] == "commit_decide_response"
        assert resp["leases"] == 0
        stale = dict(base)
        stale["policy"] = None
        stale["snapshots"] = {}
        stale["partitions"] = []
        stale["commit"] = {
            "leases": [wire.encode_lease("r", 0)],
            "max_passes": 1, "tick": 0.0005,
        }
        resp = wire.loads(worker.handle(wire.dumps(
            wire.envelope("plan_commit", stale))))
        assert resp["kind"] == "error" and resp["code"] == "stale_epoch"


# ---------------------------------------------------------------------------
# worker loss mid-prepare: the adoption rail
# ---------------------------------------------------------------------------


class TestLossMidPrepare:
    def test_connection_death_between_prepare_and_ack_adopts(self):
        """The ack never arrives: the coordinator bumps the orphaned
        epochs (late acks can never land), plans the partitions inline,
        and commits them itself — same plan core, zero lost launches,
        trace identical to serial."""
        orch0 = _make_system(shards=None)
        _submit_workload(orch0, 4)
        orch0.run()
        serial = _trace(orch0)
        orch0.close()

        dropped = [0]

        def on_recv(t, kind):
            if kind == "plan_commit" and not dropped[0]:
                dropped[0] = 1
                raise TransportError("reset", "connection died mid-prepare")

        hooks = {"on_recv": on_recv}
        trace, summary = _run_hooked(4, hooks)
        assert dropped[0] == 1
        assert trace == serial
        assert summary.get("lease_adoptions", 0) >= 1
        assert summary.get("worker_losses", 0) >= 1
        assert summary.get("inline_parts", 0) >= 1

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_randomized_loss_storms_stay_serial(self, seed):
        """Property: random subsets of plan_commit exchanges dying at
        random points (submit or recv) never lose or double a launch
        and never bend the trace."""
        orch0 = _make_system(shards=None)
        _submit_workload(orch0, seed)
        orch0.run()
        serial = _trace(orch0)
        orch0.close()

        rng = random.Random(9000 + seed)
        kill_recv = set(rng.sample(range(1, 16), k=3))
        kill_submit = set(rng.sample(range(1, 16), k=2))
        n_recv = [0]
        n_submit = [0]

        def on_recv(t, kind):
            if kind != "plan_commit":
                return
            n_recv[0] += 1
            if n_recv[0] in kill_recv:
                raise TransportError("reset", "storm: ack dropped")

        def on_submit(t, kind):
            if kind != "plan_commit":
                return
            n_submit[0] += 1
            if n_submit[0] in kill_submit:
                raise TransportError("reset", "storm: prepare dropped")

        hooks = {"on_recv": on_recv, "on_submit": on_submit}
        trace, _summary = _run_hooked(seed, hooks)
        assert trace == serial

"""The port's copy of the control plane (``repro_torch.core``) under the
reference suite ``tests/test_resident_state.py``, imports rewritten, each case kept.

The reference suite's own description follows.

Resident worker plan state: in-place delta application plus the
copy-on-plan reset must be indistinguishable from rebuilding a fresh
manager from every snapshot.

Two rails, checked at two levels:

* **property** — inside a real worker, after every resident-state
  resolution (fingerprint hit, in-place ``apply_state`` patch, or full
  rebuild) the replica's ``snapshot_state()`` must byte-equal both a
  from-scratch ``restore_snapshot`` of the same payload and the payload
  itself; and planning (which clones ``plan_mutates`` families) must
  leave the resident replicas byte-untouched.
* **end to end** — 8 seeds of the mixed four-family workload, traces
  bit-identical to serial, under healthy workers AND under eviction,
  mid-run worker restart, and resident-amnesia fault injection."""

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
from repro_torch.core.cluster import ApiResourceSpec, CpuNodeSpec, GpuNodeSpec
from repro_torch.core.fairqueue import FairSharePolicy
from repro_torch.core.managers.base import ResourceManager
from repro_torch.core.managers.basic import BasicResourceManager
from repro_torch.core.managers.cpu import CpuManager
from repro_torch.core.managers.gpu import GpuManager, ServiceSpec
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.remote import LoopbackTransport, RemoteShardWorker
from repro_torch.core.simulator import EventLoop, FrozenClock


# ---------------------------------------------------------------------------
# workload: all four manager families in one system (mirrors
# tests/test_remote.py so every family's resident replica is exercised)
# ---------------------------------------------------------------------------


def _make_system(shards, cores=32, fair=False, **kw):
    loop = EventLoop()
    managers = {
        "cpu": CpuManager([CpuNodeSpec("n0", cores=cores)]),
        "gpu": GpuManager([GpuNodeSpec("g0")], [ServiceSpec("rm0", 40.0)]),
        "api": BasicResourceManager(
            ApiResourceSpec("api", mode="quota", quota=4, period_s=5.0),
            loop.clock,
        ),
        "pool": ResourceManager("pool", 6),
    }
    fs = FairSharePolicy(weights={"heavy": 2.0, "light": 1.0}) if fair else None
    return Orchestrator(
        managers, loop=loop, shards=shards, fair_share=fs, **kw
    )


def _submit_workload(orch, seed, tasks=("task0",), waves=8, per_wave=8,
                     period=2.0):
    """Wave-style churn (mirrors tests/test_wire_bill.py): every wave
    submits a mix across all four families at ONE timestamp, so rounds
    are genuinely multi-partition (= sharded, = over the wire) and every
    worker sees a steady stream of plan requests."""
    rng = random.Random(seed)
    wave_no = [0]

    def wave():
        w = wave_no[0]
        wave_no[0] += 1
        for i in range(per_wave):
            task = tasks[(w * per_wave + i) % len(tasks)]
            kind = rng.random()
            tid = f"{task}-w{w}-{i}"
            if kind < 0.3:
                a = Action(
                    name="reward", cost={"cpu": ranged("cpu", 1, 8)},
                    key_resource="cpu", elasticity=AmdahlElasticity(0.08),
                    base_duration=rng.uniform(1, 8), task_id=task,
                    trajectory_id=tid,
                )
            elif kind < 0.5:
                a = Action(
                    name="tool",
                    cost={"pool": fixed("pool", rng.choice((1, 2)))},
                    base_duration=rng.uniform(0.2, 2.0), task_id=task,
                    trajectory_id=tid,
                )
            elif kind < 0.75:
                a = Action(
                    name="rm:score",
                    cost={"gpu": ResourceRequest("gpu", (1, 2, 4, 8))},
                    key_resource="gpu", elasticity=AmdahlElasticity(0.15),
                    base_duration=rng.uniform(0.5, 3.0), service="rm0",
                    task_id=task, trajectory_id=tid,
                )
            else:
                a = Action(
                    name="api:q", cost={"api": fixed("api")},
                    base_duration=rng.uniform(0.1, 1.0), task_id=task,
                    trajectory_id=tid,
                )
            orch.submit(a)
        if w + 1 < waves:
            orch.loop.call_after(period, wave)

    wave()


def _trace(orch):
    return sorted(
        (r.name, r.task_id, r.trajectory_id, round(r.submit, 9),
         round(r.start, 9), round(r.finish, 9),
         tuple(sorted(r.units.items())), r.failed)
        for r in orch.telemetry.records
    )


def _run(seed, shards, transport=None, tasks=("task0",), **kw):
    if transport is not None:
        kw["transport"] = transport
    orch = _make_system(shards, **kw)
    _submit_workload(orch, seed, tasks=tasks)
    orch.run()
    trace = _trace(orch)
    assert orch.queue_depth() == 0 and orch.in_flight() == 0
    for m in orch.managers.values():
        m.check_occupancy()
    orch.close()
    return orch, trace


# ---------------------------------------------------------------------------
# the property worker: byte-compares every resident resolution against
# a from-scratch rebuild, and pins resident state across planning
# ---------------------------------------------------------------------------


class _PropertyWorker(RemoteShardWorker):
    """Worker that asserts the resident-state equivalence property on
    every request it serves, whatever path resolution took."""

    checks = [0]

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._expect = {}

    def _manager(self, rtype, fp, full):
        mgr = super()._manager(rtype, fp, full)
        rebuilt = type(mgr).restore_snapshot(full["state"])
        # resident replica (hit / patched / rebuilt) == fresh rebuild,
        # byte for byte on the canonical wire encoding...
        assert wire.dumps(mgr.snapshot_state()) == wire.dumps(
            rebuilt.snapshot_state()
        ), f"{rtype}: resident replica diverged from rebuild"
        # ...and both round-trip the payload itself (canonical-form
        # compare: the payload crossed a codec, so ints/floats and
        # list/tuple spellings may differ while the value may not)
        assert wire.fingerprint(mgr.snapshot_state()) == wire.fingerprint(
            full["state"]
        ), f"{rtype}: snapshot_state does not round-trip the payload"
        # pin the post-resolution state: planning must not move it
        self._expect[rtype] = wire.dumps(mgr.snapshot_state())
        _PropertyWorker.checks[0] += 1
        return mgr

    def _plan(self, payload, parse_s=0.0):
        self._expect = {}
        resp = super()._plan(payload, parse_s)
        # planning clones plan_mutates families (copy-on-plan); the
        # resident replicas themselves must come out byte-untouched
        for rt, expected in self._expect.items():
            res = self._resident.get(rt)
            assert res is not None and wire.dumps(
                res[1].snapshot_state()
            ) == expected, f"{rt}: planning mutated the resident replica"
        return resp


class _PropertyLoopback(LoopbackTransport):
    def __init__(self):
        super().__init__()
        self._worker = _PropertyWorker()


class TestResidentProperty:
    @pytest.mark.parametrize("seed", [3, 11])
    def test_resident_equals_rebuild_every_request(self, seed):
        _, serial = _run(seed, None)
        _PropertyWorker.checks[0] = 0
        orch, trace = _run(
            seed, 2, transport=_PropertyLoopback, plan_mode="remote"
        )
        assert trace == serial
        assert _PropertyWorker.checks[0] > 0
        # steady state is in-place patches (this workload moves every
        # touched manager's clock each round); rebuilds happen only on
        # first sight of a family at a worker, never again
        cache = orch.telemetry.wire_worker_cache
        assert cache.get("resident_patches", 0) > 0
        assert cache.get("resident_rebuilds", 0) <= 2 * len(orch.managers)
        assert orch.telemetry.wire_fallbacks == 0

    def test_resident_resolution_paths_direct(self):
        """One worker, one family, all three paths in order: first sight
        rebuilds, an identical fingerprint reuses the same object, a
        changed state patches that same object in place."""
        w = RemoteShardWorker()
        m = ResourceManager("pool", 6)
        full = wire.encode_snapshot(m)
        fp = wire.fingerprint(full)
        m1 = w._manager("pool", fp, full)
        assert w._stats["resident_rebuilds"] == 1
        m2 = w._manager("pool", fp, full)
        assert m2 is m1 and w._stats["resident_hits"] == 1
        m._in_use, m._task_use = 2, {"t": 2}
        full2 = wire.encode_snapshot(m)
        m3 = w._manager("pool", wire.fingerprint(full2), full2)
        assert m3 is m1 and w._stats["resident_patches"] == 1
        assert wire.dumps(m3.snapshot_state()) == wire.dumps(
            m.snapshot_state()
        )
        # a different-topology payload rebuilds (apply_state refused)
        big = wire.encode_snapshot(ResourceManager("pool", 12))
        m4 = w._manager("pool", wire.fingerprint(big), big)
        assert m4 is not m1 and w._stats["resident_rebuilds"] == 2


# ---------------------------------------------------------------------------
# apply_state unit rails: topology changes refuse, state changes land
# byte-identically (all four families)
# ---------------------------------------------------------------------------


class TestApplyStateRails:
    def _roundtrip(self, mgr, mutate):
        state0 = mgr.snapshot_state()
        replica = type(mgr).restore_snapshot(state0)
        mutate(mgr)
        state1 = mgr.snapshot_state()
        assert replica.apply_state(state1) is True
        assert wire.dumps(replica.snapshot_state()) == wire.dumps(state1)
        return replica

    def test_pool_roundtrips_and_refuses_topology(self):
        m = ResourceManager("pool", 6)

        def mutate(m):
            m._in_use = 3
            m._task_use = {"t": 3}

        replica = self._roundtrip(m, mutate)
        assert replica.apply_state({"rtype": "other", "capacity": 6}) is False
        assert replica.apply_state({"rtype": "pool", "capacity": 9}) is False

    def test_cpu_roundtrips_and_refuses_topology(self):
        m = CpuManager([CpuNodeSpec("n0", cores=8)])

        def mutate(m):
            a = Action(
                name="r", cost={"cpu": ranged("cpu", 1, 4)},
                key_resource="cpu", base_duration=1.0, task_id="t",
                trajectory_id="t-0",
            )
            assert m.try_allocate(a, 2) is not None

        replica = self._roundtrip(m, mutate)
        other = CpuManager([CpuNodeSpec("n1", cores=8)]).snapshot_state()
        assert replica.apply_state(other) is False

    def test_gpu_roundtrips_and_refuses_topology(self):
        m = GpuManager([GpuNodeSpec("g0")], [ServiceSpec("rm0", 40.0)])

        def mutate(m):
            a = Action(
                name="rm:score",
                cost={"gpu": ResourceRequest("gpu", (1, 2, 4))},
                key_resource="gpu", base_duration=1.0, service="rm0",
                task_id="t", trajectory_id="t-0",
            )
            assert m.try_allocate(a, 2) is not None

        replica = self._roundtrip(m, mutate)
        other = GpuManager(
            [GpuNodeSpec("g1")], [ServiceSpec("rm0", 40.0)]
        ).snapshot_state()
        assert replica.apply_state(other) is False
        osvc = GpuManager(
            [GpuNodeSpec("g0")], [ServiceSpec("rm1", 40.0)]
        ).snapshot_state()
        assert replica.apply_state(osvc) is False

    def test_api_quota_roundtrips_and_refuses_spec_change(self):
        spec = ApiResourceSpec("api", mode="quota", quota=4, period_s=5.0)
        m = BasicResourceManager(spec, FrozenClock(0.0))

        def mutate(m):
            a = Action(
                name="api:q", cost={"api": fixed("api")},
                base_duration=1.0, task_id="t", trajectory_id="t-0",
            )
            assert m.try_allocate(a, 1) is not None
            m._clock = FrozenClock(2.5)

        replica = self._roundtrip(m, mutate)
        wider = BasicResourceManager(
            ApiResourceSpec("api", mode="quota", quota=9, period_s=5.0),
            FrozenClock(0.0),
        ).snapshot_state()
        assert replica.apply_state(wider) is False
        # the patched replica's clock is re-pinned at the new instant:
        # available must read the settled tokens without a refill jump
        assert replica._clock.now() == 2.5
        assert replica.available == 3


# ---------------------------------------------------------------------------
# 8-seed e2e trace identity under fault injection (eviction, restart,
# resident amnesia) — every divergence path must end in a recovery
# round, never a different trace
# ---------------------------------------------------------------------------


class _RestartingLoopback(LoopbackTransport):
    """Worker silently restarts mid-run: resident replicas, intern
    table, and snapshot caches all vanish while the client's sent-state
    still describes the old worker."""

    restart_after = 6
    restarted_warm = False

    def __init__(self):
        super().__init__()
        self._n = 0

    def submit(self, request):
        self._n += 1
        if self._n == self.restart_after:
            # per-instance count: by its own 6th request this worker is
            # warm (policy, interns, residents), so the swap strands
            # client refs for certain — a cold swap would be a no-op
            if self._worker._policy is not None:
                _RestartingLoopback.restarted_warm = True
            self._worker = RemoteShardWorker()
        super().submit(request)


class _EvictingLoopback(LoopbackTransport):
    """Worker intern budget far below the client mirror's — worker-side
    evictions the mirror cannot predict force stale_intern recoveries."""

    def __init__(self):
        super().__init__()
        self._worker._interns = wire.LruBytes(2048)


class _AmnesiacLoopback(LoopbackTransport):
    """Worker whose resident replicas are dropped before every request:
    each round takes the full decode/rebuild path.  Traces must not
    move — resident state is a cache, not an input."""

    def submit(self, request):
        self._worker._resident.clear()
        super().submit(request)


class TestResidentTraceIdentity:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6, 7])
    def test_faulted_workers_stay_bit_identical(self, seed):
        _, serial = _run(seed, None)

        # healthy resident workers: identical, zero fallbacks
        orch, trace = _run(seed, 2, plan_mode="remote")
        assert trace == serial, f"seed {seed}: resident run diverged"
        if orch.telemetry.wire_rounds:
            assert orch.telemetry.wire_fallbacks == 0

        # rotate one fault per seed so all three appear across the set
        fault = (_RestartingLoopback, _EvictingLoopback, _AmnesiacLoopback)[
            seed % 3
        ]
        _RestartingLoopback.restarted_warm = False
        orch_f, trace_f = _run(seed, 2, transport=fault, plan_mode="remote")
        assert trace_f == serial, (
            f"seed {seed}: {fault.__name__} diverged from serial"
        )
        if fault is _RestartingLoopback and _RestartingLoopback.restarted_warm:
            # a warmed worker died mid-run: the stranded refs must
            # surface as a counted recovery round
            assert orch_f.telemetry.wire_fallbacks >= 1

    def test_restart_rebuilds_resident_state(self):
        """After the mid-run restart the new worker rebuilds its
        resident replicas from the recovery full-send and keeps going —
        rebuilds are visible in the cache telemetry."""
        _, serial = _run(5, None)
        _RestartingLoopback.restarted_warm = False
        orch, trace = _run(
            5, 2, transport=_RestartingLoopback, plan_mode="remote"
        )
        assert trace == serial
        cache = orch.telemetry.wire_worker_cache
        assert cache.get("resident_rebuilds", 0) >= 1
        assert orch.telemetry.wire_fallbacks >= 1

"""The port's copy of the control plane (``repro_torch.core``) under the
reference suite ``tests/test_transport.py``, imports rewritten, each case kept.

The reference suite's own description follows.

Socket shard transport, fault tolerance, and the chaos storm rails.

Three layers of guarantees:

* **framing** — length-prefixed frames fail with *typed* errors on
  every malformed input (mid-frame disconnect, oversized length,
  refused connect, read timeout) so the round client can route every
  failure through one recovery rail;
* **lifecycle** — transports are safe to close twice, safe to close
  concurrently with a blocked read, and process-backed workers never
  outlive an abandoned orchestrator;
* **equivalence under fire** — an 8-seed kill/restart/reconnect storm
  over real TCP sockets, plus packet-level chaos schedules (drops,
  truncation, silent worker amnesia), must produce launch traces
  bit-identical to the serial round loop with zero lost or doubled
  launches.
"""

import gc
import multiprocessing
import socket
import threading
import time

import pytest

from repro_torch.core import wire
from repro_torch.core.remote import ProcessTransport, _sweep_process_transports
from repro_torch.core.transport import (
    ChaosPlan,
    ChaosTransport,
    SocketTransport,
    WorkerServer,
    chaos_fleet,
    read_frame,
    socket_fleet,
    write_frame,
)
from repro_torch.core.wire import TransportError

from test_torch_remote import _make_system, _submit_workload, _trace


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _drain_frame() -> bytes:
    """The smallest real round-trip: a drain envelope the worker
    answers with ``drain_response``."""
    return wire.encode_frame(wire.envelope("drain", {}), "json")


def _free_port() -> int:
    """A port that was just free — nothing listens on it afterwards."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pipe_pair():
    """A connected TCP socket pair on loopback (real sockets, so
    shutdown semantics match production, unlike socketpair on some
    platforms)."""
    with socket.socket() as srv:
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        client = socket.create_connection(srv.getsockname(), timeout=5)
        peer, _ = srv.accept()
    return client, peer


def _run_serial(seed, tasks=("heavy", "light"), n=60):
    orch = _make_system(shards=4, plan_mode="inline")
    _submit_workload(orch, seed=seed, tasks=list(tasks), n=n)
    orch.run()
    trace = _trace(orch)
    orch.close()
    return trace


def _run_socket(seed, transport, tasks=("heavy", "light"), n=60, kills=(), **kw):
    orch = _make_system(shards=4, plan_mode="remote", transport=transport, **kw)
    _submit_workload(orch, seed=seed, tasks=list(tasks), n=n)
    for t, fn in kills:
        orch.loop.call_after(t, fn)
    orch.run()
    trace = _trace(orch)
    summary = orch.telemetry.wire_summary()
    orch.close()
    return trace, summary


# ---------------------------------------------------------------------------
# framing edge cases
# ---------------------------------------------------------------------------


class TestFraming:
    def test_round_trip(self):
        client, peer = _pipe_pair()
        try:
            write_frame(client, b"\xb1hello")
            assert read_frame(peer) == b"\xb1hello"
        finally:
            client.close()
            peer.close()

    def test_mid_frame_disconnect_is_truncated(self):
        """Peer dies after the header + part of the payload: the reader
        gets ``truncated_frame``, not a hang or a short read."""
        client, peer = _pipe_pair()
        try:
            import struct

            peer.sendall(struct.pack(">I", 100) + b"only-part")
            peer.close()
            with pytest.raises(TransportError) as ei:
                read_frame(client)
            assert ei.value.code == "truncated_frame"
        finally:
            client.close()

    def test_header_only_disconnect_is_truncated(self):
        client, peer = _pipe_pair()
        try:
            peer.sendall(b"\x00\x00")  # half a length prefix
            peer.close()
            with pytest.raises(TransportError) as ei:
                read_frame(client)
            assert ei.value.code == "truncated_frame"
        finally:
            client.close()

    def test_oversized_length_rejected_before_allocation(self):
        """A hostile/corrupt length prefix larger than MAX_FRAME_BYTES
        is refused from the 4 header bytes alone."""
        client, peer = _pipe_pair()
        try:
            import struct

            peer.sendall(struct.pack(">I", wire.MAX_FRAME_BYTES + 1))
            with pytest.raises(TransportError) as ei:
                read_frame(client)
            assert ei.value.code == "frame_too_large"
        finally:
            client.close()
            peer.close()

    def test_oversized_write_rejected_locally(self):
        client, peer = _pipe_pair()
        try:
            blob = memoryview(bytearray(8))  # stand-in; size check first

            class Huge(bytes):
                def __len__(self):
                    return wire.MAX_FRAME_BYTES + 1

            with pytest.raises(TransportError) as ei:
                write_frame(client, Huge(blob))
            assert ei.value.code == "frame_too_large"
        finally:
            client.close()
            peer.close()

    def test_zero_length_frame_is_truncated(self):
        client, peer = _pipe_pair()
        try:
            import struct

            peer.sendall(struct.pack(">I", 0))
            with pytest.raises(TransportError) as ei:
                read_frame(client)
            assert ei.value.code == "truncated_frame"
        finally:
            client.close()
            peer.close()


# ---------------------------------------------------------------------------
# SocketTransport lifecycle
# ---------------------------------------------------------------------------


class TestSocketTransport:
    def test_connect_refused_is_typed(self):
        t = SocketTransport(("127.0.0.1", _free_port()), connect_timeout=2)
        with pytest.raises(TransportError) as ei:
            t.submit(b"x")
        assert ei.value.code == "connect"
        t.close()

    def test_read_timeout_is_typed_and_resets(self):
        """A worker that never answers trips ``read_timeout`` and drops
        the connection so the next submit reconnects."""
        with socket.socket() as srv:
            srv.bind(("127.0.0.1", 0))
            srv.listen(1)
            t = SocketTransport(srv.getsockname(), read_timeout=0.2)
            t.submit(b"ping")
            with pytest.raises(TransportError) as ei:
                t.recv()
            assert ei.value.code == "read_timeout"
            assert t._sock is None  # connection dropped → reconnect next
            t.close()

    def test_double_close_is_idempotent(self):
        with WorkerServer() as srv:
            t = SocketTransport(srv.addr)
            t.submit(_drain_frame())
            t.recv()
            t.close()
            t.close()  # second close is a no-op, not an error
            with pytest.raises(TransportError) as ei:
                t.submit(b"x")
            assert ei.value.code == "closed"

    def test_recv_without_submit_is_closed(self):
        t = SocketTransport(("127.0.0.1", 1))
        with pytest.raises(TransportError) as ei:
            t.recv()
        assert ei.value.code == "closed"

    def test_concurrent_close_wakes_blocked_reader(self):
        """close() from another thread while recv() is blocked must wake
        the reader with a typed error (teardown during an in-flight
        pipelined round)."""
        with socket.socket() as srv:
            srv.bind(("127.0.0.1", 0))
            srv.listen(1)
            t = SocketTransport(srv.getsockname(), read_timeout=30)
            t.submit(b"ping")  # server never answers
            errors = []

            def reader():
                try:
                    t.recv()
                    errors.append(None)
                except TransportError as e:
                    errors.append(e.code)

            th = threading.Thread(target=reader)
            th.start()
            time.sleep(0.05)  # let the reader block in recv
            t.close()
            th.join(timeout=5)
            assert not th.is_alive()
            assert errors and errors[0] in ("reset", "truncated_frame", "closed")

    def test_context_manager_closes(self):
        with WorkerServer() as srv:
            with SocketTransport(srv.addr) as t:
                t.submit(_drain_frame())
                t.recv()
            with pytest.raises(TransportError):
                t.submit(b"x")

    def test_socket_fleet_maps_shards_to_addrs(self):
        fac = socket_fleet([("a", 1), ("b", 2)])
        assert fac(0).addr == ("a", 1)
        assert fac(1).addr == ("b", 2)
        assert fac(2).addr == ("a", 1)  # wraps
        with pytest.raises(ValueError):
            socket_fleet([])

    def test_zero_arg_transport_factories_still_work(self):
        """Pre-fleet callers pass a transport class/zero-arg factory
        (``transport=LoopbackTransport``); the client must keep
        accepting those beside ``shard_idx -> transport`` fleets."""
        from repro_torch.core.remote import LoopbackTransport, _per_shard

        wrapped = _per_shard(LoopbackTransport)
        a, b = wrapped(0), wrapped(1)
        assert isinstance(a, LoopbackTransport) and a is not b

        def fleet(shard_idx):
            return ("fleet", shard_idx)

        assert _per_shard(fleet)(3) == ("fleet", 3)


class TestWorkerServer:
    def test_kill_connections_counts_and_endpoint_survives(self):
        with WorkerServer() as srv:
            t = SocketTransport(srv.addr)
            t.submit(_drain_frame())
            t.recv()
            deadline = time.monotonic() + 5
            killed = 0
            while killed == 0 and time.monotonic() < deadline:
                killed = srv.kill_connections()
                time.sleep(0.01)
            assert killed == 1
            # the dropped connection surfaces as a typed error ...
            with pytest.raises(TransportError):
                t.submit(_drain_frame())
                t.recv()
            # ... and the endpoint is still up: reconnect just works
            t.submit(_drain_frame())
            assert t.recv()
            t.close()

    def test_close_is_idempotent(self):
        srv = WorkerServer()
        srv.close()
        srv.close()


# ---------------------------------------------------------------------------
# ProcessTransport leak regression
# ---------------------------------------------------------------------------


class TestProcessTransportLeak:
    def test_abandoned_transport_reaps_child(self):
        """Dropping the last reference without close() must not leak the
        daemonic worker process (``__del__`` closes it)."""
        t = ProcessTransport()
        t.submit(_drain_frame())
        t.recv()
        proc = t._proc
        assert proc.is_alive()
        del t
        gc.collect()
        proc.join(timeout=10)
        assert not proc.is_alive()

    def test_abandoned_orchestrator_leaves_no_children(self):
        """End to end: run a remote round over process workers, abandon
        the orchestrator without close(), and verify no child process
        survives collection."""
        before = {p.pid for p in multiprocessing.active_children()}
        orch = _make_system(shards=2, plan_mode="remote", transport="process")
        _submit_workload(orch, seed=3, tasks=["heavy"], n=12)
        orch.run()
        del orch
        gc.collect()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            leaked = {
                p.pid for p in multiprocessing.active_children()
            } - before
            if not leaked:
                break
            time.sleep(0.05)
        assert not leaked

    def test_atexit_sweep_closes_stragglers(self):
        t = ProcessTransport()
        t.submit(_drain_frame())
        t.recv()
        proc = t._proc
        _sweep_process_transports()
        proc.join(timeout=10)
        assert not proc.is_alive()
        t.close()  # still idempotent after the sweep


# ---------------------------------------------------------------------------
# chaos plans
# ---------------------------------------------------------------------------


class _CountingInner:
    """Minimal in-memory transport standing in for a worker."""

    def __init__(self, log):
        self.log = log
        log.append("new")

    def submit(self, request):
        self.log.append("submit")
        self._last = request

    def recv(self):
        self.log.append("recv")
        return b"ok"

    def close(self):
        self.log.append("close")


class TestChaosTransport:
    def test_drop_submit_raises_and_rebuilds(self):
        log = []
        t = ChaosTransport(lambda: _CountingInner(log), schedule={0: "drop_submit"})
        with pytest.raises(TransportError) as ei:
            t.submit(b"a")
        assert ei.value.code == "reset"
        t.submit(b"b")  # index 1: clean
        assert t.recv() == b"ok"
        assert t.plan.faults_fired == 1
        assert log.count("new") == 2  # rebuilt after the fault

    def test_drop_recv_and_truncate_fire_at_recv(self):
        log = []
        t = ChaosTransport(
            lambda: _CountingInner(log), schedule={0: "drop_recv", 1: "truncate"}
        )
        t.submit(b"a")
        with pytest.raises(TransportError) as ei:
            t.recv()
        assert ei.value.code == "reset"
        t.submit(b"b")
        with pytest.raises(TransportError) as ei:
            t.recv()
        assert ei.value.code == "truncated_frame"
        assert t.plan.faults_fired == 2

    def test_amnesia_is_silent(self):
        log = []
        t = ChaosTransport(lambda: _CountingInner(log), schedule={1: "amnesia"})
        t.submit(b"a")
        assert t.recv() == b"ok"
        t.submit(b"b")  # amnesia: no error, but a fresh inner
        assert t.recv() == b"ok"
        assert log.count("new") == 2
        assert t.plan.faults_fired == 1

    def test_plan_survives_transport_rebuild(self):
        """The whole point of ChaosPlan: a client that recreates the
        transport must not restart the request counter or re-arm
        already-fired faults."""
        log = []
        plan = ChaosPlan({0: "drop_submit", 2: "drop_recv"})
        t1 = ChaosTransport(lambda: _CountingInner(log), plan=plan)
        with pytest.raises(TransportError):
            t1.submit(b"a")  # index 0 fires
        t1.close()
        t2 = ChaosTransport(lambda: _CountingInner(log), plan=plan)
        t2.submit(b"b")  # index 1: clean — NOT a replay of index 0
        assert t2.recv() == b"ok"
        t2.submit(b"c")  # index 2 fires at recv
        with pytest.raises(TransportError):
            t2.recv()
        assert plan.requests == 3
        assert plan.faults_fired == 2

    def test_chaos_fleet_shares_plans(self):
        fac = chaos_fleet(lambda i: _CountingInner([]), {0: {0: "drop_submit"}})
        t = fac(0)
        with pytest.raises(TransportError):
            t.submit(b"a")
        t2 = fac(0)  # rebuild: same plan object
        assert t2.plan is t.plan
        assert fac.plans[0].faults_fired == 1


# ---------------------------------------------------------------------------
# equivalence under fire: the storm rails
# ---------------------------------------------------------------------------

STORM_SEEDS = list(range(8))
KILL_TIMES = (0.5, 1.5, 2.5, 4.0, 6.0, 8.0)

# per-seed wire summaries, filled by the parametrized storm test and
# audited in aggregate afterwards (whether a given seed's rounds
# interleave with the virtual-time kills depends on its workload shape,
# so the losses/reconnects floor is a storm-wide property)
_storm_summaries = {}


class TestKillRestartStorm:
    """The acceptance rail: 8 seeds of kill/restart/reconnect storms
    over real TCP sockets, every launch trace bit-identical to serial,
    zero lost or doubled launches."""

    @pytest.mark.parametrize("seed", STORM_SEEDS)
    def test_kill_storm_trace_identical_to_serial(self, seed):
        serial = _run_serial(seed)
        with WorkerServer() as srv:
            kills = [(t, srv.kill_connections) for t in KILL_TIMES]
            trace, summary = _run_socket(
                seed, socket_fleet([srv.addr]), kills=kills
            )
        assert trace == serial
        # zero lost / doubled launches
        uids = [(r[0], r[1], r[2]) for r in trace]
        assert len(uids) == len(set(uids)) == len(serial)
        _storm_summaries[seed] = summary

    def test_storm_actually_stormed(self):
        """Across the 8 seeds the kills really interleaved with rounds:
        workers were lost, clients reconnected, partitions fell back
        inline — the identical traces above were earned, not vacuous."""
        assert len(_storm_summaries) == len(STORM_SEEDS)
        losses = sum(s["worker_losses"] for s in _storm_summaries.values())
        reconnects = sum(s["reconnects"] for s in _storm_summaries.values())
        inline = sum(s["inline_parts"] for s in _storm_summaries.values())
        assert losses >= 8
        assert reconnects >= 4
        assert inline >= losses  # every loss fell back inline

    def test_clean_socket_round_matches_serial(self):
        serial = _run_serial(99)
        with WorkerServer() as srv:
            trace, summary = _run_socket(99, socket_fleet([srv.addr]))
        assert trace == serial
        assert summary["worker_losses"] == 0
        assert summary["rounds"] > 0

    def test_two_server_fleet_matches_serial(self):
        serial = _run_serial(41)
        with WorkerServer() as a, WorkerServer() as b:
            trace, summary = _run_socket(41, socket_fleet([a.addr, b.addr]))
        assert trace == serial

    def test_dead_fleet_runs_entirely_inline(self):
        """Every worker unreachable: all partitions fall back to inline
        planning, the run still completes, trace still identical."""
        serial = _run_serial(17)
        fac = socket_fleet([("127.0.0.1", _free_port())], connect_timeout=0.5)
        trace, summary = _run_socket(17, fac)
        assert trace == serial
        assert summary["worker_losses"] >= 1
        assert summary["inline_parts"] >= 1
        assert summary["reconnects"] == 0  # it never came back


class TestChaosStorm:
    """Packet-level fault schedules over real sockets."""

    def test_amnesia_storm_drives_full_resend_rail(self):
        """Silent worker replacement must surface as typed stale-state
        errors absorbed by the full-resend rail — NOT worker losses."""
        serial = _run_serial(11, n=80)
        with WorkerServer() as srv:
            fac = chaos_fleet(
                lambda i: SocketTransport(srv.addr),
                {0: {2: "amnesia", 5: "amnesia"}, 1: {3: "amnesia"}, 2: {1: "amnesia"}},
            )
            trace, summary = _run_socket(11, fac, n=80)
        assert trace == serial
        assert summary["fallbacks"] >= 1  # stale-ref storm absorbed
        assert summary["worker_losses"] == 0

    def test_mixed_storm_trace_identical(self):
        serial = _run_serial(23, n=80)
        with WorkerServer() as srv:
            fac = chaos_fleet(
                lambda i: SocketTransport(srv.addr),
                {
                    0: {2: "drop_recv", 6: "amnesia"},
                    1: {1: "drop_submit", 5: "truncate"},
                    2: {4: "amnesia", 7: "drop_recv"},
                },
            )
            trace, summary = _run_socket(23, fac, n=80)
        assert trace == serial
        assert summary["worker_losses"] >= 1
        assert summary["reconnects"] >= 1
        uids = [(r[0], r[1], r[2]) for r in trace]
        assert len(uids) == len(set(uids))

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_seeded_chaos_storms(self, seed):
        import random

        rng = random.Random(1000 + seed)
        faults = ["drop_submit", "drop_recv", "truncate", "amnesia"]
        schedules = {
            i: {rng.randrange(1, 10): rng.choice(faults) for _ in range(2)}
            for i in range(4)
        }
        serial = _run_serial(seed, n=80)
        with WorkerServer() as srv:
            fac = chaos_fleet(lambda i: SocketTransport(srv.addr), schedules)
            trace, _summary = _run_socket(seed, fac, n=80)
        assert trace == serial


# ---------------------------------------------------------------------------
# worker-owned commit under fire: leases + two-phase over real sockets
# ---------------------------------------------------------------------------

_wc_storm_summaries = {}


class TestWorkerCommitStorm:
    """The two-phase worker-owned commit under the same kill/restart
    storms: authoritative replicas die mid-protocol, orphaned leases
    are adopted, fresh workers refuse stale epochs — and every launch
    trace stays bit-identical to serial."""

    @pytest.mark.parametrize("seed", STORM_SEEDS)
    def test_kill_storm_worker_commit_trace_identical(self, seed):
        serial = _run_serial(seed)
        with WorkerServer() as srv:
            kills = [(t, srv.kill_connections) for t in KILL_TIMES]
            trace, summary = _run_socket(
                seed, socket_fleet([srv.addr]), kills=kills,
                commit_mode="worker",
            )
        assert trace == serial
        uids = [(r[0], r[1], r[2]) for r in trace]
        assert len(uids) == len(set(uids)) == len(serial)
        _wc_storm_summaries[seed] = summary

    def test_storm_exercised_the_ownership_rails(self):
        """Across the seeds the storm really hit the two-phase rails:
        prepares happened, workers died holding leases (adoptions or
        regrants recovered them), and no round ever diverged."""
        assert len(_wc_storm_summaries) == len(STORM_SEEDS)
        agg = {}
        for s in _wc_storm_summaries.values():
            for k, v in s.items():
                agg[k] = agg.get(k, 0.0) + v
        assert agg.get("prepares", 0) > 0
        assert agg.get("worker_losses", 0) >= 1
        # every storm recovery rode a typed rail: adoption (loss) or
        # regrant (restarted worker refused a stale epoch)
        assert agg.get("lease_adoptions", 0) + agg.get("lease_regrants", 0) >= 1
        assert agg.get("commit_diverged", 0) == 0

    def test_clean_worker_commit_round_matches_serial(self):
        """Steady state over a real socket: fused rounds carry the
        commits, zero fallbacks, zero aborts, zero losses."""
        serial = _run_serial(99)
        with WorkerServer() as srv:
            trace, summary = _run_socket(
                99, socket_fleet([srv.addr]), commit_mode="worker"
            )
        assert trace == serial
        assert summary["worker_losses"] == 0
        assert summary.get("fallbacks", 0) == 0
        assert summary.get("prepares", 0) > 0
        assert summary.get("commit_aborts", 0) == 0

    def test_amnesia_storm_rides_the_stale_epoch_rail(self):
        """Silent worker replacement while leases are held: the blank
        worker must refuse the epoch assertion typed (stale_epoch ->
        regrant + full re-send), never launch doubled state."""
        serial = _run_serial(11, n=80)
        with WorkerServer() as srv:
            fac = chaos_fleet(
                lambda i: SocketTransport(srv.addr),
                {0: {2: "amnesia", 5: "amnesia"}, 1: {3: "amnesia"},
                 2: {1: "amnesia"}},
            )
            trace, summary = _run_socket(11, fac, n=80, commit_mode="worker")
        assert trace == serial
        assert summary["worker_losses"] == 0
        assert (
            summary.get("lease_regrants", 0) + summary.get("fallbacks", 0) >= 1
        )

    def test_dead_fleet_declines_to_inline(self):
        """Every worker unreachable: no worker can hold authoritative
        state, every round falls back, the run still completes with the
        serial trace."""
        serial = _run_serial(17)
        fac = socket_fleet([("127.0.0.1", _free_port())], connect_timeout=0.5)
        trace, summary = _run_socket(17, fac, commit_mode="worker")
        assert trace == serial
        assert summary["worker_losses"] >= 1

"""Socket shard transport: the multi-host leg of the control plane.

:mod:`repro_torch.core.remote` defined the byte boundary
(:class:`~repro_torch.core.remote.ShardTransport`: ``submit``/``recv``/
``close`` over opaque frames) and two local carriers — loopback and a
``multiprocessing`` pipe.  This module adds the carrier that leaves the
machine:

* :class:`SocketTransport` — one TCP connection per shard worker,
  frames length-prefixed (4-byte big-endian) around the existing
  :func:`repro_torch.core.wire.encode_frame` bytes, with connect and read
  timeouts.  Every failure mode surfaces as a typed
  :class:`~repro_torch.core.wire.TransportError` (``connect`` /
  ``read_timeout`` / ``truncated_frame`` / ``frame_too_large`` /
  ``reset`` / ``closed``) so the round client can treat worker loss
  uniformly.  The connection is lazy: constructing the transport never
  touches the network, and after any failure the connection is dropped
  so the *next* submit transparently reconnects — a fresh connection
  means a fresh worker (see below), which lands exactly on the
  existing restarted-worker recovery rail (full re-send +
  ``reset_interns``).
* :class:`WorkerServer` — the serving side: accepts connections and
  runs **one fresh** :class:`~repro_torch.core.remote.RemoteShardWorker` per
  connection on its own thread.  Binding the worker's lifetime to the
  connection is what makes reconnect semantics trivial: client-side
  state reset after a drop is always consistent with the worker it
  will reach next.  In-process (for tests and the chaos suite: kill /
  restart without port churn) or standalone via
  ``python -m repro_torch.core.transport``.
  The served worker speaks the *whole* frame surface — plan rounds,
  batched rounds, drain, and the worker-owned two-phase commit frames
  (``plan_commit`` / ``commit_decide``): a socket fleet can run
  ``commit_mode="worker"`` with no transport-level opt-in, and a
  fresh-per-connection worker holds no leases, which is exactly the
  state the coordinator's fresh-grant / ``stale_epoch`` rail expects.
* :func:`socket_fleet` — a transport factory mapping shard index →
  address, the shape :class:`~repro_torch.core.remote.RemoteRoundClient`
  accepts for multi-host fleets.
* :class:`ChaosTransport` — deterministic packet-level fault
  injection for the chaos suite: scheduled submit/recv failures
  (connection reset, mid-frame truncation) and silent worker amnesia
  (reconnect-to-fresh-worker, which the client must absorb through
  the typed stale-state errors).  Wraps any inner transport factory.

Wire format on the socket (both directions)::

    +--------------------+---------------------------+
    | length: u32 (BE)   | frame: length bytes       |
    +--------------------+---------------------------+

where *frame* is a :func:`repro_torch.core.wire.encode_frame` payload (JSON
text or the 0xB1 binary codec — self-describing, so the prefix carries
no codec bit).  A length above
:data:`repro_torch.core.wire.MAX_FRAME_BYTES` is rejected before any
allocation.  There is no shutdown frame: closing the connection is the
shutdown signal (unlike the mp-pipe transport, TCP has real EOF).
"""

from __future__ import annotations

import argparse
import socket
import struct
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import wire
from repro_torch.core.wire import TransportError

_LEN = struct.Struct(">I")

#: Defaults for the client-side socket timeouts (seconds).  Connect is
#: short — a dead host should fail fast into the inline-fallback rail;
#: read is long — it bounds a *worker plan phase*, not a network RTT.
CONNECT_TIMEOUT_S = 5.0
READ_TIMEOUT_S = 60.0


def _read_exact(sock: socket.socket, n: int, what: str) -> bytes:
    """Read exactly ``n`` bytes or raise the matching typed error."""
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(min(1 << 16, n - len(buf)))
        except socket.timeout:
            raise TransportError(
                "read_timeout", f"socket read timed out awaiting {what}"
            ) from None
        except OSError as e:
            raise TransportError("reset", f"connection lost reading {what}: {e}") from None
        if not chunk:
            raise TransportError(
                "truncated_frame",
                f"peer closed mid-{what} ({len(buf)}/{n} bytes)",
            )
        buf += chunk
    return bytes(buf)


def read_frame(sock: socket.socket, what: str = "frame") -> bytes:
    """Read one length-prefixed frame; typed errors on every failure."""
    header = _read_exact(sock, _LEN.size, f"{what} header")
    (n,) = _LEN.unpack(header)
    if n > wire.MAX_FRAME_BYTES:
        raise TransportError(
            "frame_too_large",
            f"{what} length {n} exceeds MAX_FRAME_BYTES {wire.MAX_FRAME_BYTES}",
        )
    if n == 0:
        raise TransportError("truncated_frame", f"zero-length {what}")
    return _read_exact(sock, n, what)


def write_frame(sock: socket.socket, blob: bytes, what: str = "frame") -> None:
    """Write one length-prefixed frame; typed errors on every failure."""
    if len(blob) > wire.MAX_FRAME_BYTES:
        raise TransportError(
            "frame_too_large",
            f"{what} length {len(blob)} exceeds MAX_FRAME_BYTES {wire.MAX_FRAME_BYTES}",
        )
    try:
        sock.sendall(_LEN.pack(len(blob)) + blob)
    except socket.timeout:
        raise TransportError("read_timeout", f"socket send timed out on {what}") from None
    except OSError as e:
        raise TransportError("reset", f"connection lost sending {what}: {e}") from None


class SocketTransport:
    """One shard worker over one TCP connection (lazy, reconnecting).

    Implements the :class:`~repro_torch.core.remote.ShardTransport` contract
    (single in-flight request: ``submit`` then ``recv``).  The
    connection is established on first use; any transport failure drops
    it, so the next ``submit`` reconnects — reaching a *fresh* worker
    on a :class:`WorkerServer` (worker-per-connection), which the round
    client's reset/full-resend rail absorbs.  ``close()`` is idempotent
    and thread-safe: closing from another thread while a ``recv`` is
    blocked shuts the socket down, waking the reader with a typed
    error (the concurrent-close contract the round client relies on
    during teardown)."""

    def __init__(
        self,
        addr: Tuple[str, int],
        connect_timeout: float = CONNECT_TIMEOUT_S,
        read_timeout: float = READ_TIMEOUT_S,
    ) -> None:
        self.addr = (addr[0], int(addr[1]))
        self.connect_timeout = connect_timeout
        self.read_timeout = read_timeout
        self._sock: Optional[socket.socket] = None
        self._closed = False
        self._lock = threading.Lock()

    # -- ShardTransport contract ---------------------------------------
    def submit(self, request: bytes) -> None:
        blob = request.encode("utf-8") if isinstance(request, str) else request
        sock = self._connect()
        try:
            write_frame(sock, blob, "request")
        except TransportError:
            self.reset()
            raise

    def recv(self) -> bytes:
        sock = self._sock
        if sock is None:
            raise TransportError("closed", "recv() without a live connection")
        try:
            return read_frame(sock, "response")
        except TransportError:
            self.reset()
            raise

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self.reset()

    def __enter__(self) -> "SocketTransport":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- connection management -----------------------------------------
    def _connect(self) -> socket.socket:
        with self._lock:
            if self._closed:
                raise TransportError("closed", "transport already closed")
            if self._sock is not None:
                return self._sock
            try:
                sock = socket.create_connection(self.addr, timeout=self.connect_timeout)
            except OSError as e:
                raise TransportError(
                    "connect", f"cannot reach shard worker at {self.addr}: {e}"
                ) from None
            sock.settimeout(self.read_timeout)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:  # pragma: no cover - exotic stacks
                pass
            self._sock = sock
            return sock

    def reset(self) -> None:
        """Drop the current connection (the transport stays usable: the
        next ``submit`` reconnects unless closed).  Safe to call from
        another thread — a reader blocked in ``recv`` wakes with a
        typed error."""
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass


def socket_fleet(
    addrs: Sequence[Tuple[str, int]],
    connect_timeout: float = CONNECT_TIMEOUT_S,
    read_timeout: float = READ_TIMEOUT_S,
) -> Callable[[int], SocketTransport]:
    """Transport factory for a worker fleet: shard index *i* connects to
    ``addrs[i % len(addrs)]``.  Pass the returned callable as the
    orchestrator's ``transport``."""
    if not addrs:
        raise ValueError("socket_fleet: need at least one worker address")
    fixed = [(h, int(p)) for h, p in addrs]

    def factory(shard_idx: int) -> SocketTransport:
        return SocketTransport(
            fixed[shard_idx % len(fixed)],
            connect_timeout=connect_timeout,
            read_timeout=read_timeout,
        )

    return factory


# ---------------------------------------------------------------------------
# the serving side
# ---------------------------------------------------------------------------


def serve_connection(conn: socket.socket, plan_delay_s: float = 0.0) -> None:
    """Serve one connection with one fresh worker until EOF.

    The worker's entire cache state (intern table, snapshot bases,
    resident replicas) lives and dies with the connection — a
    reconnecting client always faces a blank worker, which its
    reset/full-resend rail expects.  ``plan_delay_s`` marks the worker
    a plan-phase straggler (scenario fault injection — see
    :class:`repro_torch.core.remote.RemoteShardWorker`)."""
    from repro_torch.core.remote import RemoteShardWorker

    worker = RemoteShardWorker(plan_delay_s=plan_delay_s)
    try:
        while True:
            try:
                request = read_frame(conn, "request")
            except TransportError:
                return  # client went away (EOF, reset, oversized garbage)
            write_frame(conn, worker.handle_bytes(request), "response")
    except TransportError:  # pragma: no cover - client died mid-response
        return
    finally:
        try:
            conn.close()
        except OSError:
            pass


class WorkerServer:
    """A shard-worker endpoint: accept loop + one worker thread per
    connection.  ``port=0`` binds an ephemeral port (read ``.port``).

    ``kill_connections()`` hard-drops every live connection — the
    chaos suite's "worker died" lever: each connection IS a worker, so
    dropping it kills the worker while the endpoint stays up for the
    client's reconnect (no port churn, deterministic under the DES
    harness)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 plan_delay_s: float = 0.0) -> None:
        # per-endpoint straggler injection: every worker served from
        # this endpoint inflates its per-partition plan wall (the
        # scenario fault schedule's remote-path straggler lever)
        self.plan_delay_s = plan_delay_s
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(64)
        self._srv = srv
        self.host, self.port = srv.getsockname()[:2]
        self._closed = False
        self._conns: List[socket.socket] = []
        self._lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._accept = threading.Thread(
            target=self._accept_loop, name=f"shard-srv-{self.port}", daemon=True
        )
        self._accept.start()

    @property
    def addr(self) -> Tuple[str, int]:
        return (self.host, self.port)

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _peer = self._srv.accept()
            except OSError:
                return  # listening socket closed
            with self._lock:
                if self._closed:
                    try:
                        conn.close()
                    except OSError:
                        pass
                    return
                self._conns.append(conn)
                self._conns = [c for c in self._conns if c.fileno() != -1]
            t = threading.Thread(
                target=serve_connection, args=(conn, self.plan_delay_s),
                daemon=True,
            )
            t.start()
            self._threads.append(t)

    def kill_connections(self) -> int:
        """Drop every live worker connection (leaves the endpoint up);
        returns the number of connections killed."""
        with self._lock:
            conns, self._conns = self._conns, []
        killed = 0
        for c in conns:
            if c.fileno() == -1:
                continue
            killed += 1
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        return killed

    def close(self) -> None:
        """Stop accepting, drop live connections, join worker threads."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        try:
            self._srv.close()
        except OSError:
            pass
        self.kill_connections()
        for t in self._threads:
            t.join(timeout=2)
        self._accept.join(timeout=2)

    def __enter__(self) -> "WorkerServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# deterministic fault injection (the chaos suite's packet-level lever)
# ---------------------------------------------------------------------------


class ChaosPlan:
    """One worker's fault plan, shared across transport recreations.

    ``schedule`` maps a 0-based request index to a fault name; the
    request counter lives here — NOT on the transport object — because
    the round client tears down and rebuilds a failed transport, and
    the plan must keep counting (and keep its remaining faults) across
    that rebuild for the storm to be deterministic."""

    __slots__ = ("schedule", "requests", "faults_fired")

    def __init__(self, schedule: Optional[Dict[int, str]] = None) -> None:
        self.schedule = dict(schedule or {})
        self.requests = 0
        self.faults_fired = 0


class ChaosTransport:
    """Wraps a transport with a scheduled fault plan.

    The :class:`ChaosPlan` maps a 0-based request index (counted across
    the plan's whole life, including re-sends and client-side transport
    rebuilds) to a fault:

    * ``"drop_submit"`` — the request never leaves: the inner transport
      is torn down and ``submit`` raises ``TransportError("reset")``;
    * ``"drop_recv"`` — the request is swallowed after submit: the
      inner transport is torn down and ``recv`` raises
      ``TransportError("reset")`` (worker died holding the request);
    * ``"truncate"`` — like ``drop_recv`` but surfaces as
      ``TransportError("truncated_frame")`` (peer died mid-frame);
    * ``"amnesia"`` — *silent* worker replacement before submit: the
      inner transport is recreated (fresh worker), no error raised —
      the worker answers the stale-referencing request with a typed
      ``stale_ref``/``stale_intern`` error, which the client's
      full-resend recovery rail must absorb (the stale-ref storm).

    Faults are one-shot per index, so a storm is deterministic and
    replayable; the inner transport is rebuilt via ``factory`` after
    every injected teardown.  Build fleets with :func:`chaos_fleet`."""

    def __init__(
        self,
        factory: Callable[[], object],
        plan: Optional[ChaosPlan] = None,
        schedule: Optional[Dict[int, str]] = None,
    ) -> None:
        self._factory = factory
        self._inner = factory()
        self.plan = plan if plan is not None else ChaosPlan(schedule)
        self._pending_fault: Optional[str] = None
        self._pending_idx = 0

    def _teardown(self) -> None:
        try:
            self._inner.close()
        except Exception:  # noqa: BLE001 - already failing
            pass
        self._inner = self._factory()

    def submit(self, request: bytes) -> None:
        plan = self.plan
        idx = plan.requests
        plan.requests += 1
        fault = plan.schedule.pop(idx, None)
        if fault == "amnesia":
            plan.faults_fired += 1
            self._teardown()
            fault = None
        elif fault == "drop_submit":
            plan.faults_fired += 1
            self._teardown()
            raise TransportError("reset", f"chaos: request {idx} dropped at submit")
        self._pending_fault = fault
        self._pending_idx = idx
        self._inner.submit(request)

    def recv(self) -> bytes:
        fault, self._pending_fault = self._pending_fault, None
        if fault is not None:
            self.plan.faults_fired += 1
            self._teardown()
            if fault == "truncate":
                raise TransportError(
                    "truncated_frame",
                    f"chaos: response {self._pending_idx} truncated mid-frame",
                )
            raise TransportError(
                "reset", f"chaos: response {self._pending_idx} dropped"
            )
        return self._inner.recv()

    def close(self) -> None:
        self._inner.close()


def chaos_fleet(
    inner_factory: Callable[[int], object],
    schedules: Dict[int, Dict[int, str]],
) -> Callable[[int], ChaosTransport]:
    """A chaos-wrapped transport factory for the round client.

    ``schedules`` maps shard index → fault plan (see
    :class:`ChaosTransport`).  Each shard's :class:`ChaosPlan` is
    created once and survives client-side transport rebuilds, so the
    storm stays deterministic end to end.  The returned factory exposes
    the live plans as ``factory.plans`` (shard → :class:`ChaosPlan`)
    for assertions on faults fired."""
    plans: Dict[int, ChaosPlan] = {
        i: ChaosPlan(sched) for i, sched in schedules.items()
    }

    def factory(shard_idx: int) -> ChaosTransport:
        plan = plans.setdefault(shard_idx, ChaosPlan())
        return ChaosTransport(lambda: inner_factory(shard_idx), plan=plan)

    factory.plans = plans  # type: ignore[attr-defined]
    return factory


# ---------------------------------------------------------------------------
# standalone entrypoint: python -m repro_torch.core.transport
# ---------------------------------------------------------------------------


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Serve shard workers on a TCP endpoint until interrupted.

    Prints ``PORT <n>`` (flushed) once listening — a launcher binding
    port 0 reads the actual port from the first stdout line."""
    parser = argparse.ArgumentParser(
        description="Serve ARL-Tangram shard plan workers over TCP"
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0, help="0 = ephemeral")
    args = parser.parse_args(argv)
    server = WorkerServer(args.host, args.port)
    print(f"PORT {server.port}", flush=True)
    try:
        threading.Event().wait()  # serve until killed
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    raise SystemExit(main())

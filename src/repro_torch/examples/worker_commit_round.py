"""Worker-owned two-phase commit over TCP, with a forced conflict and
a mid-run ownership fence (abort + retry).

Torch twin of ``examples/worker_commit_round.py``: its worker processes are
``python -m repro_torch.core.transport``.

Launches one standalone shard-worker process (``python -m repro_torch.core.transport``)
and runs the contender workload with ``commit_mode="worker"``: the
worker holds the *authoritative* manager replicas under epoch-stamped
ownership leases, plans AND commits each round on its own state, and the
client confirms or aborts the intent on the next frame (two-phase
prepare -> intent/ack -> commit|abort, fused into ``plan_commit``
frames).

Two things are forced to go wrong, on purpose:

* **conflict** — every contender claims 2 units of the 2-unit
  ``shared`` pool, so each round's plans over-claim it; the worker
  resolves the loser on its authoritative replicas (rolls the launch
  back via ``release_unlaunched``) and the next pass retries — the
  client never arbitrates;
* **abort/retry** — a lease fence mid-run (what ``migrate_task`` or a
  rebalance issues before moving ownership) aborts the open commit
  intent with an explicit ``commit_decide`` frame and revokes the
  leases; the next round re-grants fresh epochs and retries.

Both runs must end with a launch trace bit-identical to the serial
round loop — conflicts and fences cost wire frames, never correctness.

docs/architecture.md and docs/wire-protocol.md describe each moving part.

Run:  PYTHONPATH=src python -m repro_torch.examples.worker_commit_round
"""

import os
import subprocess
import sys
from pathlib import Path

from repro_torch.core import wire
from repro_torch.core.action import Action, fixed
from repro_torch.core.managers.base import ResourceManager
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.simulator import EventLoop
from repro_torch.core.transport import SocketTransport, socket_fleet

SRC = Path(__file__).resolve().parents[2]  # the directory holding repro_torch


class FenceMidPrepare:
    """Shard-transport wrapper that fences ownership while the prepare
    window is OPEN: once armed, the next in-flight ``plan_commit``
    frame triggers a full lease fence before its ack is read — the
    worst-case handoff timing (``migrate_task``/``rebalance`` racing a
    live two-phase round).  The fenced intent must be aborted, never
    adopted."""

    def __init__(self, inner, state):
        self._inner = inner
        self._state = state  # {"orch": Orchestrator|None, "armed": bool}
        self._last_kind = None

    def submit(self, request):
        try:
            payload = wire.decode_frame(request)
            self._last_kind = (
                payload.get("kind") if isinstance(payload, dict) else None
            )
        except wire.WireError:
            self._last_kind = None
        self._inner.submit(request)

    def recv(self):
        st = self._state
        if (st.get("armed") and self._last_kind == "plan_commit"
                and st.get("orch") is not None):
            st["armed"] = False
            st["orch"]._commit_engine.fence()
        return self._inner.recv()

    def close(self):
        self._inner.close()


def spawn_worker() -> subprocess.Popen:
    """One standalone worker endpoint (``python -m repro_torch.core.transport``);
    reads its ephemeral port from the ``PORT <n>`` line it prints once
    listening."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(SRC), os.environ.get("PYTHONPATH")) if p)}
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.core.transport", "--port", "0"],
        stdout=subprocess.PIPE, text=True, env=env,
    )


def worker_port(proc: subprocess.Popen) -> int:
    line = proc.stdout.readline().strip()
    assert line.startswith("PORT "), f"unexpected worker banner: {line!r}"
    return int(line.split()[1])


def build(**kw) -> Orchestrator:
    managers = {
        "a": ResourceManager("a", 4),
        "b": ResourceManager("b", 4),
        "shared": ResourceManager("shared", 2),
    }
    return Orchestrator(managers, loop=EventLoop(), **kw)


def submit_contenders(orch: Orchestrator, n: int = 18) -> None:
    """Waves of contenders: every action needs its home pool plus BOTH
    units of the 2-unit shared pool, so concurrent per-partition plans
    over-claim ``shared`` every round and commit must arbitrate."""
    for i in range(n):
        part = "a" if i % 2 == 0 else "b"
        orch.submit(
            Action(
                name=f"{part}{i}",
                cost={part: fixed(part, 1), "shared": fixed("shared", 2)},
                key_resource=part,
                base_duration=1.0 + 0.25 * (i % 3),
                trajectory_id=f"t{i}",
            ),
            delay=0.5 * (i // 6),
        )


def trace(orch: Orchestrator):
    return sorted(
        (r.name, r.trajectory_id, round(r.submit, 9), round(r.start, 9),
         round(r.finish, 9), tuple(sorted(r.units.items())))
        for r in orch.telemetry.records if not r.failed
    )


def main() -> None:
    print("== serial baseline (client-side managers, serial commit)")
    serial = build()
    submit_contenders(serial)
    serial.run()
    serial_trace = trace(serial)
    print(f"   completed={len(serial_trace)}  "
          f"mean ACT={serial.telemetry.mean_act():.3f}s")
    serial.close()

    proc = spawn_worker()
    try:
        addr = ("127.0.0.1", worker_port(proc))
        print(f"\n== worker-owned commit (authoritative replicas on :{addr[1]})")
        orch = build(shards=1, plan_mode="remote",
                     transport=socket_fleet([addr]), commit_mode="worker")
        submit_contenders(orch)
        orch.run()
        w = orch.telemetry.wire_summary()
        conflict_trace = trace(orch)
        print(f"   completed={len(conflict_trace)}  "
              f"prepares={w['prepares']:.0f}  acks={w['commit_acks']:.0f}  "
              f"lease grants={w['lease_grants']:.0f}")
        print(f"   conflicts resolved worker-side="
              f"{orch.telemetry.commit_conflicts}  "
              f"(client-serial commit walk never ran: "
              f"{orch.telemetry.commit_wall_s * 1e3:.2f}ms)")
        assert orch.telemetry.commit_conflicts > 0, "no conflict was forced?"
        orch.close()

        print("\n== same run + a lease fence mid-prepare (abort, then retry)")
        state = {"orch": None, "armed": False}
        orch = build(
            shards=1, plan_mode="remote", commit_mode="worker",
            transport=lambda i: FenceMidPrepare(SocketTransport(addr), state),
        )
        state["orch"] = orch
        submit_contenders(orch)
        # virtual time 1.25: arm the fence.  The next round's plan_commit
        # frame is answered with its intent already fenced — exactly what
        # an ownership handoff (migrate_task / rebalance) issues before
        # moving state.  The ack is discarded, the worker rolls back to
        # its pre-round replicas on an explicit commit_decide abort, the
        # leases are revoked, and the next round re-grants fresh epochs
        # and retries — the abort/retry rail.
        orch.loop.call_after(1.25, lambda: state.update(armed=True))
        orch.run()
        w = orch.telemetry.wire_summary()
        fenced_trace = trace(orch)
        print(f"   completed={len(fenced_trace)}  "
              f"fenced intents={w['fenced_intents']:.0f}  "
              f"aborts={w['commit_aborts']:.0f}  "
              f"lease grants={w['lease_grants']:.0f} "
              f"(re-granted after the fence)")
        assert w["fenced_intents"] >= 1, "the fence caught no open intent?"
        assert w["commit_aborts"] >= 1, "the fenced intent was not aborted?"
        orch.close()
    finally:
        proc.kill()
        proc.wait(timeout=10)

    assert conflict_trace == serial_trace, "conflict run diverged from serial!"
    assert fenced_trace == serial_trace, "fenced run diverged from serial!"
    print("\n== launch traces bit-identical to serial — conflict, fence, and all")


if __name__ == "__main__":
    main()

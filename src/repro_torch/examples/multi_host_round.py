"""Multi-host plan rounds over TCP, with a worker killed mid-run.

Torch twin of ``examples/multi_host_round.py``: its worker processes are
``python -m repro_torch.core.transport``.

Launches two standalone shard-worker processes (in production these run
on other machines), plans the fleet-churn workload over a
:func:`repro_torch.core.transport.socket_fleet` spanning both,
and **kills one worker halfway through**.  The orchestrator notes the
loss, plans that worker's partitions inline for the round, and keeps
retrying the endpoint with bounded backoff; the run completes with a
launch trace bit-identical to the serial round loop — fault tolerance
costs wire time, never correctness.

docs/architecture.md and docs/wire-protocol.md describe each moving part.

Run:  PYTHONPATH=src python -m repro_torch.examples.multi_host_round
"""

import os
import subprocess
import sys
from pathlib import Path

from repro_torch.core.action import Action, AmdahlElasticity, ResourceRequest, fixed
from repro_torch.core.managers.base import ResourceManager
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.simulator import EventLoop
from repro_torch.core.transport import socket_fleet

POOLS = 4
SRC = Path(__file__).resolve().parents[2]  # the directory holding repro_torch


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


def build(shards=None, **kw):
    loop = EventLoop()
    managers = {f"pool{k}": ResourceManager(f"pool{k}", 4) for k in range(POOLS)}
    return Orchestrator(managers, loop=loop, shards=shards, **kw)


def submit_workload(orch):
    for i in range(64):
        pool = f"pool{i % POOLS}"
        if i % 2:
            a = Action(
                name="reward", cost={pool: ResourceRequest(pool, (1, 2, 4))},
                key_resource=pool, elasticity=AmdahlElasticity(0.08),
                base_duration=2.0 + 0.25 * (i % 5), trajectory_id=f"t{i}",
            )
        else:
            a = Action(
                name="tool", cost={pool: fixed(pool, 1)},
                base_duration=0.5 + 0.1 * (i % 3), trajectory_id=f"t{i}",
            )
        orch.submit(a, delay=0.75 * (i // 8))


def trace(orch):
    return sorted(
        (r.name, r.trajectory_id, round(r.submit, 9), round(r.start, 9),
         round(r.finish, 9), tuple(sorted(r.units.items())))
        for r in orch.telemetry.records if not r.failed
    )


def main():
    print("== serial baseline (shards=None)")
    serial = build()
    submit_workload(serial)
    serial.run()
    serial_trace = trace(serial)
    print(f"   completed={len(serial_trace)}  mean ACT={serial.telemetry.mean_act():.3f}s")
    serial.close()

    print("\n== two worker processes over localhost TCP")
    a, b = spawn_worker(), spawn_worker()
    try:
        addrs = [("127.0.0.1", worker_port(a)), ("127.0.0.1", worker_port(b))]
        print(f"   workers listening on {addrs[0][1]} and {addrs[1][1]}")
        orch = build(shards=2, plan_mode="remote", transport=socket_fleet(addrs))
        submit_workload(orch)
        # virtual time 4.0: hard-kill worker B mid-run.  Its shard falls
        # back to inline planning (the plan core is shared, so plans are
        # identical) and the client backs off reconnect attempts on the
        # dead endpoint in rounds, not wall time.
        orch.loop.call_after(4.0, b.kill)
        orch.run()
        remote_trace = trace(orch)
        w = orch.telemetry.wire_summary()
        print(f"   completed={len(remote_trace)}  mean ACT={orch.telemetry.mean_act():.3f}s")
        print(f"   wire rounds={w['rounds']:.0f}  worker losses={w['worker_losses']:.0f}  "
              f"reconnects={w['reconnects']:.0f}  inline fallback parts={w['inline_parts']:.0f}")
        orch.close()
    finally:
        for proc in (a, b):
            proc.kill()
            proc.wait(timeout=10)

    assert remote_trace == serial_trace, "multi-host trace diverged from serial!"
    print("\n== launch traces bit-identical to serial, worker death and all")


if __name__ == "__main__":
    main()

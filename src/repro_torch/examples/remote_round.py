"""One remote plan/commit round, end to end.

Runs the same mixed workload through three control planes —

1. the serial round loop (``shards=None``),
2. out-of-process planning over the full wire codec path
   (``plan_mode="remote"``, loopback transport), and
3. real worker OS processes (``transport="process"``),

then proves the launch traces are bit-identical and prints the honest
accounting: modeled critical-path decision latency next to (never mixed
with) the measured serialization overhead.  Finishes with a live
sub-queue migration between partition replicas.

Torch twin of ``examples/remote_round.py``.  ``--start-method`` picks how
the worker processes start (``spawn`` where the parent holds a CUDA
context); by default, as in the reference, ``fork`` where there is one.
docs/architecture.md and docs/wire-protocol.md describe each moving part.

Run:  PYTHONPATH=src python -m repro_torch.examples.remote_round
"""

import argparse
from typing import Dict, Optional, Sequence

from repro_torch.core.action import Action, AmdahlElasticity, ResourceRequest, fixed
from repro_torch.core.fairqueue import FairSharePolicy
from repro_torch.core.managers.base import ResourceManager
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.remote import ProcessTransport
from repro_torch.core.simulator import EventLoop

POOLS = 4


def build(shards=None, **kw):
    loop = EventLoop()
    managers = {f"pool{k}": ResourceManager(f"pool{k}", 4) for k in range(POOLS)}
    fs = FairSharePolicy(weights={"heavy": 2.0, "light": 1.0})
    return Orchestrator(managers, loop=loop, fair_share=fs, shards=shards, **kw)


def submit_workload(orch):
    futs = []
    for i in range(48):
        pool = f"pool{i % POOLS}"
        task = "heavy" if i % 3 else "light"
        if i % 2:
            a = Action(
                name="reward", cost={pool: ResourceRequest(pool, (1, 2, 4))},
                key_resource=pool, elasticity=AmdahlElasticity(0.08),
                base_duration=2.0 + 0.25 * (i % 5), task_id=task,
                trajectory_id=f"t{i}",
            )
        else:
            a = Action(
                name="tool", cost={pool: fixed(pool, 1)},
                base_duration=0.5 + 0.1 * (i % 3), task_id=task,
                trajectory_id=f"t{i}",
            )
        # wave arrivals: batches land on every pool at one timestamp, so
        # rounds are genuinely multi-partition and the plan phase shards
        futs.append(orch.submit(a, delay=0.5 * (i // 8)))
    return futs


def trace(orch):
    return sorted(
        (r.name, r.task_id, r.trajectory_id, round(r.submit, 9),
         round(r.start, 9), round(r.finish, 9),
         tuple(sorted(r.units.items())))
        for r in orch.telemetry.records if not r.failed
    )


def run(label, **kw):
    orch = build(**kw)
    futs = submit_workload(orch)
    orch.run()
    assert all(f.done() for f in futs)
    t = orch.telemetry
    print(f"\n== {label}")
    print(f"   completed={len(t.records)}  mean ACT={t.mean_act():.3f}s  "
          f"rounds={orch.stats['rounds']} (sharded={orch.stats['sharded_rounds']})")
    if t.wire_rounds:
        w = t.wire_summary()
        print(f"   critical-path plan: {t.plan_critical_s * 1e3:.2f} ms total")
        print(f"   wire overhead (separate!): encode {w['encode_s'] * 1e3:.2f} ms, "
              f"decode {w['decode_s'] * 1e3:.2f} ms, "
              f"{w['bytes'] / 1024:.0f} KiB over {t.wire_rounds:.0f} rounds")
    orch.close()
    return trace(orch), (t.wire_summary()["bytes"] if t.wire_rounds else 0)


def demo_migration():
    print("\n== sub-queue migration (pool0 -> pool1 replica)")
    orch = build()
    # pile both tenants' backlog onto pool0; pool1..3 idle
    for i in range(16):
        task = "heavy" if i % 2 else "light"
        orch.submit(Action(
            name="tool", cost={"pool0": fixed("pool0", 1)}, base_duration=1.0,
            task_id=task, trajectory_id=f"m{i}",
        ))
    orch.run(until=0.01)
    depths = lambda: {p: len(orch._queues.get(p) or ()) for p in ("pool0", "pool1")}
    print(f"   before: depths={depths()}")
    moved = orch.rebalance(["pool0", "pool1"])
    print(f"   rebalance moved {moved} queued action(s) "
          f"({orch.telemetry.migrations} migration(s), "
          f"{orch.telemetry.migration_wall_s * 1e6:.0f} us control-plane cost)")
    print(f"   after:  depths={depths()}")
    orch.run()
    pools = {p for r in orch.telemetry.records for p in r.units}
    print(f"   drained on pools: {sorted(pools)}  "
          f"(WFQ tags + virtual clock carried by the TaskShard)")


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """The three modes, asserted equal; returns each mode's wire bytes."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--start-method", choices=("fork", "spawn", "forkserver"), default=None)
    args = ap.parse_args(argv)
    process_transport = (
        "process" if args.start_method is None
        else lambda: ProcessTransport(start_method=args.start_method)
    )
    serial, serial_b = run("serial round loop (shards=None)")
    loopback, loopback_b = run("remote plans, loopback wire (shards=2)",
                               shards=2, plan_mode="remote")
    process, process_b = run(
        f"remote plans, worker processes (shards=2, {args.start_method or 'default'} start)",
        shards=2, plan_mode="remote", transport=process_transport)
    assert loopback == serial, "loopback remote trace diverged!"
    assert process == serial, "process remote trace diverged!"
    print("\n== launch traces: serial == loopback == process  (bit-identical)")
    demo_migration()
    return {"serial": serial_b, "loopback": loopback_b, "process": process_b}

if __name__ == "__main__":
    main()

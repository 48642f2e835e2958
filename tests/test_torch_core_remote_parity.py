"""The port's remote half of the control plane against ``repro.core``, with no
tolerance.

* the same plan rounds encode to byte-identical request frames in both
  packages, in both codecs;
* each package's round client is served by the *other* package's shard
  worker through a transport that only passes bytes, and launches exactly
  what the serial round loop launches;
* ``compile_scenario`` compiles equal streams in both packages, and their
  sim runs give equal ``structural_trace``s;
* the port's live mode on CPU lanes (the plain RMSNorm as payload)
  reproduces the sim's structural trace and the reference's live run with
  sleep payloads;
* the port's dense DP scan (``backend="torch"``, here on the CPU) equals the
  reference's ``backend="jax"`` and the NumPy path bit for bit.
"""

from __future__ import annotations

import itertools
import random

import pytest

import repro.core.action as j_action
import repro.core.cluster as j_cluster
import repro.core.dparrange as j_dp
import repro.core.live as j_live
import repro.core.managers.basic as j_basic
import repro.core.managers.cpu as j_cpu
import repro.core.managers.gpu as j_gpu
import repro.core.orchestrator as j_orch
import repro.core.remote as j_remote
import repro.core.scenarios as j_scen
import repro.core.scheduler as j_sched
import repro.core.simulator as j_sim
import repro_torch.core.action as t_action
import repro_torch.core.cluster as t_cluster
import repro_torch.core.dparrange as t_dp
import repro_torch.core.live as t_live
import repro_torch.core.managers.basic as t_basic
import repro_torch.core.managers.cpu as t_cpu
import repro_torch.core.managers.gpu as t_gpu
import repro_torch.core.orchestrator as t_orch
import repro_torch.core.remote as t_remote
import repro_torch.core.scenarios as t_scen
import repro_torch.core.scheduler as t_sched
import repro_torch.core.simulator as t_sim

# one namespace per package, so each workload is written once
JAX_SIDE = dict(action=j_action, cluster=j_cluster, basic=j_basic, cpu=j_cpu, gpu=j_gpu,
                orch=j_orch, remote=j_remote, sim=j_sim, scen=j_scen, sched=j_sched)
PORT = dict(action=t_action, cluster=t_cluster, basic=t_basic, cpu=t_cpu, gpu=t_gpu,
            orch=t_orch, remote=t_remote, sim=t_sim, scen=t_scen, sched=t_sched)
SIDES = (JAX_SIDE, PORT)


@pytest.fixture(autouse=True)
def _same_uids(monkeypatch):
    """Action uids cross the wire: both packages count them from one start."""
    monkeypatch.setattr(j_action, "_ACTION_COUNTER", itertools.count(1))
    monkeypatch.setattr(t_action, "_ACTION_COUNTER", itertools.count(1))


def _restart_uids():
    j_action._ACTION_COUNTER = itertools.count(1)
    t_action._ACTION_COUNTER = itertools.count(1)


# ---------------------------------------------------------------------------
# tests/test_remote.py's mixed workload, in the package ``m``
# ---------------------------------------------------------------------------


def _make_system(m, shards=None, **kw):
    c, a = m["cluster"], m["action"]
    loop = m["sim"].EventLoop()
    managers = {
        "cpu": m["cpu"].CpuManager([c.CpuNodeSpec("n0", cores=32)]),
        "gpu": m["gpu"].GpuManager([c.GpuNodeSpec("g0")], [m["gpu"].ServiceSpec("rm0", 40.0)]),
        "api": m["basic"].BasicResourceManager(
            c.ApiResourceSpec("api", mode="quota", quota=4, period_s=5.0), loop.clock
        ),
    }
    return m["orch"].Orchestrator(managers, loop=loop, incremental=True, shards=shards, **kw)


def _submit_workload(m, orch, seed, n=60):
    a = m["action"]
    rng = random.Random(seed)
    for i in range(n):
        kind = rng.random()
        delay = rng.uniform(0.0, 5.0)
        if kind < 0.4:
            act = a.Action(name="reward", cost={"cpu": a.ranged("cpu", 1, 8)},
                           key_resource="cpu", elasticity=a.AmdahlElasticity(0.08),
                           base_duration=rng.uniform(1, 8), trajectory_id=f"t-{i}")
        elif kind < 0.6:
            act = a.Action(name="tool", cost={"cpu": a.fixed("cpu", rng.choice((1, 2)))},
                           base_duration=rng.uniform(0.2, 2.0), trajectory_id=f"t-{i}")
        elif kind < 0.8:
            act = a.Action(name="rm:score", cost={"gpu": a.ResourceRequest("gpu", (1, 2, 4, 8))},
                           key_resource="gpu", elasticity=a.AmdahlElasticity(0.15),
                           base_duration=rng.uniform(0.5, 3.0), service="rm0",
                           trajectory_id=f"t-{i}")
        else:
            act = a.Action(name="search", cost={"api": a.fixed("api")},
                           base_duration=rng.uniform(0.1, 1.0), trajectory_id=f"t-{i}")
        orch.submit(act, delay=delay)


def _trace(orch):
    return sorted(
        (r.name, r.task_id, r.trajectory_id, round(r.submit, 9), round(r.start, 9),
         round(r.finish, 9), tuple(sorted(r.units.items())), r.failed)
        for r in orch.telemetry.records
    )


def _run(m, seed, **kw):
    orch = _make_system(m, **kw)
    _submit_workload(m, orch, seed)
    orch.run()
    assert orch.queue_depth() == 0 and orch.in_flight() == 0
    orch.close()
    return _trace(orch)


class _BytesTransport:
    """A shard transport that hands request bytes to ``worker`` and its
    response bytes back, recording both; nothing else crosses."""

    def __init__(self, worker, log):
        self._worker, self._log, self._resp = worker, log, None

    def submit(self, request):
        request = request.encode("utf-8") if isinstance(request, str) else request
        self._resp = self._worker.handle_bytes(request)
        self._log.append((bytes(request), bytes(self._resp)))

    def recv(self):
        resp, self._resp = self._resp, None
        return resp

    def close(self):
        pass


def _served_by(worker_cls, log):
    return lambda shard_idx: _BytesTransport(worker_cls(), log)


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", ["json", "binary"])
@pytest.mark.parametrize("seed", [0, 1])
def test_plan_frames_byte_identical(codec, seed):
    """Every frame each package's client sends over the same rounds is the
    same bytes in both packages; the workers' answers are equal too, once
    the times each worker measured are set aside."""
    logs = []
    for m in SIDES:
        _restart_uids()
        log = []
        _run(m, seed, shards=2, plan_mode="remote", wire_codec=codec,
             transport=_served_by(m["remote"].RemoteShardWorker, log))
        logs.append(log)
    assert len(logs[0]) >= 5  # rounds really crossed the wire
    assert [req for req, _ in logs[0]] == [req for req, _ in logs[1]]
    from repro.core import wire as j_wire
    from repro_torch.core import wire as t_wire

    answers = [[repr(_unmeasured(w.decode_frame(resp))) for _, resp in log]
               for w, log in zip((j_wire, t_wire), logs)]
    assert answers[0] == answers[1]


# the seconds a worker measures with its own clock (``time.perf_counter``)
MEASURED = {"wall_s", "plan_s", "codec_s", "commit_s", "rebuild_s", "reset_s"}


def _unmeasured(payload):
    """``payload`` without the times the worker measured."""
    if isinstance(payload, dict):
        return {k: _unmeasured(v) for k, v in payload.items() if k not in MEASURED}
    if isinstance(payload, list):
        return [_unmeasured(v) for v in payload]
    return payload


def test_frames_decode_alike():
    """Each codec's frame of one plan request decodes to the same payload in
    both packages, and re-encodes to the same bytes."""
    log = []
    _run(PORT, 0, shards=2, plan_mode="remote", wire_codec="binary",
         transport=_served_by(t_remote.RemoteShardWorker, log))
    from repro.core import wire as j_wire
    from repro_torch.core import wire as t_wire

    for req, resp in log[:6]:
        for frame in (req, resp):
            pj, pt = j_wire.decode_frame(frame), t_wire.decode_frame(frame)
            assert repr(pj) == repr(pt)  # repr: a NaN is not equal to itself
            for codec in ("json", "binary"):
                assert j_wire.encode_frame(pj, codec=codec) == t_wire.encode_frame(pt, codec=codec)


# ---------------------------------------------------------------------------
# each package's client, served by the other's worker
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", ["json", "binary"])
@pytest.mark.parametrize("client,server", [(JAX_SIDE, PORT), (PORT, JAX_SIDE)],
                         ids=["reference-client", "port-client"])
def test_cross_served_rounds_launch_the_serial_trace(client, server, codec):
    serial = _run(client, 3)
    log = []
    crossed = _run(client, 3, shards=2, plan_mode="remote", wire_codec=codec,
                   transport=_served_by(server["remote"].RemoteShardWorker, log))
    assert log and crossed == serial


@pytest.mark.parametrize("client,server", [(JAX_SIDE, PORT), (PORT, JAX_SIDE)],
                         ids=["reference-client", "port-client"])
def test_cross_served_worker_commit(client, server):
    """Worker-owned commit (the worker holds the authoritative replicas)
    across the packages: the serial trace again."""
    serial = _run(client, 4)
    log = []
    crossed = _run(client, 4, shards=1, plan_mode="remote", commit_mode="worker",
                   transport=_served_by(server["remote"].RemoteShardWorker, log))
    assert log and crossed == serial


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

SCENARIOS = ["live_smoke", "fleet_churn", "chaos_storm", "straggler_fleet"]


def _sim_trace(m, compiled):
    s = m["scen"]
    spec = compiled.spec
    loop = m["sim"].EventLoop()
    orch = m["orch"].Orchestrator(
        s.build_managers(spec, loop), loop=loop, policy=m["sched"].ElasticScheduler(),
        fair_share=s.build_fair_share(spec), incremental=True,
    )
    s.install_scenario(compiled, orch)
    orch.run()
    n = len(orch.telemetry.records)
    orch.close()
    return s.structural_trace(orch.telemetry.records), n


@pytest.mark.parametrize("name", SCENARIOS)
def test_compiled_scenarios_equal(name):
    compiled = [m["scen"].compile_scenario(m["scen"].SCENARIO_BUILDERS[name](), time_scale=0.1)
                for m in SIDES]
    assert compiled[0].stream_bytes() == compiled[1].stream_bytes()
    assert len(compiled[0].events) == len(compiled[1].events) > 0
    assert (j_scen.encode_scenario(compiled[0].spec)
            == t_scen.encode_scenario(compiled[1].spec))
    # the port decodes the reference's encoding to its own spec, and back
    assert t_scen.decode_scenario(j_scen.encode_scenario(compiled[0].spec)) == compiled[1].spec


@pytest.mark.parametrize("name", SCENARIOS)
def test_sim_structural_traces_equal(name):
    traces = [_sim_trace(m, m["scen"].compile_scenario(m["scen"].SCENARIO_BUILDERS[name]()))
              for m in SIDES]
    assert traces[0][1] > 0
    assert traces[0] == traces[1]


def test_live_on_cpu_lanes_reproduces_sim_and_reference():
    """The port's live mode with plain-RMSNorm payloads on four CPU lanes:
    the sim's structural trace, and the reference's live run with sleeps."""
    compiled = t_scen.compile_scenario(t_scen.live_smoke_spec(), time_scale=0.1)
    sim, n = _sim_trace(PORT, compiled)
    live = t_live.run_live_scenario(compiled, device="cpu", wall_limit_s=60.0)
    assert t_scen.structural_trace(live.telemetry.records) == sim
    assert len(live.telemetry.records) == n
    assert all(r.finish > r.start for r in live.telemetry.records)
    # every lane ran the kernel's plain version, and each output is right
    from repro_torch.kernels.ref import rmsnorm_ref

    assert sorted(live.payload.launches) == [0, 1, 2, 3]
    assert all(v > 0 for v in live.payload.launches.values())
    for x, w, out in live.payload.outputs.values():
        assert out.device.type == "cpu" and out.dtype == x.dtype
        assert (out - rmsnorm_ref(x, w)).abs().max().item() == 0.0
    ref_compiled = j_scen.compile_scenario(j_scen.live_smoke_spec(), time_scale=0.1)
    ref_live = j_live.run_live_scenario(ref_compiled, use_kernels=False, wall_limit_s=60.0)
    assert j_scen.structural_trace(ref_live.telemetry.records) == sim


# ---------------------------------------------------------------------------
# A6: the dense DP scan
# ---------------------------------------------------------------------------


def _dense_dp_cases():
    """tests/test_dense_dp.py::test_jax_backend_matches_ref's cases, made by
    its own ``_random_tasks``: (reference tasks, port tasks, operator in each)."""
    from test_dense_dp import _random_tasks

    def both(tasks):
        return tasks, [t_dp.DPTask(t.name, t.units, t.durations) for t in tasks]

    rng = random.Random(3)
    for _ in range(10):
        capacity = rng.randint(1, 16)
        yield (*both(_random_tasks(rng, rng.randint(1, 4), list(range(1, 9)))),
               lambda dp, c=capacity: dp.BasicDPOperator(c))
    yield (*both(_random_tasks(rng, 3, [1, 2, 4, 8])),
           lambda dp: dp.GpuChunkDPOperator((8, 4, 2, 1), total_devices=8))


def _objectives(results):
    return [None if r is None else (r.total_duration, r.allocation, r.durations)
            for r in results]


def test_torch_scan_bit_identical_to_jax_scan_and_numpy():
    pytest.importorskip("jax")
    for jt, tt, op in _dense_dp_cases():
        got = t_dp.dp_arrange_prefixes_dense(tt, op(t_dp), backend="torch", device="cpu")
        assert _objectives(got) == _objectives(
            t_dp.dp_arrange_prefixes_dense(tt, op(t_dp), backend="numpy"))
        assert _objectives(got) == _objectives(
            j_dp.dp_arrange_prefixes_dense(jt, op(j_dp), backend="jax"))
        assert _objectives(got) == _objectives(
            j_dp.dp_arrange_prefixes_dense(jt, op(j_dp), backend="numpy"))


# ---------------------------------------------------------------------------
# the paths the in-process copy left raising now do what the reference does
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", [dict(shards=2, plan_mode="remote"),
                                  dict(shards=1, plan_mode="remote", commit_mode="worker")],
                         ids=["plan_mode=remote", "commit_mode=worker"])
def test_remote_modes_launch_as_the_reference(mode):
    traces = []
    for m in SIDES:
        _restart_uids()
        traces.append(_run(m, 5, **mode))
    assert traces[0] == traces[1] == _run(PORT, 5)


def test_worker_commit_without_remote_plans_refused_alike():
    errors = []
    for m in SIDES:
        with pytest.raises(ValueError) as e:
            _make_system(m, shards=2, commit_mode="worker")
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "plan_mode='remote'" in errors[1]


def _bad_delta_errors(m, build, delta):
    from importlib import import_module

    wire = import_module(m["orch"].__name__.rsplit(".", 1)[0] + ".wire")
    mgr = build(m)
    base = wire.encode_snapshot(mgr)["state"]
    with pytest.raises(wire.WireError) as e:
        type(mgr).apply_delta(base, delta)
    return str(e.value)


@pytest.mark.parametrize("build,delta", [
    (lambda m: m["cpu"].CpuManager([m["cluster"].CpuNodeSpec("n0", cores=8)]),
     {"nodes": {"3": {"free": 1}}}),
    (lambda m: m["gpu"].GpuManager([m["cluster"].GpuNodeSpec("g0")],
                                   [m["gpu"].ServiceSpec("rm0", 40.0)]),
     {"alloc": {"nowhere": {"free": {}}}}),
], ids=["cpu", "gpu"])
def test_bad_snapshot_delta_raises_the_wire_error(build, delta):
    err = _bad_delta_errors(PORT, build, delta)
    assert "snapshot delta patches" in err and err == _bad_delta_errors(JAX_SIDE, build, delta)

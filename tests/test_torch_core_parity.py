"""The port's copy of the control plane against ``repro.core``: decision for
decision, with no tolerance.

The same seeded workloads run through both packages, each with its own
managers, actions and event loop.  Launch traces (``decision_trace``: the
tuples of ``tests/test_shards.py``'s ``_trace``), ``StepStats``, the GPU manager's
EOE counters and DPArrange's objectives and choices must be *equal*: the
copy is plain Python and NumPy doing the same float64 arithmetic in the
same order.
"""

from __future__ import annotations

import dataclasses
import random

import pytest

from _hypothesis_compat import given, settings, st

import repro.core.action as j_action
import repro.core.cluster as j_cluster
import repro.core.dparrange as j_dp
import repro.core.fairqueue as j_fair
import repro.core.managers.basic as j_basic
import repro.core.managers.cpu as j_cpu
import repro.core.managers.gpu as j_gpu
import repro.core.orchestrator as j_orch
import repro.core.simulator as j_sim
import repro.rl.driver as j_driver
import repro.rl.tasks as j_tasks
import repro_torch.core.action as t_action
import repro_torch.core.cluster as t_cluster
import repro_torch.core.dparrange as t_dp
import repro_torch.core.fairqueue as t_fair
import repro_torch.core.managers.basic as t_basic
import repro_torch.core.managers.cpu as t_cpu
import repro_torch.core.managers.gpu as t_gpu
import repro_torch.core.orchestrator as t_orch
import repro_torch.core.simulator as t_sim
import repro_torch.rl.driver as t_driver
import repro_torch.rl.tasks as t_tasks
from repro_torch.core.telemetry import decision_trace

# one namespace per package, so each workload is written once
JAX_SIDE = dict(action=j_action, cluster=j_cluster, fair=j_fair, basic=j_basic, cpu=j_cpu,
                gpu=j_gpu, orch=j_orch, sim=j_sim, driver=j_driver, tasks=j_tasks, dp=j_dp)
PORT = dict(action=t_action, cluster=t_cluster, fair=t_fair, basic=t_basic, cpu=t_cpu,
            gpu=t_gpu, orch=t_orch, sim=t_sim, driver=t_driver, tasks=t_tasks, dp=t_dp)
SIDES = (JAX_SIDE, PORT)


# ---------------------------------------------------------------------------
# the mixed workload of tests/test_shards.py, serial and sharded, fair or not
# ---------------------------------------------------------------------------


def _make_system(m, shards, fair):
    """tests/test_shards.py's ``_make_system`` in the package ``m``."""
    c = m["cluster"]
    loop = m["sim"].EventLoop()
    managers = {
        "cpu": m["cpu"].CpuManager([c.CpuNodeSpec("n0", cores=32)]),
        "gpu": m["gpu"].GpuManager([c.GpuNodeSpec("g0")], [m["gpu"].ServiceSpec("rm0", 40.0)]),
        "api": m["basic"].BasicResourceManager(
            c.ApiResourceSpec("api", mode="quota", quota=4, period_s=5.0), loop.clock
        ),
    }
    fs = m["fair"].FairSharePolicy(weights={"heavy": 2.0, "light": 1.0}) if fair else None
    return m["orch"].Orchestrator(managers, loop=loop, incremental=True, fair_share=fs,
                                  shards=shards)


def _submit_workload(m, orch, seed, tasks, n=60):
    """tests/test_shards.py's ``_submit_workload`` in the package ``m``."""
    A = m["action"]
    rng = random.Random(seed)
    for i in range(n):
        task = tasks[i % len(tasks)]
        kind = rng.random()
        delay = rng.uniform(0.0, 5.0)
        if kind < 0.4:
            a = A.Action(
                name="reward", cost={"cpu": A.ranged("cpu", 1, 8)}, key_resource="cpu",
                elasticity=A.AmdahlElasticity(0.08), base_duration=rng.uniform(1, 8),
                task_id=task, trajectory_id=f"{task}-{i}",
            )
        elif kind < 0.6:
            a = A.Action(
                name="tool", cost={"cpu": A.fixed("cpu", rng.choice((1, 2)))},
                base_duration=rng.uniform(0.2, 2.0), task_id=task,
                trajectory_id=f"{task}-{i}",
            )
        elif kind < 0.8:
            a = A.Action(
                name="rm:score", cost={"gpu": A.ResourceRequest("gpu", (1, 2, 4, 8))},
                key_resource="gpu", elasticity=A.AmdahlElasticity(0.15),
                base_duration=rng.uniform(0.5, 3.0), service="rm0", task_id=task,
                trajectory_id=f"{task}-{i}",
            )
        else:
            a = A.Action(
                name="api:q", cost={"api": A.fixed("api")},
                base_duration=rng.uniform(0.1, 1.0), task_id=task,
                trajectory_id=f"{task}-{i}",
            )
        orch.submit(a, delay=delay)


@pytest.mark.parametrize("fair", [False, True], ids=["fcfs", "fair"])
@pytest.mark.parametrize("shards", [None, 2], ids=["serial", "shards2"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixed_workload_identical(seed, shards, fair):
    tasks = ("heavy", "light") if fair else ("task0",)
    out = []
    for m in SIDES:
        orch = _make_system(m, shards, fair)
        _submit_workload(m, orch, seed, tasks)
        end = orch.run()
        assert orch.queue_depth() == 0 and orch.in_flight() == 0
        out.append((end, decision_trace(orch.telemetry.records),
                    dict(orch.managers["gpu"].stats),
                    orch.telemetry.mean_act()))
        orch.close()
    assert len(out[0][1]) == 60
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# rl/driver.py's step runners over the three rl/tasks.py workloads
# ---------------------------------------------------------------------------


WORKLOADS = {
    "coding": lambda t: t.make_coding_workload(24, seed=3, arrival_spread_s=10),
    "deepsearch": lambda t: t.make_deepsearch_workload(16, seed=4),
    "mopd": lambda t: t.make_mopd_workload(32, seed=5, n_teachers=4, arrival_spread_s=10),
}


def _step(m, workload, system):
    trajs = WORKLOADS[workload](m["tasks"])
    cluster = m["cluster"].paper_testbed(cpu_nodes=1, gpu_nodes=2)
    if system == "tangram":
        stats, tg = m["driver"].run_tangram_step(trajs, cluster)
        systems = {"tangram": tg}
    else:
        stats, systems = m["driver"].run_baseline_step(trajs, cluster, gpu_baseline=system)
    traces = {k: decision_trace(s.telemetry.records) for k, s in systems.items()}
    gpu = getattr(systems.get("tangram"), "managers", {}).get("gpu")
    return dataclasses.asdict(stats), traces, dict(gpu.stats) if gpu else None


@pytest.mark.parametrize("system", ["tangram", "static", "serverless"])
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_step_runners_identical(workload, system):
    want, got = (_step(m, workload, system) for m in SIDES)
    assert any(want[1].values())  # actions ran
    assert want == got


# ---------------------------------------------------------------------------
# DPArrange on drawn tasks: objective and choices
# ---------------------------------------------------------------------------


def _draw_tasks(data, n_tasks, unit_pool):
    tasks = []
    for i in range(n_tasks):
        units = tuple(sorted(data.draw(st.sets(st.sampled_from(unit_pool), min_size=1,
                                               max_size=4), label=f"units{i}")))
        durs = tuple(
            data.draw(st.floats(0.1, 100.0, allow_nan=False, allow_infinity=False),
                      label=f"dur{i}_{k}")
            for k in units
        )
        tasks.append((f"t{i}", units, durs))
    return tasks


def _result(r):
    return None if r is None else (r.total_duration, r.allocation, r.durations)


def _both(tasks, op_args, gpu, weights):
    out = []
    for m in SIDES:
        dp = m["dp"]
        ts = [dp.DPTask(*t) for t in tasks]
        op = dp.GpuChunkDPOperator(*op_args) if gpu else dp.BasicDPOperator(*op_args)
        out.append((
            _result(dp.dp_arrange(ts, op, weights=weights)),
            [_result(r) for r in dp.dp_arrange_prefixes(ts, op, weights=weights)],
            [_result(r) for r in dp.dp_arrange_prefixes(ts, op, table=None, weights=weights)],
        ))
    return out


@settings(max_examples=150, deadline=None)
@given(n_tasks=st.integers(1, 6), total=st.integers(0, 24), weighted=st.booleans(),
       data=st.data())
def test_dp_basic_identical(n_tasks, total, weighted, data):
    tasks = _draw_tasks(data, n_tasks, list(range(1, 9)))
    weights = [data.draw(st.sampled_from((0.5, 1.0, 2.0))) for _ in tasks] if weighted else None
    want, got = _both(tasks, (total,), False, weights)
    assert want == got


@settings(max_examples=100, deadline=None)
@given(n_tasks=st.integers(1, 5), counts=st.tuples(*(st.integers(0, 3) for _ in range(4))),
       weighted=st.booleans(), data=st.data())
def test_dp_gpu_chunks_identical(n_tasks, counts, weighted, data):
    tasks = _draw_tasks(data, n_tasks, [1, 2, 4, 8])
    weights = [data.draw(st.sampled_from((0.5, 1.0, 2.0))) for _ in tasks] if weighted else None
    total = counts[0] + 2 * counts[1] + 4 * counts[2] + 8 * counts[3]
    want, got = _both(tasks, (counts, None, total), True, weights)
    assert want == got

"""The port's copy of the control plane (``repro_torch.core``) under the
reference suite ``tests/test_scenarios.py``, imports rewritten, each case kept.

The reference suite's own description follows.

Scenario factory: the differential replay rail and its properties.

Five layers of guarantees:

* **replay** — a spec plus its seed IS the workload: compiling twice
  yields byte-identical event streams, the committed spec files under
  ``benchmarks/scenarios/`` compile to exactly what their builders
  produce, and the seed is load-bearing (reseeding a stochastic spec
  moves the fingerprint);
* **distributions** — the in-house samplers really produce the shapes
  the specs declare (Pareto tail index via a Hill estimator, lognormal
  mean, clamp bounds, the legacy cycle ladders bit-for-bit);
* **codec** — specs round-trip through the wire-style sparse dict
  encoding, unknown fields are ignored (additive schema changes stay
  compatible), and every malformed input dies with a *typed*
  ``ScenarioError``;
* **legacy equivalence** — the three hand-written bench scenarios the
  factory replaced (fleet churn / mixed churn / multi-tenant fairness)
  are PINNED here as frozen copies, and the spec-driven runs must
  reproduce their launch traces bit-identically;
* **sim-vs-live** — the same compiled scenario run under the DES clock
  and under the real-time live harness must produce the same
  structural (per-pool launch order) trace, and the worked examples in
  ``docs/scenarios.md`` must decode, compile, and fingerprint exactly
  as documented.
"""

import dataclasses
import json
import math
import random
import re
from pathlib import Path

import pytest

from repro_torch.core.action import Action, AmdahlElasticity, ResourceRequest, fixed
from repro_torch.core.cluster import ApiResourceSpec, CpuNodeSpec, GpuNodeSpec
from repro_torch.core.fairqueue import FairSharePolicy
from repro_torch.core.managers.base import ResourceManager
from repro_torch.core.managers.basic import BasicResourceManager
from repro_torch.core.managers.cpu import CpuManager
from repro_torch.core.managers.gpu import GpuManager, ServiceSpec
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.scenarios import (
    CHURN_APIS,
    FAIRNESS_WEIGHTS,
    SCENARIO_BUILDERS,
    ActionKindSpec,
    ArrivalSpec,
    DurationSpec,
    MixSpec,
    PoolSpec,
    ScenarioError,
    ScenarioSpec,
    StreamSpec,
    build_fair_share,
    build_managers,
    build_policy,
    churn_spec,
    compile_scenario,
    decode_scenario,
    encode_scenario,
    fairness_spec,
    fleet_churn_spec,
    install_scenario,
    live_smoke_spec,
    load_scenario,
    structural_trace,
)
from repro_torch.core.scheduler import ElasticScheduler
from repro_torch.core.simulator import EventLoop

REPO = Path(__file__).resolve().parent.parent
SPEC_DIR = REPO / "benchmarks" / "scenarios"


def _trace(orch):
    return sorted(
        (r.name, r.task_id, r.trajectory_id, round(r.submit, 9),
         round(r.start, 9), round(r.finish, 9),
         tuple(sorted(r.units.items())), r.failed)
        for r in orch.telemetry.records
    )


def _spec_orch(spec, loop=None):
    loop = loop or EventLoop()
    return Orchestrator(
        build_managers(spec, loop), loop=loop, policy=build_policy(spec),
        incremental=True, fair_share=build_fair_share(spec),
    )


def _run_spec(spec, until=None):
    orch = _spec_orch(spec)
    install_scenario(spec, orch)
    orch.run(until=until)
    trace = _trace(orch)
    orch.close()
    return trace


# ---------------------------------------------------------------------------
# the replay rail: seed determinism, spec files, fingerprints
# ---------------------------------------------------------------------------


class TestReplayRail:
    @pytest.mark.parametrize("name", sorted(SCENARIO_BUILDERS))
    def test_stream_bit_identical(self, name):
        """Identical spec + seed => byte-identical compiled streams."""
        build = SCENARIO_BUILDERS[name]
        a, b = compile_scenario(build()), compile_scenario(build())
        assert a.stream_bytes() == b.stream_bytes()
        assert a.fingerprint() == b.fingerprint()

    @pytest.mark.parametrize("name", sorted(SCENARIO_BUILDERS))
    def test_codec_round_trip_preserves_stream(self, name):
        """The replay rail survives the wire boundary: a decoded copy
        compiles to the same bytes as the original."""
        spec = SCENARIO_BUILDERS[name]()
        copied = decode_scenario(encode_scenario(spec))
        assert copied == spec
        assert (compile_scenario(copied).stream_bytes()
                == compile_scenario(spec).stream_bytes())

    def test_committed_spec_files_match_builders(self):
        """benchmarks/scenarios/*.json is exactly the builder registry:
        nothing stale, nothing missing, nothing diverged."""
        assert sorted(p.stem for p in SPEC_DIR.glob("*.json")) == sorted(
            SCENARIO_BUILDERS
        )
        for name, build in SCENARIO_BUILDERS.items():
            assert load_scenario(str(SPEC_DIR / f"{name}.json")) == build(), (
                f"{name}.json diverged from its builder — re-export with "
                f"save_scenario"
            )

    @pytest.mark.parametrize("name", ["heavy_tail", "diurnal"])
    def test_seed_is_load_bearing(self, name):
        spec = SCENARIO_BUILDERS[name]()
        reseeded = dataclasses.replace(spec, seed=spec.seed + 1)
        assert (compile_scenario(spec).fingerprint()
                != compile_scenario(reseeded).fingerprint())

    def test_time_scale_shrinks_times_and_durations(self):
        """The live runner's knob: every arrival instant and duration
        scales, nothing else changes (same templates, same order)."""
        spec = SCENARIO_BUILDERS["heavy_tail"]()
        full = compile_scenario(spec)
        half = compile_scenario(spec, time_scale=0.5)
        assert len(full.events) == len(half.events)
        for a, b in zip(full.events, half.events):
            assert b.t == pytest.approx(a.t * 0.5)
            assert b.template.base_duration == pytest.approx(
                a.template.base_duration * 0.5)
            assert b.template.trajectory_id == a.template.trajectory_id

    def test_horizon_gated_preview_is_bounded(self):
        """A closed-loop stream without a total compiles a bounded
        preview (the driver draws past it on demand)."""
        spec = fairness_spec()
        compiled = compile_scenario(spec, max_actions=40)
        assert len(compiled.events) == 40 * len(spec.streams)
        assert compiled.totals == (None,) * len(spec.streams)


# ---------------------------------------------------------------------------
# distribution sanity: the in-house samplers produce what specs declare
# ---------------------------------------------------------------------------


class TestDistributions:
    def test_pareto_tail_index_recovered(self):
        """Hill estimator over the top decile of 4000 draws must
        recover the declared tail index (alpha=1.6, infinite variance —
        sample moments would never converge, the tail index does)."""
        d = DurationSpec(kind="pareto", base=0.4, alpha=1.6)
        rng = random.Random(1234)
        draws = sorted((d.sample({}, rng) for _ in range(4000)), reverse=True)
        k = 400
        hill = sum(math.log(draws[i] / draws[k]) for i in range(k)) / k
        assert 1.35 < 1.0 / hill < 1.85

    def test_pareto_scale_is_the_minimum(self):
        d = DurationSpec(kind="pareto", base=0.4, alpha=1.6)
        rng = random.Random(7)
        draws = [d.sample({}, rng) for _ in range(1000)]
        assert min(draws) >= 0.4
        assert min(draws) == pytest.approx(0.4, rel=0.01)

    def test_lognormal_mean_within_tolerance(self):
        mu, sigma = -0.5, 0.6
        d = DurationSpec(kind="lognormal", base=mu, sigma=sigma)
        rng = random.Random(99)
        n = 4000
        mean = sum(d.sample({}, rng) for _ in range(n)) / n
        expected = math.exp(mu + sigma * sigma / 2.0)
        assert abs(mean - expected) < 0.08 * expected

    def test_clamps_respected(self):
        d = DurationSpec(kind="lognormal", base=0.0, sigma=2.0,
                         lo=0.5, hi=3.0)
        rng = random.Random(5)
        draws = [d.sample({}, rng) for _ in range(500)]
        assert min(draws) >= 0.5 and max(draws) <= 3.0
        # with sigma=2 both clamps really engage
        assert 0.5 in draws and 3.0 in draws

    def test_cycle_ladder_matches_legacy_formula(self):
        """The churn bench's duration ladder, 5.0 + (i % 7)."""
        d = DurationSpec(kind="cycle", base=5.0, step=1.0, mod=7)
        rng = random.Random(0)
        assert [d.sample({"seq": i}, rng) for i in range(15)] == [
            5.0 + (i % 7) for i in range(15)
        ]

    def test_sampling_never_touches_global_rng(self):
        """Streams draw from their own seeded Random — the global RNG
        state is irrelevant to compilation."""
        spec = SCENARIO_BUILDERS["heavy_tail"]()
        random.seed(1)
        fp1 = compile_scenario(spec).fingerprint()
        random.seed(2)
        random.random()
        fp2 = compile_scenario(spec).fingerprint()
        assert fp1 == fp2


# ---------------------------------------------------------------------------
# codec: sparse round-trip, compatibility, typed rejection
# ---------------------------------------------------------------------------


def _tiny_spec(**over):
    kw = dict(
        name="tiny",
        pools=(PoolSpec("pool0", kind="pool", cores=2),),
        streams=(StreamSpec(
            mix=MixSpec(pattern=(0,), kinds=(ActionKindSpec(
                name="w", units=(1,),
                duration=DurationSpec(kind="fixed", base=1.0)),)),
            pools=("pool0",), traj="t{seq}"),),
        arrival=ArrivalSpec(kind="burst", n=4),
    )
    kw.update(over)
    return ScenarioSpec(**kw)


class TestCodec:
    def test_sparse_encoding_omits_defaults(self):
        body = encode_scenario(_tiny_spec())["spec"]
        assert "seed" not in body  # seed=0 is the default
        assert "faults" not in body
        assert "seed" in encode_scenario(_tiny_spec(seed=11))["spec"]

    def test_unknown_fields_ignored(self):
        """The wire idiom: additive schema changes never break an old
        decoder."""
        spec = _tiny_spec()
        payload = encode_scenario(spec)
        payload["spec"]["future_field"] = {"nested": True}
        payload["spec"]["arrival"]["frobnicate"] = 7
        payload["spec"]["streams"][0]["mix"]["kinds"][0]["extra"] = "x"
        assert decode_scenario(payload) == spec

    def test_error_is_a_value_error_with_code(self):
        err = ScenarioError("bad_thing", "message")
        assert isinstance(err, ValueError)
        assert err.code == "bad_thing"

    @pytest.mark.parametrize("mutate,code", [
        (lambda p: p.update(v=99), "bad_version"),
        (lambda p: p.update(kind="not_a_spec"), "bad_envelope"),
        (lambda p: p.update(spec=[1, 2]), "bad_field"),
        (lambda p: p["spec"].update(arrival={"kind": "nope"}),
         "bad_arrival"),
        (lambda p: p["spec"]["streams"][0]["mix"]["kinds"][0].update(
            duration={"kind": "weibull"}), "bad_duration"),
        (lambda p: p["spec"]["streams"][0]["mix"]["kinds"][0].update(
            units=[]), "bad_kind"),
        (lambda p: p["spec"]["streams"][0]["mix"].update(pattern=[9]),
         "bad_mix"),
        (lambda p: p["spec"]["pools"][0].update(kind="quantum"),
         "bad_pool"),
        (lambda p: p["spec"].update(pools=[]), "bad_spec"),
        (lambda p: p["spec"]["streams"][0].update(pools=["ghost"]),
         "unknown_pool"),
        (lambda p: p["spec"].update(faults=[{"kind": "gremlin"}]),
         "bad_fault"),
    ])
    def test_malformed_payload_rejected_with_typed_error(self, mutate, code):
        payload = encode_scenario(_tiny_spec())
        mutate(payload)
        with pytest.raises(ScenarioError) as ei:
            decode_scenario(payload)
        assert ei.value.code == code

    def test_non_dict_payload_rejected(self):
        with pytest.raises(ScenarioError) as ei:
            decode_scenario("not a dict")
        assert ei.value.code == "bad_envelope"

    def test_closed_loop_needs_deterministic_durations(self):
        """Refill times are decided by the run, so a stochastic
        duration would couple the stream to scheduling order and break
        replay — rejected at spec construction."""
        with pytest.raises(ScenarioError) as ei:
            _tiny_spec(
                streams=(StreamSpec(
                    mix=MixSpec(pattern=(0,), kinds=(ActionKindSpec(
                        name="w", units=(1,),
                        duration=DurationSpec(kind="pareto", base=0.4)),)),
                    pools=("pool0",), traj="t{seq}"),),
                arrival=ArrivalSpec(kind="closed_loop", prime=4, wave=2,
                                    total=8),
            )
        assert ei.value.code == "closed_loop_stochastic"

    def test_unknown_policy_knob_rejected(self):
        spec = _tiny_spec(policy={"not_a_knob": 1})
        with pytest.raises(ScenarioError) as ei:
            build_policy(spec, gated=True)
        assert ei.value.code == "bad_policy"
        # ungated runs never apply (or validate) the spec's knobs
        assert build_policy(spec) is not None


# ---------------------------------------------------------------------------
# legacy equivalence: the pinned pre-factory bench scenarios
# ---------------------------------------------------------------------------
#
# Frozen copies of the generators + harness loops the scenario factory
# replaced (benchmarks/bench_scheduler.py before the refactor).  The
# equivalence gate below is only meaningful against THIS reference —
# never "fix" these to match the factory; a mismatch means the factory
# broke replay of the legacy workloads.

_LEGACY_APIS = ("google_search", "web_fetch", "pdf_parse", "embed",
                "code_exec", "translate")
_LEGACY_WEIGHTS = {"heavy0": 2.0, "heavy1": 2.0, "light0": 1.0,
                   "light1": 1.0}


def _legacy_churn_action(i):
    kind = i % 8
    if kind == 0:
        return Action(
            name="reward", cost={"cpu": ResourceRequest("cpu", (1, 2, 4, 8))},
            key_resource="cpu", elasticity=AmdahlElasticity(0.05),
            base_duration=5.0 + (i % 7), trajectory_id=f"c{i}",
        )
    if kind == 1:
        return Action(
            name="tool", cost={"cpu": fixed("cpu", 1)},
            base_duration=0.5 + 0.1 * (i % 5), trajectory_id=f"c{i}",
        )
    if kind == 2:
        return Action(
            name="rm:score", cost={"gpu": ResourceRequest("gpu", (1, 2, 4))},
            key_resource="gpu", elasticity=AmdahlElasticity(0.15),
            base_duration=1.0 + 0.25 * (i % 4), service="rm0",
            trajectory_id=f"c{i}",
        )
    api = _LEGACY_APIS[i % len(_LEGACY_APIS)]
    return Action(
        name=f"api:{api}", cost={api: fixed(api, 1)},
        base_duration=0.3 + 0.2 * (i % 3), trajectory_id=f"c{i}",
    )


def _legacy_fleet_action(pool, wave, i):
    rt = f"pool{pool}"
    if i % 3 == 2:
        return Action(
            name="tool", cost={rt: fixed(rt, 1)},
            base_duration=0.5 + 0.1 * (wave % 3),
            trajectory_id=f"p{pool}-{wave}-{i}",
        )
    return Action(
        name="reward", cost={rt: ResourceRequest(rt, (1, 2, 4, 8))},
        key_resource=rt, elasticity=AmdahlElasticity(0.05),
        base_duration=4.0 + 0.5 * ((wave + i) % 4),
        trajectory_id=f"p{pool}-{wave}-{i}",
    )


def _legacy_tenant_action(task, i):
    heavy = task.startswith("heavy")
    i += 3 * (task.endswith("1"))
    if heavy and i % 6 == 5:
        return Action(
            name="rm:score", cost={"gpu": ResourceRequest("gpu", (1, 2, 4))},
            key_resource="gpu", elasticity=AmdahlElasticity(0.15),
            base_duration=1.0 + 0.2 * (i % 3), service="rm0", task_id=task,
            trajectory_id=f"{task}-{i}",
        )
    if heavy:
        return Action(
            name="reward", cost={"cpu": ResourceRequest("cpu", (2, 4, 8))},
            key_resource="cpu", elasticity=AmdahlElasticity(0.08),
            base_duration=3.5 + 0.3 * (i % 4), task_id=task,
            trajectory_id=f"{task}-{i}",
        )
    if i % 8 == 7:
        return Action(
            name="rm:probe", cost={"gpu": fixed("gpu", 1)},
            base_duration=0.3, service="rm0", task_id=task,
            trajectory_id=f"{task}-{i}",
        )
    return Action(
        name="tool", cost={"cpu": fixed("cpu", 1)},
        base_duration=0.4 + 0.1 * (i % 3), task_id=task,
        trajectory_id=f"{task}-{i}",
    )


def _legacy_churn_run(queue, events):
    loop = EventLoop()
    managers = {
        "cpu": CpuManager([CpuNodeSpec("n0", cores=32)]),
        "gpu": GpuManager([GpuNodeSpec("g0")], [ServiceSpec("rm0", 40.0)]),
    }
    for api in _LEGACY_APIS:
        managers[api] = BasicResourceManager(
            ApiResourceSpec(api, mode="concurrency", max_concurrency=3),
            loop.clock,
        )
    orch = Orchestrator(managers, loop=loop, policy=ElasticScheduler(),
                        incremental=True)
    counter = [queue]
    done_since_wave = [0]
    wave = max(8, queue // 4)

    def refill(_fut):
        done_since_wave[0] += 1
        if done_since_wave[0] < wave or counter[0] >= queue + events:
            return
        done_since_wave[0] = 0
        for _ in range(wave):
            if counter[0] >= queue + events:
                break
            i = counter[0]
            counter[0] += 1
            orch.submit(_legacy_churn_action(i)).add_done_callback(refill)

    for i in range(queue):
        fut = orch.submit(_legacy_churn_action(i), delay=0.001 * i)
        fut.add_done_callback(refill)
    orch.run()
    trace = _trace(orch)
    orch.close()
    return trace


def _legacy_fleet_run(queue, waves, cores=8, period_s=4.0, pools=8):
    per_pool = max(1, queue // pools)
    loop = EventLoop()
    managers = {
        f"pool{k}": ResourceManager(f"pool{k}", cores) for k in range(pools)
    }
    orch = Orchestrator(managers, loop=loop, policy=ElasticScheduler(),
                        incremental=True)
    wave_no = [0]

    def submit_wave():
        w = wave_no[0]
        wave_no[0] += 1
        for k in range(pools):
            for i in range(per_pool):
                orch.submit(_legacy_fleet_action(k, w, i))
        if w + 1 < waves:
            orch.loop.call_after(period_s, submit_wave)

    submit_wave()
    orch.run()
    trace = _trace(orch)
    orch.close()
    return trace


def _legacy_fairness_run(fair, horizon, tasks=None):
    tasks = list(tasks or _LEGACY_WEIGHTS)
    loop = EventLoop()
    managers = {
        "cpu": CpuManager([CpuNodeSpec("n0", cores=16)]),
        "gpu": GpuManager([GpuNodeSpec("g0")], [ServiceSpec("rm0", 40.0)]),
    }
    fs = FairSharePolicy(weights=dict(_LEGACY_WEIGHTS)) if fair else None
    orch = Orchestrator(managers, loop=loop, policy=ElasticScheduler(),
                        fair_share=fs)
    wave = 6
    counters = {t: 0 for t in tasks}
    pending_wave = {t: 0 for t in tasks}

    def submit(task, burst):
        for _ in range(burst):
            i = counters[task]
            counters[task] += 1
            fut = orch.submit(_legacy_tenant_action(task, i))
            fut.add_done_callback(lambda _f, t=task: refill(t))

    def refill(task):
        if orch.now >= horizon:
            return
        pending_wave[task] += 1
        if pending_wave[task] >= wave:
            pending_wave[task] = 0
            submit(task, wave)

    for k, t in enumerate(tasks):
        orch.loop.call_after(0.001 * k, lambda t=t: submit(t, 2 * wave))
    orch.run(until=horizon * 2)
    trace = _trace(orch)
    orch.close()
    return trace


class TestLegacyEquivalence:
    def test_pinned_constants_still_current(self):
        """The factory's exported constants must equal the frozen
        legacy values (the benches now import them from scenarios)."""
        assert CHURN_APIS == _LEGACY_APIS
        assert FAIRNESS_WEIGHTS == _LEGACY_WEIGHTS

    def test_churn_spec_reproduces_legacy_trace(self):
        """Mixed agentic churn: closed-loop primes + wave refills over
        cpu/gpu/6-api managers, bit-identical launch trace."""
        spec = churn_spec(queue=32, events=64)
        assert _run_spec(spec) == _legacy_churn_run(queue=32, events=64)

    def test_fleet_churn_spec_reproduces_legacy_trace(self):
        """Synchronized fleet waves over 8 replica pools."""
        spec = fleet_churn_spec(queue=32, waves=4)
        assert _run_spec(spec) == _legacy_fleet_run(queue=32, waves=4)

    def test_fairness_spec_reproduces_legacy_trace(self):
        """Multi-tenant WFQ churn: staggered closed-loop streams,
        horizon-gated refills, weighted fair share enabled."""
        horizon = 30.0
        spec = fairness_spec(horizon_s=horizon)
        fs = build_fair_share(spec)
        assert fs is not None and fs.weight_of("heavy0") == 2.0
        assert (_run_spec(spec, until=horizon * 2)
                == _legacy_fairness_run(fair=True, horizon=horizon))

    def test_fleet_managers_match_legacy_shape(self):
        spec = fleet_churn_spec(queue=32, waves=4)
        managers = build_managers(spec, EventLoop())
        assert sorted(managers) == [f"pool{k}" for k in range(8)]
        assert all(isinstance(m, ResourceManager) for m in managers.values())


# ---------------------------------------------------------------------------
# sim vs live: the structural-equivalence rail (no card needed here —
# the sleep payload exercises the identical control plane)
# ---------------------------------------------------------------------------


class TestSimVsLive:
    def test_live_run_reproduces_sim_structural_trace(self):
        from repro_torch.core.live import run_live_scenario

        spec = live_smoke_spec()
        compiled = compile_scenario(spec, time_scale=0.1)

        orch = _spec_orch(spec)
        install_scenario(compiled, orch)
        orch.run()
        sim_tr = structural_trace(orch.telemetry.records)
        n_sim = len(orch.telemetry.records)
        orch.close()

        live = run_live_scenario(compiled, use_kernels=False,
                                 wall_limit_s=60.0)
        live_tr = structural_trace(live.telemetry.records)
        assert len(live.telemetry.records) == n_sim
        assert live_tr == sim_tr
        # live timing is real: every completion took measurable wall
        assert all(r.finish > r.start for r in live.telemetry.records)


# ---------------------------------------------------------------------------
# the documented worked examples must decode against the REAL codec
# ---------------------------------------------------------------------------

DOC = REPO / "docs" / "scenarios.md"

#: What docs/scenarios.md promises for its worked examples.
DOC_EXPECTED = {
    "diurnal": (64, "29d36e846b8ec910eaa6328b7310df16b9fc159f"),
    "heavy-tail": (112, "ed97a916ac7687aa1aef9be047516c324d46e653"),
}


def _doc_examples():
    """``<!-- scenario-example: <name> -->`` fenced JSON blocks."""
    out = {}
    for m in re.finditer(
        r"<!--\s*scenario-example:\s*(?P<name>[\w-]+)\s*-->\s*"
        r"```json\n(?P<body>.*?)```",
        DOC.read_text(),
        re.DOTALL,
    ):
        out[m.group("name")] = json.loads(m.group("body"))
    return out


class TestDocumentedExamples:
    def test_doc_exists_and_has_examples(self):
        assert set(DOC_EXPECTED) <= set(_doc_examples())

    @pytest.mark.parametrize("name", sorted(DOC_EXPECTED))
    def test_documented_example_compiles_as_documented(self, name):
        """Decode -> compile -> the exact event count and fingerprint
        the doc prose pins (and the prose really pins them)."""
        payload = _doc_examples()[name]
        spec = decode_scenario(payload)
        compiled = compile_scenario(spec)
        n_events, fingerprint = DOC_EXPECTED[name]
        assert len(compiled.events) == n_events
        assert compiled.fingerprint() == fingerprint
        text = DOC.read_text()
        assert fingerprint in text and str(n_events) in text
        # re-encoding reproduces the documented payload field-for-field
        assert encode_scenario(spec) == payload

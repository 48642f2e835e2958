"""Scenario factory: declarative, seeded workload generation.

Every bench scenario used to be a hand-written Python generator (an
``_churn_action(i)`` here, a wave loop there) — adding a workload meant
adding code, and the CI gates were only as strong as the handful of
shapes someone had written down.  This module replaces that with a
**declarative** :class:`ScenarioSpec`: fleet topology (pools), traffic
streams (tenant + action mix), an arrival process, and a fault
schedule, all plain frozen dataclasses that encode to a wire-codec-style
dict (:func:`encode_scenario` / :func:`decode_scenario`, versioned
envelope, unknown fields ignored, malformed fields rejected with typed
:class:`ScenarioError`\\ s).

**Determinism is the contract.**  :func:`compile_scenario` turns a spec
into a :class:`CompiledScenario` — a deterministic event stream of
:class:`ActionTemplate`\\ s — using only ``random.Random(seed)`` uniforms
fed through in-house inverse-CDF / Box-Muller transforms (never
``random.lognormvariate`` or numpy, whose numeric paths may drift across
versions).  Identical spec + seed ⇒ **byte-identical** stream
(:meth:`CompiledScenario.stream_bytes`), which is what makes the
differential replay rail possible: the same compiled stream drives the
DES benches (``bench_scheduler.py --suite generated``), the chaos
harness, *and* the live-mode runner (:mod:`repro_torch.core.live`), with
sim-vs-live launch traces compared structurally.

Arrival processes: Poisson, diurnal (sinusoid-modulated Poisson via
thinning), burst-pause, synchronized waves, one-shot burst, and
closed-loop (completions refill the queue in bursts — the paper's
rollout-batch shape; closed-loop streams must use deterministic
duration kinds, since refill times are decided by the run, not the
compiler).  Duration distributions: fixed, cycle (the legacy benches'
``base + step * (idx % mod)`` shape), lognormal, and Pareto heavy-tail
(DeepSearch-style tool latencies).

A worked example (doctested; see docs/scenarios.md for the schema):

>>> spec = ScenarioSpec(
...     name="doc",
...     seed=7,
...     pools=(PoolSpec("pool0", kind="pool", cores=2),),
...     streams=(StreamSpec(
...         mix=MixSpec(
...             pattern=(0,),
...             kinds=(ActionKindSpec(
...                 name="tool", units=(1,),
...                 duration=DurationSpec(kind="fixed", base=0.5)),),
...         ),
...         pools=("pool0",), traj="t{seq}"),),
...     arrival=ArrivalSpec(kind="burst", n=4),
... )
>>> compiled = compile_scenario(spec)
>>> [ev.template.trajectory_id for ev in compiled.events]
['t0', 't1', 't2', 't3']
>>> compiled.stream_bytes() == compile_scenario(spec).stream_bytes()
True
>>> decode_scenario(encode_scenario(spec)) == spec
True
"""

from __future__ import annotations

import dataclasses
import json
import math
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import wire
from repro_torch.core.action import (
    Action,
    AmdahlElasticity,
    LinearElasticity,
    ResourceRequest,
)

#: Version of the scenario-spec encoding.  Additive fields ride within a
#: version (decoders ignore unknown keys, the wire idiom); a breaking
#: change bumps it and the decoder refuses the mismatch with a typed
#: error.
SCENARIO_VERSION = 1

#: Compiled-stream preview length for unbounded closed-loop streams
#: (the serialized event stream must be finite to be byte-comparable).
DEFAULT_MAX_ACTIONS = 2048


class ScenarioError(ValueError):
    """A malformed scenario spec.  ``code`` names the failure class so
    callers (and tests) can assert on *what* was wrong, not on message
    prose."""

    def __init__(self, code: str, message: str) -> None:
        super().__init__(message)
        self.code = code


def _require(cond: bool, code: str, message: str) -> None:
    if not cond:
        raise ScenarioError(code, message)


# ---------------------------------------------------------------------------
# Deterministic distributions (raw uniforms only — stable across Python
# versions and platforms, which is what the bit-identical rail rides on)
# ---------------------------------------------------------------------------

#: Duration kinds whose samples are pure functions of the action's
#: indices (no rng) — the only kinds closed-loop streams may use.
DETERMINISTIC_DURATIONS = frozenset({"fixed", "cycle"})

#: Index sources a cycle duration may key on.
INDEX_SOURCES = ("seq", "slot", "wave", "wave_plus_slot")


def _std_normal(rng: random.Random) -> float:
    """One standard-normal draw via Box–Muller from two raw uniforms."""
    u1 = max(rng.random(), 1e-12)
    u2 = rng.random()
    return math.sqrt(-2.0 * math.log(u1)) * math.cos(2.0 * math.pi * u2)


@dataclass(frozen=True)
class DurationSpec:
    """How an action kind's base duration (T_ori) is produced.

    * ``fixed``     — always ``base``.
    * ``cycle``     — ``base + step * ((idx + offset) % mod)`` where
      ``idx`` comes from ``index`` (the legacy benches' deterministic
      duration ladders are exactly this shape).
    * ``lognormal`` — ``exp(base + sigma * z)`` (``base`` is the
      log-mean mu), clamped to ``[lo, hi]`` when set.
    * ``pareto``    — ``base * (1 - u)^(-1/alpha)`` (``base`` is the
      scale x_m), clamped to ``hi`` when set — the heavy tail.
    """

    kind: str = "fixed"
    base: float = 1.0
    step: float = 0.0
    mod: int = 1
    offset: int = 0
    index: str = "seq"
    sigma: float = 0.5
    alpha: float = 1.5
    lo: Optional[float] = None
    hi: Optional[float] = None

    def __post_init__(self) -> None:
        _require(
            self.kind in ("fixed", "cycle", "lognormal", "pareto"),
            "bad_duration", f"unknown duration kind {self.kind!r}",
        )
        _require(self.index in INDEX_SOURCES, "bad_duration",
                 f"unknown duration index source {self.index!r}")
        if self.kind == "cycle":
            _require(self.mod >= 1, "bad_duration",
                     f"cycle mod must be >= 1, got {self.mod}")
        if self.kind == "pareto":
            _require(self.alpha > 0, "bad_duration",
                     f"pareto alpha must be > 0, got {self.alpha}")
            _require(self.base > 0, "bad_duration",
                     f"pareto scale must be > 0, got {self.base}")
        if self.kind == "lognormal":
            _require(self.sigma >= 0, "bad_duration",
                     f"lognormal sigma must be >= 0, got {self.sigma}")
        if self.kind in ("fixed", "cycle"):
            _require(self.base > 0 or self.step > 0, "bad_duration",
                     "duration base must be positive")

    @property
    def deterministic(self) -> bool:
        return self.kind in DETERMINISTIC_DURATIONS

    def sample(self, idx: Dict[str, int], rng: random.Random) -> float:
        if self.kind == "fixed":
            return self.base
        if self.kind == "cycle":
            return self.base + self.step * ((idx[self.index] + self.offset) % self.mod)
        if self.kind == "lognormal":
            v = math.exp(self.base + self.sigma * _std_normal(rng))
        else:  # pareto
            u = rng.random()
            v = self.base * (1.0 - u) ** (-1.0 / self.alpha)
        if self.lo is not None:
            v = max(v, self.lo)
        if self.hi is not None:
            v = min(v, self.hi)
        return v


# ---------------------------------------------------------------------------
# Action kinds, mixes, streams
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ActionKindSpec:
    """One action archetype in a stream's mix.

    ``rtype=None`` binds the action to the pool the stream fans it onto
    (replica-fleet shape); a set ``rtype`` pins it (multiplexed-fleet
    shape, e.g. ``cpu`` / ``gpu``); a non-empty ``rtype_cycle`` picks
    ``rtype_cycle[idx % len]`` per action (the churn bench's rotating
    API fleet).  ``elasticity`` is ``None`` (rigid), ``("amdahl",
    serial)``, or ``("linear", 0.0)``."""

    name: str
    units: Tuple[int, ...]
    duration: DurationSpec
    elasticity: Optional[Tuple[str, float]] = None
    rtype: Optional[str] = None
    rtype_cycle: Tuple[str, ...] = ()
    service: Optional[str] = None

    def __post_init__(self) -> None:
        _require(bool(self.units), "bad_kind", f"{self.name}: empty unit set")
        _require(all(u > 0 for u in self.units), "bad_kind",
                 f"{self.name}: units must be positive")
        if self.elasticity is not None:
            model = self.elasticity[0]
            _require(model in ("amdahl", "linear"), "bad_kind",
                     f"{self.name}: unknown elasticity model {model!r}")
            _require(len(self.units) > 1, "bad_kind",
                     f"{self.name}: elastic kind needs > 1 feasible unit")
        _require(not (self.rtype and self.rtype_cycle), "bad_kind",
                 f"{self.name}: rtype and rtype_cycle are exclusive")

    def resolve_rtype(self, pool: str, idx: int) -> str:
        if self.rtype_cycle:
            return self.rtype_cycle[idx % len(self.rtype_cycle)]
        return self.rtype if self.rtype is not None else pool

    def build_elasticity(self):
        if self.elasticity is None:
            return None
        model, param = self.elasticity
        return (AmdahlElasticity(param) if model == "amdahl"
                else LinearElasticity())


@dataclass(frozen=True)
class MixSpec:
    """Which :class:`ActionKindSpec` the stream's ``idx``-th slot draws:
    ``kinds[pattern[idx % len(pattern)]]`` — the deterministic cyclic
    mixes every legacy bench used.  (A weighted random mix is just a
    pattern sampled offline; keeping the mix deterministic keeps the
    compiled stream byte-stable.)"""

    pattern: Tuple[int, ...]
    kinds: Tuple[ActionKindSpec, ...]

    def __post_init__(self) -> None:
        _require(bool(self.kinds), "bad_mix", "mix has no action kinds")
        _require(bool(self.pattern), "bad_mix", "mix has an empty pattern")
        _require(
            all(0 <= p < len(self.kinds) for p in self.pattern),
            "bad_mix",
            f"pattern indexes outside kinds[0..{len(self.kinds) - 1}]",
        )

    def kind_at(self, idx: int) -> ActionKindSpec:
        return self.kinds[self.pattern[idx % len(self.pattern)]]


@dataclass(frozen=True)
class StreamSpec:
    """One traffic stream: a tenant (``task_id`` + fair-share weight /
    quota), an action mix, the pools it fans over, and a trajectory-id
    pattern (placeholders: ``{seq}`` ``{slot}`` ``{wave}`` ``{pool}``
    ``{pidx}`` ``{task}``).  ``phase`` offsets every index the mix and
    durations see — the fairness bench de-phases twin tenants this way."""

    mix: MixSpec
    pools: Tuple[str, ...] = ()
    task_id: str = "task0"
    weight: Optional[float] = None
    quota: Optional[float] = None
    phase: int = 0
    traj: str = "t{seq}"


# ---------------------------------------------------------------------------
# Pools (fleet topology)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PoolSpec:
    """One resource pool.  ``kind``:

    * ``pool`` — plain :class:`ResourceManager` with ``cores`` units
      (the replica-fleet pools);
    * ``cpu``  — :class:`CpuManager` over one ``cores``-core node;
    * ``gpu``  — :class:`GpuManager` over one node with one
      ``service`` at ``capacity`` (the reward-model fleet);
    * ``api``  — :class:`BasicResourceManager` with ``concurrency``
      concurrent slots (rate-limited external tools)."""

    name: str
    kind: str = "pool"
    cores: int = 8
    service: Optional[str] = None
    capacity: float = 40.0
    concurrency: int = 3

    def __post_init__(self) -> None:
        _require(self.kind in ("pool", "cpu", "gpu", "api"), "bad_pool",
                 f"{self.name}: unknown pool kind {self.kind!r}")
        if self.kind in ("pool", "cpu"):
            _require(self.cores > 0, "bad_pool",
                     f"{self.name}: cores must be > 0")
        if self.kind == "api":
            _require(self.concurrency > 0, "bad_pool",
                     f"{self.name}: concurrency must be > 0")


# ---------------------------------------------------------------------------
# Arrival processes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArrivalSpec:
    """When actions arrive.

    * ``burst``       — ``n`` actions per stream×pool at ``at``.
    * ``waves``       — ``per_wave`` actions per stream×pool every
      ``period_s``, ``waves`` times (the synchronized fleet churn).
    * ``poisson``     — exponential gaps at ``rate_hz`` until
      ``horizon_s``, round-robin over the stream's pools.
    * ``diurnal``     — non-homogeneous Poisson, rate
      ``rate_hz * (1 + amplitude * sin(2*pi*t/period_s)) / (1+amplitude)``
      sampled by thinning (peak rate ``rate_hz``).
    * ``burst_pause`` — ``burst`` same-instant actions, then silence,
      every ``period_s``, ``waves`` times.
    * ``closed_loop`` — ``prime`` actions up front (spaced
      ``prime_spacing_s`` apart; streams staggered by
      ``stream_stagger_s``), then every ``wave`` completions of a stream
      trigger a ``wave``-sized same-instant refill, bounded by ``total``
      actions and/or the ``horizon_s`` clock.
    """

    kind: str
    n: int = 0
    at: float = 0.0
    period_s: float = 1.0
    waves: int = 1
    per_wave: int = 1
    burst: int = 1
    rate_hz: float = 1.0
    amplitude: float = 0.5
    horizon_s: Optional[float] = None
    prime: int = 0
    wave: int = 1
    total: Optional[int] = None
    prime_spacing_s: float = 0.0
    stream_stagger_s: float = 0.0

    def __post_init__(self) -> None:
        kinds = ("burst", "waves", "poisson", "diurnal", "burst_pause",
                 "closed_loop")
        _require(self.kind in kinds, "bad_arrival",
                 f"unknown arrival kind {self.kind!r}")
        if self.kind in ("poisson", "diurnal"):
            _require(self.rate_hz > 0, "bad_arrival", "rate_hz must be > 0")
            _require(self.horizon_s is not None and self.horizon_s > 0,
                     "bad_arrival", f"{self.kind} arrivals need horizon_s")
        if self.kind == "diurnal":
            _require(0 <= self.amplitude <= 1, "bad_arrival",
                     "diurnal amplitude must be in [0, 1]")
        if self.kind in ("waves", "burst_pause"):
            _require(self.period_s > 0, "bad_arrival", "period_s must be > 0")
            _require(self.waves >= 1, "bad_arrival", "waves must be >= 1")
        if self.kind == "closed_loop":
            _require(self.prime >= 1, "bad_arrival",
                     "closed_loop needs prime >= 1")
            _require(self.wave >= 1, "bad_arrival",
                     "closed_loop needs wave >= 1")
            _require(self.total is not None or self.horizon_s is not None,
                     "bad_arrival",
                     "closed_loop needs a total or horizon_s bound")


# ---------------------------------------------------------------------------
# Fault schedule
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.

    * ``kill_worker``  — hard-drop every worker connection at virtual
      ``at`` (the chaos suite's kill lever).
    * ``packet``       — inject ``fault`` (``drop_submit`` /
      ``drop_recv`` / ``truncate`` / ``amnesia``) on ``shard``'s
      ``index``-th request (:class:`~repro_torch.core.transport.ChaosPlan`).
    * ``straggler``    — per-action latency inflation: actions bound to
      ``pool`` whose arrival falls in ``[at, until)`` have their
      durations multiplied by ``factor``; additionally ``plan_delay_s``
      > 0 marks worker ``worker`` a plan-phase straggler (its reported
      per-partition plan wall is inflated by that much — the rebalance
      cadence's plan-cost signal)."""

    kind: str
    at: float = 0.0
    until: Optional[float] = None
    shard: int = 0
    index: int = 0
    fault: str = "drop_recv"
    pool: Optional[str] = None
    factor: float = 1.0
    worker: Optional[int] = None
    plan_delay_s: float = 0.0

    def __post_init__(self) -> None:
        _require(self.kind in ("kill_worker", "packet", "straggler"),
                 "bad_fault", f"unknown fault kind {self.kind!r}")
        if self.kind == "packet":
            _require(
                self.fault in ("drop_submit", "drop_recv", "truncate",
                               "amnesia"),
                "bad_fault", f"unknown packet fault {self.fault!r}",
            )
        if self.kind == "straggler":
            _require(self.factor >= 1.0, "bad_fault",
                     "straggler factor must be >= 1")
            _require(self.pool is not None or self.worker is not None,
                     "bad_fault", "straggler needs a pool or a worker")


# ---------------------------------------------------------------------------
# The spec
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ScenarioSpec:
    """A complete generated scenario: fleet + streams + arrivals +
    faults (+ an optional scheduler-knob override the scenario is built
    to evaluate — the wave-forming gate specs carry theirs here)."""

    name: str
    pools: Tuple[PoolSpec, ...]
    streams: Tuple[StreamSpec, ...]
    arrival: ArrivalSpec
    seed: int = 0
    faults: Tuple[FaultSpec, ...] = ()
    policy: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        _require(bool(self.pools), "bad_spec", "spec has no pools")
        _require(bool(self.streams), "bad_spec", "spec has no streams")
        names = [p.name for p in self.pools]
        _require(len(set(names)) == len(names), "bad_pool",
                 f"duplicate pool names in {names}")
        known = set(names)
        for s in self.streams:
            for p in s.pools:
                _require(p in known, "unknown_pool",
                         f"stream {s.task_id!r} targets unknown pool {p!r}")
            for k in s.mix.kinds:
                if k.rtype is not None:
                    _require(k.rtype in known, "unknown_pool",
                             f"kind {k.name!r} targets unknown pool {k.rtype!r}")
                for rt in k.rtype_cycle:
                    _require(rt in known, "unknown_pool",
                             f"kind {k.name!r} cycles unknown pool {rt!r}")
                if self.arrival.kind == "closed_loop":
                    _require(k.duration.deterministic,
                             "closed_loop_stochastic",
                             f"kind {k.name!r}: closed-loop streams need "
                             f"deterministic durations (refill times are "
                             f"run-decided, so stochastic draws would not "
                             f"be replayable)")

    # -- fault-schedule views (what the harnesses consume) ------------
    def kill_times(self) -> Tuple[float, ...]:
        return tuple(f.at for f in self.faults if f.kind == "kill_worker")

    def packet_plan(self) -> Dict[int, Dict[int, str]]:
        plan: Dict[int, Dict[int, str]] = {}
        for f in self.faults:
            if f.kind == "packet":
                plan.setdefault(f.shard, {})[f.index] = f.fault
        return plan

    def stragglers(self) -> Tuple[FaultSpec, ...]:
        return tuple(f for f in self.faults if f.kind == "straggler")


# ---------------------------------------------------------------------------
# Wire-codec-style encoding (dict <-> spec, versioned, typed errors)
# ---------------------------------------------------------------------------

_SPEC_TYPES = {
    "duration": DurationSpec,
    "kindspec": ActionKindSpec,
    "mix": MixSpec,
    "stream": StreamSpec,
    "pool": PoolSpec,
    "arrival": ArrivalSpec,
    "fault": FaultSpec,
}


def _enc(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if v == f.default and f.default is not dataclasses.MISSING:
                continue  # sparse encoding: defaults stay implicit
            out[f.name] = _enc(v)
        return out
    if isinstance(obj, tuple):
        return [_enc(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _enc(v) for k, v in obj.items()}
    return obj


def _dec(cls, payload: Any, where: str):
    """Build dataclass ``cls`` from a dict, ignoring unknown keys (the
    wire idiom: additive fields never break an old decoder)."""
    if not isinstance(payload, dict):
        raise ScenarioError(
            "bad_field", f"{where}: expected an object, got "
            f"{type(payload).__name__}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs: Dict[str, Any] = {}
    for key, value in payload.items():
        f = fields.get(key)
        if f is None:
            continue
        kwargs[key] = _dec_field(f, value, f"{where}.{key}")
    try:
        return cls(**kwargs)
    except ScenarioError:
        raise
    except (TypeError, ValueError) as e:
        raise ScenarioError("bad_field", f"{where}: {e}") from None


def _dec_field(f, value: Any, where: str) -> Any:
    ann = str(f.type)
    if value is None:
        return None
    if "DurationSpec" in ann:
        return _dec(DurationSpec, value, where)
    if "MixSpec" in ann:
        return _dec(MixSpec, value, where)
    if "ActionKindSpec" in ann:
        return tuple(_dec(ActionKindSpec, v, f"{where}[{i}]")
                     for i, v in enumerate(value))
    if "StreamSpec" in ann:
        return tuple(_dec(StreamSpec, v, f"{where}[{i}]")
                     for i, v in enumerate(value))
    if "PoolSpec" in ann:
        return tuple(_dec(PoolSpec, v, f"{where}[{i}]")
                     for i, v in enumerate(value))
    if "ArrivalSpec" in ann:
        return _dec(ArrivalSpec, value, where)
    if "FaultSpec" in ann:
        return tuple(_dec(FaultSpec, v, f"{where}[{i}]")
                     for i, v in enumerate(value))
    if isinstance(value, list):
        # plain tuples of scalars, or the elasticity (model, param) pair
        return tuple(tuple(v) if isinstance(v, list) else v for v in value)
    return value


def encode_scenario(spec: ScenarioSpec) -> Dict[str, Any]:
    """Spec -> versioned wire dict (sparse: defaulted fields omitted)."""
    return wire.envelope("scenario_spec", {"spec": _enc(spec)})


def decode_scenario(payload: Any) -> ScenarioSpec:
    """Versioned wire dict -> validated spec (typed errors)."""
    if not isinstance(payload, dict):
        raise ScenarioError("bad_envelope", "scenario payload must be a dict")
    if payload.get("v") != wire.WIRE_VERSION:
        raise ScenarioError(
            "bad_version",
            f"scenario version {payload.get('v')!r} != {wire.WIRE_VERSION}")
    if payload.get("kind") != "scenario_spec":
        raise ScenarioError(
            "bad_envelope", f"expected kind 'scenario_spec', got "
            f"{payload.get('kind')!r}")
    body = payload.get("spec")
    return _dec(ScenarioSpec, body, "spec")


def load_scenario(path: str) -> ScenarioSpec:
    """Read + decode a spec file (JSON envelope on disk)."""
    with open(path) as f:
        return decode_scenario(json.load(f))


def save_scenario(spec: ScenarioSpec, path: str) -> None:
    with open(path, "w") as f:
        json.dump(encode_scenario(spec), f, indent=2, sort_keys=True)
        f.write("\n")


# ---------------------------------------------------------------------------
# Compilation: spec -> deterministic event stream
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ActionTemplate:
    """A frozen description of one action occurrence.  Templates are
    what the stream serializes (Actions are mutable and carry a global
    uid counter); :meth:`build` mints a fresh :class:`Action` — both the
    DES driver and the live runner build from the same templates, which
    is the replay rail's invariant."""

    name: str
    rtype: str
    units: Tuple[int, ...]
    base_duration: float
    elasticity: Optional[Tuple[str, float]] = None
    service: Optional[str] = None
    task_id: str = "task0"
    trajectory_id: str = "traj0"

    def build(self, fn: Optional[Callable[..., object]] = None) -> Action:
        kwargs: Dict[str, Any] = dict(
            name=self.name,
            cost={self.rtype: ResourceRequest(self.rtype, self.units)},
            base_duration=self.base_duration,
            task_id=self.task_id,
            trajectory_id=self.trajectory_id,
            service=self.service,
            fn=fn,
        )
        if self.elasticity is not None:
            model, param = self.elasticity
            kwargs["key_resource"] = self.rtype
            kwargs["elasticity"] = (
                AmdahlElasticity(param) if model == "amdahl"
                else LinearElasticity()
            )
        return Action(**kwargs)

    def to_dict(self) -> Dict[str, Any]:
        return _enc(self)


@dataclass(frozen=True)
class ArrivalEvent:
    """One stream occurrence: submit ``template`` at virtual ``t``
    (``None`` for closed-loop refills, whose time the run decides)."""

    t: Optional[float]
    stream: int
    template: ActionTemplate


@dataclass
class CompiledScenario:
    """The deterministic event stream a spec compiles to."""

    spec: ScenarioSpec
    events: Tuple[ArrivalEvent, ...]
    #: per stream: total actions this run may submit (None = unbounded,
    #: horizon-gated)
    totals: Tuple[Optional[int], ...]
    time_scale: float = 1.0

    def to_dict(self) -> Dict[str, Any]:
        return wire.envelope("scenario_stream", {
            "scenario": self.spec.name,
            "seed": self.spec.seed,
            "time_scale": self.time_scale,
            "events": [
                {"t": ev.t, "stream": ev.stream, **ev.template.to_dict()}
                for ev in self.events
            ],
        })

    def stream_bytes(self) -> bytes:
        """Canonical byte serialization — the bit-identical-replay rail:
        equal spec + seed must produce equal bytes, asserted in CI."""
        return json.dumps(
            self.to_dict(), sort_keys=True, separators=(",", ":")
        ).encode("utf-8")

    def fingerprint(self) -> str:
        return wire.fingerprint(self.to_dict())


def _traj(pattern: str, *, seq: int, slot: int, wave: int, pool: str,
          pidx: int, task: str) -> str:
    return pattern.format(seq=seq, slot=slot, wave=wave, pool=pool,
                          pidx=pidx, task=task)


def _straggle_factor(spec: ScenarioSpec, rtype: str,
                     t: Optional[float]) -> float:
    """Per-action latency inflation from the fault schedule (stragglers
    pinned to a pool, windowed on arrival time when it is known)."""
    factor = 1.0
    for f in spec.stragglers():
        if f.pool != rtype:
            continue
        if t is not None:
            if t < f.at or (f.until is not None and t >= f.until):
                continue
        factor *= f.factor
    return factor


def _template(spec: ScenarioSpec, stream: StreamSpec, rng: random.Random,
              *, seq: int, slot: int, wave: int, pool: str, pidx: int,
              t: Optional[float], time_scale: float) -> ActionTemplate:
    kind = stream.mix.kind_at(seq)
    rtype = kind.resolve_rtype(pool, seq)
    idx = {"seq": seq, "slot": slot, "wave": wave,
           "wave_plus_slot": wave + slot}
    dur = kind.duration.sample(idx, rng)
    dur *= _straggle_factor(spec, rtype, t)
    name = kind.name.format(rtype=rtype)
    return ActionTemplate(
        name=name,
        rtype=rtype,
        units=kind.units,
        base_duration=dur * time_scale,
        elasticity=kind.elasticity,
        service=kind.service,
        task_id=stream.task_id,
        trajectory_id=_traj(stream.traj, seq=seq, slot=slot, wave=wave,
                            pool=pool, pidx=pidx, task=stream.task_id),
    )


def _stream_rng(spec: ScenarioSpec, stream_idx: int) -> random.Random:
    # int-only seeding: str seeds hash identically everywhere, but int
    # arithmetic is simplest to reason about and version-proof
    return random.Random(spec.seed * 1_000_003 + stream_idx * 7919 + 17)


def _open_loop_times(spec: ScenarioSpec, rng: random.Random) -> List[float]:
    """Timed arrival instants for one stream (open-loop kinds only)."""
    arr = spec.arrival
    out: List[float] = []
    if arr.kind == "burst":
        out = [arr.at] * arr.n
    elif arr.kind == "waves":
        for w in range(arr.waves):
            out += [w * arr.period_s] * arr.per_wave
    elif arr.kind == "burst_pause":
        for w in range(arr.waves):
            out += [w * arr.period_s] * arr.burst
    elif arr.kind == "poisson":
        t = 0.0
        while True:
            t += -math.log(max(1e-12, 1.0 - rng.random())) / arr.rate_hz
            if t >= arr.horizon_s:
                break
            out.append(t)
    elif arr.kind == "diurnal":
        # thinning: candidates at the peak rate, accepted at rate(t)/peak
        t = 0.0
        while True:
            t += -math.log(max(1e-12, 1.0 - rng.random())) / arr.rate_hz
            if t >= arr.horizon_s:
                break
            rate = (1.0 + arr.amplitude * math.sin(
                2.0 * math.pi * t / arr.period_s)) / (1.0 + arr.amplitude)
            if rng.random() < rate:
                out.append(t)
    return out


def compile_scenario(
    spec: ScenarioSpec,
    max_actions: int = DEFAULT_MAX_ACTIONS,
    time_scale: float = 1.0,
) -> CompiledScenario:
    """Spec -> :class:`CompiledScenario`.

    Open-loop arrivals compile to fully-timed events.  Closed-loop
    arrivals compile to timed prime events plus untimed refill templates
    in deterministic draw order (bounded by ``total`` or previewed to
    ``max_actions`` for horizon-gated streams — the driver keeps drawing
    from the same pure index functions past the preview).  ``time_scale``
    multiplies every duration and arrival time — the live runner's knob
    for shrinking a virtual scenario onto real seconds."""
    events: List[ArrivalEvent] = []
    totals: List[Optional[int]] = []
    arr = spec.arrival
    for si, stream in enumerate(spec.streams):
        rng = _stream_rng(spec, si)
        pools = stream.pools or ("",)
        if arr.kind == "closed_loop":
            total = arr.total
            totals.append(total)
            n_preview = total if total is not None else max_actions
            seq = 0
            for n in range(n_preview):
                t: Optional[float]
                if n < arr.prime:
                    t = (arr.stream_stagger_s * si
                         + arr.prime_spacing_s * n) * time_scale
                else:
                    t = None
                pool = pools[0]
                idx = stream.phase + seq
                events.append(ArrivalEvent(
                    t=t, stream=si,
                    template=_template(
                        spec, stream, rng, seq=idx, slot=0, wave=0,
                        pool=pool, pidx=0, t=t, time_scale=time_scale),
                ))
                seq += 1
        elif arr.kind == "waves":
            totals.append(arr.waves * arr.per_wave * len(pools))
            for w in range(arr.waves):
                t = w * arr.period_s * time_scale
                for pidx, pool in enumerate(pools):
                    for slot in range(arr.per_wave):
                        idx = stream.phase + slot
                        events.append(ArrivalEvent(
                            t=t, stream=si,
                            template=_template(
                                spec, stream, rng, seq=idx, slot=slot,
                                wave=w, pool=pool, pidx=pidx, t=t,
                                time_scale=time_scale),
                        ))
        else:
            times = _open_loop_times(spec, rng)
            totals.append(len(times) * (1 if arr.kind != "burst" else 1))
            for n, t0 in enumerate(times):
                pidx = n % len(pools)
                pool = pools[pidx]
                t = t0 * time_scale
                idx = stream.phase + n
                events.append(ArrivalEvent(
                    t=t, stream=si,
                    template=_template(
                        spec, stream, rng, seq=idx, slot=n, wave=0,
                        pool=pool, pidx=pidx, t=t,
                        time_scale=time_scale),
                ))
    return CompiledScenario(
        spec=spec, events=tuple(events), totals=tuple(totals),
        time_scale=time_scale,
    )


# ---------------------------------------------------------------------------
# Fleet construction + the one spec-driven bench path
# ---------------------------------------------------------------------------


def build_managers(spec: ScenarioSpec, loop) -> Dict[str, Any]:
    """Instantiate the fleet a spec declares (pool order preserved —
    manager construction order is part of scenario determinism)."""
    from repro_torch.core.cluster import ApiResourceSpec, CpuNodeSpec, GpuNodeSpec
    from repro_torch.core.managers.base import ResourceManager
    from repro_torch.core.managers.basic import BasicResourceManager
    from repro_torch.core.managers.cpu import CpuManager
    from repro_torch.core.managers.gpu import GpuManager, ServiceSpec

    managers: Dict[str, Any] = {}
    for p in spec.pools:
        if p.kind == "pool":
            managers[p.name] = ResourceManager(p.name, p.cores)
        elif p.kind == "cpu":
            managers[p.name] = CpuManager([CpuNodeSpec("n0", cores=p.cores)])
        elif p.kind == "gpu":
            services = [ServiceSpec(p.service, p.capacity)] if p.service else []
            managers[p.name] = GpuManager([GpuNodeSpec("g0")], services)
        else:  # api
            managers[p.name] = BasicResourceManager(
                ApiResourceSpec(p.name, mode="concurrency",
                                max_concurrency=p.concurrency),
                loop.clock,
            )
    return managers


def build_fair_share(spec: ScenarioSpec):
    """A :class:`FairSharePolicy` when any stream declares a weight or
    quota; ``None`` otherwise (single-tenant specs stay on the FCFS
    fast path)."""
    from repro_torch.core.fairqueue import FairSharePolicy

    weights = {s.task_id: s.weight for s in spec.streams
               if s.weight is not None}
    quota = {s.task_id: s.quota for s in spec.streams
             if s.quota is not None}
    if not weights and not quota:
        return None
    return FairSharePolicy(weights=weights, quota=quota)


def build_policy(spec: ScenarioSpec, gated: bool = False):
    """The scheduler for a spec run.  ``gated=True`` applies the spec's
    ``policy`` knob overrides (the wave-forming gate configs); the
    default run is always the paper-faithful baseline scheduler."""
    from repro_torch.core.scheduler import ElasticScheduler

    knobs = dict(spec.policy) if gated else {}
    kwargs = {}
    if "estimate_units" in knobs:
        kwargs["estimate_units"] = knobs.pop("estimate_units")
    policy = ElasticScheduler(**kwargs)
    for key, value in knobs.items():
        _require(hasattr(policy, key), "bad_policy",
                 f"unknown scheduler knob {key!r}")
        setattr(policy, key, value)
    return policy


class ScenarioDriver:
    """Feeds a compiled stream into an orchestrator.

    Open-loop events are scheduled at their compiled times.  Closed-loop
    streams mirror the legacy benches exactly: primes are submitted with
    their compiled delays, and every completed action ticks its stream's
    wave counter — each full wave triggers one same-instant refill burst
    drawn from the untimed tail of the stream (templates past the
    compiled preview are drawn on demand from the same pure index
    functions, so unbounded streams never diverge from the preview)."""

    def __init__(self, compiled: CompiledScenario, orch,
                 payload: Optional[Callable[[ActionTemplate],
                                            Callable[..., object]]] = None,
                 ) -> None:
        self.compiled = compiled
        self.orch = orch
        self.payload = payload
        self.spec = compiled.spec
        self.submitted = [0] * len(self.spec.streams)
        self._events_by_stream: List[List[ArrivalEvent]] = [
            [] for _ in self.spec.streams
        ]
        for ev in compiled.events:
            self._events_by_stream[ev.stream].append(ev)
        self._wave_pending = [0] * len(self.spec.streams)

    def _build(self, template: ActionTemplate) -> Action:
        fn = self.payload(template) if self.payload is not None else None
        return template.build(fn)

    # -- template access past the compiled preview ---------------------
    def _template_at(self, si: int, n: int) -> ActionTemplate:
        evs = self._events_by_stream[si]
        if n < len(evs):
            return evs[n].template
        stream = self.spec.streams[si]
        pools = stream.pools or ("",)
        return _template(
            self.spec, stream, _stream_rng(self.spec, si),
            seq=stream.phase + n, slot=0, wave=0, pool=pools[0], pidx=0,
            t=None, time_scale=self.compiled.time_scale)

    # -- installation --------------------------------------------------
    def install(self) -> None:
        """Wire the whole stream onto the orchestrator's event loop
        (call once, before ``orch.run()``)."""
        arr = self.spec.arrival
        if arr.kind == "closed_loop":
            self._install_closed_loop()
        elif arr.kind == "waves":
            self._install_waves()
        else:
            for ev in self.compiled.events:
                self._submit_at(ev.stream, ev.template, ev.t or 0.0)
                self.submitted[ev.stream] += 1

    def _submit_at(self, si: int, template: ActionTemplate,
                   t: float, track: bool = False):
        fut = self.orch.submit(self._build(template), delay=t - self.orch.now)
        if track:
            fut.add_done_callback(lambda _f, si=si: self._on_done(si))
        return fut

    def _install_waves(self) -> None:
        # mirror the legacy fleet loop: one synchronous wave now, then a
        # self-rescheduling chain every period (identical event order)
        arr = self.spec.arrival
        by_wave: Dict[int, List[ArrivalEvent]] = {}
        for ev in self.compiled.events:
            w = int(round((ev.t or 0.0)
                          / (arr.period_s * self.compiled.time_scale)))
            by_wave.setdefault(w, []).append(ev)

        def submit_wave(w: int) -> None:
            for ev in by_wave.get(w, []):
                self.orch.submit(self._build(ev.template))
                self.submitted[ev.stream] += 1
            if w + 1 < arr.waves:
                self.orch.loop.call_after(
                    arr.period_s * self.compiled.time_scale,
                    lambda: submit_wave(w + 1))

        submit_wave(0)

    def _install_closed_loop(self) -> None:
        arr = self.spec.arrival
        for si in range(len(self.spec.streams)):
            evs = self._events_by_stream[si]
            if arr.stream_stagger_s or not arr.prime_spacing_s:
                # legacy fairness shape: one staggered same-instant burst
                t0 = arr.stream_stagger_s * si * self.compiled.time_scale

                def prime(si=si):
                    for _ in range(min(arr.prime,
                                       len(self._events_by_stream[si]))):
                        self._submit_burst_one(si)

                self.orch.loop.call_after(t0, prime)
            else:
                # legacy churn shape: spaced submit() calls made up front
                for n in range(min(arr.prime, len(evs))):
                    ev = evs[n]
                    self._submit_at(si, ev.template, ev.t or 0.0, track=True)
                    self.submitted[si] += 1

    def _submit_burst_one(self, si: int) -> None:
        n = self.submitted[si]
        total = self.compiled.totals[si]
        if total is not None and n >= total:
            return
        self.submitted[si] = n + 1
        fut = self.orch.submit(self._build(self._template_at(si, n)))
        fut.add_done_callback(lambda _f, si=si: self._on_done(si))

    def _on_done(self, si: int) -> None:
        arr = self.spec.arrival
        horizon = arr.horizon_s
        if horizon is not None and self.orch.now >= (
                horizon * self.compiled.time_scale):
            return
        total = self.compiled.totals[si]
        if total is not None and self.submitted[si] >= total:
            return
        self._wave_pending[si] += 1
        if self._wave_pending[si] < arr.wave:
            return
        self._wave_pending[si] = 0
        for _ in range(arr.wave):
            if total is not None and self.submitted[si] >= total:
                break
            self._submit_burst_one(si)


def install_scenario(spec_or_compiled, orch, payload=None) -> ScenarioDriver:
    """Compile (if needed) and install a scenario onto ``orch``.
    ``payload`` maps templates to live-mode callables (see
    :mod:`repro_torch.core.live`); sim runs leave it ``None``."""
    compiled = (
        spec_or_compiled
        if isinstance(spec_or_compiled, CompiledScenario)
        else compile_scenario(spec_or_compiled)
    )
    driver = ScenarioDriver(compiled, orch, payload=payload)
    driver.install()
    return driver


# ---------------------------------------------------------------------------
# Structural launch traces (the sim-vs-live differential rail)
# ---------------------------------------------------------------------------


def structural_trace(records) -> Dict[str, List[Tuple[str, str, str]]]:
    """Per-pool launch ORDER: ``rtype -> [(name, task, trajectory)]``
    sorted by start time.  This is the timing-free shape of a run — a
    live run must reproduce the sim's per-pool order exactly (real
    timing is reported separately, never compared)."""
    by_pool: Dict[str, List[Tuple[float, str, str, str]]] = {}
    for r in records:
        for rtype in r.units:
            by_pool.setdefault(rtype, []).append(
                (r.start, r.name, r.task_id, r.trajectory_id))
    return {
        pool: [(n, t, traj) for _, n, t, traj in sorted(rows)]
        for pool, rows in by_pool.items()
    }


# ---------------------------------------------------------------------------
# The legacy bench scenarios, re-expressed as specs
# ---------------------------------------------------------------------------

#: The churn bench's rate-limited tool fleet (DeepSearch shape).
CHURN_APIS = (
    "google_search", "web_fetch", "pdf_parse", "embed", "code_exec",
    "translate",
)


def fleet_churn_spec(queue: int = 128, waves: int = 16, cores: int = 8,
                     period_s: float = 4.0, pools: int = 8) -> ScenarioSpec:
    """The symmetric fleet churn (`shards`/`remote`/`chaos` suites):
    every wave lands the same action multiset on every pool at one
    instant, so nearly every round re-plans many dirty partitions."""
    per_pool = max(1, queue // pools)
    reward = ActionKindSpec(
        name="reward", units=(1, 2, 4, 8), elasticity=("amdahl", 0.05),
        duration=DurationSpec(kind="cycle", base=4.0, step=0.5, mod=4,
                              index="wave_plus_slot"),
    )
    tool = ActionKindSpec(
        name="tool", units=(1,),
        duration=DurationSpec(kind="cycle", base=0.5, step=0.1, mod=3,
                              index="wave"),
    )
    return ScenarioSpec(
        name="fleet_churn",
        pools=tuple(PoolSpec(f"pool{k}", kind="pool", cores=cores)
                    for k in range(pools)),
        streams=(StreamSpec(
            mix=MixSpec(pattern=(0, 0, 1), kinds=(reward, tool)),
            pools=tuple(f"pool{k}" for k in range(pools)),
            traj="p{pidx}-{wave}-{slot}",
        ),),
        arrival=ArrivalSpec(kind="waves", period_s=period_s, waves=waves,
                            per_wave=per_pool),
    )


def churn_spec(queue: int = 128, events: int = 256) -> ScenarioSpec:
    """The mixed agentic-RL churn (`latency` suite): scalable cpu/gpu
    reward backlogs plus a high-frequency stream of short rate-limited
    tool/api calls, closed-loop wave refills."""
    kinds = (
        ActionKindSpec(  # i % 8 == 0: scalable cpu reward
            name="reward", rtype="cpu", units=(1, 2, 4, 8),
            elasticity=("amdahl", 0.05),
            duration=DurationSpec(kind="cycle", base=5.0, step=1.0, mod=7),
        ),
        ActionKindSpec(  # i % 8 == 1: rigid cpu tool call
            name="tool", rtype="cpu", units=(1,),
            duration=DurationSpec(kind="cycle", base=0.5, step=0.1, mod=5),
        ),
        ActionKindSpec(  # i % 8 == 2: gpu reward-model scoring
            name="rm:score", rtype="gpu", units=(1, 2, 4),
            elasticity=("amdahl", 0.15), service="rm0",
            duration=DurationSpec(kind="cycle", base=1.0, step=0.25, mod=4),
        ),
        ActionKindSpec(  # i % 8 in 3..7: rotating rate-limited APIs
            name="api:{rtype}", rtype_cycle=CHURN_APIS, units=(1,),
            duration=DurationSpec(kind="cycle", base=0.3, step=0.2, mod=3),
        ),
    )
    return ScenarioSpec(
        name="churn",
        pools=(
            PoolSpec("cpu", kind="cpu", cores=32),
            PoolSpec("gpu", kind="gpu", service="rm0", capacity=40.0),
        ) + tuple(PoolSpec(api, kind="api", concurrency=3)
                  for api in CHURN_APIS),
        streams=(StreamSpec(
            mix=MixSpec(pattern=(0, 1, 2, 3, 3, 3, 3, 3), kinds=kinds),
            traj="c{seq}",
        ),),
        arrival=ArrivalSpec(
            kind="closed_loop", prime=queue, wave=max(8, queue // 4),
            total=queue + events, prime_spacing_s=0.001,
        ),
    )


#: The fairness bench's configured weights (targets are w_i / sum(w)).
FAIRNESS_WEIGHTS = {"heavy0": 2.0, "heavy1": 2.0, "light0": 1.0,
                    "light1": 1.0}


def _heavy_stream(task: str, phase: int) -> StreamSpec:
    score = ActionKindSpec(
        name="rm:score", rtype="gpu", units=(1, 2, 4),
        elasticity=("amdahl", 0.15), service="rm0",
        duration=DurationSpec(kind="cycle", base=1.0, step=0.2, mod=3),
    )
    reward = ActionKindSpec(
        name="reward", rtype="cpu", units=(2, 4, 8),
        elasticity=("amdahl", 0.08),
        duration=DurationSpec(kind="cycle", base=3.5, step=0.3, mod=4),
    )
    return StreamSpec(
        mix=MixSpec(pattern=(0, 0, 0, 0, 0, 1), kinds=(reward, score)),
        task_id=task, weight=FAIRNESS_WEIGHTS[task], phase=phase,
        traj="{task}-{seq}",
    )


def _light_stream(task: str, phase: int) -> StreamSpec:
    tool = ActionKindSpec(
        name="tool", rtype="cpu", units=(1,),
        duration=DurationSpec(kind="cycle", base=0.4, step=0.1, mod=3),
    )
    probe = ActionKindSpec(
        name="rm:probe", rtype="gpu", units=(1,), service="rm0",
        duration=DurationSpec(kind="fixed", base=0.3),
    )
    return StreamSpec(
        mix=MixSpec(pattern=(0, 0, 0, 0, 0, 0, 0, 1), kinds=(tool, probe)),
        task_id=task, weight=FAIRNESS_WEIGHTS[task], phase=phase,
        traj="{task}-{seq}",
    )


def fairness_spec(horizon_s: float = 90.0,
                  tasks: Optional[Sequence[str]] = None) -> ScenarioSpec:
    """The multi-tenant fairness scenario (`fairness` suite): 2 heavy +
    2 light tenants, closed-loop wave refills, horizon-gated."""
    tasks = list(tasks or FAIRNESS_WEIGHTS)
    streams = []
    for t in tasks:
        phase = 3 if t.endswith("1") else 0
        streams.append(_heavy_stream(t, phase) if t.startswith("heavy")
                       else _light_stream(t, phase))
    return ScenarioSpec(
        name="fairness",
        pools=(
            PoolSpec("cpu", kind="cpu", cores=16),
            PoolSpec("gpu", kind="gpu", service="rm0", capacity=40.0),
        ),
        streams=tuple(streams),
        arrival=ArrivalSpec(
            kind="closed_loop", prime=12, wave=6, horizon_s=horizon_s,
            stream_stagger_s=0.001,
        ),
    )


def chaos_storm_spec(queue: int = 128, waves: int = 16,
                     kill_times: Sequence[float] = (
                         5.0, 9.0, 13.0, 21.0, 29.0, 37.0)) -> ScenarioSpec:
    """The fleet churn plus the kill-storm fault schedule (`chaos`
    suite, scenario a): server-side connection drops at fixed virtual
    times, all after the warm-up window."""
    base = fleet_churn_spec(queue=queue, waves=waves)
    return dataclasses.replace(
        base, name="chaos_storm",
        faults=tuple(FaultSpec(kind="kill_worker", at=t)
                     for t in kill_times),
    )


def chaos_packet_spec(queue: int = 128, waves: int = 16) -> ScenarioSpec:
    """Fleet churn + the mixed packet-fault schedule (`chaos` b)."""
    base = fleet_churn_spec(queue=queue, waves=waves)
    plan = {
        0: {3: "drop_recv", 7: "amnesia", 10: "truncate"},
        1: {4: "drop_submit", 8: "amnesia"},
        2: {5: "amnesia", 9: "drop_recv"},
    }
    return dataclasses.replace(
        base, name="chaos_packet",
        faults=tuple(
            FaultSpec(kind="packet", shard=s, index=i, fault=f)
            for s, sched in sorted(plan.items())
            for i, f in sorted(sched.items())
        ),
    )


def chaos_amnesia_spec(queue: int = 128, waves: int = 16) -> ScenarioSpec:
    """Fleet churn + the pure-amnesia schedule (`chaos` c): silent
    worker swaps that must surface as typed stale-ref errors."""
    base = fleet_churn_spec(queue=queue, waves=waves)
    plan = {0: {3: "amnesia", 6: "amnesia"}, 1: {4: "amnesia"},
            2: {5: "amnesia"}, 3: {7: "amnesia"}}
    return dataclasses.replace(
        base, name="chaos_amnesia",
        faults=tuple(
            FaultSpec(kind="packet", shard=s, index=i, fault=f)
            for s, sched in sorted(plan.items())
            for i, f in sorted(sched.items())
        ),
    )


# ---------------------------------------------------------------------------
# Generated scenarios beyond the legacy set
# ---------------------------------------------------------------------------


def deep_congestion_spec(n: int = 24, cores: int = 48,
                         base: float = 55.0) -> ScenarioSpec:
    """The wave-forming gate's target regime: one same-instant burst of
    long, highly scalable actions (powers-of-two DoP up to 32, near-
    linear Amdahl) against a pool far smaller than aggregate demand.
    Here pricing deferred actions at min units (the paper's Alg. 2)
    spreads everything thin, while the gated config
    (``estimate_units="dp_avg"`` + ``eviction_search="exhaustive"`` +
    ``dop_floor``) forms waves at high DoP and wins on mean ACT."""
    burst = ActionKindSpec(
        name="reward", units=(1, 2, 4, 8, 16, 32),
        elasticity=("amdahl", 0.05),
        duration=DurationSpec(kind="cycle", base=base, step=1.0, mod=5),
    )
    return ScenarioSpec(
        name="deep_congestion",
        pools=(PoolSpec("cpu", kind="pool", cores=cores),),
        streams=(StreamSpec(
            mix=MixSpec(pattern=(0,), kinds=(burst,)),
            pools=("cpu",), traj="d{slot}",
        ),),
        arrival=ArrivalSpec(kind="burst", n=n),
        policy={"estimate_units": "dp_avg",
                "eviction_search": "exhaustive", "dop_floor": 8},
    )


def mid_congestion_spec(n: int = 3, cores: int = 48,
                        base: float = 55.0) -> ScenarioSpec:
    """The control for the gate: the same action shape at a depth the
    pool can absorb near max DoP — the gated config must be ~a no-op
    here (that separation is what EXPERIMENTS.md could not produce from
    the hand-written scenarios)."""
    spec = deep_congestion_spec(n=n, cores=cores, base=base)
    return dataclasses.replace(spec, name="mid_congestion")


def heavy_tail_spec(horizon_s: float = 120.0, rate_hz: float = 2.0,
                    seed: int = 11) -> ScenarioSpec:
    """Production-shaped tool latencies: Poisson arrivals of rigid tool
    calls whose durations are Pareto (alpha=1.6, heavy tail) — the
    DeepSearch latency shape the paper measures against."""
    tool = ActionKindSpec(
        name="tool", units=(1,),
        duration=DurationSpec(kind="pareto", base=0.4, alpha=1.6, hi=120.0),
    )
    return ScenarioSpec(
        name="heavy_tail", seed=seed,
        pools=(PoolSpec("cpu", kind="pool", cores=16),),
        streams=(StreamSpec(
            mix=MixSpec(pattern=(0,), kinds=(tool,)),
            pools=("cpu",), traj="h{seq}",
        ),),
        arrival=ArrivalSpec(kind="poisson", rate_hz=rate_hz,
                            horizon_s=horizon_s),
    )


def diurnal_spec(horizon_s: float = 240.0, rate_hz: float = 4.0,
                 period_s: float = 60.0, seed: int = 13) -> ScenarioSpec:
    """Diurnal waves: sinusoid-modulated Poisson arrivals of a mixed
    rigid/scalable stream over a 4-pool fleet — the
    millions-of-users-scale arrival shape, shrunk to bench time."""
    reward = ActionKindSpec(
        name="reward", units=(1, 2, 4), elasticity=("amdahl", 0.1),
        duration=DurationSpec(kind="lognormal", base=0.5, sigma=0.6,
                              hi=60.0),
    )
    tool = ActionKindSpec(
        name="tool", units=(1,),
        duration=DurationSpec(kind="lognormal", base=-0.7, sigma=0.4,
                              hi=10.0),
    )
    return ScenarioSpec(
        name="diurnal", seed=seed,
        pools=tuple(PoolSpec(f"pool{k}", kind="pool", cores=8)
                    for k in range(4)),
        streams=(StreamSpec(
            mix=MixSpec(pattern=(0, 1, 1), kinds=(reward, tool)),
            pools=("pool0", "pool1", "pool2", "pool3"), traj="u{seq}",
        ),),
        arrival=ArrivalSpec(kind="diurnal", rate_hz=rate_hz,
                            amplitude=0.8, period_s=period_s,
                            horizon_s=horizon_s),
    )


def live_smoke_spec(n_pools: int = 4, per_pool: int = 6) -> ScenarioSpec:
    """The CI live-mode scenario: ``n_pools`` single-unit device pools
    (one CUDA stream each in live mode) fed rigid kernel actions with
    strictly distinct durations — per-pool launch order is then fully
    determined by FCFS, so the sim-vs-live structural-equivalence gate
    is deterministic by construction, not by timing luck."""
    work = ActionKindSpec(
        name="kernel", units=(1,),
        duration=DurationSpec(kind="cycle", base=0.6, step=0.17, mod=7),
    )
    return ScenarioSpec(
        name="live_smoke",
        pools=tuple(PoolSpec(f"dev{k}", kind="pool", cores=1)
                    for k in range(n_pools)),
        streams=(StreamSpec(
            mix=MixSpec(pattern=(0,), kinds=(work,)),
            pools=tuple(f"dev{k}" for k in range(n_pools)),
            traj="k{pidx}-{slot}",
        ),),
        arrival=ArrivalSpec(kind="waves", period_s=2.0, waves=3,
                            per_wave=per_pool // 3 or 1),
    )


def straggler_fleet_spec(pools: int = 3, cores: int = 2, n: int = 36,
                         duration: float = 1.5, straggler_worker: int = 0,
                         plan_delay_s: float = 0.004) -> ScenarioSpec:
    """The remote-path straggler scenario (tests/test_rebalance.py):
    two equally-deep replica pools plus an idle sink, planned over a
    two-worker socket fleet where one worker's plan phase is inflated.
    Depth and starvation tie across the loaded pools, so the rebalance
    source pick falls through to the plan-cost EWMA — the straggled
    worker's pool must be the one load migrates away from.  Each loaded
    pool carries two task sub-queues: a movable sub-queue must be
    strictly smaller than the depth gap, so a single whole-pool
    sub-queue could never migrate and the rail would be vacuous."""
    work = ActionKindSpec(
        name="w", units=(1,),
        duration=DurationSpec(kind="fixed", base=duration),
    )
    loaded = [f"pool{k}" for k in range(pools - 1)]
    return ScenarioSpec(
        name="straggler_fleet",
        pools=tuple(PoolSpec(f"pool{k}", kind="pool", cores=cores)
                    for k in range(pools)),
        streams=tuple(
            StreamSpec(
                mix=MixSpec(pattern=(0,), kinds=(work,)),
                pools=(p,), task_id=f"t{p}{sub}", traj=p + sub + "-{slot}",
            )
            for p in loaded for sub in ("a", "b")
        ),
        arrival=ArrivalSpec(kind="burst", n=n // (2 * (pools - 1))),
        faults=(FaultSpec(kind="straggler", worker=straggler_worker,
                          plan_delay_s=plan_delay_s),),
    )


#: Registry of the committed generated scenarios (name -> builder), the
#: source of truth the spec files under benchmarks/scenarios/ are
#: exported from (tests assert the files match the builders).
SCENARIO_BUILDERS: Dict[str, Callable[[], ScenarioSpec]] = {
    "fleet_churn": fleet_churn_spec,
    "churn": churn_spec,
    "fairness": fairness_spec,
    "chaos_storm": chaos_storm_spec,
    "chaos_packet": chaos_packet_spec,
    "chaos_amnesia": chaos_amnesia_spec,
    "deep_congestion": deep_congestion_spec,
    "mid_congestion": mid_congestion_spec,
    "heavy_tail": heavy_tail_spec,
    "diurnal": diurnal_spec,
    "live_smoke": live_smoke_spec,
    "straggler_fleet": straggler_fleet_spec,
}

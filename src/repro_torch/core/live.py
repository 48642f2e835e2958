"""Live mode: the scenario harness on real time and real work.

The DES benches model an action as a duration; live mode *runs* it — a
real payload (the RMSNorm kernel of :mod:`repro_torch.kernels.ops`) on a
thread-pool worker, against :class:`~repro_torch.core.simulator.RealClock`,
over one CUDA stream per pool on one card (or, with ``device="cpu"``, one
CPU lane per pool running the kernel's plain version, which is how the
tests run it).

The control plane is unchanged: :class:`LiveOrchestrator` overrides
exactly one method (``_schedule_completion`` — the seam
:class:`~repro_torch.core.orchestrator.Orchestrator` exposes for this) so a
launch dispatches the payload instead of arming a virtual timer, and
completion happens when the work actually returns.  Everything else —
queues, scheduler, managers, fairness, telemetry — is the same code the
sim runs, which is what makes the **differential replay rail** honest:
the same compiled :class:`~repro_torch.core.scenarios.CompiledScenario` drives
both modes, and the live run's launch trace must be *structurally*
equivalent to the sim's (same per-pool launch order; real timing is
reported separately, never compared — see
:func:`repro_torch.core.scenarios.structural_trace`).

A pool's payloads enter its stream themselves: the current CUDA stream is
per thread, and each payload runs on a pool thread.  A payload keeps one
kernel in flight (it waits for its stream after every launch) and returns
only once the stream has drained, so an action finishes when its device
work has.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.action import Action
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.scenarios import ActionTemplate, CompiledScenario
from repro_torch.core.simulator import RealClock, _Event


class LiveModeError(RuntimeError):
    """Live-mode environment failure (no card where ``device="cuda"`` was
    asked for, a device live mode does not run on, ...)."""


class CpuLane:
    """One pool's lane on the CPU, in place of a CUDA stream: its work is
    done when the call that issued it returns, and its marks are the
    host's clock.

    A lane's surface, which :class:`CudaLane` shares: ``device``,
    ``enter()`` (make it the calling thread's current lane), ``mark()`` (a
    point on its timeline), ``elapsed_ms(a, b)`` (from mark ``a`` to mark
    ``b``) and ``synchronize()``."""

    device = torch.device("cpu")

    def __init__(self, index: int) -> None:
        self.index = index

    def enter(self):
        return nullcontext()

    def mark(self) -> float:
        return time.perf_counter()

    @staticmethod
    def elapsed_ms(a: float, b: float) -> float:
        return (b - a) * 1e3

    def synchronize(self) -> None:
        pass

    def __repr__(self) -> str:
        return f"CpuLane({self.index})"


class CudaLane(torch.cuda.Stream):
    """One pool's CUDA stream, with :class:`CpuLane`'s surface: ``enter()``
    makes it the calling thread's current stream (the current stream is per
    thread), and its marks are timing events recorded on it."""

    def enter(self):
        return torch.cuda.stream(self)

    def mark(self) -> torch.cuda.Event:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self)
        return ev

    @staticmethod
    def elapsed_ms(a: torch.cuda.Event, b: torch.cuda.Event) -> float:
        return a.elapsed_time(b)


def ensure_devices(n: int, device: str = "cuda") -> list:
    """``n`` lanes for live mode: :class:`CudaLane` streams on the card, or
    with ``device="cpu"`` :class:`CpuLane`\\ s.  Asking for ``cuda`` where
    torch sees no card raises :class:`LiveModeError`; nothing falls back
    to the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [CpuLane(i) for i in range(n)]
    if dev.type != "cuda":
        raise LiveModeError(f"live mode runs on 'cuda' or 'cpu', not {device!r}")
    if not torch.cuda.is_available():
        raise LiveModeError(
            f"live mode on {device!r} needs a CUDA card and torch sees none "
            "(pass device='cpu' for CPU lanes)"
        )
    return [CudaLane(device=dev) for _ in range(n)]


class LiveEventLoop:
    """The event loop on wall time.

    Same surface as :class:`~repro_torch.core.simulator.EventLoop` (``call_at``
    / ``call_after`` / ``cancel`` / ``run`` / ``pending`` / ``clock``),
    but timers fire at real instants and worker threads hand completions
    back with :meth:`post` (callbacks always execute on the loop thread,
    so the orchestrator stays single-threaded exactly as in sim mode).
    ``run`` drains until there are no timers, no posted callbacks, and
    no retained in-flight work."""

    def __init__(self) -> None:
        self.clock = RealClock()
        self._heap: List[_Event] = []
        self._seq = itertools.count()
        self._posted: deque = deque()
        self._cond = threading.Condition()
        self._inflight = 0

    # -- scheduling (loop thread) --------------------------------------
    def call_at(self, when: float, callback: Callable[[], None]) -> _Event:
        # real time moved on while the caller computed `when`; a
        # slightly-past deadline just means "as soon as possible"
        ev = _Event(when=when, seq=next(self._seq), callback=callback)
        with self._cond:
            heapq.heappush(self._heap, ev)
            self._cond.notify()
        return ev

    def call_after(self, delay: float, callback: Callable[[], None]) -> _Event:
        return self.call_at(self.clock.now() + max(0.0, delay), callback)

    def cancel(self, ev: _Event) -> None:
        ev.cancelled = True

    def pending(self) -> int:
        with self._cond:
            return sum(1 for e in self._heap if not e.cancelled)

    # -- worker-thread handoff -----------------------------------------
    def retain(self) -> None:
        """Mark one unit of off-loop work in flight (keeps ``run`` from
        exiting while a payload is still executing)."""
        with self._cond:
            self._inflight += 1

    def release(self) -> None:
        with self._cond:
            self._inflight -= 1
            self._cond.notify()

    def post(self, callback: Callable[[], None]) -> None:
        """Enqueue a callback from any thread; it runs on the loop
        thread ahead of timer events."""
        with self._cond:
            self._posted.append(callback)
            self._cond.notify()

    # -- the loop -------------------------------------------------------
    def run(self, until: Optional[float] = None,
            max_events: int = 1_000_000) -> float:
        n = 0
        while True:
            cb: Optional[Callable[[], None]] = None
            with self._cond:
                while True:
                    now = self.clock.now()
                    if until is not None and now >= until:
                        return now
                    if self._posted:
                        cb = self._posted.popleft()
                        break
                    while self._heap and self._heap[0].cancelled:
                        heapq.heappop(self._heap)
                    if self._heap and self._heap[0].when <= now:
                        cb = heapq.heappop(self._heap).callback
                        break
                    if not self._heap and self._inflight == 0:
                        return now
                    deadline = self._heap[0].when if self._heap else None
                    timeout = (None if deadline is None
                               else max(0.0, deadline - now))
                    if until is not None:
                        wall = max(0.0, until - now)
                        timeout = wall if timeout is None else min(timeout, wall)
                    self._cond.wait(timeout)
            cb()
            n += 1
            if n >= max_events:
                raise RuntimeError(f"event budget exceeded ({max_events})")


class LiveOrchestrator(Orchestrator):
    """The orchestrator on real work: launches dispatch the action's
    payload (``action.fn``, or a real sleep of the modeled duration) to
    a thread pool, and completion fires when the payload returns.  All
    other lifecycle paths — withdraw, deadline/retry, telemetry — are
    the inherited sim-mode code."""

    def __init__(self, managers, *, loop: Optional[LiveEventLoop] = None,
                 max_workers: int = 8, **kwargs) -> None:
        super().__init__(managers, loop=loop or LiveEventLoop(), **kwargs)
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="live-action")
        self.payload = None  # run_live_scenario's KernelPayloads, if any

    def _schedule_completion(self, action: Action, duration: float,
                             overhead: float) -> None:
        # the modeled finish is only an estimate; the real one is
        # stamped when the payload returns
        action.finish_time = self.now + overhead + duration
        loop = self.loop
        loop.retain()

        def work() -> None:
            t0 = time.monotonic()
            try:
                if action.fn is not None:
                    action.fn()
                else:
                    time.sleep(duration)
            finally:
                real_s = time.monotonic() - t0
                loop.post(lambda: self._on_live_done(action, real_s))

        self._pool.submit(work)

    def _on_live_done(self, action: Action, real_s: float) -> None:
        try:
            if action.uid not in self._executing:
                return  # withdrawn (timeout/cancel) while the work ran
            action.finish_time = self.now
            self._complete(action, real_s)
        finally:
            self.loop.release()

    def close(self) -> None:
        self._pool.shutdown(wait=True)
        super().close()


# ---------------------------------------------------------------------------
# Kernel payloads: the RMSNorm kernel on each pool's stream
# ---------------------------------------------------------------------------


class KernelPayloads:
    """Payloads that launch ``rmsnorm_op`` on f32 ``[rows, cols]`` on the
    template's pool's lane until the template's (time-scaled) duration has
    elapsed, then wait for the lane to drain.  Each lane's inputs come
    from a ``torch.Generator`` seeded with the lane's index.  Calling it
    with a template gives that template's payload.

    It records what its payloads did, per lane index: ``launches`` (kernel
    calls), ``outputs`` (the last ``(x, w, out)``) and ``windows`` (each
    action's ``(start, end)`` in milliseconds on the lanes' common
    timeline; see :func:`lane_overlap`).  Call :func:`warm_devices` first:
    the first call builds and loads the kernel."""

    def __init__(self, lanes: Sequence, pool_device: Dict[str, int], *,
                 rows: int = 64, cols: int = 64) -> None:
        self.lanes = list(lanes)
        self.pool_device = pool_device
        self.rows, self.cols = rows, cols
        self.launches: Dict[int, int] = {}
        self.outputs: Dict[int, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}
        self.windows: Dict[int, List[Tuple[float, float]]] = {}
        self._lock = threading.Lock()
        self._origin = self.lanes[0].mark()
        self.lanes[0].synchronize()

    def __call__(self, template: ActionTemplate) -> Callable[[], None]:
        from repro_torch.kernels.ops import rmsnorm_op

        idx = self.pool_device.get(template.rtype, 0) % len(self.lanes)
        lane = self.lanes[idx]
        target_s = template.base_duration

        def fn() -> None:
            with lane.enter():
                gen = torch.Generator(device=lane.device).manual_seed(idx)
                x = torch.randn(self.rows, self.cols, generator=gen, device=lane.device)
                w = torch.randn(self.cols, generator=gen, device=lane.device)
                start = lane.mark()
                t0 = time.monotonic()
                out, n = None, 0
                while time.monotonic() - t0 < target_s:
                    out = rmsnorm_op(x, w)
                    n += 1
                    lane.synchronize()  # one kernel in flight at a time
                end = lane.mark()
                lane.synchronize()
            window = (lane.elapsed_ms(self._origin, start), lane.elapsed_ms(self._origin, end))
            with self._lock:
                self.launches[idx] = self.launches.get(idx, 0) + n
                self.windows.setdefault(idx, []).append(window)
                if out is not None:
                    self.outputs[idx] = (x, w, out)

        return fn


def kernel_payload_factory(
    devices: Sequence, pool_device: Dict[str, int], *, rows: int = 64,
    cols: int = 64,
) -> KernelPayloads:
    """The RMSNorm payloads over ``devices`` (lanes of
    :func:`ensure_devices`); ``pool_device`` maps a pool to its lane's
    index.  See :class:`KernelPayloads`."""
    return KernelPayloads(devices, pool_device, rows=rows, cols=cols)


def warm_devices(devices: Sequence, *, rows: int = 8, cols: int = 64) -> int:
    """One kernel call per lane on the caller's thread, before any pool
    thread runs: the first builds and loads the kernel.  Returns the
    launches made."""
    from repro_torch.kernels.ops import rmsnorm_op

    for lane in devices:
        with lane.enter():
            x = torch.ones((rows, cols), dtype=torch.float32, device=lane.device)
            rmsnorm_op(x, torch.ones(cols, dtype=torch.float32, device=lane.device))
        lane.synchronize()
    return len(devices)


def lane_overlap(windows: Dict[int, List[Tuple[float, float]]]) -> Dict[str, float]:
    """How far the lanes' work overlapped in time, from each lane's
    ``(start, end)`` windows in milliseconds on one timeline: the lanes'
    busy milliseconds summed (each the union of its windows), the
    milliseconds in which any lane was busy, those in which two or more
    were, and their mean concurrency (busy summed / any busy)."""
    edges = []
    busy = 0.0
    for ws in windows.values():
        merged: List[List[float]] = []
        for a, b in sorted(ws):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        for a, b in merged:
            busy += b - a
            edges += [(a, 1), (b, -1)]
    if not edges:
        return {"busy_ms": 0.0, "any_ms": 0.0, "two_or_more_ms": 0.0, "concurrency": 0.0}
    edges.sort()
    any_ms = two_ms = 0.0
    depth, last = 0, edges[0][0]
    for t, d in edges:
        if depth >= 1:
            any_ms += t - last
        if depth >= 2:
            two_ms += t - last
        depth, last = depth + d, t
    return {"busy_ms": busy, "any_ms": any_ms, "two_or_more_ms": two_ms,
            "concurrency": busy / any_ms if any_ms else 0.0}


# ---------------------------------------------------------------------------
# The live runner
# ---------------------------------------------------------------------------


def run_live_scenario(
    compiled: CompiledScenario,
    *,
    devices: Optional[list] = None,
    device: str = "cuda",
    max_workers: Optional[int] = None,
    wall_limit_s: float = 300.0,
    use_kernels: bool = True,
):
    """Run a compiled scenario in live mode; returns the orchestrator
    (telemetry carries the real-time records; ``payload`` is the
    :class:`KernelPayloads`, or None).  The payloads run on ``devices``
    (lanes of :func:`ensure_devices`), by default one per pool on
    ``device``.
    ``use_kernels=False`` substitutes real sleeps for kernel work (same
    structural trace); only the caller chooses it."""
    from repro_torch.core.scenarios import build_fair_share, build_managers, \
        install_scenario
    from repro_torch.core.scheduler import ElasticScheduler

    spec = compiled.spec
    payload = None
    if use_kernels:
        devs = devices or ensure_devices(len(spec.pools), device)
        warm_devices(devs)
        pool_device = {p.name: i for i, p in enumerate(spec.pools)}
        payload = kernel_payload_factory(devs, pool_device)
    loop = LiveEventLoop()
    managers = build_managers(spec, loop)
    orch = LiveOrchestrator(
        managers,
        loop=loop,
        policy=ElasticScheduler(),
        fair_share=build_fair_share(spec),
        incremental=True,
        max_workers=max_workers or max(4, 2 * len(spec.pools)),
    )
    orch.payload = payload
    install_scenario(compiled, orch, payload=payload)
    orch.run(until=wall_limit_s)
    orch.close()
    return orch

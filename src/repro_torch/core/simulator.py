"""Discrete-event simulation engine.

ARL-Tangram's control plane is clock-agnostic: the same scheduler and
managers run against a :class:`SimClock` (benchmarks; reproduces the
paper's figures from trace-parameterized workloads) or a
:class:`RealClock` (live mode; the end-to-end example executes real JAX
work on a thread pool).  The engine is a plain binary-heap event loop.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional


class Clock:
    def now(self) -> float:  # pragma: no cover - interface
        raise NotImplementedError


class RealClock(Clock):
    def __init__(self) -> None:
        self._t0 = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._t0


class FrozenClock(Clock):
    """A clock pinned at one instant — the governing clock of manager
    snapshots rebuilt from the wire.  Planning happens at a fixed
    virtual ``now`` (no event callback runs while plans are
    outstanding), so a remote snapshot's time-dependent state (quota
    refills) must read exactly the instant the snapshot was taken."""

    def __init__(self, at: float) -> None:
        self._at = float(at)

    def now(self) -> float:
        return self._at


@dataclass(order=True)
class _Event:
    when: float
    seq: int
    callback: Callable[[], None] = field(compare=False)
    cancelled: bool = field(default=False, compare=False)


#: Relative tolerance for "same timestamp" comparisons.  Coalesced
#: same-instant events reach the heap through different float-sum paths
#: (submit_time + overheads vs finish_time - duration, ...), so their
#: timestamps can disagree by a few ulps — at virtual times around 1e6 s
#: one ulp is ~2.3e-10, far above any absolute 1e-12 guard.  Long
#: multi-tenant runs hit exactly this ("time went backwards" on events
#: that are logically simultaneous); comparing with an epsilon scaled by
#: the clock's magnitude keeps the guard meaningful at every time scale.
TIME_REL_EPS = 1e-9


def _time_tolerance(now: float) -> float:
    return TIME_REL_EPS * max(1.0, abs(now))


class SimClock(Clock):
    """Virtual time advanced by :class:`EventLoop`."""

    def __init__(self) -> None:
        self._now = 0.0

    def now(self) -> float:
        return self._now

    def _advance(self, t: float) -> None:
        if t < self._now - _time_tolerance(self._now):
            raise RuntimeError(f"time went backwards: {t} < {self._now}")
        self._now = max(self._now, t)


class EventLoop:
    """Deterministic discrete-event loop over a :class:`SimClock`."""

    def __init__(self, clock: Optional[SimClock] = None) -> None:
        self.clock = clock or SimClock()
        self._heap: List[_Event] = []
        self._seq = itertools.count()

    def call_at(self, when: float, callback: Callable[[], None]) -> _Event:
        if when < self.clock.now() - _time_tolerance(self.clock.now()):
            raise ValueError(f"cannot schedule in the past: {when} < {self.clock.now()}")
        ev = _Event(when=when, seq=next(self._seq), callback=callback)
        heapq.heappush(self._heap, ev)
        return ev

    def call_after(self, delay: float, callback: Callable[[], None]) -> _Event:
        return self.call_at(self.clock.now() + max(0.0, delay), callback)

    def cancel(self, ev: _Event) -> None:
        ev.cancelled = True

    def run(self, until: Optional[float] = None, max_events: int = 50_000_000) -> float:
        """Drain events (optionally up to virtual time ``until``)."""
        n = 0
        while self._heap:
            if until is not None and self._heap[0].when > until:
                self.clock._advance(until)
                break
            ev = heapq.heappop(self._heap)
            if ev.cancelled:
                continue
            self.clock._advance(ev.when)
            ev.callback()
            n += 1
            if n >= max_events:
                raise RuntimeError(f"event budget exceeded ({max_events})")
        return self.clock.now()

    def pending(self) -> int:
        return sum(1 for e in self._heap if not e.cancelled)


class Future:
    """Minimal future usable from both sim and live modes."""

    def __init__(self) -> None:
        self._done = threading.Event()
        self._result: object = None
        self._exc: Optional[BaseException] = None
        self._callbacks: List[Callable[["Future"], None]] = []

    def set_result(self, value: object) -> None:
        self._result = value
        self._done.set()
        for cb in self._callbacks:
            cb(self)

    def set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._done.set()
        for cb in self._callbacks:
            cb(self)

    def add_done_callback(self, cb: Callable[["Future"], None]) -> None:
        if self._done.is_set():
            cb(self)
        else:
            self._callbacks.append(cb)

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> object:
        if not self._done.wait(timeout):
            raise TimeoutError("future not resolved")
        if self._exc is not None:
            raise self._exc
        return self._result

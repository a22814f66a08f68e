"""Spans and the device trace of a traced run.

Spans come from the benchmark's own wrappers around calls into the
program's layers, on the instances a run builds (``wrap``); nothing is
added inside the program.  The device side comes from torch.profiler's
CUDA activity: every kernel and copy the card ran in the window.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


@dataclass
class Span:
    name: str
    t0: float            # host perf_counter seconds
    t1: float
    thread: str
    n: float = 0.0       # units of work the call covered (superframes, ...)


@dataclass
class DeviceOp:
    name: str
    t0: float            # seconds, on the host perf_counter clock
    t1: float


@dataclass
class Recorder:
    """Spans of one run (only a traced run fills it)."""

    on: bool = False
    spans: list = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def add(self, name: str, t0: float, t1: float, n: float = 0.0) -> None:
        if self.on:
            with self._lock:
                self.spans.append(Span(name, t0, t1,
                                       threading.current_thread().name, n))

    def wrap(self, obj, attr: str, name: str, units=None) -> None:
        """Time every call of obj.attr as a span `name`; units(result,
        args) gives the span's units of work.  Nothing when off."""
        if not self.on:
            return
        fn = getattr(obj, attr)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.add(name, t0, time.perf_counter(),
                     0.0 if units is None else units(out, args))
            return out
        setattr(obj, attr, timed)

    def total(self, name: str) -> tuple[float, float, int]:
        """(seconds, units, calls) of the spans named `name`."""
        s = [x for x in self.spans if x.name == name]
        return (sum(x.t1 - x.t0 for x in s), sum(x.n for x in s), len(s))


def device_ops(prof, mark_us: float, mark_s: float) -> list[DeviceOp]:
    """The card's operations in a torch.profiler run, on the host
    clock: the profiler's clock is tied to it by one marker event
    recorded at mark_s (perf_counter) and found at mark_us."""
    from torch.autograd import DeviceType
    ops = []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        t0 = (ev.time_range.start - mark_us) * 1e-6 + mark_s
        t1 = (ev.time_range.end - mark_us) * 1e-6 + mark_s
        ops.append(DeviceOp(ev.name, t0, t1))
    ops.sort(key=lambda o: o.t0)
    return ops


def marker_us(prof, name: str) -> float:
    for ev in prof.events():
        if ev.name == name:
            return ev.time_range.start
    raise RuntimeError(f"profiler trace lacks the marker {name!r}")


def busy_intervals(ops: list[DeviceOp], t0: float, t1: float) -> list:
    """Union of the device operations' intervals, clipped to [t0, t1]."""
    out = []
    for o in ops:
        a, b = max(o.t0, t0), min(o.t1, t1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


# host spans that only wait for the card or for the pipeline: they take
# a gap's time only where no span of host work covers it
WAITS = ("stream.wait", "mc.consume")


def idle_gaps(busy: list, t0: float, t1: float, spans: list) -> dict:
    """Seconds of device idle time in [t0, t1], by what the host was
    doing: each instant of a gap goes to a span of host work that covers
    it, else to a waiting span, else to "none"."""
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    out: dict = {}
    for waiting in (False, True):
        ivs = sorted((s.t0, s.t1, s.name) for s in spans
                     if (s.name in WAITS) == waiting)
        left = []
        for a, b in gaps:
            cur = a
            for s0, s1, name in ivs:
                if s1 <= cur:
                    continue
                if s0 >= b:
                    break
                lo = max(s0, cur)
                if lo > cur:
                    left.append((cur, lo))
                hi = min(s1, b)
                if hi > lo:
                    out[name] = out.get(name, 0.0) + (hi - lo)
                cur = max(cur, hi)
                if cur >= b:
                    break
            if cur < b:
                left.append((cur, b))
        gaps = left
    rest = sum(b - a for a, b in gaps)
    if rest > 0:
        out["none"] = rest
    return out


def top(d: dict, k: int = 10) -> list:
    return [[n, v] for n, v in sorted(d.items(), key=lambda x: -x[1])[:k]]

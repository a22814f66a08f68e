"""Spans of the port's layers, recorded while a torch.profiler records.

An entry call (``IqStream.__init__``, ``IqStream.superframes``,
``MonteCarloBatch.plan_blocks``) asks once, on its own thread, whether a
torch.profiler is recording that thread (``recorder``), and gets a
``Recorder`` or None, which it hands to any thread it starts: the
profiler's state is thread-local, so a thread the entry call starts
cannot ask for itself.  A thread that makes an entry call on behalf of
the thread that started it (``MonteCarloBatch``'s ``mc.lookahead``
thread calls ``plan_blocks``) runs it inside ``adopt(rec)``, and
``recorder`` there returns the handed Recorder.  Nothing else switches
recording on; with it off, a span site costs an ``is None`` test and a
no-op ``with``.

A span holds its name; its start and end on the ``time.perf_counter()``
clock, the clock a profiler's device trace can be mapped onto through
one marker event recorded beside a ``perf_counter()`` reading; the
thread it ran on and the span that enclosed it there (``parent``); the
unit of work that spans on different threads share (``req``: "stream
<n> / group <i>", "batch <n>"); the superframes or batches it covered
(``n``); and, where asked, the thread's CPU seconds over it (``cpu``),
the bytes it allocated (``bytes``) or the kernel rows it launched
(``rows``: a dispatch group's sub-blocks where its blocks are split).

Spans live in memory, in one process-wide list of at most ``CAP``;
``dropped()`` counts those past the cap, and ``spans(t0, t1)`` returns
those that start in a window.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch

__all__ = ["CAP", "Recorder", "Span", "adopt", "child", "dropped",
           "recorder", "serial", "span", "spans"]

CAP = 200_000


class Span(NamedTuple):
    name: str
    t0: float               # time.perf_counter() seconds
    t1: float
    thread: str
    parent: str | None      # the enclosing span on the same thread
    req: str
    n: float                # superframes or batches covered
    cpu: float | None       # the thread's CPU seconds over the span
    bytes: int              # bytes allocated
    rows: int = 0           # kernel rows launched


class _Local(threading.local):
    def __init__(self):
        self.stack: list = []     # the thread's open spans, innermost last
        self.adopted = None       # the Recorder handed to the thread (adopt)


_lock = threading.Lock()
_spans: list[Span] = []
_dropped = 0
_local = _Local()
_serials = itertools.count(1)


def serial() -> int:
    """A process-wide serial number for a stream or a batch."""
    return next(_serials)


def spans(t0: float = float("-inf"), t1: float = float("inf")) -> list:
    """The recorded spans that start in [t0, t1], in order of ending."""
    with _lock:
        return [s for s in _spans if t0 <= s.t0 <= t1]


def dropped() -> int:
    """Spans not kept because the list held CAP."""
    return _dropped


def _add(s: Span) -> None:
    global _dropped
    with _lock:
        if len(_spans) < CAP:
            _spans.append(s)
        else:
            _dropped += 1


class _Open:
    """A span being recorded: a context manager, or open()/close() where
    the caller reads the clock itself.  group, n, bytes and rows may be
    set until it closes."""

    __slots__ = ("name", "base", "group", "n", "bytes", "rows", "cpu", "t0",
                 "_c0")

    def __init__(self, name: str, base: str, group=None, n: float = 0.0,
                 nbytes: int = 0, cpu: bool = False):
        self.name, self.base, self.group = name, base, group
        self.n, self.bytes, self.rows, self.cpu = n, nbytes, 0, cpu

    def open(self, t0: float | None = None) -> _Open:
        _local.stack.append(self)
        if self.cpu:
            self._c0 = time.thread_time()
        self.t0 = time.perf_counter() if t0 is None else t0
        return self

    def close(self, t1: float | None = None) -> None:
        t1 = time.perf_counter() if t1 is None else t1
        cpu = time.thread_time() - self._c0 if self.cpu else None
        stack = _local.stack
        stack.pop()
        req = self.base if self.group is None else \
            f"{self.base} / group {self.group}"
        _add(Span(self.name, self.t0, t1, threading.current_thread().name,
                  stack[-1].name if stack else None, req, float(self.n),
                  cpu, int(self.bytes), int(self.rows)))

    def __enter__(self) -> _Open:
        return self.open()

    def __exit__(self, *exc) -> None:
        self.close()


class _Off:
    """The span of a site that records nothing."""

    __slots__ = ("group", "n", "bytes", "rows")

    def __enter__(self) -> _Off:
        return self

    def __exit__(self, *exc) -> None:
        pass


OFF = _Off()


class Recorder:
    """Opens the spans of one entry call; req names its unit of work."""

    __slots__ = ("req",)

    def __init__(self, req: str):
        self.req = req

    def span(self, name: str, group=None, n: float = 0.0,
             cpu: bool = False) -> _Open:
        """A span of this recorder's work (of its group `group`, when
        given); cpu=True also reads the thread's CPU time."""
        return _Open(name, self.req, group, n, cpu=cpu)


def recorder(kind: str, number: int | None = None) -> Recorder | None:
    """A Recorder for "<kind> <number>" (a fresh serial number when
    None) while a torch.profiler records the calling thread, else None;
    inside adopt(rec) with rec not None, rec."""
    if _local.adopted is not None:
        return _local.adopted
    if not torch.autograd._profiler_enabled():
        return None
    return Recorder(f"{kind} {serial() if number is None else number}")


@contextlib.contextmanager
def adopt(rec: Recorder | None):
    """recorder() on this thread returns rec while the block runs: the
    Recorder (or None) that the thread which started this one handed
    it."""
    _local.adopted = rec
    try:
        yield
    finally:
        _local.adopted = None


def span(rec: Recorder | None, name: str, group=None, n: float = 0.0,
         cpu: bool = False):
    """rec.span(...), or a span that records nothing when rec is None."""
    if rec is None:
        return OFF
    return rec.span(name, group, n, cpu)


def child(name: str, nbytes: int = 0, n: float = 0.0):
    """A span inside the thread's innermost open span, of its unit of
    work; one that records nothing where the thread has no open span."""
    stack = _local.stack
    if not stack:
        return OFF
    top = stack[-1]
    return _Open(name, top.base, top.group, n, nbytes)

"""The port's span recorder (pluto_gps_sim_tpu_torch.runtime.trace).

It records only while a torch.profiler records the thread that starts
the work, hands its recorder to the stream's planner thread, and leaves
the output byte for byte as it is untraced.  Runs are the CPU twin at
1 MHz: a K=2 IqStream of 7 blocks in plans of at most 3 (its blocks
also split into 3 sub-rows under a lowered kernel range), and a B=3
MonteCarloBatch of 3 blocks, alone or as generate calls of 3, 3, 3 and 2
blocks (the second call's lookahead is taken by the third, the third's
discarded by the fourth).  transfer.pin_alloc is recorded only on a
card (pinned staging and output buffers); the benchmark's traced runs
read it there.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from pluto_gps_sim_tpu_torch.ingest import read_rinex2
from pluto_gps_sim_tpu_torch.models.geodesy import llh2xyz
from pluto_gps_sim_tpu_torch.parallel import MonteCarloBatch
from pluto_gps_sim_tpu_torch.runtime import (select_ephemeris_set,
                                             setup_scenario, trace)
from pluto_gps_sim_tpu_torch.runtime.stream import SF_BLOCKS, IqStream

TOKYO = np.array([35.681298 / 57.2957795131, 139.766247 / 57.2957795131,
                  10.0])
FS = 1_000_000.0
BLOCKS, MAX_BLOCKS = 7, 3

STREAM_SPANS = {"stream.init", "stream.plan", "scheduler.solve",
                "stream.prepare", "stream.dispatch", "stream.queue_wait",
                "transfer.event_wait", "stream.unpack"}
MC_SPANS = {"mc.plan_blocks", "mc.solve", "mc.plan", "mc.build"}
MC_PARTS = {"mc.solve", "mc.plan", "mc.build"}
# one batch, and batches back to back: one lookahead taken, one discarded
BATCHES = {"one": (3,), "ahead": (3, 3, 3, 2)}
# every span but stream.init and the consumer's last queue wait (for the
# end of the stream) belongs to a dispatch group
GROUP_SPANS = STREAM_SPANS - {"stream.init"}


@pytest.fixture(scope="module")
def scenario(fixture_paths):
    rin = read_rinex2(fixture_paths["rinex2"])
    g0 = setup_scenario(rin, None)
    return rin, g0, select_ephemeris_set(rin, g0), np.asarray(llh2xyz(TOKYO))


def _stream(scenario):
    rin, g0, ieph, xyz = scenario
    st = IqStream(rin, g0, ieph, xyz, fs=FS, device="cpu",
                  superframes_per_dispatch=2)
    return np.concatenate(list(st.superframes(BLOCKS,
                                              max_blocks=MAX_BLOCKS)))


def _batch(scenario, calls=BATCHES["one"]):
    """(the batch, its IQ [B, sum(calls), N, 2]) of one generate call
    per entry of calls, in a row."""
    rin, g0, ieph, xyz = scenario
    rx = xyz[None, :] + np.array([[0.0, 0, 0], [500, 0, 0], [0, 500, 0]])
    mc = MonteCarloBatch(rin, g0, ieph, rx, fs=FS)
    return mc, np.concatenate([mc.generate(n, "cpu") for n in calls],
                              axis=1)


def _traced(fn, *args):
    """(fn's result, the spans that started during it) under a
    torch.profiler."""
    with torch.profiler.profile():
        t0 = time.perf_counter()
        out = fn(*args)
        t1 = time.perf_counter()
    return out, trace.spans(t0, t1)


def test_no_profiler_records_nothing(scenario):
    t0 = time.perf_counter()
    _stream(scenario)
    for calls in BATCHES.values():
        _batch(scenario, calls)
    assert trace.spans(t0, time.perf_counter()) == []


def test_traced_stream_same_bytes_and_every_span(scenario):
    plain = _stream(scenario)
    iq, spans = _traced(_stream, scenario)
    assert np.array_equal(iq, plain)
    assert {s.name for s in spans} == STREAM_SPANS
    planner = [s for s in spans if s.name in ("stream.plan",
                                              "stream.prepare",
                                              "stream.dispatch")]
    assert {s.thread for s in planner} == {"iqstream-planner"}
    assert all(s.cpu is not None and s.cpu >= 0 for s in planner)


@pytest.mark.parametrize("calls", BATCHES)
def test_traced_batch_same_bytes_and_every_span(scenario, calls):
    """A lookahead's mc.plan_blocks records on its own thread, one
    batch each; mc.lookahead_wait on the caller's, n 1 where the call
    took the lookahead's planes and 0 where it discarded them."""
    calls = BATCHES[calls]
    _, plain = _batch(scenario, calls)
    (mc, iq), spans = _traced(_batch, scenario, calls)
    assert np.array_equal(iq, plain)
    ahead = len(calls) > 1
    assert {s.name for s in spans} == \
        MC_SPANS | ({"mc.lookahead_wait"} if ahead else set())
    assert (mc.lookahead_hits, mc.lookahead_misses) == \
        ((1, 1) if ahead else (0, 0))
    top = [s for s in spans if s.name == "mc.plan_blocks"]
    # a batch planned for each call but the hit, and one per lookahead
    assert len(top) == len(calls) + mc.lookahead_misses
    assert all(s.n == 1.0 for s in top)
    main = threading.current_thread().name
    assert sorted(s.thread for s in top) == sorted(
        [main] * (len(calls) - mc.lookahead_hits)
        + ["mc.lookahead"] * (mc.lookahead_hits + mc.lookahead_misses))
    waits = [s for s in spans if s.name == "mc.lookahead_wait"]
    assert [s.n for s in sorted(waits, key=lambda s: s.t0)] == \
        ([1.0, 0.0] if ahead else [])
    assert all(s.thread == main and s.parent is None for s in waits)
    # a wait shares its batch's req with the lookahead that planned it
    assert {s.req for s in waits} == \
        {s.req for s in top if s.thread == "mc.lookahead"}


def _nested(spans):
    """Every span with a parent lies inside an open span of that name on
    its own thread, of the same unit of work."""
    for s in spans:
        if s.parent is None:
            continue
        assert any(p.name == s.parent and p.thread == s.thread
                   and p.req == s.req and p.t0 <= s.t0 and s.t1 <= p.t1
                   for p in spans), s


def test_stream_spans_nest_and_groups_share_req(scenario):
    _, spans = _traced(_stream, scenario)
    _nested(spans)
    assert {s.parent for s in spans if s.name == "scheduler.solve"} == \
        {"stream.plan"}
    stream = next(s.req for s in spans if s.name == "stream.init")
    groups: dict = {}
    for s in spans:
        if s.req != stream:
            groups.setdefault(s.req, set()).add(s.name)
    # ramp 1 then 2 superframes a group: 3 blocks, then 3 + 1
    assert sorted(groups) == [f"{stream} / group 0", f"{stream} / group 1"]
    for names in groups.values():
        assert names == GROUP_SPANS
    # the consumer's spans and the planner's, on two threads
    assert {s.thread for s in spans if s.name == "stream.queue_wait"} == \
        {threading.current_thread().name}


def test_queue_wait_counts_every_superframe_delivered(scenario):
    iq, spans = _traced(_stream, scenario)
    got = sum(s.n for s in spans if s.name == "stream.queue_wait")
    assert got == pytest.approx(iq.shape[0] / SF_BLOCKS)
    assert sum(s.n for s in spans if s.name == "stream.plan") == \
        pytest.approx(BLOCKS / SF_BLOCKS)


@pytest.mark.parametrize("calls", BATCHES)
def test_batch_parts_fall_inside_plan_blocks(scenario, calls):
    """Every mc.plan_blocks, the caller's and the lookahead's alike,
    holds its three parts, on its own thread and of its own batch."""
    _, spans = _traced(_batch, scenario, BATCHES[calls])
    _nested(spans)
    tops = [s for s in spans if s.name == "mc.plan_blocks"]
    parts = [s for s in spans if s.name in MC_PARTS]
    assert len({s.req for s in tops}) == len(tops)
    for top in tops:
        mine = [s for s in parts if s.req == top.req]
        assert {s.name for s in mine} == MC_PARTS
        for s in mine:
            assert s.parent == "mc.plan_blocks" and s.thread == top.thread
            assert top.t0 <= s.t0 <= s.t1 <= top.t1
        assert sum(s.t1 - s.t0 for s in mine) <= top.t1 - top.t0
    assert sum(len([s for s in parts if s.req == top.req])
               for top in tops) == len(parts)


def test_unsplit_dispatch_counts_a_row_a_block(scenario):
    _, spans = _traced(_stream, scenario)
    assert not [s for s in spans if s.name == "packing.split"]
    dispatch = [s for s in spans if s.name == "stream.dispatch"]
    assert [s.rows for s in dispatch] == \
        [round(s.n * SF_BLOCKS) for s in dispatch]
    assert sum(s.rows for s in dispatch) == BLOCKS
    assert all(s.rows == 0 for s in spans if s.name != "stream.dispatch")


def test_split_stream_spans_and_rows(scenario, monkeypatch):
    """Blocks past a lowered kernel range (1 MHz blocks of 100,000
    samples, range 40,000: 3 sub-rows a block): packing.split inside
    stream.prepare covers every superframe split, and each group's
    stream.dispatch carries its sub-rows, 3 a block; untraced, nothing."""
    from pluto_gps_sim_tpu_torch.ops import synth_cuda as sc
    monkeypatch.setattr(sc, "MAX_BLOCK_SAMPLES", 40_000)
    t0 = time.perf_counter()
    plain = _stream(scenario)
    assert trace.spans(t0, time.perf_counter()) == []
    iq, spans = _traced(_stream, scenario)
    assert np.array_equal(iq, plain)
    _nested(spans)
    split = [s for s in spans if s.name == "packing.split"]
    assert split and {s.parent for s in split} == {"stream.prepare"}
    assert {s.thread for s in split} == {"iqstream-planner"}
    assert sum(s.n for s in split) == pytest.approx(BLOCKS / SF_BLOCKS)
    dispatch = [s for s in spans if s.name == "stream.dispatch"]
    assert [s.rows for s in dispatch] == \
        [3 * round(s.n * SF_BLOCKS) for s in dispatch]
    assert sum(s.rows for s in dispatch) == 3 * BLOCKS


def test_cap_counts_dropped_spans(scenario, monkeypatch):
    _, full = _traced(_stream, scenario)
    monkeypatch.setattr(trace, "CAP", 3)
    monkeypatch.setattr(trace, "_spans", [])
    monkeypatch.setattr(trace, "_dropped", 0)
    _, spans = _traced(_stream, scenario)
    assert len(spans) == 3
    assert trace.dropped() == len(full) - 3


def test_thread_started_under_profiler_is_not_recorded():
    """Why an entry call hands its recorder to the threads it starts:
    the profiler's state is the starting thread's alone."""
    seen = {}

    def ask():
        seen["rec"] = trace.recorder("probe")
    with torch.profiler.profile():
        assert trace.recorder("probe") is not None
        t = threading.Thread(target=ask)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert seen["rec"] is None

"""The Monte-Carlo batch's lookahead metrics, mc.exposed_control_s_per_batch
and mc.lookahead_hit_pct, on synthetic span lists (the program's
runtime/trace spans as a traced run would leave them) and on the
static-2m6.mc256 cell at the CPU tests' sizes.  Where nothing plans
ahead (the parent), the first reads the whole control plane a batch and
the second 0 %."""

import math

import pytest
import torch

from conftest import HOOKS, SEED, tiny
from harness import spec as specmod
from harness.runner import Run, run_cell

EXPOSED = "mc.exposed_control_s_per_batch"
HITS = "mc.lookahead_hit_pct"
CELL = "static-2m6.mc256"


def _span(name, t0, t1, thread="MainThread", n=0.0, parent=None):
    from pluto_gps_sim_tpu_torch.runtime.trace import Span
    return Span(name, t0, t1, thread, parent, "batch 1", n, None, 0)


def _plan(t0, t1, thread="MainThread"):
    """A batch's mc.plan_blocks with its three parts."""
    third = (t1 - t0) / 3
    return [_span("mc.plan_blocks", t0, t1, thread, 1.0)] + [
        _span(name, t0 + k * third, t0 + (k + 1) * third, thread,
              parent="mc.plan_blocks")
        for k, name in enumerate(("mc.solve", "mc.plan", "mc.build"))]


def _wait(t0, t1, hit):
    return [_span("mc.lookahead_wait", t0, t1, n=float(hit))]


# (spans, exposed s a batch, hit %) over a window of [0, 10] s
CASES = {
    # the parent: three batches, each planned by its call, 0.7 s
    "parent": (_plan(0.0, 0.7) + _plan(1.0, 1.7) + _plan(2.0, 2.7),
               0.7, 0.0),
    # back to back: the window's first call waits 0.4 s for the planes
    # a lookahead began before the window; the next two take theirs
    # after 0.3 s waits; each starts a 0.7 s lookahead of the next batch
    "ahead": (_plan(-0.5, 0.2, "mc.lookahead") + _wait(0.0, 0.4, True)
              + _plan(0.5, 1.2, "mc.lookahead") + _wait(1.0, 1.3, True)
              + _plan(1.4, 2.1, "mc.lookahead") + _wait(2.0, 2.3, True)
              + _plan(2.4, 3.1, "mc.lookahead"),
              (0.4 + 0.3 + 0.3) / 3, 100.0),
    # a call with another n_blocks waits 0.2 s to discard the pending
    # lookahead and plans its own batch (0.6 s): one call of two hit
    "miss": (_wait(0.0, 0.4, True) + _plan(0.5, 1.2, "mc.lookahead")
             + _wait(1.0, 1.2, False) + _plan(1.2, 1.8),
             (0.4 + 0.2 + 0.6) / 2, 50.0),
}


@pytest.fixture
def window(monkeypatch):
    """A Run of the window [0, 10] whose program spans are `spans`."""
    from pluto_gps_sim_tpu_torch.runtime import trace

    def make(spans):
        monkeypatch.setattr(
            trace, "spans",
            lambda t0=-math.inf, t1=math.inf: [s for s in spans
                                                if t0 <= s.t0 <= t1])
        run = Run(CELL, "batch")
        run.t0, run.t1 = 0.0, 10.0
        return run
    return make


@pytest.mark.parametrize("case", CASES)
def test_lookahead_metrics_read_synthetic_spans(window, case):
    spans, exposed, hits = CASES[case]
    run = window(spans)
    assert specmod.metric_reader(EXPOSED)(run) == pytest.approx(exposed)
    assert specmod.metric_reader(HITS)(run) == pytest.approx(hits)


@pytest.mark.parametrize("name", [EXPOSED, HITS])
def test_lookahead_metrics_read_nothing_without_spans(window, name):
    """No batch span in the window (untraced, or a stream cell): no
    value, not a zero."""
    assert specmod.metric_reader(name)(window([])) is None
    assert specmod.metric_reader(name)(
        window([_span("stream.plan", 1.0, 2.0)])) is None


def test_lookahead_metrics_listed_for_the_batch_cell_only(spec):
    for cell in (w["name"] for w in spec["workloads"]):
        names = {m["name"] for m in specmod.metrics_for(spec, cell, True)}
        assert names & {EXPOSED, HITS} == (
            {EXPOSED, HITS} if cell == CELL else set()), cell


def test_mc256_cell_reads_its_lookahead(spec):
    """Two warm-up batches, the second of which plans the first window
    batch ahead: the window's one call takes it, so every call hit."""
    with torch.profiler.profile():
        out = run_cell(spec, CELL, SEED, 0.0, True, "cpu",
                       overrides=tiny(spec, CELL, warm_batches=2),
                       hooks=HOOKS)
    assert out["correct"], out["checks"]
    assert out["metrics"][HITS]["value"] == 100.0
    v = out["metrics"][EXPOSED]["value"]
    assert math.isfinite(v) and v >= 0

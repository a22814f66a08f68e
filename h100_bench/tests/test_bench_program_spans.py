"""The per-layer metrics that read the program's own spans
(pluto_gps_sim_tpu_torch.runtime.trace): each cell run at the CPU
tests' sizes inside an outer torch.profiler, which switches the
program's recorder on, gives a finite reading of every such metric it
lists."""

import math

import pytest
import torch

from conftest import HOOKS, SEED, tiny
from harness import spec as specmod
from harness.runner import run_cell

CELLS = ["static-2m6.stream", "motion-5m.stream", "static-2m6.mc256",
         "static-2m6.ttff-clips"]
# the metrics read from the program's spans, not from the benchmark's
# wrappers around its calls (run.rec)
PROGRAM_SPAN_METRICS = {
    "control.plan_ms_per_sf", "control.solve_ms_per_sf",
    "packing.prepare_ms_per_sf", "transfer.pin_alloc_ms_per_sf",
    "stream.queue_wait_ms_per_sf", "transfer.event_wait_ms_per_sf",
    "planner.offcpu_pct", "mc.solve_s_per_batch", "mc.plan_s_per_batch",
    "mc.build_s_per_batch", "control.first_plan_ms", "control.init_ms"}


def _program_span_metrics(spec, cell):
    return [m["name"] for m in specmod.metrics_for(spec, cell, True)
            if m["name"] in PROGRAM_SPAN_METRICS]


@pytest.mark.parametrize("cell", CELLS)
def test_program_span_metrics_read_finite(spec, cell):
    names = _program_span_metrics(spec, cell)
    assert names, cell
    with torch.profiler.profile():
        out = run_cell(spec, cell, SEED, 0.0, True, "cpu",
                       overrides=tiny(spec, cell), hooks=HOOKS)
    assert out["correct"], out["checks"]
    for name in names:
        assert name in out["metrics"], (name, out["metrics"])
        v = out["metrics"][name]["value"]
        assert math.isfinite(v) and v >= 0, (name, v)


def test_program_span_metrics_read_nothing_untraced(spec):
    """Without a profiler the program records nothing, and the readers
    return no value rather than a zero."""
    cell = "static-2m6.stream"
    out = run_cell(spec, cell, SEED, 0.0, True, "cpu",
                   overrides=tiny(spec, cell), hooks=HOOKS)
    assert not set(_program_span_metrics(spec, cell)) & set(out["metrics"])

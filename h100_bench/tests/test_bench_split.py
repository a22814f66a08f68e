"""The split-block cell (wide-10m.stream) on the CPU, at the tests' tiny
sizes: at 1 MHz a block has 100,000 samples, under the kernel's Q24
range, so the range is lowered to 40,000 samples and every block splits
into 3 sub-blocks of 33,334 (K x sub > N, so the reassembly trims), as
every block of the cell splits on the card.  A sound run is correct
against the reference's unsplit f64 closed form; the float32 control and
an answer altered where the kernel produces it are not; and
packing.split_ms_per_sf reads the program's packing.split span."""

import math

import pytest
import torch

from conftest import HOOKS, SEED, tiny
from harness import judge
from harness.runner import run_cell

CELL = "wide-10m.stream"
CAP = 40_000            # the kernel's range at the tests' sizes
METRIC = "packing.split_ms_per_sf"


@pytest.fixture
def split_cap(monkeypatch):
    from pluto_gps_sim_tpu_torch.ops import synth_cuda
    monkeypatch.setattr(synth_cuda, "MAX_BLOCK_SAMPLES", CAP)


def _run(spec, cell=CELL, trace=False, control=False):
    return run_cell(spec, cell, SEED, 0.0, trace, "cpu",
                    overrides=tiny(spec, cell), control=control,
                    hooks=HOOKS)


def test_sound_split_run_is_correct(spec, split_cap, monkeypatch):
    """The cell's program runs IqStream with split_k 3 at this size, and
    its blocks pass the gate."""
    from pluto_gps_sim_tpu_torch.runtime.stream import IqStream
    seen = []
    init = IqStream.__init__

    def recorded(self, *args, **kwargs):
        init(self, *args, **kwargs)
        seen.append((self.split_k, self.sub_block_samples))
    monkeypatch.setattr(IqStream, "__init__", recorded)
    out = _run(spec)
    assert out["correct"], out["checks"]
    assert out["checks"]["blocks"]["value"] > 0
    assert seen and set(seen) == {(3, 33_334)}


def test_float32_control_is_not_correct_on_split_cell(spec, split_cap):
    out = _run(spec, control=True)
    assert not out["correct"]
    r = out["info"]["readings"]
    assert (r["mismatch_frac"] > judge.LIMITS["mismatch_frac"]
            or r["max_err"] > judge.LIMITS["max_err"])


def test_altered_sub_row_is_not_correct(spec, split_cap, monkeypatch):
    """One word of every sub-row off by 1,000 in I, where the kernel
    produces it."""
    from pluto_gps_sim_tpu_torch.ops import synth_cuda
    synth = synth_cuda.synth_blocks

    def altered(*args, **kwargs):
        out = synth(*args, **kwargs).clone()
        out[:, 7] += 1000
        return out
    monkeypatch.setattr(synth_cuda, "synth_blocks", altered)
    out = _run(spec)
    assert not out["correct"], out["checks"]


def test_split_metric_reads_the_program_span(spec, split_cap):
    with torch.profiler.profile():
        out = _run(spec, trace=True)
    assert out["correct"], out["checks"]
    v = out["metrics"][METRIC]["value"]
    assert math.isfinite(v) and v > 0, v


def test_split_metric_reads_nothing_untraced(spec, split_cap):
    """Without a profiler the program records nothing, and the reader
    returns no value rather than a zero."""
    out = _run(spec, trace=True)
    assert out["correct"], out["checks"]
    assert METRIC not in out["metrics"]


def test_split_metric_reads_nothing_where_no_block_splits(spec):
    """At the kernel's own range the tiny cell's 100,000-sample blocks
    are not split: no packing.split span, no reading (as on a program
    that records no such span)."""
    with torch.profiler.profile():
        out = _run(spec, trace=True)
    assert out["correct"], out["checks"]
    assert METRIC not in out["metrics"]
    assert "packing.prepare_ms_per_sf" in out["metrics"]

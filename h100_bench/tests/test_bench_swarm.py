"""The split-block batch cell (swarm-10m.mc256) on the CPU, at the tests'
tiny sizes: at 1 MHz a block has 100,000 samples, under the kernel's Q24
range, so the range is lowered to 40,000 samples and every block of the
batch splits into 3 sub-rows of 33,334 (K x sub > N, so the blocks the
batch yields are trimmed views), as every block of the cell splits on
the card.  A sound run is correct against the reference's unsplit f64
closed form; the float32 control and an answer altered where the kernel
produces it are not; and mc.split_s_per_batch reads the program's
packing.split spans under mc.build, on the caller's thread and on the
lookahead's."""

import math

import pytest
import torch

from conftest import HOOKS, SEED, tiny
from harness import judge
from harness.runner import run_cell

CELL = "swarm-10m.mc256"
CAP = 40_000            # the kernel's range at the tests' sizes
METRIC = "mc.split_s_per_batch"


@pytest.fixture
def split_cap(monkeypatch):
    from pluto_gps_sim_tpu_torch.ops import synth_cuda
    monkeypatch.setattr(synth_cuda, "MAX_BLOCK_SAMPLES", CAP)


def _run(spec, trace=False, control=False):
    return run_cell(spec, CELL, SEED, 0.0, trace, "cpu",
                    overrides=tiny(spec, CELL), control=control,
                    hooks=HOOKS)


def test_sound_split_batch_is_correct(spec, split_cap, monkeypatch):
    """The cell's program runs MonteCarloBatch with split_k 3 at this
    size, and its rows pass the gate."""
    from pluto_gps_sim_tpu_torch.parallel import MonteCarloBatch
    seen = []
    init = MonteCarloBatch.__init__

    def recorded(self, *args, **kwargs):
        init(self, *args, **kwargs)
        seen.append((self.split_k, self.sub_block_samples))
    monkeypatch.setattr(MonteCarloBatch, "__init__", recorded)
    out = _run(spec)
    assert out["correct"], out["checks"]
    assert out["checks"]["blocks"]["value"] > 0
    assert seen == [(3, 33_334)]


def test_float32_control_is_not_correct_on_swarm(spec, split_cap):
    out = _run(spec, control=True)
    assert not out["correct"]
    r = out["info"]["readings"]
    assert (r["mismatch_frac"] > judge.LIMITS["mismatch_frac"]
            or r["max_err"] > judge.LIMITS["max_err"])


def test_altered_sub_row_is_not_correct_on_swarm(spec, split_cap,
                                                 monkeypatch):
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


def test_split_metric_reads_the_program_spans(spec, split_cap):
    """The window's call plans its batch on the caller's thread and
    starts a lookahead, which plans the next on its own: both record
    packing.split under mc.build, and the metric reads them."""
    from pluto_gps_sim_tpu_torch.runtime import trace
    before = len(trace.spans())
    with torch.profiler.profile():
        out = _run(spec, trace=True)
    assert out["correct"], out["checks"]
    v = out["metrics"][METRIC]["value"]
    assert math.isfinite(v) and v > 0, v
    split = [s for s in trace.spans()[before:] if s.name == "packing.split"]
    assert split and {s.parent for s in split} == {"mc.build"}
    assert "mc.lookahead" in {s.thread for s in split}
    assert len({s.thread for s in split}) == 2
    pins = [s for s in trace.spans()[before:]
            if s.name == "transfer.pin_alloc"]
    assert not pins, "a CPU batch stages nothing in pinned memory"


def test_split_metric_reads_nothing_untraced(spec, split_cap):
    """Without a profiler the program records nothing, and the reader
    returns no value rather than a zero."""
    out = _run(spec, trace=True)
    assert out["correct"], out["checks"]
    assert METRIC not in out["metrics"]


def test_split_metric_reads_nothing_where_no_block_splits(spec):
    """At the kernel's own range the tiny cell's 100,000-sample blocks
    are not split: no packing.split span, no reading (as on a program
    whose batch does not split), while the build is read."""
    with torch.profiler.profile():
        out = _run(spec, trace=True)
    assert out["correct"], out["checks"]
    assert METRIC not in out["metrics"]
    assert "mc.build_s_per_batch" in out["metrics"]

"""What decides `correct`, driven end to end on the CPU at a tiny size:
sound runs pass, the float32 control fails, and so does each fault the
cells can have, planted under the timed path."""

import numpy as np
import pytest
import torch

from conftest import HOOKS, SEED, tiny
from harness import judge
from harness.runner import run_cell

CELLS = ["static-2m6.stream", "motion-5m.stream", "static-2m6.mc256",
         "static-2m6.ttff-clips"]
# 0.3 s before a 30 s boundary: a stream's first segment is two groups
NEAR_BOUNDARY = {"start_s": 5 * 3600 + 29.7}


def _run(spec, cell, seconds=0.0, control=False, hooks=None, **traffic):
    return run_cell(spec, cell, SEED, seconds, False, "cpu",
                    overrides=tiny(spec, cell, **traffic), control=control,
                    hooks={**HOOKS, **(hooks or {})})


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(spec, cell):
    out = _run(spec, cell)
    assert out["correct"], out["checks"]
    assert out["checks"]["blocks"]["value"] > 0
    assert list(out["checks"])[-1] == "blocks"


@pytest.mark.parametrize("cell", CELLS)
def test_float32_control_is_not_correct(spec, cell):
    out = _run(spec, cell, control=True)
    assert not out["correct"]
    r = out["info"]["readings"]
    assert r["mismatch_frac"] > judge.LIMITS["mismatch_frac"]
    assert r["max_err"] > judge.LIMITS["max_err"]


def _altered(synth):
    """The kernel's answer altered where it is produced: one word of
    every row off by 1,000 in I."""
    def wrapped(*args, **kwargs):
        out = synth(*args, **kwargs).clone()
        out[:, 7] += 1000
        return out
    return wrapped


def _half_left_out(synth):
    """Half of the batch left out: the rows past the middle of every
    launch stay zero."""
    def wrapped(*args, **kwargs):
        out = synth(*args, **kwargs).clone()
        out[out.shape[0] // 2:] = 0
        return out
    return wrapped


@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer_is_not_correct(spec, cell, monkeypatch):
    from pluto_gps_sim_tpu_torch.ops import synth_cuda
    monkeypatch.setattr(synth_cuda, "synth_blocks",
                        _altered(synth_cuda.synth_blocks))
    out = _run(spec, cell)
    assert not out["correct"], out["checks"]


def test_half_of_the_batch_left_out_is_not_correct(spec, monkeypatch):
    from pluto_gps_sim_tpu_torch.ops import synth_cuda
    monkeypatch.setattr(synth_cuda, "synth_blocks",
                        _half_left_out(synth_cuda.synth_blocks))
    out = _run(spec, "static-2m6.mc256", sample=64)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["static-2m6.stream", "static-2m6.mc256"])
def test_step_that_leaves_its_state_unchanged_is_not_correct(
        spec, cell, monkeypatch):
    """The scheduler's step plans a superframe and returns the state as
    it found it, so the next superframe repeats the time it planned."""
    from pluto_gps_sim_tpu_torch.runtime.scheduler import Scheduler
    plan = Scheduler.plan

    def unchanged(self, *args, **kwargs):
        keep = (self.jblk, self.ieph,
                {k: np.copy(v) for k, v in vars(self.state).items()})
        out = plan(self, *args, **kwargs)
        self.jblk, self.ieph = keep[0], keep[1]
        for k, v in keep[2].items():
            setattr(self.state, k, v)
        return out
    monkeypatch.setattr(Scheduler, "plan", unchanged)
    out = _run(spec, cell, seconds=3.0, hooks=NEAR_BOUNDARY, sample=64)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["static-2m6.stream", "static-2m6.ttff-clips"])
def test_ionosphere_setting_reaches_both_sides(spec, cell, monkeypatch):
    """A configuration with the ionosphere off runs correct; with the
    reference held to the ionosphere on, the same run is not."""
    import reference
    off = {"config": {**tiny(spec, cell)["config"], "ionosphere": False},
           "traffic": tiny(spec, cell)["traffic"]}
    out = run_cell(spec, cell, SEED, 0.0, False, "cpu", overrides=off,
                   hooks=HOOKS)
    assert out["correct"], out["checks"]
    replay = reference.replay
    monkeypatch.setattr(reference, "replay",
                        lambda *a: replay(*a[:-1], True))
    out = run_cell(spec, cell, SEED, 0.0, False, "cpu", overrides=off,
                   hooks=HOOKS)
    assert not out["correct"], out["checks"]


def test_a_channel_count_the_sides_do_not_run_is_refused(spec):
    over = tiny(spec, "static-2m6.stream")
    over["config"] = {**over["config"], "channels": 8}
    with pytest.raises(ValueError, match="8 channels"):
        run_cell(spec, "static-2m6.stream", SEED, 0.0, False, "cpu",
                 overrides=over, hooks=HOOKS)


def test_reference_precision_is_f64():
    """The reference's ramps run in float64 unless the control asks."""
    import inspect

    import reference
    sig = inspect.signature(reference.replay)
    assert sig.parameters["dtype"].default is torch.float64

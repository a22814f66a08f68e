"""The whole-name check that a run loaded no JAX."""

import json
import sys
import types

import pytest

from harness import guard


def test_planted_jax_package_is_found():
    mods = {"pluto_gps_sim_tpu": None, "pluto_gps_sim_tpu.ops": None,
            "pluto_gps_sim_tpu_torch": None, "numpy": None}
    assert guard.forbidden_modules(mods) == ["pluto_gps_sim_tpu",
                                             "pluto_gps_sim_tpu.ops"]


def test_port_and_lookalikes_pass():
    mods = ["pluto_gps_sim_tpu_torch", "pluto_gps_sim_tpu_torch.ops",
            "jaxtyping", "flaxen", "jaxlib_extra", "torch"]
    assert guard.forbidden_modules(mods) == []


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib", "flax.nn"])
def test_jax_itself_is_found(name):
    assert guard.forbidden_modules([name, "torch"]) == [name]


@pytest.mark.parametrize("planted,rc", [("pluto_gps_sim_tpu", 3),
                                        ("pluto_gps_sim_tpu_torch_x", 0)])
def test_run_refuses_a_planted_module(monkeypatch, capsys, planted, rc):
    """run.py's main, with the card and the cell stubbed: a planted JAX
    package fails the run and prints no result; a look-alike passes."""
    import torch

    import run
    from harness import runner
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    result = {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
              "device": {}, "info": {}, "checks": {}}
    monkeypatch.setattr(runner, "run_cell", lambda *a, **k: dict(result))
    monkeypatch.setitem(sys.modules, planted, types.ModuleType(planted))
    assert run.main(["--workload", "static-2m6.stream", "--seed", "1",
                     "--seconds", "1"]) == rc
    out = capsys.readouterr().out.strip()
    if rc:
        assert out == ""
    else:
        assert json.loads(out.splitlines()[-1])["correct"] is True


def test_run_refuses_without_a_card(monkeypatch, capsys):
    import torch

    import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "static-2m6.stream", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""

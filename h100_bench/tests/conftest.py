"""The benchmark harness's own tests, on the CPU.

    python -m pytest h100_bench/tests -q

Tests that need a CUDA card carry the ``card`` marker and skip inside the
``cuda_card`` fixture where there is none; the benchmark's runs on the
card are made by h100_bench/run.py and h100_bench/readings.py."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))

# the sizes the CPU tests run a cell at: 1 MHz, a few blocks
TINY = {"config": {"fs_hz": 1_000_000, "dispatch_superframes": 2},
        "stream": {"sample": 4, "warm_superframes": 0.02},
        "batch": {"receivers": 3, "batch_blocks": 3, "chunk_blocks": 4,
                  "warm_batches": 1, "sample": 4},
        "clips": {"clip_blocks": 3, "warm_clips": 1, "sample": 2}}
# a tiny stream's segments: 5 blocks, not the rest of the day
HOOKS = {"segment_blocks": 5}
SEED = 2**31 + 17          # a seed past 32 signed bits, as the driver's are


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(scope="session")
def spec():
    from harness import spec as specmod
    return specmod.load_spec()


def tiny(spec, cell, **traffic):
    """run_cell's overrides for a cell at the CPU tests' sizes."""
    from harness import spec as specmod
    kind = specmod.traffic(specmod.cell(spec, cell)["traffic"])["kind"]
    return {"config": TINY["config"], "traffic": {**TINY[kind], **traffic}}

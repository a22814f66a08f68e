"""BENCHMARK.json and the files it names, found by name.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own under the benchmark's
folder: ``configs/<config>.json``, ``traffic/<traffic>.json`` and
``metrics/<metric>.py``.  A new cell or metric is new files plus new
entries in BENCHMARK.json; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


class SpecError(RuntimeError):
    """BENCHMARK.json or a file it names is missing or malformed."""


def load_spec(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise SpecError(f"{path} not found")
    return json.loads(path.read_text())


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SpecError(f"no workload {name!r} in BENCHMARK.json")


def config(spec: dict, name: str, root: Path = ROOT) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise SpecError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    path = bench_dir / "traffic" / f"{name}.json"
    if not path.is_file():
        raise SpecError(f"no traffic file {path}")
    return json.loads(path.read_text())


def metrics_for(spec: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics
    without tracing, its per-layer metrics with it.  A metric with a
    "workloads" list is the listed cells'; an end-to-end metric without
    one is every cell's, and a per-layer metric without one is every
    cell's that reports the end-to-end metric it moves."""
    e2e = [m for m in spec["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The read(run) function of metrics/<name>.py."""
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"no metric reader {path}")
    mod_spec = importlib.util.spec_from_file_location(
        "h100_bench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read

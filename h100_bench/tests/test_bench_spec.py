"""BENCHMARK.json and the files it names: found by name, and a new cell
added from files alone."""

import json
import shutil

from conftest import HOOKS, SEED, TINY
from harness import spec as specmod


def test_every_named_file_loads(spec):
    for c in spec["configs"]:
        cfg = specmod.config(spec, c["name"])
        assert cfg["name"] == c["name"]
        for key in c["reduced"]:
            assert key in cfg["reduced"]
    for w in spec["workloads"]:
        assert specmod.traffic(w["traffic"])["kind"] in (
            "stream", "batch", "clips")
        specmod.config(spec, w["config"])
    for m in spec["per_layer"]:
        assert callable(specmod.metric_reader(m["name"]))


def test_every_cell_reports_setup_another_metric_and_a_layer(spec):
    for w in spec["workloads"]:
        e2e = [m["name"] for m in specmod.metrics_for(spec, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        per = specmod.metrics_for(spec, w["name"], True)
        assert per, w["name"]
        assert {m["moves"] for m in per} <= set(e2e), w["name"]


def test_layers_match_perf_md(spec):
    perf = (specmod.ROOT / "PERF.md").read_text()
    for m in spec["per_layer"]:
        assert f"`{m['layer']}`" in perf, m["layer"]


def test_a_cell_added_from_files_alone(spec, tmp_path):
    """A later PR's cell: a config, a traffic mix and a metric as new
    files, and entries in BENCHMARK.json; no existing file changes."""
    from harness.runner import run_cell
    bench = tmp_path / specmod.BENCH_DIR.name
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(specmod.BENCH_DIR / sub, bench / sub)
    cfg = {**specmod.config(spec, "static-2m6"), **TINY["config"],
           "name": "dummy-1m"}
    (bench / "configs" / "dummy-1m.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "short-stream.json").write_text(json.dumps(
        {**specmod.traffic("stream"), **TINY["stream"]}))
    (bench / "metrics" / "dummy.blocks.py").write_text(
        "def read(run):\n    return float(run.attempted)\n")
    new = json.loads(json.dumps(spec))
    new["configs"].append({"name": "dummy-1m", "source": "x",
                           "file": "h100_bench/configs/dummy-1m.json",
                           "reduced": [], "why": "test"})
    new["workloads"].append({"name": "dummy-1m.short-stream",
                             "config": "dummy-1m",
                             "traffic": "short-stream", "chips": 1,
                             "why": "test"})
    new["end_to_end"][1]["workloads"].append("dummy-1m.short-stream")
    new["per_layer"].append({"name": "dummy.blocks", "unit": "blocks",
                             "better": "higher", "source": "host_clock",
                             "layer": "runtime/stream",
                             "moves": "stream_rate",
                             "workloads": ["dummy-1m.short-stream"]})
    for trace in (False, True):
        out = run_cell(new, "dummy-1m.short-stream", SEED, 0.0, trace,
                       "cpu", root=tmp_path, hooks=HOOKS)
        assert out["correct"], out["checks"]
        # the per-layer metrics that list their cells stay the others'
        want = {"setup_s", "stream_rate"} if not trace else {"dummy.blocks"}
        assert set(out["metrics"]) == want, out["metrics"]

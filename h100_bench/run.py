"""The H100 benchmark of pluto_gps_sim_tpu_torch: one run of one cell.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the root of a checkout.  The cells, configurations, traffic
mixes and metrics are named in BENCHMARK.json and found by name under
h100_bench/ (harness/spec.py).  The last line of standard output is one
JSON object: correct, attempted, failed, metrics, device (and with
--trace 1 the per-layer metrics and a breakdown); the numbers compared
with the reference, each beside its limit, close standard error and the
result line.  Exits non-zero, printing no result, without a CUDA card,
with fewer cards than the cell asks for, or when JAX or the JAX package
was loaded.
"""

import time

T_PROCESS = time.perf_counter()      # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one thread for the numeric libraries: the program's host work is many
# small numpy calls, and idle pool threads only add noise on a shared host
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))     # the program, at the root


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from harness import guard, spec as specmod
    spec = specmod.load_spec()
    w = specmod.cell(spec, args.workload)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(w["chips"]):
        print(f"{args.workload} needs {w['chips']} cards, torch sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2

    from harness.runner import run_cell
    out = run_cell(spec, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda", T_PROCESS)
    bad = guard.forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(out["info"], default=float), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    del out["info"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

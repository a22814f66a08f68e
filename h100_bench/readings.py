"""Read the numbers that decide `correct` over many seeds in one process.

    python3 h100_bench/readings.py --workload <cell> --seeds 1,2,3 \\
        --seconds 3 [--control 1]

Each seed is a run of the cell as run.py makes it (the same traffic,
sizes and sampling), with a short window; one JSON line per seed gives
the comparison's readings.  --control 1 puts the float32 reference in
the program's place: the control, which must come out not correct.
The lower and upper readings that judge.LIMITS were set from come from
this script on the card (PERF.md).  Not run by the benchmark's checks.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from harness import guard, spec as specmod
    from harness.runner import run_cell
    spec = specmod.load_spec()
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = run_cell(spec, args.workload, seed, args.seconds, False,
                       "cuda", control=bool(args.control))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control,
                          "correct": out["correct"],
                          "readings": out["info"]["readings"],
                          "seconds": time.perf_counter() - t0}),
              flush=True)
    bad = guard.forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The readings a cell's limits are set from, in one process on the card:
the program's numbers over many seeds (the lower readings), and the
control's (the reference in float8 put in the program's place, through
the same checks) and each planted fault's over a few (the upper
readings), each run with a short window at the cell's own load. One JSON
line per run.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 --control 3 [--fault half:3]
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--fault", action="append", default=[], help="name:seeds")
    ap.add_argument("--first-seed", type=int, default=3 * 2 ** 30)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from run import environment

    environment()
    import torch

    from portbench.core import Bench, run_cell

    bench = Bench(ROOT)
    plan = [((), args.seeds)] + [(("control",), args.control)]
    plan += [((f.split(":")[0],), int(f.split(":")[1])) for f in args.fault]
    seed = args.first_seed
    for faults, n in plan:
        for _ in range(n):
            t0 = time.perf_counter()
            line = run_cell(bench, args.workload, seed, args.seconds, False, "cuda",
                            faults=faults)
            print(json.dumps({"seed": seed, "faults": list(faults), "correct": line["correct"],
                              "readings": line["readings"], "metrics": line["metrics"],
                              "seconds": time.perf_counter() - t0}), flush=True)
            seed += 1
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

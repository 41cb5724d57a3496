"""Run one benchmark cell once on the card and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
``breakdown`` when traced, and last ``checks``: each number compared with
its limit, which the last lines of standard error repeat). With
``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics. Without as many CUDA cards as the
cell asks for, or with JAX or the JAX package loaded, it exits non-zero
and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"  # fixed: only a checkout's first run builds


def environment() -> None:
    """Every cache inside the checkout, at fixed paths; libraries kept off
    the network and off JAX."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    for var in ("HF_HUB_OFFLINE", "TRANSFORMERS_OFFLINE", "HF_DATASETS_OFFLINE"):
        os.environ[var] = "1"
    for var in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[var] = "0"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    environment()
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.core import Bench, forbidden_modules, run_cell

    bench = Bench(ROOT)
    if args.workload not in bench.cells:
        print(f"unknown workload {args.workload!r} (have {sorted(bench.cells)})", file=sys.stderr)
        return 2
    chips = bench.cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    line = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                    T_START)
    bad = forbidden_modules()
    if bad:
        print(f"modules that the port's runs must not load were loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

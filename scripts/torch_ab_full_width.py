#!/usr/bin/env python3
"""Compare two checkouts on chip_smoke.py's full-width batch phase, on one card.

    python3 scripts/torch_ab_full_width.py BASE_DIR CHANGE_DIR [--order ABBA]

Each run is a fresh process in one checkout that imports that checkout's own
``chip_smoke.py`` and runs its ``phase_env``, ``phase_build`` and
``phase_full``: ``llama3_hubert.yaml`` at full width with random weights,
B=8 x 10 s clips, through ``generate_audio_response_batch(es)``, then the
encoder, prefill and per-step decode times of one batch. Runs go in the
order given (A = BASE_DIR, B = CHANGE_DIR; alternating pairs spread the
machine's drift over both), each printing its ``full_width`` JSON line
tagged with its checkout; the last line holds the median of each timing per
checkout and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

RUN = ("import torch, chip_smoke as cs\n"
       "torch.set_grad_enabled(False)\n"
       "card = cs.phase_env(torch)\n"
       "cs.phase_build(card)\n"
       "cs.phase_full(torch, card)\n")
METRICS = ("batch_call_s", "utt_per_s", "batches_call_s", "batches_utt_per_s", "encoder_ms",
           "prefill_ms", "decode_ms_per_step", "max_memory_allocated_gb")


def run_once(root: Path) -> dict:
    env = dict(os.environ, HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1")
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=root, env=env, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"{root}: exit {proc.returncode}\n{proc.stdout[-4000:]}\n"
                         f"{proc.stderr[-4000:]}")
    lines = [json.loads(s) for s in proc.stdout.splitlines() if s.startswith("{")]
    env_line = next(x for x in lines if x.get("phase") == "env")
    full = next(x for x in lines if x.get("phase") == "full_width")
    return dict(full, card=env_line["card"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("base", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--order", default="ABBA")
    args = ap.parse_args()
    roots = {"A": args.base.resolve(), "B": args.change.resolve()}
    runs = {"A": [], "B": []}
    card = None
    for i, tag in enumerate(args.order):
        res = run_once(roots[tag])
        card = res["card"]
        runs[tag].append(res)
        print(json.dumps({"run": i, "checkout": tag, "root": str(roots[tag]),
                          **{k: res[k] for k in METRICS}, "launches": res["launches"],
                          "card": card}), flush=True)
    print(json.dumps({"median": {tag: {k: statistics.median(r[k] for r in rs) for k in METRICS}
                                 for tag, rs in runs.items() if rs},
                      "order": args.order, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

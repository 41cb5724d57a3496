#!/usr/bin/env python3
"""Time the paged kernels on one CUDA card across the fresh-block length.

    python3 scripts/torch_bench_paged_kernels.py

At chip_smoke.py's serving shape (B=16, Hq=24, Hkv=8, Dh=128, ps=128,
mp=7, int8 pools; every call reads the same pages, pads and lengths, drawn
once from chip_smoke's seed, and only q and the fresh k/v change with T),
prints one JSON line per call: B4 (``paged_decode_attention``) at T = 1..4 fresh tokens, i.e.
R = T * Hq / Hkv query rows per block, and B5 (``fused_paged_decode``) at
T = 1, each as device milliseconds per call from torch.profiler over 20
calls, beside the bound of the same work, and the card's name and power
limit.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    import torch

    import chip_smoke as cs
    from llm_speech_summarization_tpu_torch.kernels.fused_paged import fused_paged_decode
    from llm_speech_summarization_tpu_torch.kernels.paged_attention import paged_decode_attention

    card = cs.phase_env(torch)
    torch.set_grad_enabled(False)
    G = cs.PAGED_SHAPE["Hq"] // cs.PAGED_SHAPE["Hkv"]
    for T in (1, 2, 3, 4):
        (q, kp, vp, ks, vs, table, lens, pads, kn, vn,
         lens_np, pads_np, _) = cs._paged_case(torch, cs.PAGED_SEED, T, write=False)
        args = (q, kp[1], vp[1], table, lens, pads, kn, vn, ks[1], vs[1])
        ms = cs.device_ms(torch, lambda: paged_decode_attention(*args))
        b_ms, b_by = cs.bound_ms(*cs._paged_work(lens_np, pads_np, T, write=False))
        print(json.dumps({"kernel": "B4 paged_decode_attention", "T": T, "rows": T * G, "ms": ms,
                          "bound_ms": b_ms, "bound_by": b_by, "card": card}), flush=True)
    (q, kp, vp, ks, vs, table, lens, pads, kn, vn,
     lens_np, pads_np, _) = cs._paged_case(torch, cs.PAGED_SEED, 1, write=False)
    ms = cs.device_ms(torch, lambda: fused_paged_decode(q, kp, vp, ks, vs, table, lens, pads,
                                                        kn, vn, 1))
    b_ms, b_by = cs.bound_ms(*cs._paged_work(lens_np, pads_np, 1, write=True))
    print(json.dumps({"kernel": "B5 fused_paged_decode", "T": 1, "rows": G, "ms": ms,
                      "bound_ms": b_ms, "bound_by": b_by, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

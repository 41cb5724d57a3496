#!/usr/bin/env python3
"""What bf16 rounding alone does to ``served_logit_gap`` and
``served_gap_median`` in ``moonlight_whisper.bulk_moe``, on the same seeds and
the same checked utterances as the program's own readings (one CUDA card).

    python3 scripts/moe_precision_witness.py --seeds 3000000031 3141592659 \
        [--seconds 1] [--out chiprun_out/witness.jsonl]

Each seed runs the cell once through ``portbench.core.run_cell`` (a short
window, as ``portbench/calibrate.py`` runs it) and reads the program's two
numbers. Then, on the same checked utterances, the reference in float32
scores the first choices of two bf16-rounded copies of itself, each fed the
program's served tokens as the float8 control is:

  * ``bf16_operands``: both operands of every product and the residual
    stream rounded to bf16 (the control's mechanism at bf16);
  * ``bf16_outputs``: that, and every product's result rounded to bf16 too,
    as the program's bf16 GEMMs and activations round them.

One JSON line a seed: the program's widest and median gap, each witness's
widest, median and p90, and the reference's near-ties.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _witnesses(ref):
    class Bf16(ref.Precision):
        """``Precision`` rounding to bf16: operands and activations, and
        with ``outputs`` every product's result."""

        def __init__(self, outputs: bool):
            self.name, self.outputs = "bfloat16", outputs

        def act(self, x):
            return x.float().bfloat16().float()

        def product(self, op, a, b, **kw):
            y = op(a.float().bfloat16().float(), b.float().bfloat16().float(), **kw)
            return y.bfloat16().float() if self.outputs else y

    return {"bf16_operands": Bf16(False), "bf16_outputs": Bf16(True)}


def _gaps_with_witnesses(runner):
    """``runner.reference_gaps``, and beside its readings the witnesses'
    gaps on the same checked utterances."""
    import torch

    from portbench import weights, weights_moe
    from portbench.reference import mla_moe as ref_moe
    from portbench.reference import model as ref

    plain = runner.reference_gaps
    witnesses = _witnesses(ref)

    @torch.no_grad()
    def reference_gaps(ctx, checked, batch_samples, new_tokens, control):
        out = plain(ctx, checked, batch_samples, new_tokens, control)
        dev, cfg = ctx.device, ctx.config
        dtype = weights.DTYPES[cfg["dtypes"]["param"]]
        llm = weights_moe.make_llm(cfg, ctx.seed, dev, dtype)
        enc = weights.make_encoder(cfg, ctx.seed, dev, dtype)
        gaps = {name: [] for name in witnesses}
        for wav, ids in checked:
            wav_t = torch.from_numpy(wav).to(dev)
            served = ref.token_embeds(llm, ids[:-1]) if len(ids) > 1 else None
            x = ref.prompt(llm, cfg, ref.audio_embeds(enc, cfg, wav_t, batch_samples))
            n_p = x.shape[0]
            seq = torch.cat([x, served]) if served is not None else x
            logits, _ = ref_moe.mla_moe(llm, cfg, seq, n_prompt=n_p, logits_from=n_p - 1)
            best = logits.max(-1).values
            at = torch.arange(len(ids), device=dev)
            for name, prec in witnesses.items():
                xw = ref.prompt(llm, cfg, ref.audio_embeds(enc, cfg, wav_t, batch_samples, prec))
                seqw = torch.cat([xw, served]) if served is not None else xw
                lw, _ = ref_moe.mla_moe(llm, cfg, seqw, prec, n_prompt=n_p,
                                        logits_from=n_p - 1)
                gaps[name].append(best - logits[at, lw.argmax(-1)])
        q = torch.tensor([0.5, 0.9], device=dev)
        for name, g in gaps.items():
            every = torch.cat(g).float()
            med, p90 = (float(v) for v in torch.quantile(every, q))
            out[name] = {"widest": float(every.max()), "median": med, "p90": p90}
        del llm, enc
        return out

    runner.reference_gaps = reference_gaps
    return runner


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="moonlight_whisper.bulk_moe")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "portbench"))
    sys.path.insert(0, str(ROOT))
    from run import environment

    environment()
    import torch

    from portbench.core import Bench, run_cell

    bench = Bench(ROOT)
    load = bench.runner
    bench.runner = lambda kind: _gaps_with_witnesses(load(kind))
    sink = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        line = run_cell(bench, args.workload, seed, args.seconds, False, "cuda")
        r = line["readings"]
        row = {"seed": seed, "correct": line["correct"],
               "program": {"widest": r["served_logit_gap"], "median": r["served_gap_median"],
                           "p90": r["gap_p90_p99"][0]},
               **{name: r[name] for name in ("bf16_operands", "bf16_outputs")},
               "min_selection_margin": r["min_selection_margin"], "near_ties": r["near_ties"]}
        print(json.dumps(row), flush=True)
        if sink:
            sink.write(json.dumps(row) + "\n")
            sink.flush()
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

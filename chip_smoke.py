#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one H100 and check it.

    python3 chip_smoke.py

Phases, in order; each prints one line and any failure raises:
  1. environment: the card's name and power limit, torch/CUDA versions;
  2. build the ten CUDA kernel libraries from ``llm_speech_summarization_tpu_
     torch/kernels/csrc`` with nvcc, one process per library, all at once
     (phases 3 to 4b run as soon as the flash libraries are built, while
     the decode libraries build on; this line comes after them), and
     print the registers and spill bytes of the wgmma kernels (the
     flash forward, dq and dk/dv) at each Dh, failing on any spill, and
     of the decode body's dense and paged instances, B1's float32
     forward (with and without the lse), the float32 backward's dq and
     dk/dv and the float32 decode body's instances (reported only), the
     4-row paged instances MiniChat's group of 1 selects named apart;
  3. flash attention (B1) against its plain version run in float32 at the
     main paths' six shapes (the Llama and MiniChat prefills, HuBERT-large,
     HuBERT-base and Whisper self-attention, one tensor-parallel rank's
     Llama prefill at 12/4), within B7's output bound, with injected faults the
     bound must reject, and the one PyTorch call that computes the same
     attention (timed only); then B1's float32 instance at the HuBERT-CTC
     model's shapes (10 s and 20 s clips, a bucket of four with edge
     windows) and Llama's prefill against the plain version run in float64
     within F32_OUT_ATOL + F32_OUT_RTOL (|out| + (P.|V|)/l), with injected
     faults (TF32-rounded operands among them) the bound must reject,
     REPEATS bit-equal repeats, and SDPA at float32 (timed only);
  4. the training attention kernels, B1 with its log-sum-exp and the
     backward B6 (dq; dk/dv), against their plain versions run in float32
     at the training shapes (the LLM at the trainer's spliced length, at
     24/8 heads and at one tensor-parallel rank's 12/4, HuBERT at 499
     frames), with injected faults the bound must reject,
     REPEATS rounds of the three kernels bit-equal to the first, and SDPA
     forward + backward as the yardstick;
     then B7, the same kernels in offset mode (the ring-attention
     interior), at the long-audio ring's block shapes for a visiting block
     from a rank before, equal to and after the queries' rank, with
     injected offset faults and SDPA under the block's mask;
  4b. the float32 training kernels (B1 + LSE, B6 dq and dk/dv at
     float32, ``csrc/flash_attention_f32.cu`` and ``csrc/flash_attention_
     bwd_f32.cu``) through the bf16 entry points at the LLM's, HuBERT's and
     Whisper's training shapes, then B7 at float32 at the ring's three
     block relations (the LLM's block as published, HuBERT's cut to 1000
     frames), against the plain versions run in float64 within the F32
     bounds (see F32_OUT_ATOL: the output's, the lse's and the backward's
     own), with faults the bounds must reject (TF32-rounded operands, p and
     ds rounded to bf16, a window end off by one, the KV head of the wrong
     group), REPEATS bit-equal rounds, and SDPA at float32 timed beside;
  5. fused decode (B2) against its plain version, including the in-place
     cache writes, and against the plain version run in float32 with
     injected faults, at B=8, 16 and 128 (T=1), B=16, T=3, and B=1 over
     two windows the wrapper splits in 8 (24/8 heads), at MiniChat's
     24/24 (B=16 at T=1 and T=3, B=1 over a split window) and at one
     tensor-parallel rank's 12/4 (B=8 and 16 at T=1, B=16 at T=3) and
     12/12 (B=16, T=1), repeats bit-identical, the
     split shapes also timed with one split, beside the device cost of one
     empty kernel;
  6. paged decode attention (B4) and fused paged decode + page write (B5)
     against their plain versions run in float32 at the serving shape,
     with injected faults the bound must reject (a page segment dropped
     from the chunks that cross a page among them), page writes bit-exact,
     repeats bit-identical; at Llama's 24/8 heads, at MiniChat's 24/24 and
     at one tensor-parallel rank's 12/4;
  7. the dense-cache decode kernels at the Whisper path's shapes against
     their plain versions run in float32: B3 over a bf16 cache at T=1 and
     T=3 and over an int8 cache with one layer's scales, B8 over a bf16
     and an int8 cache, writes bit-exact, with injected faults the bound
     must reject;
  7a. the float32 decode instances (B2, B3, B4, B5 and B8 at a float32
     query, ``csrc/decode_f32.cu``) at the float32 serving path's shapes
     (Llama's 24/8 heads: B2 over the int8 cache at B=8, 16, 128 and B=16
     T=3; B3 over float32, bf16 and int8 caches; B4 at T=4 and B5 over
     int8, float32 and bf16 pools; B8 over float32, int8 and bf16 caches)
     against the plain version run in float64 within F32_OUT_ATOL +
     F32_OUT_RTOL (|out| + (P.|V|)/l), with faults the bound must reject
     (TF32-rounded operands, p rounded to bf16, a window end off by one,
     the KV head of the wrong group), writes bit-exact, REPEATS bit-equal
     repeats, torch.cat + SDPA at float32 timed beside B8;
  7b. decode_mixed: the mixed decode instances (B3, B8, B4 and B5 with a
     bf16 query over a float32 cache, ``csrc/decode_f32.cu``) at the
     serving path's shapes (B3 at B=8 over 384 slots at T=1 and T=4, B8
     at offset 368, B4 at B=16 T=4 over 7 pages of 128, B5 at T=1 over two
     layers) against their plain versions within MIXED_OUT_ATOL +
     MIXED_OUT_RTOL (|out| + (P.|V|)/l), writes bit-exact, MIXED_REPEATS
     bit-equal repeats, each instance's registers and spill bytes, the
     distance to two faults (the cache read unrounded, p left unrounded)
     for information, torch.cat + SDPA at bf16 timed beside B8;
  8. the slice at a small kernel-legal width on the card and on the CPU,
     from the same weights: the HuBERT batch path on an int8 cache, the
     Whisper one on a bf16 cache and BASELINE config #1's layout
     (hubert-base, ``ctc_pool``, an MHA LLM), then a paged ``SlotDecoder``
     teacher-forced through admissions and plain and speculative chunks;
  9. one KD train step at that width on the CPU and on the card, from the
     same weights and batch, for the HuBERT-large layout and config #1's;
 10. the full-width ``llama3_hubert.yaml`` batch path through
     ``generate_audio_response_batch(es)``;
 11. the full-width serving path: ``SummarizationServer`` over HTTP with
     the paged cache, then with speculative chunks, then with the dense
     cache;
 11d. serving_tp_full: ``llama3_hubert.yaml`` (Llama-3.2-3B cut to
     TP_SERVE_LAYERS blocks) on a tensor-parallel model group of two ranks
     sharing the card over gloo (``tp_rank`` is each rank's program, in
     ``torch.distributed.run``'s environment; every rank of every launch
     runs in a process of this file started ahead, which imports and runs
     a small train step while an earlier phase runs: ``_RankPool``), one
     launch of the ranks on one engine build: the batch path (B=8 x 10 s),
     then ``cli/serve.py --tp 2`` on the dense cache and with ``--paged
     --speculative_k 3``, a burst of 8 each; greedy rows held to the
     unsharded engine margin-aware, rank 1's rows equal to rank 0's, each
     rank's launches equal to its counts, the unsharded batch path and
     servers timed beside them;
 11e. f32_full: ``llama3_hubert.yaml`` at ``compute_dtype: float32`` on
     the batch path's weights (the int8 LLM, float32 norms and encoder):
     B=8 x 10 s over the int8 cache (B1 and B2 at float32) and over a
     float32 cache (B3), each teacher-forced through the kernels and the
     plain attention, greedy rows held margin-aware (F32_LOGIT_TOL);
     ``attn_impl="pallas"`` (B8 at float32) held to the B3 rows; a paged
     server with speculative chunks, a burst of 8 (B4 and B5 at float32);
     the tokens that differ from the bf16 engine's rows, for information;
 11f. mixed_full: ``llama3_hubert.yaml`` at ``compute_dtype: float32`` with
     the rest as published (bf16 parameters, the int8 LLM, a float32
     cache), on the batch path's trees: B=8 x 10 s (B1 float32, then B3's
     mixed instance per step: the decode steps run in the norms' bf16),
     held to the plain attention margin-aware (MIXED_LOGIT_TOL);
     ``attn_impl="pallas"`` (B8 mixed) and the engine with
     ``speculative_k=3`` (B3 mixed at T=4) held to its rows; a paged server
     with speculative chunks, a burst of 8 (B4 and B5 mixed);
 11a. BASELINE config #1 at published widths (``minichat_hubert.yaml`` with
     hubert-base, int8 weights and cache): B=8 clips of 10 s through
     ``generate_audio_response_batch`` with the ``pool`` projector, then
     ``ctc_pool`` over synthetic ranges;
 11c. router_full: BASELINE config #1 served by two in-process paged
     replicas on the card (one with speculative chunks) behind
     ``cli/route.py`` in a subprocess: greedy requests one at a time
     through the router and direct, a burst, and a drain of one replica
     while more requests go in;
 11b. the bulk entry point: ``cli/infer.py --audio_dir`` over 32 WAV and
     FLAC clips on ``llama3_hubert.yaml``, its JSONL held to per-batch
     engine calls, then the pipelined ``generate_audio_response_batches``
     against serial per-batch calls (2 batches of 32 10 s clips, ABBA);
 12. the full-width ``llama3_whisper.yaml`` batch path on a bf16 KV cache
     (B1 and B3), ``greedy_generate(attn_impl="pallas")`` on its prompts
     (B8) held to the B3 stream, and a dense HTTP server on it;
 13. the full-width trainer (``Trainer(...).train()`` on synthetic data): a
     few KD steps and the closing ``validate()``, then a second trainer
     that resumes from its checkpoint and takes one more step, and one
     profiled step for the device-busy share; its encoder is exported;
     then train_save_qkv_full: the same trainer under remat_policy
     "save_qkv", 4 steps with the trace window (LSS_PROFILE_DIR,
     LSS_PROFILE_STEPS=2) on steps 3 and 4, its kernel events counted;
     then one step's forward and backward under "full" and "save_qkv" in
     turns, bit-equal; then train_f32_full: the trainer at
     ``compute_dtype: float32`` (int8 LLM, HuBERT-large, remat, B=8): two
     steps and validate through the float32 instances, its first step held
     to the plain attention's, the TF32 flags read at every backward;
 13a. convert_full: Llama-3.2-3B (bf16, two shards), HuBERT-large and
     HuBERT-large CTC drawn at published widths under their HF names,
     written as safetensors and converted by ``cli/convert.py``; an engine
     loading the files (``model.llm_checkpoint``, ``model.encoder_checkpoint``)
     runs B=8 x 10 s, its token rows equal to an engine handed the same
     trees in memory;
 13b. preprocess_full: ``iter_preprocess_examples`` over 32 synthetic 6-10 s
     examples and one 21 s clip (filtered) on the converted engine and the
     converted bf16 CTC file, which ``load_ctc_fn`` runs in float32 (B1's
     float32 instance, TF32 off); one clip's float32 CTC ids against the
     plain float32 attention, margin-aware, the frames the file's bf16
     forward flips counted, CTC ms a clip in float32 and bf16 in turns;
 13c. eval_full: ``evaluate_engine`` over 16 synthetic examples with the
     full-width ``LlamaEmbedder``;
 13d. ckpt_full: ``cli/infer.py -p`` with 13's exported encoder over the
     bulk clips, equal to an engine handed the same tree, then
     ``cli/infer.py --ctc`` on BASELINE config #1 over 8 clips;
 13e. train_whisper_full: ``llama3_whisper.yaml`` KD training (int8 LLM,
     B=16, 500 encoder frames): steps, validate, resume, a profiled step,
     and one step held to the same step with the plain attention;
 14. the long-audio trainer (``llama3_hubert_long.yaml``, published widths,
     Llama-3.2-3B and HuBERT-large cut to RANK_LAYERS blocks, 118-120 s
     synthetic clips) on a sequence-parallel ring of
     two ranks sharing the card over gloo, started in
     ``torch.distributed.run``'s environment through the training CLI
     (``--mesh 1,2,1``; ``train_rank`` is each rank's program): two steps,
     validate and a checkpoint, then a launch that resumes and takes one
     more step; then one unsharded step in this process on the same weights
     and batch, which the ring's first step must match;
 14b. train_dp_full: ``llama3_hubert.yaml`` (published widths, the models
     cut to RANK_LAYERS blocks, int8 LLM, remat) through the CLI at
     ``--mesh 2,1,1``: two gloo ranks on the card, 8 rows each of every global batch of 16, ZeRO-1; two
     steps, validate and a checkpoint, which a trainer on mesh 1,1,1 in
     this process resumes for one step; the three steps held to three
     unsharded steps on the same weights and batches (DP_RTOL);
 14c. train_tp_full: the same at ``--mesh 1,1,2`` (the LLM sharded, 12/4
     heads a rank, the fused loss vocab-parallel), two steps (no validate) held to two unsharded
     steps within TP_RTOL;
 14d. train_3d_small: ``--mesh 2,2,2`` on eight ranks (the ring and
     encoder SP, the sharded LLM, ZeRO-1), the models cut to
     SHALLOW_LAYERS blocks, one step (no validate) held to its unsharded
     step;
 14e. train_ring_f32: ``--mesh 1,2,1`` (the ring and encoder SP) at
     ``compute_dtype: float32``, the models cut to SHALLOW_LAYERS blocks,
     B=4: one step, B7's float32 instances on both ranks, held to the
     unsharded float32 step within F32_RING_RTOL.
Every main-path run is driven with the launch counts set to 0 just before it
and checked just after against what the engine, decoder or trainer ran.
Then the card line, one JSON line with every kernel's summary, and the
status line.

Needs one CUDA card of compute capability 9.0; exits nonzero otherwise.

    python3 chip_smoke.py --ab-kernels BASE_DIR [ORDER] [f32]

runs only the kernel phases (3 to 7: the flash kernels, B2, B4, B5, B3 and
B8; with ``f32`` the float32 and mixed ones: B1 float32, the float32
training kernels, the float32 and mixed decode instances) of another
checkout (BASE_DIR, e.g. the parent commit unpacked with ``git archive``)
and of this one, in ORDER (default ABBA), and prints the median device and
call ms of each kernel and shape per checkout.

    python3 chip_smoke.py --split-sweep [f32]

times B2 at small batches for each split count of the window (the numbers
``fused_decode.dense_splits`` is set from), then runs phase 5; then (with
``f32`` only) the float32 decode body's B2 and mixed B8 at B = 1-128 for
each split count (the numbers ``fused_decode.f32_splits`` is set from), and
its phases decode_f32 and decode_mixed.

    python3 chip_smoke.py --f32-train-kernels [TL]

runs only B1's float32 phase and phase 4b with HuBERT's float32 ring block
at TL frames, printing each ring case's wall and peak device memory.
"""

from __future__ import annotations

import atexit
import contextlib
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

LOGIT_TOL = 5e-2  # bf16 CPU vs card logit delta allowed per step (phase 5)
EMBED_TOL = 6e-2  # atol = rtol for the spliced embeds, CPU vs card (phase 5)
B1_TOL = 3e-2  # |kernel - plain| on valid rows: ~4 bf16 ulps at |out| <= 2
B2_ATOL = B2_RTOL = 2e-2  # kernel keeps p in float32, plain rounds p * v_scale to bf16
# B4/B5 are held to their plain version run in float32 on the same inputs:
# the kernel computes in float32 too, so what is left is its bf16 output
# rounding (at most 2^-8 relative, a third of this bound). The outputs of a
# row that attends ~450 positions are ~0.03 in size, so the bound scales
# with each output; the phases also show it rejects a shifted pad or length,
# a dropped page, shifted scales and swapped tables
PAGED_ATOL, PAGED_RTOL = 1e-3, 1e-2
# B2, B3 and B8 are held the same way (they too compute in float32): their
# float32 plain version on the same inputs within PAGED_ATOL + PAGED_RTOL
# |out|; the phases show the bound rejects a pad or offset off by one, the
# wrong layer and a dropped fresh token (and, for B2, the first split's
# share of the window dropped). B2 keeps its bf16 check beside it
# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a call is the larger
# of its bytes over the memory rate and its bf16 operations over the
# tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
# float32 work at float32 accuracy: 3xTF32 on the tensor cores (each operand
# a TF32 high part and a TF32 residual, three products), the fastest such
# route on the card: the dense TF32 rate 494.7 TFLOP/s over 3
F32_FLOPS_PER_S = 494.7e12 / 3
# B1 + LSE and B6 are held to their plain versions run in float32 on the
# same bf16 inputs. The lse is float32 on both sides (different summation
# order only): LSE_ATOL + LSE_RTOL * |lse|. The backward rounds p and ds to
# bf16 before their products (as the TPU kernels do) and its outputs to
# bf16; a CPU emulation of exactly that rounding at these shapes gave up to
# 0.21 of the bound below, which scales with each element and with its
# row's RMS (cancellation in a row's sum makes single elements small):
# BWD_RTOL * |ref| + BWD_ATOL * rms(ref row) + BWD_FLOOR * rms(ref). The
# floor covers rows whose whole gradient is cancellation noise: a query
# that sees one key has ds = dO.v - rowsum(dO * out) with out = v, about
# 1e-6 either way, summed in another order by the kernel's dp. The phase
# shows the bound rejects an end off by one, a causal frontier off by one,
# the lse of the neighbouring row, and dk/dv of one q head of the group.
LSE_ATOL, LSE_RTOL = 1e-4, 1e-5
BWD_RTOL, BWD_ATOL, BWD_FLOOR = 2e-2, 5e-2, 1e-3
NEG_LSE = -1e30  # the lse of a row that sees no key (float32)
# B7's output, and B1's, are held to their float32 plain version within
# B7_OUT_ATOL + B7_OUT_RTOL * (|out| + (P.|V|)/l), (P.|V|)/l being the plain
# version run on |v|: the kernel rounds p to bf16 before P.V (as the TPU
# kernel does) and its output to bf16, each at most 2^-8 relative (bf16's
# unit roundoff), so the bound is the worst case of the two roundings; rows
# that see a few keys come to 0.5-0.75 of it (tests/test_torch_flash_tiling.py
# emulates the kernel's tiles on the CPU). A flat 1e-3 + 1e-2 * |out| does
# not fit: where a row's output cancels, bf16 p moves it by more (an
# emulation at the ring's shapes came to 1.79x that bound). The phases show
# the bound rejects V of the wrong KV head and a k tile dropped from P.V.
B7_OUT_ATOL, B7_OUT_RTOL = 1e-5, 2.0 ** -8
# B1's float32 instance is held to the plain version run in float64 on the
# same float32 inputs, within F32_OUT_ATOL + F32_OUT_RTOL * (|out| +
# (P.|V|)/l). From the kernel's arithmetic, with u = 2^-24 (float32's unit
# roundoff) and rounding errors of either sign adding as a random walk (the
# probabilistic bound of Higham and Mary): a score is a chain of Dh FFMAs,
# off by about sqrt(Dh) u S, S = max over (query, key) of Dh^-0.5 sum_d
# |q_d k_d|; the scale, the subtraction of m and exp2f add ~4 u to each
# p's relative error; l and P.V are sums of up to n terms, sqrt(n) u of
# their |terms|. o / l then moves by at most the relative error of p times
# (|out| + (P.|V|)/l), the sums' errors on the same scale: u (sqrt(Dh) S +
# sqrt(n) + 4). At the phase's inputs (randn q, k, v; S <= 10.4 at Dh = 64
# with n of 499-999 keys, S <= 12.5 at Dh = 128 with n <= 320) that is
# 6.5e-6 to 9.7e-6: 2e-5 is 2.1-3.1x that (the phase reports each case's
# S). TF32 (2^-11) errs 2^13 times as much in each operand;
# tests/test_torch_ctc_f32.py emulates the kernel's tiles and sums on the
# CPU (under half this bound) and TF32-rounded operands (over 4x it), and
# the phase shows the bound rejects them on the card, with a window end off
# by one, a k tile dropped from P.V and the KV head of the wrong group.
F32_OUT_ATOL, F32_OUT_RTOL = 1e-7, 2e-5
# The float32 training kernels (B1 + LSE, B6 dq and dk/dv, B7) are held to
# the float64 plain versions on the same float32 inputs (the backward's on
# the kernel's own lse and delta = rowsum(dO * O)) with the constants above.
# out: the bound above. lse = m + log(l): the scores' and the sum's errors
# above, now absolute, u (sqrt(Dh) S + sqrt(n) + 4), and the rounding of m
# (a few u |lse|): F32_OUT_ATOL + F32_OUT_RTOL (1 + |lse|). The backward,
# per (query i, key j), p = exp(s - lse), dp = dO_i.v_j, ds = p (dp - delta):
# the exponent s Dh^-0.5 log2(e) - lse log2(e) is off by u (sqrt(Dh) S +
# 2 S + 2 |lse|) and exp2f by 2 u, which is p's relative error e_p; dp is a
# chain of Dh FFMAs, off by sqrt(Dh) u D, D = sum_d |dO_d v_d|; so ds is
# off by at most (e_p + (sqrt(Dh) + 2) u) M, M = p (D + |delta|) >= |ds|.
# dq_i = Dh^-0.5 sum_j ds k_j, dk_j = Dh^-0.5 sum_i ds q_i (summed over the
# G heads of the group: n G terms) and dv_j = sum_i p dO_i add sqrt(n G) u
# of their |terms|. Each output is then off by at most u (sqrt(Dh) S + 2 S
# + 2 |lse| + sqrt(Dh) + sqrt(n G) + 8) times its magnitude: Dh^-0.5 M.|K|
# for dq, Dh^-0.5 M^T.|Q| for dk, P^T.|dO| for dv (the float64 plain version
# run on absolute values, _f64_bwd_magnitudes). At the phase's inputs
# (randn; S <= 12.5 at Dh = 128 and 10.4 at 64, |lse| <= S + log n, n G <=
# 2880 terms at Dh = 128, the ring block of 960 rows x 3 heads) that is 278
# u = 1.7e-5 at most: the bound is F32_OUT_ATOL + F32_OUT_RTOL times the
# magnitude. TF32 operands,
# p or ds rounded to bf16, a window end off by one and the KV head of the
# wrong group must fall outside every bound (tests/test_torch_flash_f32_
# train.py emulates the kernels' tiles and sums on the CPU under half of
# it, and shows bf16 ds over it).


# train_small: one KD step on the CPU (plain versions) and on the card
# (kernels) from the same weights and batch, both in bf16 with float32
# master encoder weights; TF32 off for matmuls and cuDNN convolutions on the
# card. bf16 activations are rounded at other places by the two backends, so
# the losses agree to TRAIN_LOSS_RTOL and grad_norm to TRAIN_GNORM_RTOL. A
# first AdamW step moves each parameter by about lr * sign(g): at least
# TRAIN_SIGN_AGREE of the parameters the CPU step moves by more than lr / 2
# must move the same way on the card, by the same amount within lr / 4.
TRAIN_LOSS_RTOL = 2e-2
TRAIN_GNORM_RTOL = 3e-2
TRAIN_SIGN_AGREE = 0.9




def bound_ms(n_bytes: float, flops: float, flops_per_s: float = BF16_FLOPS_PER_S):
    """(least milliseconds the card could take, "bytes" or "operations"),
    the operations at ``flops_per_s`` (bf16 products by default)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line; ``at_s``: the script's seconds so far."""
    at_s = round(time.perf_counter() - _START, 1)
    print(json.dumps({"phase": phase, **fields, "at_s": at_s}), flush=True)


def call_ms(torch, fn, reps: int = 20) -> float:
    """Median milliseconds per call of ``fn`` between CUDA events: the
    device time, or the host's dispatch time where that is longer."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, reps: int = 20, sessions: int = 3, tries: int = 16,
              whole: bool = True) -> float:
    """Device milliseconds per call of ``fn``: the summed duration of the
    GPU work it launched (torch.profiler), without host dispatch gaps.
    A profiling session now and then loses device events, which lowers
    its sum and its event count, and was seen to record one stray event
    more, so a session counts only if it recorded as many device events
    as the fullest session whose count is a whole number per call
    (``whole=False`` drops that rule for calls of many kernels, where a
    session was seen to record one event fewer than a whole number per
    call every time: then the fullest session); the median of
    ``sessions`` such sessions, out of at most ``tries``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    runs = []  # (device events, device microseconds) per session

    def complete():
        counts = [n for n, _ in runs if n > 0 and (n % reps == 0 or not whole)]
        return [us for n, us in runs if counts and n == max(counts)]

    while not runs or (len(runs) < tries and len(complete()) < sessions):
        # a warm-up cycle first: a session that starts tracing on the timed
        # calls themselves was seen to miss their first kernel
        events = []

        def keep(p, events=events):  # the active cycle's device events
            events.extend(e for e in p.events() if e.device_type.name == "CUDA")

        with profile(activities=[ProfilerActivity.CUDA], on_trace_ready=keep,
                     schedule=torch.profiler.schedule(wait=0, warmup=1, active=1)) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        runs.append((len(events), sum(e.time_range.end - e.time_range.start for e in events)))
    full = complete()
    if len(full) < sessions:
        raise AssertionError(f"device_ms: {len(full)} of {len(runs)} profiling sessions recorded "
                             f"every device event (events per session: {[n for n, _ in runs]})")
    return statistics.median(full) / 1e3 / reps


def timings(torch, kernel_fn, plain_fn) -> dict:
    return dict(ms=device_ms(torch, kernel_fn), plain_ms=device_ms(torch, plain_fn),
                call_ms=call_ms(torch, kernel_fn), plain_call_ms=call_ms(torch, plain_fn))


def phase_env(torch) -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    cap = torch.cuda.get_device_capability(0)
    if tuple(cap) != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability (9, 0), got {cap}")
    card = card_line()
    try:
        import yaml  # noqa: F401

        has_yaml = True
    except ImportError:
        has_yaml = False
    emit("env", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), pyyaml=has_yaml)
    return card


def start_builds():
    """One nvcc per kernel library, all started together on threads of
    their own; returns the flash libraries' futures and the decode
    libraries'. The flash libraries build in ~7 s and the decode ones in
    ~30 s (the build line on an H100 host), so the flash phases run while
    the decode libraries are still building; their device times are the
    profiler's, which the compilers on the host do not enter."""
    from concurrent.futures import ThreadPoolExecutor

    from llm_speech_summarization_tpu_torch.kernels import (
        decode_attention, flash_attention, fused_decode, fused_paged, paged_attention,
    )

    flash = (flash_attention._lib, flash_attention._bwd_lib, flash_attention._dkv_lib)
    decode = (fused_decode._lib, paged_attention._lib, fused_paged._lib, decode_attention._lib)
    f32_lib = getattr(flash_attention, "_f32_lib", None)  # None in an older checkout (A/B)
    flash += (f32_lib,) if f32_lib else ()
    bwd_f32_lib = getattr(flash_attention, "_bwd_f32_lib", None)  # ditto
    flash += (lambda: bwd_f32_lib(True),) if bwd_f32_lib else ()
    decode_f32_lib = getattr(fused_decode, "_f32_lib", None)  # ditto
    decode += (decode_f32_lib,) if decode_f32_lib else ()
    pool = ThreadPoolExecutor(max_workers=len(flash) + len(decode))
    futures = [pool.submit(lib) for lib in flash], [pool.submit(lib) for lib in decode]
    pool.shutdown(wait=False)
    return futures


def phase_build(card, require_no_spill=True, builds=None):
    """Every kernel library built (``builds``: ``start_builds()``'s
    futures, else started here); the wgmma kernels' registers and spill
    bytes, a spill failing the phase unless ``require_no_spill`` is off (an
    A/B run of an older checkout), and the decode body's dense and paged
    instances' beside them."""
    from llm_speech_summarization_tpu_torch.kernels import (
        build, decode_attention, flash_attention, fused_decode, fused_paged, paged_attention,
    )

    for fut in sum(builds or start_builds(), []):
        fut.result()
    f32_lib = getattr(flash_attention, "_f32_lib", None)  # None in an older checkout (A/B)
    bwd_f32_lib = getattr(flash_attention, "_bwd_f32_lib", None)  # ditto
    decode_f32_lib = getattr(fused_decode, "_f32_lib", None)  # ditto
    # the wgmma designs (the forward, dq, dk/dv) keep their accumulators in
    # registers: ptxas must place them without a spill at either Dh
    regs = {}
    for lib, sources in (("flash_attention", flash_attention.SOURCES),
                         ("flash_attention_bwd", flash_attention.BWD_SOURCES),
                         ("flash_attention_dkv", flash_attention.DKV_SOURCES)):
        for kernel, n_regs, spill in build.ptxas_report(lib, sources):
            name = re.search(r"(flash_fwd_kernel|bwd_dq_kernel|bwd_dkv_kernel)", kernel).group(1)
            dh = int(re.search(r"Li(\d+)E", kernel).group(1))
            regs[f"{name} Dh={dh}"] = {"registers": n_regs, "spill_bytes": spill}
    spilled = {k: r for k, r in regs.items() if r["spill_bytes"]}
    if require_no_spill and (spilled or len(regs) != 6):
        raise AssertionError(f"build: the wgmma kernels spill or are missing: {regs}")
    # the decode body's instances (library, cache type, Dh, query rows,
    # warps): [registers, spill bytes], reported only (PERF.md §6 gives
    # their cost); B4 and B5 are its paged instances
    decode = {}
    for lib, sources in (("fused_decode", fused_decode.SOURCES),
                         ("decode_attention", decode_attention.SOURCES),
                         ("paged_attention", paged_attention.SOURCES),
                         ("fused_paged", fused_paged.SOURCES)):
        for kernel, n_regs, spill in build.ptxas_report(lib, sources):
            m = re.search(r"dense_decode_kernelI(a|13__nv_bfloat16)Li(\d+)ELi(\d+)ELb\dELi(\d+)E",
                          kernel)
            if m:
                ct = "int8" if m.group(1) == "a" else "bf16"
                decode[f"{lib} {ct} Dh={m.group(2)} R={m.group(3)} NW={m.group(4)}"] = [
                    n_regs, spill]
    if require_no_spill and not decode:
        raise AssertionError("build: no decode body instance in the ptxas logs")
    # the paged instances MiniChat's group of 1 selects (PAGED_MHA_SHAPE, as
    # BASELINE config #1's paged server runs them): T * G = 4 and 1 query
    # rows both take the 4-row bucket; 16 consumer warps only where the grid
    # leaves an SM to each block
    c, sms = PAGED_MHA_SHAPE, fused_decode.sm_count(0)
    nsplit = fused_decode.dense_splits(c["B"], c["Hkv"], c["mp"] * c["ps"], sms)
    nw = 16 if c["B"] * c["Hkv"] * nsplit <= sms else 8
    paged_g1 = {f"{lib} (T={T})": decode.get(f"{lib} int8 Dh=128 R=4 NW={nw}")
                for lib, T in (("paged_attention", 4), ("fused_paged", 1))}
    if require_no_spill and None in paged_g1.values():
        raise AssertionError(f"build: no 4-row paged instance with {nw} warps: {paged_g1}")
    # B1's float32 forward (with or without the lse), the float32 backward's
    # dq and dk/dv, and the float32 decode body's instances (cache type, Dh,
    # write, paged; the mixed ones, a bf16 query over a float32 cache, as
    # "mixed")
    f32 = flash_f32_registers(build, flash_attention) if f32_lib else {}
    if bwd_f32_lib:
        f32.update(flash_bwd_f32_registers(build, flash_attention))
    if decode_f32_lib:
        f32.update(decode_f32_registers(build, fused_decode))
    # every float32 kernel streams its tiles through shared memory and keeps
    # its accumulators in registers: ptxas must place every instance without
    # a spill
    if require_no_spill and (len(f32) != 2 + 4 + 24 + 8
                             or any(spill for _, spill in f32.values())):
        raise AssertionError(f"build: a float32 kernel spills or misses an instance: {f32}")
    emit("build", seconds=round(max(build.build_seconds.values(), default=0.0), 3),
         nvcc_seconds={k: round(v, 3) for k, v in build.build_seconds.items()},
         wgmma_kernels=regs, decode_kernels=decode, f32_kernels_registers_spill=f32,
         paged_g1_instances=dict(rows=4, warps=nw, splits=nsplit, registers_spill=paged_g1),
         card=card)


def flash_f32_registers(build, fa) -> dict:
    """[registers, spill bytes] of the float32 forward's instances in its
    build log, as "fwd Dh=64" and "fwd Dh=128"."""
    return {f"fwd Dh={int(re.search(r'Li(\d+)E', kernel).group(1))}": [n_regs, spill]
            for kernel, n_regs, spill in build.ptxas_report("flash_attention_f32",
                                                            fa.F32_SOURCES)}


def flash_bwd_f32_registers(build, fa) -> dict:
    """[registers, spill bytes] of the float32 backward's instances in its
    build log, as "dq Dh=64", "dkv Dh=64", "dq Dh=128" and "dkv Dh=128"."""
    out = {}
    for kernel, n_regs, spill in build.ptxas_report("flash_attention_bwd_f32",
                                                     fa.BWD_F32_SOURCES):
        name = re.search(r"bwd_(dq|dkv)_f32_kernel", kernel).group(1)
        out[f"{name} Dh={int(re.search(r'Li(\d+)E', kernel).group(1))}"] = [n_regs, spill]
    return out


def f32_split_count(fd, B, Hkv, max_offset) -> int:
    """The float32 decode body's split count for a call (``f32_splits``; an
    older checkout's float32 body took the bf16 rule)."""
    rule = getattr(fd, "f32_splits", fd.dense_splits)
    return rule(B, Hkv, max_offset, fd.sm_count(0))


def decode_f32_registers(build, fused_decode) -> dict:
    """[registers, spill bytes] of each instance of the float32 decode body
    in its build log: "decode <cache> Dh= write= paged=" for a float32
    query, "mixed float32 Dh= ..." for a bf16 query over a float32 cache."""
    cts = {"a": "int8", "f": "float32", "13__nv_bfloat16": "bf16"}
    out = {}
    for kernel, n_regs, spill in build.ptxas_report("decode_f32", fused_decode.F32_SOURCES):
        m = re.search(r"decode_f32_kernelI(a|f|13__nv_bfloat16)(f|13__nv_bfloat16|S\d*_)?"
                      r"Li(\d+)ELb(\d)ELb(\d)E", kernel)
        if m:
            kind = "decode" if m.group(2) in (None, "f") else "mixed"
            out[f"{kind} {cts[m.group(1)]} Dh={m.group(3)} write={m.group(4)} "
                f"paged={m.group(5)}"] = [n_regs, spill]
    return out


def phase_flash(torch, card):
    """B1 against its plain version run in float32 at the main paths' six
    shapes (Llama and MiniChat prefill, HuBERT-large and -base, Whisper, a
    tensor-parallel rank's Llama prefill), within B7_OUT_ATOL + B7_OUT_RTOL
    (|out| + (P.|V|)/l) on the valid rows, with two injected faults that
    bound must reject; the one PyTorch call that computes the same attention
    is timed beside it."""
    from llm_speech_summarization_tpu_torch.kernels.flash_attention import (
        flash_attention_fwd, flash_attention_lse_reference, flash_attention_reference,
    )

    rng = np.random.RandomState(0)
    dev = torch.device("cuda")
    results = {}
    # (a) LLM prefill: causal GQA 24/8, Dh=128, left pads incl. a full row
    #     (pad 0) and a length-1 row (pad T-1); (b) HuBERT: bidirectional
    #     16/16, Dh=64, right-pad windows [0, n_valid)
    cases = {
        "llm_prefill": dict(B=4, T=320, Hq=24, Hkv=8, Dh=128, causal=True,
                            starts=[0, 319, 37, 130], ends=[320] * 4),
        "hubert": dict(B=4, T=499, Hq=16, Hkv=16, Dh=64, causal=False,
                       starts=[0] * 4, ends=[499, 400, 1, 250]),
        # (c) Whisper-medium on 8 x 10 s clips with dynamic frames: 500
        #     frames, bidirectional 16/16, Dh=64, two shorter rows
        "whisper": dict(B=8, T=500, Hq=16, Hkv=16, Dh=64, causal=False,
                        starts=[0] * 8, ends=[500] * 6 + [321, 1]),
        # (d) MiniChat-3B's prefill: MHA, every one of 24 heads its own KV
        #     head (GQA group 1) at Dh=128, the llama prefill's left pads
        "llm_prefill_mha": dict(B=4, T=320, Hq=24, Hkv=24, Dh=128, causal=True,
                                starts=[0, 319, 37, 130], ends=[320] * 4),
        # (e) HuBERT-base: bidirectional 12/12, Dh=64, right-pad windows
        "hubert_base": dict(B=4, T=499, Hq=12, Hkv=12, Dh=64, causal=False,
                            starts=[0] * 4, ends=[499, 400, 1, 250]),
        # (f) one rank's share of (a) under tensor parallelism over two
        #     ranks: 12 query heads over 4 KV heads
        "llm_prefill_tp": dict(B=4, T=320, Hq=12, Hkv=4, Dh=128, causal=True,
                               starts=[0, 319, 37, 130], ends=[320] * 4),
    }
    for name, c in cases.items():
        B, T, causal = c["B"], c["T"], c["causal"]
        q = torch.from_numpy(rng.randn(B, T, c["Hq"], c["Dh"]).astype(np.float32)).to(dev, torch.bfloat16)
        k = torch.from_numpy(rng.randn(B, T, c["Hkv"], c["Dh"]).astype(np.float32)).to(dev, torch.bfloat16)
        v = torch.from_numpy(rng.randn(B, T, c["Hkv"], c["Dh"]).astype(np.float32)).to(dev, torch.bfloat16)
        starts = torch.tensor(c["starts"], dtype=torch.int32, device=dev)
        ends = torch.tensor(c["ends"], dtype=torch.int32, device=dev)
        got = flash_attention_fwd(q, k, v, starts, ends, causal=causal)
        torch.cuda.synchronize()
        f32 = [t.float() for t in (q, k, v)]
        ref = flash_attention_lse_reference(*f32, starts, ends, causal)[0]
        abs_out = flash_attention_lse_reference(*f32[:2], f32[2].abs(), starts, ends, causal)[0]
        bound = B7_OUT_ATOL + B7_OUT_RTOL * (ref.abs() + abs_out)
        del abs_out
        if not torch.isfinite(got).all():
            raise AssertionError(f"B1 {name}: non-finite output (pad rows must stay finite)")
        pos = torch.arange(T, device=dev)[None, :]
        rows = (pos >= starts[:, None]) & (pos < ends[:, None])  # valid query rows
        err = (got.float() - ref).abs().amax(dim=(2, 3))[rows].max().item()
        ratio = _out_ratio(torch, got, ref, bound, rows)
        if not ratio <= 1:
            raise AssertionError(f"B1 {name}: {ratio} x the output bound (max |err| {err})")
        # faults a kernel could make, through the plain version: V of the
        # neighbouring KV head, and the first k tile (64 keys) dropped from
        # P.V with its p still in the denominator
        v_tile = f32[2].clone()
        v_tile[:, :64] = 0
        faults = {}
        for fname, v_bad in (("V of the wrong KV head", f32[2].roll(1, dims=2)),
                             ("first k tile dropped from P.V", v_tile)):
            m_out = flash_attention_lse_reference(*f32[:2], v_bad, starts, ends, causal)[0]
            faults[fname] = _out_ratio(torch, m_out, ref, bound, rows)
        del v_tile, m_out, bound
        if min(faults.values()) <= 1:
            raise AssertionError(f"B1 {name}: the bound does not reject every fault: {faults}")
        t = timings(torch, lambda: flash_attention_fwd(q, k, v, starts, ends, causal=causal),
                    lambda: flash_attention_reference(q, k, v, starts, ends, causal=causal))
        t["library_ms"] = device_ms(torch, _sdpa_call(torch, q, k, v, rows, causal))
        n_bytes, flops = _flash_work(c, T)
        t["bound_ms"], t["bound_by"] = bound_ms(n_bytes, flops)
        results[name] = dict(max_abs_err=err, **t)
        emit("flash_attention", case=name, shape=[B, T, c["Hq"], c["Hkv"], c["Dh"]],
             causal=causal, max_abs_err=err, out_err_over_bound=ratio, out_atol=B7_OUT_ATOL,
             out_rtol_of_abs_out_plus_abs_pv=B7_OUT_RTOL, faults_over_bound=faults,
             bytes=n_bytes, flops=flops, **t, card=card)
    return results


# B1's float32 instance (the HuBERT-CTC model): (B, T, Hq, Hkv, Dh, causal,
# starts, ends). The CTC buckets clips to whole seconds and the
# preprocessing drops clips over 20 s: a 10 s and a 20 s clip (the main
# path), and a bucket of four with windows at its edges; Llama's prefill
# shape shows the function is general (kernel phase only)
F32_CASES = {
    "ctc_10s": (1, 499, 16, 16, 64, False, [0], [499]),
    "ctc_20s": (1, 999, 16, 16, 64, False, [0], [999]),
    "ctc_bucket_edges": (4, 499, 16, 16, 64, False, [0] * 4, [499, 400, 1, 250]),
    "llm_prefill": (4, 320, 24, 8, 128, True, [0, 319, 37, 130], [320] * 4),
}
REPEATS = 200  # identical calls per shape, each held bit-equal to the first


def tf32_round(torch, x):
    """float32 ``x`` rounded to TF32 (10 mantissa bits, to nearest)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def phase_flash_f32(torch, card):
    """B1's float32 instance at F32_CASES against the plain version run in
    float64 on the same float32 inputs, within F32_OUT_ATOL + F32_OUT_RTOL
    (|out| + (P.|V|)/l) on the valid rows; the bound must reject TF32-rounded
    operands, a window end off by one, the first k tile dropped from P.V and
    the KV head of the wrong group (each through the float64 plain
    version); REPEATS identical calls bit-equal; device times beside the
    float32 plain version and SDPA at float32 on the same mask."""
    from llm_speech_summarization_tpu_torch.kernels import build, flash_attention as fa
    from llm_speech_summarization_tpu_torch.kernels.flash_attention import (
        flash_attention_fwd, flash_attention_fwd_f32, flash_attention_lse_reference,
        flash_attention_reference,
    )

    fa._f32_lib()  # built, so that its log can be read
    regs = flash_f32_registers(build, fa)
    rng = np.random.RandomState(5)
    dev = torch.device("cuda")
    results = {}
    for name, (B, T, Hq, Hkv, Dh, causal, st, en) in F32_CASES.items():
        q, k, v = (torch.from_numpy(rng.randn(B, T, h, Dh).astype(np.float32)).to(dev)
                   for h in (Hq, Hkv, Hkv))
        starts = torch.tensor(st, dtype=torch.int32, device=dev)
        ends = torch.tensor(en, dtype=torch.int32, device=dev)
        before = flash_attention_fwd_f32.launches
        got = flash_attention_fwd(q, k, v, starts, ends, causal=causal)
        torch.cuda.synchronize()
        if flash_attention_fwd_f32.launches != before + 1 or got.dtype != torch.float32:
            raise AssertionError(f"B1 f32 {name}: flash_attention_fwd did not take the float32 "
                                 f"kernel ({got.dtype})")

        def f64(q_, k_, v_, ends_=ends):
            return flash_attention_lse_reference(q_.double(), k_.double(), v_.double(), starts,
                                                 ends_, causal)[0]

        ref = f64(q, k, v)
        bound = F32_OUT_ATOL + F32_OUT_RTOL * (ref.abs() + f64(q, k, v.abs()))
        pos = torch.arange(T, device=dev)[None, :]
        rows = (pos >= starts[:, None]) & (pos < ends[:, None])  # valid query rows
        if not torch.isfinite(got).all():
            raise AssertionError(f"B1 f32 {name}: non-finite output")
        ratio = _out_ratio(torch, got, ref, bound, rows)
        err = (got.double() - ref).abs().amax(dim=(2, 3))[rows].max().item()
        plain = flash_attention_reference(q, k, v, starts, ends, causal=causal)
        plain_ratio = _out_ratio(torch, plain, ref, bound, rows)
        del plain
        if not ratio <= 1:
            raise AssertionError(f"B1 f32 {name}: {ratio} x the output bound (max |err| {err})")
        v_tile = v.clone()
        v_tile[:, :64] = 0
        faults = {}
        for fname, args in (
                ("operands rounded to tf32", [tf32_round(torch, x) for x in (q, k, v)]),
                ("window end off by one", (q, k, v, ends - 1)),
                ("first k tile dropped from P.V", (q, k, v_tile)),
                ("KV head of the wrong group", (q, k.roll(1, dims=2), v.roll(1, dims=2)))):
            faults[fname] = _out_ratio(torch, f64(*args), ref, bound, rows)
        del v_tile, bound
        if min(faults.values()) <= 1:
            raise AssertionError(f"B1 f32 {name}: the bound does not reject every fault: "
                                 f"{faults}")
        unequal = sum(not torch.equal(flash_attention_fwd(q, k, v, starts, ends, causal=causal),
                                      got) for _ in range(REPEATS))
        if unequal:
            raise AssertionError(f"B1 f32 {name}: {unequal} of {REPEATS} repeats differ")
        # S of the bound's derivation: the largest Dh^-0.5 sum_d |q_d k_d|
        G = Hq // Hkv
        s_max = (q.abs().transpose(1, 2) @ k.abs().repeat_interleave(G, 2).permute(0, 2, 3, 1)
                 ).max().item() * Dh ** -0.5
        t = timings(torch, lambda: flash_attention_fwd(q, k, v, starts, ends, causal=causal),
                    lambda: flash_attention_reference(q, k, v, starts, ends, causal=causal))
        t["library_ms"] = device_ms(torch, _sdpa_call(torch, q, k, v, rows, causal),
                                    whole=False)
        c = dict(B=B, Hq=Hq, Hkv=Hkv, Dh=Dh, causal=causal, starts=st, ends=en)
        n_bytes, flops = _flash_work(c, T, elem_bytes=4)
        t["bound_ms"], t["bound_by"] = bound_ms(n_bytes, flops, F32_FLOPS_PER_S)
        results[name] = dict(max_abs_err=err, **t)
        emit("flash_attention_f32", case=name, shape=[B, T, Hq, Hkv, Dh], causal=causal,
             ends=en, max_abs_err=err, out_err_over_bound=ratio,
             plain_f32_err_over_bound=plain_ratio, out_atol=F32_OUT_ATOL,
             out_rtol_of_abs_out_plus_abs_pv=F32_OUT_RTOL, s_max=s_max,
             faults_over_bound=faults, repeats=REPEATS, unequal_repeats=unequal,
             bytes=n_bytes, flops=flops, pct_of_bound=100 * t["bound_ms"] / t["ms"],
             registers_spill=regs.get(f"fwd Dh={Dh}"), **t, card=card)
    return results


def _sdpa_call(torch, q, k, v, rows, causal):
    """``scaled_dot_product_attention`` over the same windows and GQA
    grouping, as a yardstick (the port never calls it)."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))  # (B, H, T, Dh)
    T = q.shape[1]
    mask = rows[:, None, None, :].expand(-1, 1, T, T)
    if causal:
        mask = mask & torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=kt.shape[1] != qt.shape[1])


def _flash_work(c, T, elem_bytes=2):
    """(bytes, flops) of one B1 call: q, k, v read and out written once
    (``elem_bytes`` each element: bf16, or 4 for float32); 2 flops per
    multiply-add of q.k and p.v over the valid (query, key) pairs of each
    window."""
    B, Hq, Hkv, Dh = c["B"], c["Hq"], c["Hkv"], c["Dh"]
    n_bytes = elem_bytes * B * T * Dh * (2 * Hq + 2 * Hkv)
    pairs = 0
    for s0, e0 in zip(c["starts"], c["ends"]):
        n = e0 - s0
        pairs += n * (n + 1) // 2 if c["causal"] else n * n
    return float(n_bytes), float(4 * Dh * Hq * pairs)


# B2's shapes (B, T, S): the batch path's B=8, the serving shape B=16 (T=1
# and the speculative T=3) and bench.py's batch B=128 over an S=384 int8
# cache; B=1, the trainers' validate generations, whose windows the
# wrapper splits in 8: at train_full's prompt length and at the long-audio
# ring's
FUSED_SHAPES = ((16, 1, 384), (16, 3, 384), (8, 1, 384), (128, 1, 384), (1, 1, 384),
                (1, 1, 1664))
# MiniChat-3B's decode (MHA: 24 KV heads, one query row per KV head at T=1,
# three with speculative_k): the serving shape at T=1 and T=3 and the
# validate generation's long split window, keyed (B, T, S, Hkv)
FUSED_MHA_SHAPES = ((16, 1, 384, 24), (16, 3, 384, 24), (1, 1, 1664, 24))
# one rank's heads under tensor parallelism over two ranks (serving_tp_full),
# keyed (B, T, S, Hq, Hkv): Llama-3.2-3B's 12/4 at the batch path's B=8 and
# the serving B=16 (T=1, and T=3 for speculative_k), MiniChat's 12/12
FUSED_TP_SHAPES = ((8, 1, 384, 12, 4), (16, 1, 384, 12, 4), (16, 3, 384, 12, 4),
                   (16, 1, 384, 12, 12))


@contextlib.contextmanager
def forced_splits(fd_mod, n, rule="dense_splits"):
    """Every launch in the block takes ``n`` splits of each window where
    ``fd_mod.<rule>`` (the bf16 body's ``dense_splits``, or the float32
    body's ``f32_splits``) would choose."""
    chosen = getattr(fd_mod, rule)
    setattr(fd_mod, rule, lambda *args: n)
    try:
        yield
    finally:
        setattr(fd_mod, rule, chosen)


def kernel_ms(torch, fn, reps: int = 20) -> dict:
    """Device milliseconds per call of each kernel that ``fn`` launches, by
    kernel name (one torch.profiler session after a warm-up cycle)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    events = []
    with profile(activities=[ProfilerActivity.CUDA],
                 on_trace_ready=lambda p: events.extend(
                     e for e in p.events() if e.device_type.name == "CUDA"),
                 schedule=torch.profiler.schedule(wait=0, warmup=1, active=1)) as prof:
        for _ in range(2):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    out = {}
    for e in events:
        name = re.search(r"(\w+)\s*[<(]", e.name)
        name = name.group(1) if name else e.name
        out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / reps
    return out


def phase_fused(torch, card):
    """B2 against its plain version (bf16, B2_ATOL/B2_RTOL) and against the
    plain version run in float32 (PAGED_ATOL + PAGED_RTOL |out|, with the
    faults that bound must reject: pad or offset off by one, the wrong
    layer, the fresh token dropped, the first split's share of the window
    dropped, or its first half where the wrapper does not split), cache
    writes bit-exact, bit-identical repeats, at FUSED_SHAPES (24/8 heads),
    FUSED_MHA_SHAPES (24/24) and FUSED_TP_SHAPES (12/4, 12/12); where the
    window is split, each kernel's
    time and the call's with one split;
    and the device cost of one empty kernel beside it."""
    from llm_speech_summarization_tpu_torch.kernels import fused_decode as fd_mod
    from llm_speech_summarization_tpu_torch.kernels.fused_decode import (
        fused_decode, fused_decode_reference,
    )

    rng = np.random.RandomState(1)
    dev = torch.device("cuda")
    L, Dh, layer = 2, 128, 1
    results = {}
    for B, T, S, Hq, Hkv in ([(*shape, 24, 8) for shape in FUSED_SHAPES]
                             + [(*shape[:3], 24, shape[3]) for shape in FUSED_MHA_SHAPES]
                             + list(FUSED_TP_SHAPES)):
        q = torch.from_numpy(rng.randn(B, T, Hq, Dh).astype(np.float32)).to(dev, torch.bfloat16)
        kn = torch.from_numpy(rng.randn(B, T, Hkv, Dh).astype(np.float32)).to(dev, torch.bfloat16)
        vn = torch.from_numpy(rng.randn(B, T, Hkv, Dh).astype(np.float32)).to(dev, torch.bfloat16)
        kc = torch.from_numpy(rng.randint(-127, 128, size=(L, B, Hkv, S, Dh)).astype(np.int8)).to(dev)
        vc = torch.from_numpy(rng.randint(-127, 128, size=(L, B, Hkv, S, Dh)).astype(np.int8)).to(dev)
        ks = torch.from_numpy((0.02 + 0.1 * rng.rand(L, B, Hkv, S)).astype(np.float32)).to(dev, torch.bfloat16)
        vs = torch.from_numpy((0.02 + 0.1 * rng.rand(L, B, Hkv, S)).astype(np.float32)).to(dev, torch.bfloat16)
        pads_np = rng.randint(0, 5, size=(B,)).astype(np.int32)
        pads = torch.from_numpy(pads_np).to(dev)
        offs_np = rng.randint(8, S - T, size=(B,)).astype(np.int32)
        offs_np[0] = S - T  # the last slot(s) of the cache
        if B > 1:
            offs_np[1] = 0  # nothing cached yet: only the fresh block
        if B == 1:
            # one long window hides a fault of one slot or of the fresh
            # token: keys that dominate some rows at the window's first and
            # last slots (scale 1) and fresh keys along a query of each group
            ks[layer, 0, :, pads_np[0]] = 1.0
            ks[layer, 0, :, offs_np[0] - 1] = 1.0
            kn = q[:, :, ::Hq // Hkv] * 8
        offs = torch.from_numpy(offs_np).to(dev)
        mo = int(offs_np.max())
        nsplit = (fd_mod.dense_splits(B, Hkv, mo, fd_mod.sm_count(0))
                  if hasattr(fd_mod, "dense_splits") else 1)
        snap = [t.clone() for t in (kc, vc, ks, vs)]
        ref_bufs = [t.clone() for t in snap]
        got_bufs = [t.clone() for t in snap]
        ref = fused_decode_reference(q, *ref_bufs, kn, vn, pads, offs, layer)
        got = fused_decode(q, *got_bufs, kn, vn, pads, offs, layer, max_offset=mo)
        torch.cuda.synchronize()
        what = f"B2 B={B} T={T} S={S} Hq={Hq} Hkv={Hkv}"
        err = (got.float() - ref.float()).abs().max().item()
        if not torch.allclose(got.float(), ref.float(), atol=B2_ATOL, rtol=B2_RTOL):
            raise AssertionError(f"{what}: out differs from the plain version (max |err| {err})")
        written = torch.zeros((L, B, Hkv, S), dtype=torch.bool, device=dev)
        for b in range(B):
            written[layer, b, :, offs_np[b]:offs_np[b] + T] = True
        for name, g, r, s0 in zip(("k_cache", "v_cache", "k_scale", "v_scale"),
                                  got_bufs, ref_bufs, snap):
            if not torch.equal(g, r):
                raise AssertionError(f"{what}: {name} differs from the plain version's write "
                                     f"at {int((g != r).sum())} elements")
            if not torch.equal(g[~written], s0[~written]):
                raise AssertionError(f"{what}: {name} changed outside the written slots")
            if torch.equal(g[written], s0[written]):
                raise AssertionError(f"{what}: {name} was not written")

        def exact_fn(pads=pads, offs=offs, layer=layer):
            return fused_decode_reference(q.float(), *(t.clone() for t in snap), kn.float(),
                                          vn.float(), pads, offs, layer)

        live = torch.from_numpy((offs_np > pads_np).astype(np.int32)).to(dev)
        # the slots of the window's first split (the kernel's even shares),
        # or of its first half where the wrapper does not split
        parts = max(nsplit, 2)
        share = torch.from_numpy(((np.clip(offs_np - pads_np, 0, None) + parts - 1) // parts)
                                 .astype(np.int32)).to(dev)
        dropped = (f"split 0 of {nsplit} dropped" if nsplit > 1
                   else "first half of the window dropped")
        check = _dense_check(torch, what, got, exact_fn, _cache_only(
            torch, q, snap[0][layer], snap[1][layer], snap[2][layer], snap[3][layer], pads,
            offs), {"pad+1": dict(pads=pads + live), "offset-1": dict(offs=offs - live),
                    "wrong layer": dict(layer=0), dropped: dict(pads=pads + share)})
        # bit-identical repeats on a fresh copy of the cache
        again_bufs = [t.clone() for t in snap]
        again = fused_decode(q, *again_bufs, kn, vn, pads, offs, layer, max_offset=mo)
        same = {"out": torch.equal(again, got),
                "caches": all(torch.equal(a, g) for a, g in zip(again_bufs, got_bufs))}
        if not all(same.values()):
            raise AssertionError(f"{what}: two identical calls differ: {same}")

        def call():
            return fused_decode(q, *got_bufs, kn, vn, pads, offs, layer, max_offset=mo)

        t = timings(torch, call,
                    lambda: fused_decode_reference(q, *ref_bufs, kn, vn, pads, offs, layer))
        split = {}
        if nsplit > 1:  # the split body and the merge kernel apart, and one split
            split["kernel_ms"] = kernel_ms(torch, call)
            with forced_splits(fd_mod, 1):
                split["ms_one_split"] = device_ms(torch, call)
                split["call_ms_one_split"] = call_ms(torch, call)
        # bytes: the valid int8 cache slots of k and v with their bf16
        # scales, q, the fresh k/v, the output and the written slots
        valid = np.clip(offs_np - pads_np, 0, None).astype(np.int64)
        n_bytes = (valid.sum() * Hkv * (2 * Dh + 4) + 2 * B * T * (2 * Hq + 2 * Hkv) * Dh
                   + B * T * Hkv * 2 * (Dh + 2))
        flops = 4 * Dh * Hq * T * (valid.sum() + B * (T + 1) / 2)
        t["bound_ms"], t["bound_by"] = bound_ms(float(n_bytes), float(flops))
        key = (B, T, S) if (Hq, Hkv) == (24, 8) else (B, T, S, Hkv) if Hq == 24 \
            else (B, T, S, Hq, Hkv)
        results[key] = dict(max_abs_err=max(err, check["max_abs_err"]), **t)
        emit("fused_decode", B=B, T=T, shape=[L, B, Hq, Hkv, S, Dh], splits=nsplit,
             max_abs_err=err, atol=B2_ATOL, rtol=B2_RTOL,
             f32_check=check, f32_atol=PAGED_ATOL, f32_rtol=PAGED_RTOL,
             cache_writes="bit-exact", bit_identical=same, bytes=float(n_bytes),
             flops=float(flops), **t, **split, card=card)
        del kc, vc, snap, ref_bufs, got_bufs, again_bufs
    # the floor under B2's time at small batch: one launch of an empty kernel
    empty = {"ms": device_ms(torch, lambda: torch.cuda._sleep(0)),
             "call_ms": call_ms(torch, lambda: torch.cuda._sleep(0))}
    emit("empty_kernel", kernel="torch.cuda._sleep(0)", **empty, card=card)
    return results


PAGED_SHAPE = dict(B=16, Hq=24, Hkv=8, Dh=128, ps=128, mp=7, L=2)
# MiniChat's heads (BASELINE config #1's paged server): a group of 1, so B4
# at T=4 and B5 take the 4-row instance of the decode body
PAGED_MHA_SHAPE = dict(PAGED_SHAPE, Hkv=24)
# one rank's heads of Llama-3.2-3B under tensor parallelism over two ranks
PAGED_TP_SHAPE = dict(PAGED_SHAPE, Hq=12, Hkv=4)
PAGED_SEED = 4  # B4 and B5 read the same pages
PAGED_T_MAX = 4  # lengths leave room for this many fresh tokens at every T


def _paged_case(torch, seed, T, write, device="cuda", shape=PAGED_SHAPE):
    """The serving ``shape``, int8 pools with scattered pages, pad rows (one
    past the first page), rows at page boundaries, a row with only the
    fresh block; with ``write`` (B5) also a row at length == ps * mp and a
    released row (table of zeros). Pools, scales, table, pads and lengths
    come from ``seed`` alone, so every T (and B5) reads the same pages;
    q and the fresh k/v from ``(seed, T)``."""
    c = shape
    B, Hq, Hkv, Dh, ps, mp, L = (c[k] for k in ("B", "Hq", "Hkv", "Dh", "ps", "mp", "L"))
    if not 1 <= T <= PAGED_T_MAX:
        raise ValueError(f"T={T} outside 1..{PAGED_T_MAX}")
    dev = torch.device(device)
    P = 1 + B * mp
    rng = np.random.RandomState(seed)

    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)

    kp = torch.from_numpy(rng.randint(-127, 128, size=(L, P, Hkv, ps, Dh)).astype(np.int8)).to(dev)
    vp = torch.from_numpy(rng.randint(-127, 128, size=(L, P, Hkv, ps, Dh)).astype(np.int8)).to(dev)
    # scales keep |int8 x scale| <= ~1.5, the size of real k/v (a scale is
    # absmax / 127)
    ks, vs = (bf(0.002 + 0.01 * rng.rand(L, P, Hkv, ps)) for _ in range(2))
    table = (1 + rng.permutation(B * mp)).reshape(B, mp).astype(np.int32)
    pads = rng.randint(0, 5, size=(B,)).astype(np.int32)
    pads[2] = ps + 2  # the window starts on the second page
    lengths = rng.randint(pads + 1, mp * ps - PAGED_T_MAX + 1).astype(np.int32)
    lengths[0], lengths[1] = ps, 2 * ps  # length % ps == 0
    lengths[3] = pads[3]  # nothing cached: only the fresh block
    lengths[4] = mp * ps - PAGED_T_MAX  # the last slots of the table
    if write:
        lengths[5] = mp * ps  # past the table: the token goes to page 0
        table[6] = 0  # a released row
    fresh = np.random.RandomState([seed, T])
    q, kn, vn = (bf(fresh.randn(B, T, h, Dh)) for h in (Hq, Hkv, Hkv))
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return q, kp, vp, ks, vs, to(table), to(lengths), to(pads), kn, vn, lengths, pads, table


def _paged_work(lengths, pads, T, write, shape=PAGED_SHAPE):
    """(bytes, flops) one call needs at ``shape``: the valid positions'
    int8 k/v and bf16 scales, q, the fresh k/v and the output, plus the
    written slots (B5); 2 flops per multiply-add of q.k and p.v."""
    c = shape
    B, Hq, Hkv, Dh, ps, mp = (c[k] for k in ("B", "Hq", "Hkv", "Dh", "ps", "mp"))
    valid = np.clip(np.minimum(lengths, ps * mp) - pads, 0, None).astype(np.int64)
    n_bytes = valid.sum() * Hkv * (2 * Dh + 2 * 2) + 2 * B * T * (2 * Hq + 2 * Hkv) * Dh
    if write:
        n_bytes += B * Hkv * 2 * (Dh + 2)
    fresh_pairs = B * Hq * T * (T + 1) // 2
    flops = 4 * Dh * (Hq * T * valid.sum() + fresh_pairs)
    return float(n_bytes), float(flops)


def _paged_masked(torch, q, kp, vp, ks, vs, table, lens, pads, kn, vn, drop):
    """float32 attention of q over int8 pages (P, Hkv, ps, Dh) through
    ``table`` and the causal fresh block, the window [pad, length) without
    the positions where ``drop`` (B, mp * ps) is set: the fault of a kernel
    that skips part of a chunk."""
    B, T, Hq, Dh = q.shape
    Hkv, ps = kp.shape[1], kp.shape[2]
    S = table.shape[1] * ps
    t = table.long()
    k, v = ((pool[t].float() * sc[t].float()[..., None]).transpose(1, 2).reshape(B, Hkv, S, Dh)
            for pool, sc in ((kp, ks), (vp, vs)))
    qg = q.float().reshape(B, T, Hkv, Hq // Hkv, Dh)
    pos = torch.arange(S, device=q.device)
    valid = (pos >= pads[:, None]) & (pos < lens[:, None]) & ~drop
    s = torch.einsum("bthgd,bhsd->bthgs", qg, k) * Dh ** -0.5
    s = torch.where(valid[:, None, None, None], s, torch.full((), -1e30, device=q.device))
    s_f = torch.einsum("bthgd,bshd->bthgs", qg, kn.float()) * Dh ** -0.5
    causal = torch.arange(T, device=q.device)[:, None] >= torch.arange(T, device=q.device)
    s_f = torch.where(causal[None, :, None, None], s_f, torch.full((), -1e30, device=q.device))
    p = torch.softmax(torch.cat([s, s_f], -1), -1)
    out = (torch.einsum("bthgs,bhsd->bthgd", p[..., :S], v)
           + torch.einsum("bthgs,bshd->bthgd", p[..., S:], vn.float()))
    return out.reshape(B, T, Hq, Dh)


def _paged_check(torch, what, got, plain, exact_fn, rows, lens, pads, ks, vs, table):
    """Hold ``got`` to the float32 plain version ``exact_fn()`` within
    PAGED_ATOL + PAGED_RTOL * |exact| on ``rows``, and show that bound
    rejects faults a kernel could make: ``exact_fn`` run with a pad or a
    length shifted by one, each row's first page dropped, the k or v
    scales shifted one slot, the tables of rows 0 and 1 swapped, and a
    page segment dropped from the chunks that cross a page (``drop``: the
    positions [k ps, k ps + pad % 64) after each row's first page boundary
    k ps, which every chunk of 64 or 128 slots from pad reaches mid-chunk).
    Returns the check's numbers."""
    exact = exact_fn()
    bound = PAGED_ATOL + PAGED_RTOL * exact.abs()

    def worst(x):  # largest |x - exact| in units of the bound, on ``rows``
        return ((x.float() - exact).abs() / bound)[rows].max().item()

    ratio = worst(got)
    err = (got.float() - exact)[rows].abs().max().item()
    if not torch.isfinite(got).all() or not ratio <= 1:
        per_row = (got.float() - exact).abs().amax(dim=(1, 2, 3)).tolist()
        raise AssertionError(f"{what}: out differs from the float32 plain version by {ratio} x "
                             f"the bound (max |err| {err}; per row {per_row})")
    ps = PAGED_SHAPE["ps"]
    live = (lens > pads).int()
    pos = torch.arange(table.shape[1] * ps, device=lens.device)
    first = ((pads // ps + 1) * ps)[:, None]  # each row's first page boundary in its window
    segment = (pos >= first) & (pos < first + (pads % 64)[:, None]) & (pos < lens[:, None])
    mutants = {
        "pad+1": dict(pads=pads + live),
        "length-1": dict(lens=lens - live),
        "first page dropped": dict(pads=torch.where(lens - pads > ps, (pads // ps + 1) * ps,
                                                    pads).int()),
        "k scale shifted": dict(ks=torch.roll(ks, 1, dims=-1)),
        "v scale shifted": dict(vs=torch.roll(vs, 1, dims=-1)),
        "tables swapped": dict(table=table[[1, 0] + list(range(2, table.shape[0]))].contiguous()),
        "page segment dropped": dict(drop=segment),
    }
    rejected = {name: worst(exact_fn(**kw)) for name, kw in mutants.items()}
    if min(rejected.values()) <= 1:
        raise AssertionError(f"{what}: the bound does not reject every fault: {rejected}")
    a = exact[rows].abs()
    return dict(max_abs_err=err, err_over_bound=ratio,
                err_vs_bf16_plain=(got.float() - plain.float())[rows].abs().max().item(),
                out_rms=a.pow(2).mean().sqrt().item(), out_median_abs=a.median().item(),
                faults_over_bound=rejected)


def phase_paged(torch, card, shape=PAGED_SHAPE):
    """B4 against its plain version at the speculative-verification shape
    (T = spec_k + 1 = 4) with ``shape``'s heads, reading layer 1 of (L, ...)
    pools in place."""
    from llm_speech_summarization_tpu_torch.kernels.paged_attention import (
        paged_decode_attention, paged_reference,
    )

    T, layer = 4, 1
    what = f"B4 at {shape['Hq']}/{shape['Hkv']}"
    (q, kp, vp, ks, vs, table, lens, pads, kn, vn,
     lens_np, pads_np, _) = _paged_case(torch, PAGED_SEED, T, write=False, shape=shape)
    args = (q, kp[layer], vp[layer], table, lens, pads, kn, vn, ks[layer], vs[layer])
    snap = [t.clone() for t in (kp, vp, ks, vs)]
    got = paged_decode_attention(*args)
    plain = paged_reference(*args)

    def exact_fn(table=table, lens=lens, pads=pads, ks=ks, vs=vs, drop=None):
        if drop is not None:
            return _paged_masked(torch, q, kp[layer], vp[layer], ks[layer], vs[layer], table,
                                 lens, pads, kn, vn, drop)
        return paged_reference(q.float(), kp[layer], vp[layer], table, lens, pads, kn.float(),
                               vn.float(), ks[layer], vs[layer])

    rows = torch.ones(q.shape[0], dtype=torch.bool, device=q.device)
    check = _paged_check(torch, what, got, plain, exact_fn, rows, lens, pads, ks, vs, table)
    for t, s0 in zip((kp, vp, ks, vs), snap):
        if not torch.equal(t, s0):
            raise AssertionError(f"{what} wrote into the pools")
    if not torch.equal(paged_decode_attention(*args), got):
        raise AssertionError(f"{what}: two identical calls differ")
    t = timings(torch, lambda: paged_decode_attention(*args), lambda: paged_reference(*args))
    n_bytes, flops = _paged_work(lens_np, pads_np, T, write=False, shape=shape)
    b_ms, b_by = bound_ms(n_bytes, flops)
    emit("paged_attention", T=T, shape=shape, **check, atol=PAGED_ATOL, rtol=PAGED_RTOL,
         bit_identical=True, bytes=n_bytes, flops=flops, bound_ms=b_ms, bound_by=b_by, **t,
         card=card)
    return dict(max_abs_err=check["max_abs_err"], bound_ms=b_ms, bound_by=b_by, **t)


def phase_fused_paged(torch, card, shape=PAGED_SHAPE):
    """B5 against its plain version at the decode shape (T = 1, L = 2) with
    ``shape``'s heads: outputs close, page writes bit-exact outside page 0,
    nothing else changed."""
    from llm_speech_summarization_tpu_torch.kernels.fused_paged import (
        _write_targets, fused_paged_decode, fused_paged_reference,
    )

    layer = 1
    what = f"B5 at {shape['Hq']}/{shape['Hkv']}"
    (q, kp, vp, ks, vs, table, lens, pads, kn, vn,
     lens_np, pads_np, table_np) = _paged_case(torch, PAGED_SEED, 1, write=True, shape=shape)
    snap = [t.clone() for t in (kp, vp, ks, vs)]
    got_bufs = [t.clone() for t in snap]
    ref_bufs = [t.clone() for t in snap]
    got = fused_paged_decode(q, *got_bufs, table, lens, pads, kn, vn, layer)
    plain = fused_paged_reference(q, *ref_bufs, table, lens, pads, kn, vn, layer)

    def exact_fn(table=table, lens=lens, pads=pads, ks=snap[2], vs=snap[3], drop=None):
        if drop is not None:
            return _paged_masked(torch, q, snap[0][layer], snap[1][layer], ks[layer], vs[layer],
                                 table, lens, pads, kn, vn, drop)
        return fused_paged_reference(q.float(), snap[0].clone(), snap[1].clone(), ks.clone(),
                                     vs.clone(), table, lens, pads, kn.float(), vn.float(), layer)

    # the released row reads page 0 while other rows write it: compare the rest
    rows = torch.from_numpy((table_np != 0).all(axis=1)).cuda()
    check = _paged_check(torch, what, got, plain, exact_fn, rows, lens, pads, snap[2], snap[3],
                         table)
    pid, slot = _write_targets(table, lens, shape["ps"])
    written = torch.zeros(snap[2].shape, dtype=torch.bool, device="cuda")  # (L, P, Hkv, ps)
    written[layer, pid, :, slot] = True
    written[:, 0] = True  # page 0 takes the boundary and released rows' tokens
    n_written = int((pid != 0).sum())
    for name, g, r, s0 in zip(("k_pool", "v_pool", "k_scale", "v_scale"), got_bufs, ref_bufs,
                              snap):
        if not torch.equal(g[:, 1:], r[:, 1:]):
            raise AssertionError(f"{what}: {name} differs from the plain version's write "
                                 f"outside page 0 at {int((g[:, 1:] != r[:, 1:]).sum())} elements")
        if not torch.equal(g[~written], s0[~written]):
            raise AssertionError(f"{what}: {name} changed outside the written slots")
        if torch.equal(g[:, 1:][written[:, 1:]], s0[:, 1:][written[:, 1:]]):
            raise AssertionError(f"{what}: {name} was not written")
    # bit-identical repeats on a fresh copy of the pools (the rows compared:
    # the released row reads page 0 while others write it)
    again_bufs = [t.clone() for t in snap]
    again = fused_paged_decode(q, *again_bufs, table, lens, pads, kn, vn, layer)
    if not (torch.equal(again[rows], got[rows])
            and all(torch.equal(a, g) for a, g in zip(again_bufs, got_bufs))):
        raise AssertionError(f"{what}: two identical calls differ")
    t = timings(torch, lambda: fused_paged_decode(q, *got_bufs, table, lens, pads, kn, vn, layer),
                lambda: fused_paged_reference(q, *ref_bufs, table, lens, pads, kn, vn, layer))
    n_bytes, flops = _paged_work(lens_np, pads_np, 1, write=True, shape=shape)
    b_ms, b_by = bound_ms(n_bytes, flops)
    emit("fused_paged", T=1, shape=shape, **check, atol=PAGED_ATOL, rtol=PAGED_RTOL,
         page_writes="bit-exact outside page 0", rows_written=n_written, bit_identical=True,
         bytes=n_bytes,
         flops=flops, bound_ms=b_ms, bound_by=b_by, **t, card=card)
    return dict(max_abs_err=check["max_abs_err"], bound_ms=b_ms, bound_by=b_by, **t)


DENSE_SHAPE = dict(B=8, Hq=24, Hkv=8, Dh=128, L=2)  # the Whisper path's LLM, 8 clips


def _whisper_cache_len() -> int:
    """S of the whisper_full batch path's cache: the prompt of 10 s clips
    (the engine's buffer arithmetic and template) rounded to the prompt
    bucket, plus 32 new tokens rounded to the decode bucket."""
    from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
    from llm_speech_summarization_tpu_torch.infer.engine import BUCKET, DECODE_BUCKET, _round_up
    from llm_speech_summarization_tpu_torch.models.audio_encoder import (
        audio_embed_buffer_len, encoder_setup_from_config,
    )
    from llm_speech_summarization_tpu_torch.utils.prompts import prompt_template_for
    from llm_speech_summarization_tpu_torch.utils.tokenizer import load_tokenizer

    cfg = load_config(str(YAML_DIR / "llama3_whisper.yaml"))
    tok = load_tokenizer(cfg.model.llm_type, cfg.model.tokenizer_path)
    tpl = prompt_template_for(cfg.model.llm_type)
    n = (len(tok.encode(tpl.prefix, add_bos=True)) + len(tok.encode(tpl.suffix, add_bos=False))
         + audio_embed_buffer_len(encoder_setup_from_config(cfg), 160000))
    return _round_up(n, BUCKET) + _round_up(32, DECODE_BUCKET)


def _dense_case(torch, seed, S, T, quantized):
    """DENSE_SHAPE over a cache of S slots: a bf16 cache of unit-scale
    values, or int8 values with scales that keep |int8 x scale| <= ~1.5;
    pads with one row starting 40 slots in, offsets with one row at the
    last slot(s) and one with nothing cached (only the fresh block)."""
    c = DENSE_SHAPE
    B, Hq, Hkv, Dh, L = (c[k] for k in ("B", "Hq", "Hkv", "Dh", "L"))
    rng = np.random.RandomState(seed)
    dev = torch.device("cuda")

    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)

    if quantized:
        kc, vc = (torch.from_numpy(rng.randint(-127, 128, size=(L, B, Hkv, S, Dh))
                                   .astype(np.int8)).to(dev) for _ in range(2))
        ks, vs = (bf(0.002 + 0.01 * rng.rand(L, B, Hkv, S)) for _ in range(2))
    else:
        kc, vc = (bf(rng.randn(L, B, Hkv, S, Dh)) for _ in range(2))
        ks = vs = None
    pads = rng.randint(0, 5, size=(B,)).astype(np.int32)
    pads[2] = 40
    offs = rng.randint(pads + 1, S - T + 1).astype(np.int32)
    offs[0], offs[1] = S - T, pads[1]
    q, kn, vn = (bf(rng.randn(B, T, h, Dh)) for h in (Hq, Hkv, Hkv))
    return q, kc, vc, ks, vs, kn, vn, pads, offs


def _cache_only(torch, q, kc, vc, ks, vs, pads, offs):
    """float32 attention of q (B, T, Hq, Dh) over one layer's cache window
    [pad, offset) alone: the fault of a kernel that drops the fresh block."""
    B, T, Hq, Dh = q.shape
    Hkv, S = kc.shape[1], kc.shape[2]
    k = kc.float() * (ks.float()[..., None] if ks is not None else 1.0)
    v = vc.float() * (vs.float()[..., None] if vs is not None else 1.0)
    s = torch.einsum("bthgd,bhsd->bthgs", q.float().reshape(B, T, Hkv, Hq // Hkv, Dh),
                     k) * Dh ** -0.5
    slot = torch.arange(S, device=q.device)
    valid = (slot[None, :] >= pads[:, None]) & (slot[None, :] < offs[:, None])
    s = torch.where(valid[:, None, None, None, :], s, torch.full((), -1e30, device=q.device))
    out = torch.einsum("bthgs,bhsd->bthgd", torch.softmax(s, -1), v)
    return out.reshape(B, T, Hq, Dh)


def _dense_work(valid, T, elem_bytes, quantized, writes):
    """(bytes, flops) of one B3 or B8 call at DENSE_SHAPE: the valid slots'
    k and v (with their bf16 scales when int8), q, the fresh k/v and the
    output, plus the written fresh rows (B3); 2 flops per multiply-add of
    q.k and p.v over the valid slots and the causal fresh block."""
    c = DENSE_SHAPE
    B, Hq, Hkv, Dh = c["B"], c["Hq"], c["Hkv"], c["Dh"]
    slot_bytes = 2 * (Dh * elem_bytes + (2 if quantized else 0))  # k and v of one slot
    n_bytes = valid.sum() * Hkv * slot_bytes + 2 * B * T * (2 * Hq + 2 * Hkv) * Dh
    if writes:
        n_bytes += B * T * Hkv * slot_bytes
    flops = 4 * Dh * Hq * T * (valid.sum() + B * (T + 1) / 2)
    return float(n_bytes), float(flops)


def _dense_check(torch, what, got, exact_fn, cache_only, mutants):
    """Hold ``got`` to ``exact_fn()`` within PAGED_ATOL + PAGED_RTOL |exact|
    and show the bound rejects each fault: ``exact_fn(**kw)`` for each of
    ``mutants`` and the cache-only attention (the fresh block dropped)."""
    exact = exact_fn()
    bound = PAGED_ATOL + PAGED_RTOL * exact.abs()

    def worst(x):
        return ((x.float() - exact).abs() / bound).max().item()

    ratio = worst(got)
    if not torch.isfinite(got).all() or not ratio <= 1:
        raise AssertionError(f"{what}: out differs from the float32 plain version by {ratio} "
                             f"x the bound")
    rejected = {name: worst(exact_fn(**kw)) for name, kw in mutants.items()}
    rejected["fresh token dropped"] = worst(cache_only)
    if min(rejected.values()) <= 1:
        raise AssertionError(f"{what}: the bound does not reject every fault: {rejected}")
    return dict(max_abs_err=(got.float() - exact).abs().max().item(), err_over_bound=ratio,
                out_rms=exact.pow(2).mean().sqrt().item(), faults_over_bound=rejected)


def phase_dense_decode(torch, card):
    """B3 (bf16 cache at T=1 and T=3, int8 cache with one layer's scales)
    and B8 (bf16 and int8 caches) against their plain versions at the
    whisper_full path's shapes, reading layer 1 of (L, ...) caches."""
    from llm_speech_summarization_tpu_torch.kernels.decode_attention import (
        decode_attention, decode_attention_reference,
    )
    from llm_speech_summarization_tpu_torch.kernels.fused_decode import (
        fused_decode_attention_write, fused_decode_attention_write_reference,
    )

    S, layer = _whisper_cache_len(), 1
    results = {}
    for T, quantized in ((1, False), (3, False), (1, True)):
        name = f"b3_{'int8' if quantized else 'bf16'}_T{T}"
        q, kc, vc, ks, vs, kn, vn, pads_np, offs_np = _dense_case(torch, 50 + T, S, T, quantized)
        pads, offs = (torch.from_numpy(a).cuda() for a in (pads_np, offs_np))
        sc = (ks[layer], vs[layer]) if quantized else ()
        snap = [t.clone() for t in (kc, vc)]
        got_bufs, ref_bufs = [t.clone() for t in snap], [t.clone() for t in snap]
        mo = int(offs_np.max())
        got = fused_decode_attention_write(q, *got_bufs, kn, vn, pads, offs, layer, *sc,
                                           max_offset=mo)
        plain = fused_decode_attention_write_reference(q, *ref_bufs, kn, vn, pads, offs, layer,
                                                       *sc)
        torch.cuda.synchronize()
        if quantized:  # the fresh (B, Hkv) scales, bit-exact
            if not all(torch.equal(g, r) for g, r in zip(got[1:], plain[1:])):
                raise AssertionError(f"B3 {name}: the returned fresh scales differ")
            got = got[0]

        def exact_fn(pads=pads, offs=offs, layer=layer):
            out = fused_decode_attention_write_reference(
                q.float(), snap[0].clone(), snap[1].clone(), kn.float(), vn.float(), pads, offs,
                layer, *((ks[layer], vs[layer]) if quantized else ()))
            return out[0] if quantized else out

        live = torch.from_numpy((offs_np > pads_np).astype(np.int32)).cuda()
        check = _dense_check(torch, f"B3 {name}", got, exact_fn, _cache_only(
            torch, q, snap[0][layer], snap[1][layer], *(sc or (None, None)), pads, offs), {
                "pad+1": dict(pads=pads + live), "offset-1": dict(offs=offs - live),
                "wrong layer": dict(layer=0)})
        written = torch.zeros(kc.shape[:4], dtype=torch.bool, device="cuda")
        for b in range(DENSE_SHAPE["B"]):
            written[layer, b, :, offs_np[b]:offs_np[b] + T] = True
        for bname, g, r, s0 in zip(("k_cache", "v_cache"), got_bufs, ref_bufs, snap):
            if not torch.equal(g, r):
                raise AssertionError(f"B3 {name}: {bname} differs from the plain version's "
                                     f"write at {int((g != r).sum())} elements")
            if not torch.equal(g[~written], s0[~written]) or torch.equal(g[written],
                                                                          s0[written]):
                raise AssertionError(f"B3 {name}: {bname} written outside the fresh slots, "
                                     f"or not at them")
        t = timings(torch, lambda: fused_decode_attention_write(
                        q, *got_bufs, kn, vn, pads, offs, layer, *sc, max_offset=mo),
                    lambda: fused_decode_attention_write_reference(
                        q, *ref_bufs, kn, vn, pads, offs, layer, *sc))
        valid = np.clip(offs_np - pads_np, 0, None).astype(np.int64)
        n_bytes, flops = _dense_work(valid, T, 1 if quantized else 2, quantized, writes=True)
        t["bound_ms"], t["bound_by"] = bound_ms(n_bytes, flops)
        # no PyTorch call attends a cache and writes it in place
        results[name] = dict(**check, **t, library_ms=None)
        emit("dense_decode", kernel="B3", case=name, S=S, T=T, shape=DENSE_SHAPE, **check,
             atol=PAGED_ATOL, rtol=PAGED_RTOL, cache_writes="bit-exact", bytes=n_bytes,
             flops=flops, **t, card=card)

    for quantized in (False, True):
        name = f"b8_{'int8' if quantized else 'bf16'}"
        q, kc, vc, ks, vs, kn, vn, pads_np, _ = _dense_case(torch, 60, S, 1, quantized)
        offset = S - 16
        pads = torch.from_numpy(pads_np).cuda()
        sc = (ks[layer], vs[layer]) if quantized else ()
        snap = [t.clone() for t in (kc, vc)]
        got = decode_attention(q, kc[layer], vc[layer], kn, vn, pads, offset, *sc)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip((kc, vc), snap)):
            raise AssertionError(f"B8 {name} wrote into the cache")

        def exact_fn(pads=pads, offset=offset, layer=layer):
            return decode_attention_reference(
                q.float(), kc[layer], vc[layer], kn.float(), vn.float(), pads, offset,
                *((ks[layer], vs[layer]) if quantized else ()))

        offs = torch.full_like(pads, offset)
        check = _dense_check(torch, f"B8 {name}", got, exact_fn, _cache_only(
            torch, q, kc[layer], vc[layer], *(sc or (None, None)), pads, offs), {
                "pad+1": dict(pads=pads + 1), "offset-1": dict(offset=offset - 1),
                "wrong layer": dict(layer=0)})
        t = timings(torch, lambda: decode_attention(q, kc[layer], vc[layer], kn, vn, pads,
                                                    offset, *sc),
                    lambda: decode_attention_reference(q, kc[layer], vc[layer], kn, vn, pads,
                                                       offset, *sc))
        valid = np.clip(offset - pads_np, 0, None).astype(np.int64)
        n_bytes, flops = _dense_work(valid, 1, 1 if quantized else 2, quantized, writes=False)
        t["bound_ms"], t["bound_by"] = bound_ms(n_bytes, flops)
        # over the bf16 cache, two PyTorch calls compute it: the [cache | fresh]
        # concatenation and SDPA with a boolean mask; none takes an int8 cache
        t["library_ms"] = None if quantized else device_ms(
            torch, _sdpa_decode_call(torch, q, kc[layer], vc[layer], kn, vn, pads, offset),
            whole=False)
        results[name] = dict(**check, **t)
        emit("dense_decode", kernel="B8", case=name, S=S, offset=offset, shape=DENSE_SHAPE,
             **check, atol=PAGED_ATOL, rtol=PAGED_RTOL, bytes=n_bytes, flops=flops, **t,
             library="torch.cat + scaled_dot_product_attention" if not quantized else None,
             card=card)
    return results


# The float32 decode instances (B2, B3, B4, B5 and B8 at a float32 query,
# csrc/decode_f32.cu) at the float32 serving path's shapes: Llama-3.2-3B's
# 24/8 heads at Dh=128, the batch path's S=384 dense cache and the paged
# server's pools (ps=128, mp=7). B2 over the int8 cache at the batch path's
# B=8, the server's B=16 (T=1 and the speculative T=3) and bench.py's
# B=128; B3 over a float32 cache (kv_cache_dtype null at compute_dtype
# float32) at T=1 and T=3, a bf16 cache and an int8 cache with one layer's
# scales; B4 (T=4) and B5 (T=1) over int8, float32 and bf16 pools; B8 over
# float32, int8 and bf16 caches at offset 368
F32_DECODE_B2 = ((8, 1), (16, 1), (128, 1), (16, 3))  # (B, T), int8 cache, S=384
F32_DECODE_B3 = (("float32", 1), ("float32", 3), ("bfloat16", 1), ("int8", 1))  # B=8
F32_DECODE_POOLS = ("int8", "float32", "bfloat16")
F32_DECODE_S = 384
F32_DECODE_B8_OFFSET = 368


def _f64_decode(torch, q, k, v, kn, vn, valid, p_round=None):
    """float64 decode attention, the float32 instances' yardstick: q (B, T,
    Hq, Dh) over the dense float64 k/v (B, Hkv, S, Dh), already times their
    scales, where ``valid`` (B, S), plus the fresh block (B, T, Hkv, Dh)
    causally. ``p_round`` ("tf32" or "bf16") rounds p before P.V (not in the
    denominator): the faults of a kernel that rounds p."""
    B, T, Hq, Dh = q.shape
    Hkv = k.shape[1]
    qg = q.double().reshape(B, T, Hkv, Hq // Hkv, Dh)
    neg = torch.full((), float("-inf"), dtype=torch.float64, device=q.device)
    s = torch.einsum("bthgd,bhsd->bthgs", qg, k) * Dh ** -0.5
    s = torch.where(valid[:, None, None, None, :], s, neg)
    s_f = torch.einsum("bthgd,bshd->bthgs", qg, kn.double()) * Dh ** -0.5
    causal = torch.arange(T, device=q.device)[:, None] >= torch.arange(T, device=q.device)
    s_f = torch.where(causal[None, :, None, None, :], s_f, neg)
    m = torch.maximum(s.amax(-1, keepdim=True), s_f.amax(-1, keepdim=True))
    p, p_f = torch.exp(s - m), torch.exp(s_f - m)
    den = p.sum(-1, keepdim=True) + p_f.sum(-1, keepdim=True)
    if p_round == "bf16":
        p, p_f = (x.float().bfloat16().double() for x in (p, p_f))
    elif p_round == "tf32":
        p, p_f = (tf32_round(torch, x.float()).double() for x in (p, p_f))
    o = (torch.einsum("bthgs,bhsd->bthgd", p, v)
         + torch.einsum("bthgs,bshd->bthgd", p_f, vn.double()))
    return (o / den).reshape(B, T, Hq, Dh)


def _f64_dense(torch, c, layer):
    """(k, v) of one layer of a dense case's cache as float64 times scales."""
    k, v = c["kc"][layer].double(), c["vc"][layer].double()
    if c["ks"] is not None:
        ks, vs = ((x if x.dim() == 3 else x[layer]).double() for x in (c["ks"], c["vs"]))
        k, v = k * ks[..., None], v * vs[..., None]
    return k, v


def _f64_paged(torch, c, layer):
    """(k, v) of one layer of a paged case's pools gathered through the table
    into dense (B, Hkv, mp * ps, Dh) float64, times scales."""
    t = c["table"].long()
    B, mp = t.shape
    _, _, Hkv, ps, Dh = c["kp"].shape

    def dense(pool, sc):
        x = pool[layer][t].double()  # (B, mp, Hkv, ps, Dh)
        if sc is not None:
            x = x * sc[layer][t].double()[..., None]
        return x.transpose(1, 2).reshape(B, Hkv, mp * ps, Dh)

    return dense(c["kp"], c["ks"]), dense(c["vp"], c["vs"])


def _f32_decode_check(torch, what, got, c, kv, rows):
    """Hold ``got`` to the float64 plain version on ``rows`` (B,) within
    F32_OUT_ATOL + F32_OUT_RTOL (|out| + (P.|V|)/l), and show the bound
    rejects TF32-rounded operands (q, the fresh k/v and a float cache
    rounded to TF32, an int8 cache being exact in it, and p rounded to
    TF32), p rounded to bf16, a window end off by one and the KV head of
    the wrong group. ``kv`` (k, v) are the case's dense float64 keys and
    values, ``c`` holds q, kn, vn, valid, live (rows whose window is not
    empty) and ``quantized``."""
    q, kn, vn, valid = c["q"], c["kn"], c["vn"], c["valid"]
    k, v = kv
    ref = _f64_decode(torch, q, k, v, kn, vn, valid)
    bound = F32_OUT_ATOL + F32_OUT_RTOL * (ref.abs() + _f64_decode(torch, q, k, v.abs(),
                                                                    kn, vn.abs(), valid))
    sel = rows[:, None].expand(-1, q.shape[1])  # (B, T)
    if not torch.isfinite(got[rows]).all():
        raise AssertionError(f"{what}: non-finite output")
    ratio = _out_ratio(torch, got, ref, bound, sel)
    err = (got.double() - ref).abs()[rows].max().item()
    if not ratio <= 1:
        raise AssertionError(f"{what}: {ratio} x the float32 bound (max |err| {err})")

    def tf(x):
        return tf32_round(torch, x.float()).double()

    kt, vt = (k, v) if c["quantized"] else (tf(k), tf(v))
    last = torch.cumsum(valid.int(), 1) == valid.int().sum(1, keepdim=True)
    shorter = valid & ~(last & c["live"][:, None])  # each live window's last slot dropped
    faults = {
        "operands rounded to tf32": _f64_decode(torch, tf(q), kt, vt, tf(kn), tf(vn), valid,
                                                "tf32"),
        "p rounded to bf16": _f64_decode(torch, q, k, v, kn, vn, valid, "bf16"),
        "window end off by one": _f64_decode(torch, q, k, v, kn, vn, shorter),
        "KV head of the wrong group": _f64_decode(torch, q, k.roll(1, 1), v.roll(1, 1),
                                                  kn.roll(1, 2), vn.roll(1, 2), valid),
    }
    faults = {name: _out_ratio(torch, m, ref, bound, sel) for name, m in faults.items()}
    if min(faults.values()) <= 1:
        raise AssertionError(f"{what}: the bound does not reject every fault: {faults}")
    G = q.shape[2] // k.shape[1]
    s_max = (torch.einsum("bthgd,bhsd->bthgs",
                          q.double().abs().reshape(*q.shape[:2], k.shape[1], G, -1), k.abs())
             .amax().item() * q.shape[-1] ** -0.5)
    return dict(max_abs_err=err, err_over_bound=ratio, s_max=s_max, faults_over_bound=faults)


def _f32_dense_case(torch, rng, B, T, S, cache, L=2, Hq=24, Hkv=8, Dh=128, device="cuda"):
    """float32 q and fresh k/v over an (L, B, Hkv, S, Dh) cache of type
    ``cache``: int8 with bf16 (L, B, Hkv, S) scales that keep |int8 x
    scale| <= ~1.5, or unit-scale float32 / bf16 values; pads with one row
    starting 40 slots in, offsets with one row at the last slot(s) and one
    with nothing cached."""
    dev = torch.device(device)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    if cache == "int8":
        kc, vc = (torch.from_numpy(rng.randint(-127, 128, size=(L, B, Hkv, S, Dh))
                                   .astype(np.int8)).to(dev) for _ in range(2))
        ks, vs = (f32(0.002 + 0.01 * rng.rand(L, B, Hkv, S)).bfloat16() for _ in range(2))
    else:
        dt = torch.float32 if cache == "float32" else torch.bfloat16
        kc, vc = (f32(rng.randn(L, B, Hkv, S, Dh)).to(dt) for _ in range(2))
        ks = vs = None
    pads = rng.randint(0, 5, size=(B,)).astype(np.int32)
    if B > 2:
        pads[2] = 40
    offs = rng.randint(pads + 1, S - T + 1).astype(np.int32)
    offs[0] = S - T
    if B > 1:
        offs[1] = pads[1]  # nothing cached: only the fresh block
    q, kn, vn = (f32(rng.randn(B, T, h, Dh)) for h in (Hq, Hkv, Hkv))
    pt, ot = (torch.from_numpy(a).to(dev) for a in (pads, offs))
    slot = torch.arange(S, device=dev)
    return dict(q=q, kn=kn, vn=vn, kc=kc, vc=vc, ks=ks, vs=vs, pads=pt, offs=ot,
                pads_np=pads, offs_np=offs, quantized=cache == "int8",
                valid=(slot >= pt[:, None]) & (slot < ot[:, None]), live=ot > pt)


def _f32_paged_case(torch, rng, T, write, pools, device="cuda"):
    """_paged_case's table, pads and lengths at PAGED_SHAPE (with its page
    boundary, released and past-the-table rows where ``write``), float32 q
    and fresh k/v, and pools of type ``pools``: int8 with realistic scales,
    or unit-scale float32 / bf16 values."""
    *_, lens_np, pads_np, table_np = _paged_case(torch, PAGED_SEED, T, write, device)
    c = PAGED_SHAPE
    B, Hq, Hkv, Dh, ps, mp, L = (c[k] for k in ("B", "Hq", "Hkv", "Dh", "ps", "mp", "L"))
    P = 1 + B * mp
    dev = torch.device(device)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    if pools == "int8":
        kp, vp = (torch.from_numpy(rng.randint(-127, 128, size=(L, P, Hkv, ps, Dh))
                                   .astype(np.int8)).to(dev) for _ in range(2))
        ks, vs = (f32(0.002 + 0.01 * rng.rand(L, P, Hkv, ps)).bfloat16() for _ in range(2))
    else:
        dt = torch.float32 if pools == "float32" else torch.bfloat16
        kp, vp = (f32(rng.randn(L, P, Hkv, ps, Dh)).to(dt) for _ in range(2))
        ks = vs = None
    q, kn, vn = (f32(rng.randn(B, T, h, Dh)) for h in (Hq, Hkv, Hkv))
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    lens, pads, table = to(lens_np), to(pads_np), to(table_np)
    pos = torch.arange(mp * ps, device=dev)
    valid = (pos >= pads[:, None]) & (pos < torch.clamp(lens, max=mp * ps)[:, None])
    return dict(q=q, kn=kn, vn=vn, kp=kp, vp=vp, ks=ks, vs=vs, table=table, lens=lens,
                pads=pads, lens_np=lens_np, pads_np=pads_np, table_np=table_np,
                quantized=pools == "int8", valid=valid,
                live=torch.clamp(lens, max=mp * ps) > pads)


def _f32_work(valid, B, T, Hq, Hkv, Dh, elem_bytes, quantized, writes, q_bytes=4):
    """(bytes, flops) of one float32-body call: the valid slots' k and v
    (with their bf16 scales when int8), q, the fresh k/v and the output
    (``q_bytes`` each: float32, or bf16 for the mixed instances), and the
    written fresh rows; 2 flops per multiply-add of q.k and p.v over the
    valid slots and the causal fresh block."""
    slot_bytes = 2 * (Dh * elem_bytes + (2 if quantized else 0))  # k and v of one slot
    n_bytes = int(valid) * Hkv * slot_bytes + q_bytes * B * T * (2 * Hq + 2 * Hkv) * Dh
    if writes:
        n_bytes += B * T * Hkv * slot_bytes
    flops = 4 * Dh * Hq * T * (int(valid) + B * (T + 1) / 2)
    return float(n_bytes), float(flops)


ELEM_BYTES = {"int8": 1, "bfloat16": 2, "float32": 4}


def _repeats_equal(torch, call, got, bufs, rows, repeats=REPEATS):
    """How many of ``repeats`` identical calls differ from the first call's
    out (on ``rows``) or leave the written buffers other than they were."""
    after = [b.clone() for b in bufs]
    unequal = 0
    for _ in range(repeats):
        out = call()
        out = out[0] if isinstance(out, tuple) else out
        unequal += not (torch.equal(out[rows], got[rows])
                        and all(torch.equal(b, a) for b, a in zip(bufs, after)))
    return unequal


def phase_decode_f32(torch, card):
    """The float32 instances of B2, B3, B4, B5 and B8 at the float32 serving
    path's shapes, each reached through its public wrapper with a float32
    query: held to the plain version run in float64 on the same inputs
    within F32_OUT_ATOL + F32_OUT_RTOL (|out| + (P.|V|)/l), with the faults
    that bound must reject (``_f32_decode_check``); cache, scale and page
    writes bit-exact against the plain version; REPEATS identical calls
    bit-equal; device times beside the float32 plain version and, for B8
    over a float32 cache, torch.cat + SDPA at float32."""
    from llm_speech_summarization_tpu_torch.kernels import (
        build, decode_attention as da, fused_decode as fd, fused_paged as fp,
        paged_attention as pa,
    )

    rng = np.random.RandomState(15)
    S, layer = F32_DECODE_S, 1
    Hq, Hkv, Dh = 24, 8, 128
    results = {}
    regs = decode_f32_registers(build, fd)
    cache_of = {1: "int8", 2: "bf16", 4: "float32"}

    def finish(name, kernel, inst, check, t, valid, B, T, elem, quantized, writes, **extra):
        n_bytes, flops = _f32_work(valid, B, T, Hq, Hkv, Dh, elem, quantized, writes)
        t["bound_ms"], t["bound_by"] = bound_ms(n_bytes, flops, F32_FLOPS_PER_S)
        t.setdefault("library_ms", None)
        results[name] = dict(max_abs_err=check["max_abs_err"], **t)
        paged = kernel in ("B4", "B5")
        reg_key = f"decode {cache_of[elem]} Dh={Dh} write={int(writes)} paged={int(paged)}"
        emit("decode_f32", kernel=kernel, instance=inst, case=name, B=B, T=T,
             heads=[Hq, Hkv], Dh=Dh, **check, out_atol=F32_OUT_ATOL,
             out_rtol_of_abs_out_plus_abs_pv=F32_OUT_RTOL, bytes=n_bytes, flops=flops,
             pct_of_bound=100 * t["bound_ms"] / t["ms"], registers_spill=regs.get(reg_key),
             **t, **extra, card=card)

    def launched(wrapper, before, what):
        if wrapper.launches != before + 1:
            raise AssertionError(f"{what}: the call did not launch {wrapper.__name__}")

    def writes_equal(what, got_bufs, ref_bufs, snap, written):
        for i, (g, r, s0) in enumerate(zip(got_bufs, ref_bufs, snap)):
            if not torch.equal(g, r):
                raise AssertionError(f"{what}: buffer {i} differs from the plain version's "
                                     f"write at {int((g != r).sum())} elements")
            w = written[..., None] if g.dim() == written.dim() + 1 else written
            w = w.expand_as(g)
            if not torch.equal(g[~w], s0[~w]) or torch.equal(g[w], s0[w]):
                raise AssertionError(f"{what}: buffer {i} written outside the fresh slots, or "
                                     f"not at them")

    # ---- B2: the int8 cache with (L, B, Hkv, S) scales written in place
    for B, T in F32_DECODE_B2:
        name = f"b2_int8_B{B}_T{T}"
        c = _f32_dense_case(torch, rng, B, T, S, "int8")
        snap = [c[k].clone() for k in ("kc", "vc", "ks", "vs")]
        got_bufs, ref_bufs = [t.clone() for t in snap], [t.clone() for t in snap]
        mo = int(c["offs_np"].max())
        before = fd.fused_decode_f32.launches

        def call(bufs=got_bufs, c=c, mo=mo):
            return fd.fused_decode(c["q"], *bufs, c["kn"], c["vn"], c["pads"], c["offs"], layer,
                                   max_offset=mo)

        got = call()
        torch.cuda.synchronize()
        launched(fd.fused_decode_f32, before, name)
        if got.dtype != torch.float32:
            raise AssertionError(f"{name}: out is {got.dtype}")
        fd.fused_decode_reference(c["q"], *ref_bufs, c["kn"], c["vn"], c["pads"], c["offs"],
                                  layer)
        written = torch.zeros(snap[2].shape, dtype=torch.bool, device="cuda")
        for b in range(B):
            written[layer, b, :, c["offs_np"][b]:c["offs_np"][b] + T] = True
        writes_equal(name, got_bufs, ref_bufs, snap, written)
        rows = torch.ones(B, dtype=torch.bool, device="cuda")
        check = _f32_decode_check(torch, name, got, c, _f64_dense(torch, dict(c, kc=snap[0],
                                  vc=snap[1], ks=snap[2], vs=snap[3]), layer), rows)
        check["unequal_repeats"] = _repeats_equal(torch, call, got, got_bufs, rows)
        if check["unequal_repeats"]:
            raise AssertionError(f"{name}: {check['unequal_repeats']} of {REPEATS} repeats differ")
        t = timings(torch, call, lambda c=c, bufs=ref_bufs: fd.fused_decode_reference(
            c["q"], *bufs, c["kn"], c["vn"], c["pads"], c["offs"], layer))
        nsplit = f32_split_count(fd, B, Hkv, mo)
        finish(name, "B2", "fused_decode_f32", check, t,
               np.clip(c["offs_np"] - c["pads_np"], 0, None).sum(), B, T, 1, True, True,
               splits=nsplit, cache_writes="bit-exact")
        del c, snap, got_bufs, ref_bufs

    # ---- B3: a float32 or bf16 cache, or int8 with one layer's scales
    for cache, T in F32_DECODE_B3:
        B = 8
        name = f"b3_{cache}_T{T}"
        c = _f32_dense_case(torch, rng, B, T, S, cache)
        quantized = cache == "int8"
        sc = (c["ks"][layer], c["vs"][layer]) if quantized else ()
        snap = [c["kc"].clone(), c["vc"].clone()]
        got_bufs, ref_bufs = [t.clone() for t in snap], [t.clone() for t in snap]
        mo = int(c["offs_np"].max())
        before = fd.fused_decode_attention_write_f32.launches

        def call(bufs=got_bufs, c=c, mo=mo, sc=sc):
            return fd.fused_decode_attention_write(c["q"], *bufs, c["kn"], c["vn"], c["pads"],
                                                   c["offs"], layer, *sc, max_offset=mo)

        got = call()
        torch.cuda.synchronize()
        launched(fd.fused_decode_attention_write_f32, before, name)
        plain = fd.fused_decode_attention_write_reference(
            c["q"], *ref_bufs, c["kn"], c["vn"], c["pads"], c["offs"], layer, *sc)
        if quantized:  # the fresh (B, Hkv) scales, bit-exact
            if not all(torch.equal(g, r) for g, r in zip(got[1:], plain[1:])):
                raise AssertionError(f"{name}: the returned fresh scales differ")
            got = got[0]
        if got.dtype != torch.float32:
            raise AssertionError(f"{name}: out is {got.dtype}")
        written = torch.zeros(snap[0].shape[:4], dtype=torch.bool, device="cuda")
        for b in range(B):
            written[layer, b, :, c["offs_np"][b]:c["offs_np"][b] + T] = True
        writes_equal(name, got_bufs, ref_bufs, snap, written)
        rows = torch.ones(B, dtype=torch.bool, device="cuda")
        check = _f32_decode_check(torch, name, got, c, _f64_dense(
            torch, dict(c, kc=snap[0], vc=snap[1]), layer), rows)
        check["unequal_repeats"] = _repeats_equal(torch, call, got, got_bufs, rows)
        if check["unequal_repeats"]:
            raise AssertionError(f"{name}: {check['unequal_repeats']} of {REPEATS} repeats differ")
        t = timings(torch, call, lambda c=c, bufs=ref_bufs, sc=sc:
                    fd.fused_decode_attention_write_reference(
                        c["q"], *bufs, c["kn"], c["vn"], c["pads"], c["offs"], layer, *sc))
        finish(name, "B3", "fused_decode_attention_write_f32", check, t,
               np.clip(c["offs_np"] - c["pads_np"], 0, None).sum(), B, T, ELEM_BYTES[cache],
               quantized, True, splits=f32_split_count(fd, B, Hkv, mo),
               cache_writes="bit-exact")
        del c, snap, got_bufs, ref_bufs

    # ---- B4 (T=4, read only) and B5 (T=1, the page write) over each pool type
    for pools in F32_DECODE_POOLS:
        for T, write in ((4, False), (1, True)):
            kernel = "B5" if write else "B4"
            name = f"{kernel.lower()}_{pools}_T{T}"
            c = _f32_paged_case(torch, rng, T, write, pools)
            quantized = pools == "int8"
            bufs = [x for x in (c["kp"], c["vp"], c["ks"], c["vs"]) if x is not None]
            snap = [x.clone() for x in bufs]
            got_bufs, ref_bufs = [x.clone() for x in snap], [x.clone() for x in snap]
            B = c["q"].shape[0]
            if write:
                wrapper = fp.fused_paged_decode_f32
                pools_of = lambda b, q=quantized: (b if q else b + [None, None])  # noqa: E731

                def call(bufs=got_bufs, c=c, pools_of=pools_of):
                    return fp.fused_paged_decode(c["q"], *pools_of(bufs), c["table"], c["lens"],
                                                 c["pads"], c["kn"], c["vn"], layer)

                def plain(bufs=ref_bufs, c=c, pools_of=pools_of):
                    return fp.fused_paged_reference(c["q"], *pools_of(bufs), c["table"],
                                                    c["lens"], c["pads"], c["kn"], c["vn"],
                                                    layer)
            else:
                wrapper = pa.paged_decode_attention_f32
                sc = dict(k_scale=c["ks"][layer], v_scale=c["vs"][layer]) if quantized else {}

                def call(c=c, sc=sc):
                    return pa.paged_decode_attention(c["q"], c["kp"][layer], c["vp"][layer],
                                                     c["table"], c["lens"], c["pads"], c["kn"],
                                                     c["vn"], **sc)

                def plain(c=c, sc=sc):
                    return pa.paged_reference(c["q"], c["kp"][layer], c["vp"][layer],
                                              c["table"], c["lens"], c["pads"], c["kn"],
                                              c["vn"], sc.get("k_scale"), sc.get("v_scale"))
            before = wrapper.launches
            got = call()
            torch.cuda.synchronize()
            launched(wrapper, before, name)
            plain()
            if got.dtype != torch.float32:
                raise AssertionError(f"{name}: out is {got.dtype}")
            # the released row reads page 0 while other rows write it
            rows = torch.from_numpy((c["table_np"] != 0).all(axis=1)).cuda()
            kv = _f64_paged(torch, dict(c, kp=snap[0], vp=snap[1],
                                        ks=snap[2] if quantized else None,
                                        vs=snap[3] if quantized else None), layer)
            check = _f32_decode_check(torch, name, got, c, kv, rows)
            if write:
                from llm_speech_summarization_tpu_torch.kernels.fused_paged import (
                    _write_targets,
                )

                pid, slot = _write_targets(c["table"], c["lens"], PAGED_SHAPE["ps"])
                written = torch.zeros(snap[0].shape[:4], dtype=torch.bool, device="cuda")
                written[layer, pid, :, slot] = True
                for i, (g, r, s0) in enumerate(zip(got_bufs, ref_bufs, snap)):
                    w = (written[..., None] if g.dim() == 5 else written).expand_as(g)
                    if not torch.equal(g[:, 1:], r[:, 1:]):
                        raise AssertionError(f"{name}: buffer {i} differs from the plain "
                                             f"version's write outside page 0")
                    w = w.clone()
                    w[:, 0] = True  # page 0 takes the boundary and released rows' tokens
                    if not torch.equal(g[~w], s0[~w]):
                        raise AssertionError(f"{name}: buffer {i} changed outside the written "
                                             f"slots")
            else:
                for x, s0 in zip(bufs, snap):
                    if not torch.equal(x, s0):
                        raise AssertionError(f"{name} wrote into the pools")
            check["unequal_repeats"] = _repeats_equal(torch, call, got, got_bufs, rows)
            if check["unequal_repeats"]:
                raise AssertionError(f"{name}: {check['unequal_repeats']} of {REPEATS} "
                                     f"repeats differ")
            t = timings(torch, call, plain)
            valid = c["valid"].sum().item()
            finish(name, kernel, wrapper.__name__, check, t, valid, B, T, ELEM_BYTES[pools],
                   quantized, write,
                   splits=f32_split_count(fd, B, Hkv, PAGED_SHAPE["mp"] * PAGED_SHAPE["ps"]),
                   page_writes="bit-exact outside page 0" if write else None)
            del c, snap, got_bufs, ref_bufs, bufs

    # ---- B8: one layer's cache read in place, every row at one offset
    for cache in ("float32", "int8", "bfloat16"):
        B, offset = 8, F32_DECODE_B8_OFFSET
        name = f"b8_{cache}"
        c = _f32_dense_case(torch, rng, B, 1, S, cache)
        c["offs"] = torch.full_like(c["pads"], offset)
        slot = torch.arange(S, device="cuda")
        c["valid"] = (slot >= c["pads"][:, None]) & (slot < offset)
        c["live"] = c["offs"] > c["pads"]
        quantized = cache == "int8"
        sc = (c["ks"][layer], c["vs"][layer]) if quantized else ()
        kc, vc = c["kc"][layer], c["vc"][layer]
        before = da.decode_attention_f32.launches

        def call(c=c, kc=kc, vc=vc, sc=sc):
            return da.decode_attention(c["q"], kc, vc, c["kn"], c["vn"], c["pads"], offset, *sc)

        got = call()
        torch.cuda.synchronize()
        launched(da.decode_attention_f32, before, name)
        if got.dtype != torch.float32:
            raise AssertionError(f"{name}: out is {got.dtype}")
        rows = torch.ones(B, dtype=torch.bool, device="cuda")
        check = _f32_decode_check(torch, name, got, c, _f64_dense(torch, c, layer), rows)
        check["unequal_repeats"] = _repeats_equal(torch, call, got, [c["kc"], c["vc"]], rows)
        if check["unequal_repeats"]:
            raise AssertionError(f"{name}: {check['unequal_repeats']} of {REPEATS} repeats differ")
        t = timings(torch, call, lambda c=c, kc=kc, vc=vc, sc=sc: da.decode_attention_reference(
            c["q"], kc, vc, c["kn"], c["vn"], c["pads"], offset, *sc))
        if cache == "float32":  # cat + SDPA at float32 computes the same; none takes int8
            t["library_ms"] = device_ms(torch, _sdpa_decode_call(
                torch, c["q"], kc, vc, c["kn"], c["vn"], c["pads"], offset), whole=False)
        valid = np.clip(offset - c["pads_np"], 0, None).sum()
        finish(name, "B8", "decode_attention_f32", check, t, valid, B, 1, ELEM_BYTES[cache],
               quantized, False, splits=f32_split_count(fd, B, Hkv, offset),
               library="torch.cat + scaled_dot_product_attention" if cache == "float32"
               else None)
        del c
    return results


# decode_mixed: the mixed instances (B3, B8, B4, B5 at a bf16 query over a
# float32 cache) are held to their plain versions on the card within
# MIXED_OUT_ATOL + MIXED_OUT_RTOL (|out| + (P.|V|)/l), |out| and (P.|V|)/l
# from the float64 attention over the cache rounded to bf16 (tests/
# test_torch_decode_mixed.py holds the plain versions to the JAX kernels in
# interpret mode within the same bound). Both sides round every cached
# value to bf16 and take the same exact products; what parts them is where
# each rounds p over the cache to bf16 (the kernel at its running max of a
# chunk of 64 slots, the plain version at the row's max), whether the
# fresh p is rounded (the plain version rounds it, the kernel does not, as
# the Pallas kernels do not), the order of the float32 sums, and the bf16
# rounding of the output: each at most 2^-8 relative of the term it
# rounds, so the bound is their worst case
MIXED_OUT_ATOL, MIXED_OUT_RTOL = 1e-5, 2.0 ** -8
MIXED_REPEATS = 10  # identical calls per case, each held bit-equal to the first
MIXED_DECODE_B3_T = (1, 4)  # B3 at B=8 over F32_DECODE_S slots; T=4: the spec chunks


def _bf16_cache(torch, kv):
    """(k, v) float64 rounded to bf16 (nearest even), as the mixed
    instances and the TPU kernels read a float32 cache under a bf16 query."""
    return tuple(x.float().bfloat16().double() for x in kv)


def _mixed_check(torch, what, got, plain, c, kv, rows):
    """Hold the mixed instance's bf16 ``got`` to its plain version's
    ``plain`` on ``rows`` (B,) within MIXED_OUT_ATOL + MIXED_OUT_RTOL (|out|
    + (P.|V|)/l); for information, how far (in units of the bound) two
    faults lie from the plain version: the cache read without rounding to
    bf16, and p over the cache left unrounded. ``kv``: the dense float64
    (k, v) of the float32 cache as stored."""
    q, kn, vn, valid = c["q"], c["kn"], c["vn"], c["valid"]
    kr, vr = _bf16_cache(torch, kv)
    ref = _f64_decode(torch, q, kr, vr, kn, vn, valid)
    bound = MIXED_OUT_ATOL + MIXED_OUT_RTOL * (
        ref.abs() + _f64_decode(torch, q, kr, vr.abs(), kn, vn.abs(), valid))
    sel = rows[:, None].expand(-1, q.shape[1])
    if got.dtype != torch.bfloat16 or got.shape != plain.shape:
        raise AssertionError(f"{what}: out is {got.dtype} {tuple(got.shape)}")
    if not torch.isfinite(got[rows]).all():
        raise AssertionError(f"{what}: non-finite output")
    ratio = _out_ratio(torch, got, plain.double(), bound, sel)
    err = (got.double() - plain.double()).abs()[rows].max().item()
    if not ratio <= 1:
        raise AssertionError(f"{what}: {ratio} x the mixed bound (max |err| {err})")

    def out_bf16(x):
        return x.float().bfloat16().double()

    faults = {
        "cache not rounded to bf16": out_bf16(_f64_decode(torch, q, *kv, kn, vn, valid, "bf16")),
        "p over the cache unrounded": out_bf16(ref),
    }
    faults = {name: _out_ratio(torch, m, plain.double(), bound, sel)
              for name, m in faults.items()}
    return dict(max_abs_err=err, err_over_bound=ratio, faults_over_bound=faults)


def phase_decode_mixed(torch, card):
    """The mixed instances of B3, B8, B4 and B5 (``csrc/decode_f32.cu``: a
    bf16 query over a float32 cache, the decode of bf16 parameters at
    compute_dtype float32) at the serving path's shapes, each reached
    through its public wrapper: held to the plain version on the same
    inputs within MIXED_OUT_ATOL + MIXED_OUT_RTOL (|out| + (P.|V|)/l);
    cache and page writes bit-exact against the plain version's;
    MIXED_REPEATS identical calls bit-equal; device times beside the plain
    version and, for B8, torch.cat + SDPA at bf16 on the cache cast to bf16
    ahead of the timed calls; each instance's registers and spill bytes."""
    from llm_speech_summarization_tpu_torch.kernels import (
        build, decode_attention as da, fused_decode as fd, fused_paged as fp,
        paged_attention as pa,
    )

    t_phase = time.perf_counter()
    regs = {k: v for k, v in decode_f32_registers(build, fd).items() if k.startswith("mixed")}
    rng = np.random.RandomState(17)
    S, layer = F32_DECODE_S, 1
    Hq, Hkv, Dh = 24, 8, 128
    results = {}

    def bf16_inputs(c):
        for k in ("q", "kn", "vn"):
            c[k] = c[k].bfloat16()
        return c

    def finish(name, kernel, wrapper, before, check, t, valid, B, T, writes, reg_key, **extra):
        if wrapper.launches != before + 1 + MIXED_REPEATS:
            raise AssertionError(f"{name}: {wrapper.launches - before} launches of "
                                 f"{wrapper.__name__}, expected {1 + MIXED_REPEATS}")
        n_bytes, flops = _f32_work(valid, B, T, Hq, Hkv, Dh, 4, False, writes, q_bytes=2)
        t["bound_ms"], t["bound_by"] = bound_ms(n_bytes, flops)
        t.setdefault("library_ms", None)
        results[name] = dict(max_abs_err=check["max_abs_err"], **t)
        emit("decode_mixed", kernel=kernel, instance=wrapper.__name__, case=name, B=B, T=T,
             heads=[Hq, Hkv], Dh=Dh, cache="float32", query="bfloat16", **check,
             out_atol=MIXED_OUT_ATOL, out_rtol_of_abs_out_plus_abs_pv=MIXED_OUT_RTOL,
             repeats=MIXED_REPEATS, bytes=n_bytes, flops=flops,
             pct_of_bound=100 * t["bound_ms"] / t["ms"], registers_spill=regs.get(reg_key),
             **t, **extra, card=card)

    # ---- B3: T=1 (each decode step) and T=4 (the speculative chunks)
    for T in MIXED_DECODE_B3_T:
        B = 8
        name = f"b3_mixed_T{T}"
        c = bf16_inputs(_f32_dense_case(torch, rng, B, T, S, "float32"))
        snap = [c["kc"].clone(), c["vc"].clone()]
        got_bufs, ref_bufs = [x.clone() for x in snap], [x.clone() for x in snap]
        mo = int(c["offs_np"].max())
        before = fd.fused_decode_attention_write_mixed.launches

        def call(bufs=got_bufs, c=c, mo=mo):
            return fd.fused_decode_attention_write(c["q"], *bufs, c["kn"], c["vn"], c["pads"],
                                                   c["offs"], layer, max_offset=mo)

        got = call()
        plain = fd.fused_decode_attention_write_reference(
            c["q"], *ref_bufs, c["kn"], c["vn"], c["pads"], c["offs"], layer)
        torch.cuda.synchronize()
        for i, (g, r, s0) in enumerate(zip(got_bufs, ref_bufs, snap)):
            written = torch.zeros(s0.shape[:4], dtype=torch.bool, device="cuda")
            for b in range(B):
                written[layer, b, :, c["offs_np"][b]:c["offs_np"][b] + T] = True
            w = written[..., None].expand_as(g)
            fresh = (c["kn"], c["vn"])[i].float().transpose(1, 2)  # (B, Hkv, T, Dh)
            if not torch.equal(g, r) or not torch.equal(g[~w], s0[~w]):
                raise AssertionError(f"{name}: buffer {i} differs from the plain version's write")
            for b in range(B):
                o = int(c["offs_np"][b])
                if not torch.equal(g[layer, b, :, o:o + T], fresh[b]):
                    raise AssertionError(f"{name}: row {b}'s fresh values are not widened "
                                         "bit for bit")
        rows = torch.ones(B, dtype=torch.bool, device="cuda")
        check = _mixed_check(torch, name, got, plain, c,
                             _f64_dense(torch, dict(c, kc=snap[0], vc=snap[1]), layer), rows)
        check["unequal_repeats"] = _repeats_equal(torch, call, got, got_bufs, rows,
                                                  MIXED_REPEATS)
        if check["unequal_repeats"]:
            raise AssertionError(f"{name}: {check['unequal_repeats']} of {MIXED_REPEATS} "
                                 "repeats differ")
        launches = fd.fused_decode_attention_write_mixed.launches
        t = timings(torch, call, lambda c=c, bufs=ref_bufs:
                    fd.fused_decode_attention_write_reference(
                        c["q"], *bufs, c["kn"], c["vn"], c["pads"], c["offs"], layer))
        fd.fused_decode_attention_write_mixed.launches = launches  # the timed calls not counted
        finish(name, "B3", fd.fused_decode_attention_write_mixed, before, check, t,
               np.clip(c["offs_np"] - c["pads_np"], 0, None).sum(), B, T, True,
               "mixed float32 Dh=128 write=1 paged=0",
               splits=f32_split_count(fd, B, Hkv, mo), cache_writes="bit-exact")
        del c, snap, got_bufs, ref_bufs

    # ---- B8: one layer's cache read in place, every row at one offset
    B, offset = 8, F32_DECODE_B8_OFFSET
    name = "b8_mixed"
    c = bf16_inputs(_f32_dense_case(torch, rng, B, 1, S, "float32"))
    c["offs"] = torch.full_like(c["pads"], offset)
    slot = torch.arange(S, device="cuda")
    c["valid"] = (slot >= c["pads"][:, None]) & (slot < offset)
    kc, vc = c["kc"][layer], c["vc"][layer]
    before = da.decode_attention_mixed.launches

    def call(c=c, kc=kc, vc=vc):
        return da.decode_attention(c["q"], kc, vc, c["kn"], c["vn"], c["pads"], offset)

    def plain_fn(c=c, kc=kc, vc=vc):
        return da.decode_attention_reference(c["q"], kc, vc, c["kn"], c["vn"], c["pads"], offset)

    got = call()
    plain = plain_fn()
    torch.cuda.synchronize()
    rows = torch.ones(B, dtype=torch.bool, device="cuda")
    check = _mixed_check(torch, name, got, plain, c, _f64_dense(torch, c, layer), rows)
    check["unequal_repeats"] = _repeats_equal(torch, call, got, [c["kc"], c["vc"]], rows,
                                              MIXED_REPEATS)
    if check["unequal_repeats"]:
        raise AssertionError(f"{name}: {check['unequal_repeats']} of {MIXED_REPEATS} repeats "
                             "differ")
    launches = da.decode_attention_mixed.launches
    t = timings(torch, call, plain_fn)
    kc16, vc16 = kc.bfloat16(), vc.bfloat16()  # cast ahead, outside the timed calls
    t["library_ms"] = device_ms(torch, _sdpa_decode_call(
        torch, c["q"], kc16, vc16, c["kn"], c["vn"], c["pads"], offset), whole=False)
    da.decode_attention_mixed.launches = launches
    finish(name, "B8", da.decode_attention_mixed, before, check, t,
           np.clip(offset - c["pads_np"], 0, None).sum(), B, 1, False,
           "mixed float32 Dh=128 write=0 paged=0", splits=f32_split_count(fd, B, Hkv, offset),
           library="torch.cat + scaled_dot_product_attention at bf16 on the cache cast to "
                   "bf16 ahead of the timed calls")
    del c, kc16, vc16

    # ---- B4 (T=4, read only) and B5 (T=1, L=2, the page write) over float32 pools
    for T, write in ((4, False), (1, True)):
        kernel = "B5" if write else "B4"
        name = f"{kernel.lower()}_mixed_T{T}"
        c = bf16_inputs(_f32_paged_case(torch, rng, T, write, "float32"))
        snap = [c["kp"].clone(), c["vp"].clone()]
        got_bufs, ref_bufs = [x.clone() for x in snap], [x.clone() for x in snap]
        B = c["q"].shape[0]
        if write:
            wrapper = fp.fused_paged_decode_mixed

            def call(bufs=got_bufs, c=c):
                return fp.fused_paged_decode(c["q"], *bufs, None, None, c["table"], c["lens"],
                                             c["pads"], c["kn"], c["vn"], layer)

            def plain_fn(bufs=ref_bufs, c=c):
                return fp.fused_paged_reference(c["q"], *bufs, None, None, c["table"],
                                                c["lens"], c["pads"], c["kn"], c["vn"], layer)
        else:
            wrapper = pa.paged_decode_attention_mixed

            def call(c=c):
                return pa.paged_decode_attention(c["q"], c["kp"][layer], c["vp"][layer],
                                                 c["table"], c["lens"], c["pads"], c["kn"],
                                                 c["vn"])

            def plain_fn(c=c):
                return pa.paged_reference(c["q"], c["kp"][layer], c["vp"][layer], c["table"],
                                          c["lens"], c["pads"], c["kn"], c["vn"])
        before = wrapper.launches
        got = call()
        plain = plain_fn()
        torch.cuda.synchronize()
        rows = torch.from_numpy((c["table_np"] != 0).all(axis=1)).cuda()
        kv = _f64_paged(torch, dict(c, kp=snap[0], vp=snap[1], ks=None, vs=None), layer)
        check = _mixed_check(torch, name, got, plain, c, kv, rows)
        if write:
            for i, (g, r) in enumerate(zip(got_bufs, ref_bufs)):
                if not torch.equal(g[:, 1:], r[:, 1:]):
                    raise AssertionError(f"{name}: buffer {i} differs from the plain version's "
                                         "write outside page 0")
        elif not all(torch.equal(x, s0) for x, s0 in zip((c["kp"], c["vp"]), snap)):
            raise AssertionError(f"{name} wrote into the pools")
        check["unequal_repeats"] = _repeats_equal(torch, call, got, got_bufs, rows,
                                                  MIXED_REPEATS)
        if check["unequal_repeats"]:
            raise AssertionError(f"{name}: {check['unequal_repeats']} of {MIXED_REPEATS} "
                                 "repeats differ")
        launches = wrapper.launches
        t = timings(torch, call, plain_fn)
        wrapper.launches = launches
        finish(name, kernel, wrapper, before, check, t, c["valid"].sum().item(), B, T, write,
               f"mixed float32 Dh=128 write={int(write)} paged=1",
               splits=f32_split_count(fd, B, Hkv, PAGED_SHAPE["mp"] * PAGED_SHAPE["ps"]),
               page_writes="bit-exact outside page 0" if write else None)
        del c, snap, got_bufs, ref_bufs
    emit("decode_mixed_wall", seconds=time.perf_counter() - t_phase, card=card)
    return results


def _sdpa_decode_call(torch, q, kc, vc, kn, vn, pads, offset):
    """``scaled_dot_product_attention`` of q (B, 1, Hq, Dh) over one layer's
    bf16 cache concatenated with the fresh k/v, masked to [pad, offset) and
    the fresh slot: B8's function as two PyTorch calls (the port never
    calls them)."""
    import torch.nn.functional as F

    S = kc.shape[2]
    slot = torch.arange(S + 1, device=q.device)
    mask = ((slot[None, :] >= pads[:, None]) & (slot[None, :] < offset)) | (slot[None, :] == S)
    mask = mask[:, None, None, :]  # (B, 1, 1, S + 1)
    qt = q.transpose(1, 2)

    def call():
        k = torch.cat([kc, kn.transpose(1, 2)], dim=2)
        v = torch.cat([vc, vn.transpose(1, 2)], dim=2)
        return F.scaled_dot_product_attention(qt, k, v, attn_mask=mask, enable_gqa=True)

    return call


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def synthetic_pool_ranges(n_samples, sr=16000):
    """4-frame [start, end) ranges tiling a clip's frames, as the synthetic
    dataset draws its ``pool_ranges_4`` (``data/datasets.py``)."""
    frames = max((n_samples - sr // 100) // (sr // 50), 8)
    return np.asarray([(s, s + 4) for s in range(0, frames - 3, 4)], np.int32)


def _minichat_base_config(method):
    """BASELINE config #1: ``minichat_hubert.yaml`` with the hubert-base
    encoder and int8 LLM weights (int8 cache as shipped)."""
    from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config

    cfg = load_config(str(YAML_DIR / "minichat_hubert.yaml"))
    cfg.model.audio_encoder.type = "facebook/hubert-base-ls960"
    cfg.model.audio_encoder.preset = None
    cfg.model.audio_encoder.downsample_method = method
    cfg.model.llm_weight_dtype = "int8"
    return cfg


def _small_base_models():
    """(LLM, encoder) configs of BASELINE config #1's layout at the small
    kernel-legal width: an MHA LLM with MiniChat's switches (2/2 heads at
    Dh=128, vocab 49216, no rope scaling, an untied head) and hubert-base's
    (no conv bias, group-normed stem, post-LN blocks; 4 heads at Dh=64)."""
    import dataclasses

    from llm_speech_summarization_tpu_torch.models.hubert import hubert_preset
    from llm_speech_summarization_tpu_torch.models.llama import LlamaConfig

    llm_cfg = LlamaConfig(vocab_size=49216, hidden_size=256, intermediate_size=1024,
                          num_layers=2, num_heads=2, num_kv_heads=2, head_dim=128,
                          rope_theta=10000.0, rope_scaling=None, tie_embeddings=False,
                          max_position_embeddings=4096)
    enc_cfg = dataclasses.replace(hubert_preset("facebook/hubert-base-ls960"), hidden_size=256,
                                  num_layers=2, num_heads=4, intermediate_size=1024)
    return llm_cfg, enc_cfg


def phase_slice(torch, card, whisper=False, base=False):
    """Small kernel-legal width, same weights on the CPU (plain versions)
    and the card (kernels): ``llama3_hubert.yaml`` (int8 weights and cache:
    B1, B2), with ``whisper`` ``llama3_whisper.yaml`` on a bf16 cache (bf16
    weights: B1, B3), or with ``base`` BASELINE config #1's layout: the
    hubert-base encoder (group-normed stem, post-LN blocks) with the
    ``ctc_pool`` projector over synthetic ranges and an MHA LLM (MiniChat's
    switches: every head its own KV head, no rope scaling, an untied head)
    on int8 weights and cache (B1, B2)."""

    from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
    from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference
    from llm_speech_summarization_tpu_torch.models.hubert import HubertConfig
    from llm_speech_summarization_tpu_torch.models.llama import (
        LlamaConfig, init_kv_cache, llama_forward,
    )
    from llm_speech_summarization_tpu_torch.models.whisper import WhisperConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if base:
        cfg = _minichat_base_config("ctc_pool")
    else:
        cfg = load_config(str(YAML_DIR / ("llama3_whisper.yaml" if whisper
                                          else "llama3_hubert.yaml")))
    cfg.model.llm_embedding_channels = 256
    llm_cfg = LlamaConfig(hidden_size=256, intermediate_size=1024, num_layers=2,
                          num_heads=6, num_kv_heads=2, head_dim=128)
    if base:
        llm_cfg, enc_cfg = _small_base_models()
    elif whisper:
        cfg.model.kv_cache_dtype = "bfloat16"
        enc_cfg = WhisperConfig(d_model=256, num_layers=2, num_heads=4, ffn_dim=1024)
    else:
        enc_cfg = HubertConfig(hidden_size=256, num_layers=2, num_heads=4,
                               intermediate_size=1024)
    cpu = LLMSpeechTextInference(cfg, llm_cfg=llm_cfg, encoder_cfg=enc_cfg, device="cpu")
    gpu = LLMSpeechTextInference(
        cfg, llm_params=_to(cpu.llm_params, "cuda"),
        audio_encoder_params=_to(cpu.audio_encoder_params, "cuda"),
        llm_cfg=llm_cfg, encoder_cfg=enc_cfg, device="cuda",
    )
    rng = np.random.RandomState(1)
    clips = [(0.1 * rng.randn(n)).astype(np.float32) for n in (16000, 11200)]
    ranges = [synthetic_pool_ranges(len(c)) for c in clips] if base else None

    e_c, m_c = cpu.build_audio_prompt_batch(clips, ctc_pool_ranges=ranges)
    e_g, m_g = gpu.build_audio_prompt_batch(clips, ctc_pool_ranges=ranges)
    if not torch.equal(m_c, m_g.cpu()):
        raise AssertionError("slice: splice masks differ between CPU and card")
    embed_err = (e_g.cpu().float() - e_c.float()).abs().max().item()
    if not torch.allclose(e_g.cpu().float(), e_c.float(), atol=EMBED_TOL, rtol=EMBED_TOL):
        raise AssertionError(f"slice: spliced embeds differ (max |err| {embed_err})")

    # prefill + teacher-forced decode from the CPU's embeds and tokens
    B, Lp, _ = e_c.shape
    steps = 16
    caches = [init_kv_cache(llm_cfg, B, Lp + steps, cpu.cache_dtype, device=d)
              for d in ("cpu", "cuda")]
    outs = [llama_forward(eng.llm_params, llm_cfg, inputs_embeds=e_c.to(d), attn_mask=m_c.to(d),
                          kv_cache=c, cache_offset=0, last_logit_only=True)
            for eng, d, c in ((cpu, "cpu", caches[0]), (gpu, "cuda", caches[1]))]
    lc, lg = outs[0].logits[:, -1], outs[1].logits[:, -1].cpu()
    prefill_err = (lc - lg).abs().max().item()
    if not prefill_err <= LOGIT_TOL:
        raise AssertionError(f"slice: prefill logits differ by {prefill_err} > {LOGIT_TOL}")
    lens = m_c.to(torch.int32).sum(1)
    pads = (Lp - lens).to(torch.int32)
    tok = lc.argmax(-1).to(torch.int32)
    checked = decisions = 0
    step_err = 0.0
    for step in range(1, steps):
        kw = dict(positions=(lens + step - 1)[:, None], cache_offset=Lp + step - 1)
        lx = llama_forward(cpu.llm_params, llm_cfg, input_ids=tok[:, None], kv_cache=caches[0],
                           kv_pad_lens=pads, **kw).logits[:, 0]
        lf = llama_forward(gpu.llm_params, llm_cfg, input_ids=tok[:, None].cuda(),
                           kv_cache=caches[1], kv_pad_lens=pads.cuda(),
                           **{**kw, "positions": kw["positions"].cuda()}).logits[:, 0].cpu()
        step_err = max(step_err, (lx - lf).abs().max().item())
        top2 = torch.topk(lx, 2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > 2 * LOGIT_TOL
        if not (lx.argmax(-1)[decided] == lf.argmax(-1)[decided]).all():
            raise AssertionError(f"slice: the card flipped a decided token at step {step}")
        checked += int(decided.sum())
        decisions += B
        tok = lx.argmax(-1).to(torch.int32)  # teacher-force the CPU stream into both
    if not step_err <= LOGIT_TOL:
        raise AssertionError(f"slice: decode logits differ by {step_err} > {LOGIT_TOL}")
    if checked == 0:
        raise AssertionError("slice: no decided step, the stream contract checked nothing")

    text_c = cpu.generate_audio_response_batch(clips, max_new_tokens=steps,
                                               ctc_pool_ranges=ranges)
    text_g = gpu.generate_audio_response_batch(clips, max_new_tokens=steps,
                                               ctc_pool_ranges=ranges)
    emit("slice_small", config=cfg.model.audio_encoder.type, llm=cfg.model.llm_type,
         projector=cfg.model.audio_encoder.downsample_method,
         kv_cache=str(cpu.cache_dtype), embed_max_abs_err=embed_err, embed_tol=EMBED_TOL,
         prefill_logit_max_abs_err=prefill_err, decode_logit_max_abs_err=step_err,
         logit_tol=LOGIT_TOL, decided_checked=checked, decisions=decisions,
         engine_streams_equal=text_c == text_g, card=card)
    return cpu, gpu, llm_cfg


def phase_serving_small(torch, card, cpu, gpu, llm_cfg):
    """A paged int8 ``SlotDecoder`` on the CPU (plain versions) and one on
    the card (kernels B1, B4, B5), same weights and prompts: two waves
    admitted (the second mid-flight), chunks of one step or one speculative
    round, the CPU decoder's state copied into the card's after each (teacher
    forcing), and every chunk's logits held within LOGIT_TOL; a decided
    token (top-2 margin above 2 * LOGIT_TOL) may not flip."""
    from llm_speech_summarization_tpu_torch.infer.slots import SlotDecoder

    texts = ["summarize the meeting notes", "a short one", "what was decided about the budget",
             "list the action items, with owners and dates"]
    e_c, m_c = cpu.build_text_prompt_batch(texts)
    T = e_c.shape[1]
    fields = ("offsets", "pad_lens", "last_token", "done", "tokens", "n_emitted", "budgets")
    report = {}
    for spec_k in (0, 3):
        decs = []
        for eng, dev in ((cpu, "cpu"), (gpu, "cuda")):
            d = SlotDecoder(eng.llm_params, llm_cfg, eos_id=eng.tokenizer.eos_id, n_slots=4,
                            max_prompt_len=T, max_new_tokens=24, cache_dtype=torch.int8,
                            paged=True, num_pages=1 + 4 * 4, spec_k=spec_k, device=dev)
            seen = []
            fwd = d._forward

            def recording(ids, positions, fwd=fwd, seen=seen):
                out = fwd(ids, positions)
                seen[:] = [out.logits.float().cpu()]
                return out

            d._forward = recording
            decs.append((d, seen))
        (dc, seen_c), (dg, seen_g) = decs

        def teacher_force():
            for f in fields:
                getattr(dg.state, f).copy_(getattr(dc.state, f))
            dg._mirror = tuple(x.copy() for x in dc._mirror)
            dg._bound = dc._bound.copy()

        err, checked, chunks = 0.0, 0, 0
        for wave, rows in enumerate(((0, 1), (2, 3))):
            for d in (dc, dg):
                d.admit(e_c[list(rows)].to(d.device), m_c[list(rows)].to(d.device), list(rows),
                        [24, 20])
            teacher_force()
            for _ in range(6 if wave == 0 else 12):
                for d in (dc, dg):
                    d.decode_chunk(1, spec=spec_k > 0)
                if dc.last_chunk_steps == 0:
                    break
                lc, lg = seen_c[0], seen_g[0]
                err = max(err, (lc - lg).abs().max().item())
                top2 = torch.topk(lc, 2, dim=-1).values
                decided = (top2[..., 0] - top2[..., 1]) > 2 * LOGIT_TOL
                if not (lc.argmax(-1)[decided] == lg.argmax(-1)[decided]).all():
                    raise AssertionError(f"serving_small spec_k={spec_k}: the card flipped a "
                                         f"decided token")
                checked += int(decided.sum())
                chunks += 1
                teacher_force()
        if not err <= LOGIT_TOL:
            raise AssertionError(f"serving_small spec_k={spec_k}: logits differ by {err} > "
                                 f"{LOGIT_TOL}")
        if checked == 0:
            raise AssertionError(f"serving_small spec_k={spec_k}: no decided token checked")
        report[spec_k] = dict(logit_max_abs_err=err, decided_checked=checked, chunks=chunks,
                              card_counts=dict(dg.counts))
    emit("serving_small", page_size=128, prompt_len=T, logit_tol=LOGIT_TOL,
         runs={str(k): v for k, v in report.items()}, card=card)


def _train_total_len():
    """The spliced length of the full-width trainer on 10 s audio."""
    from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
    from llm_speech_summarization_tpu_torch.models.audio_encoder import (
        encoder_setup_from_config,
    )
    from llm_speech_summarization_tpu_torch.train.trainer import spliced_length
    from llm_speech_summarization_tpu_torch.utils.prompts import prompt_template_for
    from llm_speech_summarization_tpu_torch.utils.tokenizer import load_tokenizer

    cfg = load_config(str(YAML_DIR / "llama3_hubert.yaml"))
    tok = load_tokenizer(cfg.model.llm_type, cfg.model.tokenizer_path)
    tpl = prompt_template_for(cfg.model.llm_type)
    return spliced_length(cfg, encoder_setup_from_config(cfg),
                          len(tok.encode(tpl.prefix, add_bos=True)),
                          len(tok.encode(tpl.suffix, add_bos=False)), 160000)


def _dense_mutant(torch, q, k, v, g, lse, delta, starts, ends, causal, frontier):
    """The plain forward lse and backward with the causal frontier moved by
    ``frontier`` keys (a fault a kernel could make), float32."""
    from llm_speech_summarization_tpu_torch.ops.attention import NEG_INF

    B, T, Hq, Dh = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, T, Hkv, G, Dh).float()
    s = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) * Dh ** -0.5
    pos = torch.arange(T, device=q.device)
    keys = (pos[None, :] >= starts[:, None]) & (pos[None, :] < ends[:, None])
    mask = keys[:, None, None, None]
    if causal:
        mask = mask & (pos[None, :] <= pos[:, None] + frontier)
    sm = torch.where(mask, s, NEG_INF)
    m = sm.amax(-1, keepdim=True)
    lse_f = (m + torch.log(torch.exp(sm - m).sum(-1, keepdim=True).clamp(min=1e-30)))[..., 0]
    p = torch.exp(torch.where(mask, s - lse.reshape(B, Hkv, G, T, 1), NEG_INF))
    dog = g.reshape(B, T, Hkv, G, Dh).float()
    dp = torch.einsum("bthgd,bshd->bhgts", dog, v.float())
    ds = p * (dp - delta.reshape(B, Hkv, G, T, 1))
    dq = torch.einsum("bhgts,bshd->bthgd", ds, k.float()).reshape(B, T, Hq, Dh) * Dh ** -0.5
    dk = torch.einsum("bhgts,bthgd->bshd", ds, qg) * Dh ** -0.5
    dv = torch.einsum("bhgts,bthgd->bshd", p, dog)
    return lse_f.reshape(B, Hq, T), dq, dk, dv


def _row_ratio(torch, got, ref, rows=None):
    """Largest |got - ref| over the bound BWD_RTOL |ref| + BWD_ATOL rms(row)
    + BWD_FLOOR rms(ref) (NaN counts as infinitely far), on ``rows`` of
    (B, T) when given."""
    ref = ref.float()
    sel = ref[rows] if rows is not None else ref
    bound = (BWD_RTOL * ref.abs() + BWD_ATOL * ref.pow(2).mean(-1, keepdim=True).sqrt()
             + BWD_FLOOR * sel.pow(2).mean().sqrt() + 1e-12)
    r = torch.nan_to_num((got.float() - ref).abs() / bound, nan=float("inf"))
    return (r[rows] if rows is not None else r).max().item()


def _out_ratio(torch, got, ref, bound, rows):
    """Largest |got - ref| / bound on the (B, T) ``rows`` (NaN counts as
    infinitely far; 0 where no row is chosen)."""
    if not rows.any():
        return 0.0
    r = torch.nan_to_num((got.float() - ref).abs() / bound, nan=float("inf"))
    return r[rows].max().item()


def _sdpa_train_calls(torch, q, k, v, g, rows, causal):
    """``scaled_dot_product_attention`` forward, and forward + backward,
    over the same windows (k/v repeated to the q heads), as yardsticks."""
    import torch.nn.functional as F

    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt, vt = (x.repeat_interleave(G, dim=2).transpose(1, 2).contiguous().requires_grad_()
              for x in (k, v))
    gt = g.transpose(1, 2).contiguous()
    T = q.shape[1]
    mask = rows[:, None, None, :].expand(-1, 1, T, T)
    if causal:
        mask = mask & torch.ones((T, T), dtype=torch.bool, device=q.device).tril()

    def fwd():
        with torch.enable_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    def fwd_bwd():
        with torch.enable_grad():
            torch.autograd.grad(fwd(), (qt, kt, vt), gt)

    return fwd, fwd_bwd


def _train_attn_work(c, T, elem_bytes=2, pairs=None):
    """(bytes, flops) of B1 + LSE, B6 dq and B6 dk/dv at case ``c``: each
    input read once and each output written once (q, k, v, dout and the
    outputs ``elem_bytes`` an element: bf16, or 4 for float32; float32 lse
    and delta), 2 flops per multiply-add over the valid (query, key) pairs
    (``pairs``, else counted from the case's windows): two products in the
    forward, three for dq (s, dp, dq), four for dk/dv (s, dp, dv, dk); and
    "bwd", the whole backward's five (s, dp, dq, dk, dv)."""
    B, Hq, Hkv, Dh = c["B"], c["Hq"], c["Hkv"], c["Dh"]
    if pairs is None:
        pairs = sum(n * (n + 1) // 2 if c["causal"] else n * n
                    for n in (e0 - s0 for s0, e0 in zip(c["starts"], c["ends"])))
    qo = elem_bytes * B * T * Hq * Dh  # one (B, T, Hq, Dh) tensor
    kv = elem_bytes * B * T * Hkv * Dh
    rowf = 4 * B * Hq * T  # one (B, Hq, T) float32 tensor
    f = 2 * Dh * Hq * pairs  # one product
    return {
        "fwd_lse": (float(2 * qo + 2 * kv + rowf), float(2 * f)),
        "dq": (float(3 * qo + 2 * kv + 2 * rowf), float(3 * f)),
        "dkv": (float(2 * qo + 4 * kv + 2 * rowf), float(4 * f)),
        "bwd": (float(3 * qo + 4 * kv + 2 * rowf), float(5 * f)),
    }


def phase_flash_train(torch, card):
    """B1 + LSE and B6 (dq, dk/dv) against their float32 plain versions at
    the training shapes, the injected faults, bit-identical repeats,
    and device times beside the plain versions and SDPA."""
    from llm_speech_summarization_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_bwd_reference,
        flash_attention_fwd_lse, flash_attention_lse_reference,
    )

    T_llm = _train_total_len()
    rng = np.random.RandomState(3)
    dev = torch.device("cuda")
    cases = {
        "llm_train": dict(B=4, T=T_llm, Hq=24, Hkv=8, Dh=128, causal=True,
                          starts=[0, T_llm // 2, 37, 130], ends=[T_llm] * 4),
        "hubert_train": dict(B=4, T=499, Hq=16, Hkv=16, Dh=64, causal=False,
                             starts=[0] * 4, ends=[499, 300, 411, 77]),
        # one rank's heads of the tensor-parallel trainer (model group of 2)
        "llm_train_tp": dict(B=4, T=T_llm, Hq=12, Hkv=4, Dh=128, causal=True,
                             starts=[0, T_llm // 2, 37, 130], ends=[T_llm] * 4),
    }
    results = {}
    for name, c in cases.items():
        B, T, causal = c["B"], c["T"], c["causal"]
        def bf(*shape):
            return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev, torch.bfloat16)

        q = bf(B, T, c["Hq"], c["Dh"])
        k, v = bf(B, T, c["Hkv"], c["Dh"]), bf(B, T, c["Hkv"], c["Dh"])
        starts = torch.tensor(c["starts"], dtype=torch.int32, device=dev)
        ends = torch.tensor(c["ends"], dtype=torch.int32, device=dev)
        pos = torch.arange(T, device=dev)[None, :]
        rows = (pos >= starts[:, None]) & (pos < ends[:, None])  # valid query rows
        g = (bf(B, T, c["Hq"], c["Dh"]).float() * rows[:, :, None, None]).bfloat16()

        out, lse = flash_attention_fwd_lse(q, k, v, starts, ends, causal)
        ref_out, ref_lse = flash_attention_lse_reference(q.float(), k.float(), v.float(),
                                                         starts, ends, causal)
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq = flash_attention_bwd_dq(q, k, v, g, lse, delta, starts, ends, causal)
        dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, delta, starts, ends, causal)
        torch.cuda.synchronize()
        f32 = [t.float() for t in (q, k, v, g)]
        ref = flash_attention_bwd_reference(*f32, lse, delta, starts, ends, causal)

        lse_bound = LSE_ATOL + LSE_RTOL * ref_lse.abs()
        lse_ratio = ((lse - ref_lse).abs() / lse_bound).max().item()
        out_err = (out.float() - ref_out).abs().amax(dim=(2, 3))[rows].max().item()
        ratios = {"dq": _row_ratio(torch, dq, ref[0], rows), "dk": _row_ratio(torch, dk, ref[1]),
                  "dv": _row_ratio(torch, dv, ref[2])}
        finite = all(torch.isfinite(t).all() for t in (out, dq, dk, dv))
        if not (finite and lse_ratio <= 1 and out_err <= B1_TOL and max(ratios.values()) <= 1):
            raise AssertionError(f"{name}: kernels differ from the plain versions: lse "
                                 f"{lse_ratio} x bound, out max err {out_err}, backward "
                                 f"{ratios} x bound, finite {finite}")

        # faults a kernel could make, each through the plain version
        faults = {}
        mut_ends = ends - 1
        m_lse = flash_attention_lse_reference(q.float(), k.float(), v.float(), starts, mut_ends,
                                              causal)[1]
        faults["lse end-1"] = ((m_lse - ref_lse).abs() / lse_bound).max().item()
        bwd_mutants = {
            "end-1": flash_attention_bwd_reference(*f32, lse, delta, starts, mut_ends, causal),
            "lse of the neighbouring row": flash_attention_bwd_reference(
                *f32, torch.roll(lse, 1, dims=-1), delta, starts, ends, causal),
        }
        if causal:
            f_lse, *f_bwd = _dense_mutant(torch, *f32, lse, delta, starts, ends, causal, 1)
            faults["lse frontier+1"] = ((f_lse - ref_lse).abs() / lse_bound).max().item()
            bwd_mutants["frontier+1"] = f_bwd
        G = c["Hq"] // c["Hkv"]
        if G > 1:  # dk/dv of the first q head of each group only
            first = (torch.arange(c["Hq"], device=dev) % G == 0).float()
            bwd_mutants["one q head of the group"] = flash_attention_bwd_reference(
                f32[0], f32[1], f32[2], f32[3] * first[None, None, :, None], lse,
                delta * first[None, :, None], starts, ends, causal)
        for fname, m in bwd_mutants.items():  # rejected if any output leaves the bound
            ratios_m = [_row_ratio(torch, m[1], ref[1]), _row_ratio(torch, m[2], ref[2])]
            if fname != "one q head of the group":  # that fault is in dk/dv only
                ratios_m.append(_row_ratio(torch, m[0], ref[0], rows))
            faults[fname] = max(ratios_m)
        if min(faults.values()) <= 1:
            raise AssertionError(f"{name}: the bound does not reject every fault: {faults}")

        # bit-identical repeats (the remat recompute relies on it): REPEATS
        # rounds of the three kernels in the training order, each output
        # held to the first round's, the unequal ones counted
        unequal = dict.fromkeys(("out", "lse", "dq", "dk", "dv"), 0)
        for _ in range(REPEATS):
            out2, lse2 = flash_attention_fwd_lse(q, k, v, starts, ends, causal)
            dq2 = flash_attention_bwd_dq(q, k, v, g, lse, delta, starts, ends, causal)
            dk2, dv2 = flash_attention_bwd_dkv(q, k, v, g, lse, delta, starts, ends, causal)
            for key, a, b in (("out", out, out2), ("lse", lse, lse2), ("dq", dq, dq2),
                              ("dk", dk, dk2), ("dv", dv, dv2)):
                unequal[key] += not torch.equal(a, b)
        same = {key: n == 0 for key, n in unequal.items()}
        if not all(same.values()):
            raise AssertionError(f"{name}: of {REPEATS} identical calls, these many differ from "
                                 f"the first: {unequal}")

        work = _train_attn_work(c, T)
        sdpa_fwd, sdpa_fwd_bwd = _sdpa_train_calls(torch, q, k, v, g, rows, causal)
        sdpa_f = device_ms(torch, sdpa_fwd, whole=False)
        sdpa_fb = device_ms(torch, sdpa_fwd_bwd, whole=False)
        plain_bwd = device_ms(torch, lambda: flash_attention_bwd_reference(
            q, k, v, g, lse, delta, starts, ends, causal), whole=False)
        res = {}
        for kname, fn, lib in (
                ("fwd_lse", lambda: flash_attention_fwd_lse(q, k, v, starts, ends, causal),
                 sdpa_f),
                ("dq", lambda: flash_attention_bwd_dq(q, k, v, g, lse, delta, starts, ends,
                                                      causal), sdpa_fb - sdpa_f),
                ("dkv", lambda: flash_attention_bwd_dkv(q, k, v, g, lse, delta, starts, ends,
                                                        causal), sdpa_fb - sdpa_f)):
            b_ms, b_by = bound_ms(*work[kname])
            res[kname] = dict(ms=device_ms(torch, fn), call_ms=call_ms(torch, fn), bound_ms=b_ms,
                              bound_by=b_by, library_ms=lib, bytes=work[kname][0],
                              flops=work[kname][1])
        res["fwd_lse"]["plain_ms"] = device_ms(torch, lambda: flash_attention_lse_reference(
            q, k, v, starts, ends, causal), whole=False)
        res["dq"]["plain_ms"] = res["dkv"]["plain_ms"] = plain_bwd  # one plain backward
        lse_err = (lse - ref_lse).abs()[ref_lse > -1e29].max().item()
        res["fwd_lse"]["max_abs_err"] = max(out_err, lse_err)
        res["dq"]["max_abs_err"] = (dq.float() - ref[0])[rows].abs().max().item()
        res["dkv"]["max_abs_err"] = max((dk.float() - ref[1]).abs().max().item(),
                                        (dv.float() - ref[2]).abs().max().item())
        results[name] = res
        emit("flash_train", case=name, shape=[B, T, c["Hq"], c["Hkv"], c["Dh"]], causal=causal,
             starts=c["starts"], ends=c["ends"], lse_err_over_bound=lse_ratio,
             lse_atol=LSE_ATOL, lse_rtol=LSE_RTOL, out_max_abs_err=out_err,
             bwd_err_over_bound=ratios, bwd_rtol=BWD_RTOL, bwd_atol_of_row_rms=BWD_ATOL,
             bwd_floor_of_rms=BWD_FLOOR,
             faults_over_bound=faults, bit_identical=same, repeats=REPEATS,
             unequal_repeats=unequal, sdpa_fwd_ms=sdpa_f,
             sdpa_fwd_bwd_ms=sdpa_fb, kernels=res, card=card)
    return results


def _sdpa_masked_calls(torch, q, k, v, g, mask):
    """``scaled_dot_product_attention`` forward, and forward + backward,
    under a (B, T, S) boolean mask (k/v repeated to the q heads), as
    yardsticks of the ring's per-block interior."""
    import torch.nn.functional as F

    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt, vt = (x.repeat_interleave(G, dim=2).transpose(1, 2).contiguous().requires_grad_()
              for x in (k, v))
    gt = g.transpose(1, 2).contiguous()
    m = mask[:, None]

    def fwd():
        with torch.enable_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m)

    def fwd_bwd():
        with torch.enable_grad():
            torch.autograd.grad(fwd(), (qt, kt, vt), gt)

    return fwd, fwd_bwd


# flash_ring: the ring's three block relations on rank r of n = 2, the
# queries at q_off = r * Tl and the visiting block of rank src at k_off =
# src * Tl; the windows are the global ones clipped to the block
RING_N = 2
RING_BLOCKS = {"src<rank": (1, 0), "src==rank": (1, 1), "src>rank": (0, 1)}
RING_SHAPES = {
    # the LLM at the long-audio trainer's spliced T = 1920 on 2 ranks, left
    # pads (sample 1's reach into the second block)
    "llm_ring": dict(B=4, Tl=960, Hq=24, Hkv=8, Dh=128, causal=True,
                     starts=[0, 1200, 37, 130], ends=[1920] * 4),
    # HuBERT on 120 s clips: 6000 frames on 2 ranks, right-pad windows
    "hubert_ring": dict(B=4, Tl=3000, Hq=16, Hkv=16, Dh=64, causal=False,
                        starts=[0] * 4, ends=[5999, 4000, 2999, 100]),
}


def _ring_pairs(c, r, src):
    """Valid (query, key) pairs of one block pair (for the bound)."""
    Tl, pairs = c["Tl"], 0
    q_pos = np.arange(Tl)[:, None] + r * Tl
    k_pos = np.arange(Tl)[None, :] + src * Tl
    for s0, e0 in zip(c["starts"], c["ends"]):
        ok = (k_pos >= s0) & (k_pos < e0) & (q_pos >= 0)  # (Tl, Tl)
        if c["causal"]:
            ok = ok & (k_pos <= q_pos)
        pairs += int(ok.sum())
    return pairs


def phase_flash_ring(torch, card):
    """B7 (the forward, dq and dk/dv in offset mode) against the plain
    versions run in float32, at the ring's shapes and its three block
    relations, with the lse and backward bounds of B1 + LSE and B6 and the
    output bound B7_OUT_*; a row that sees no key of the block must get lse
    = -1e30 exactly. Injected offset and P.V faults must exceed the bounds.
    Device times beside the bound, the plain versions and SDPA under the
    block's boolean mask."""
    from llm_speech_summarization_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd_dkv_offset, flash_attention_bwd_dq_offset,
        flash_attention_bwd_reference, flash_attention_fwd_lse_offset,
        flash_attention_lse_reference,
    )
    from llm_speech_summarization_tpu_torch.ops.ring_attention import _block_windows

    rng = np.random.RandomState(7)
    dev = torch.device("cuda")
    results = {}
    for name, c in RING_SHAPES.items():
        B, Tl, causal = c["B"], c["Tl"], c["causal"]

        def bf(*shape):
            return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev, torch.bfloat16)

        q = bf(B, Tl, c["Hq"], c["Dh"])
        k, v = bf(B, Tl, c["Hkv"], c["Dh"]), bf(B, Tl, c["Hkv"], c["Dh"])
        g = bf(B, Tl, c["Hq"], c["Dh"])
        f32 = [t.float() for t in (q, k, v, g)]
        starts_g = torch.tensor(c["starts"], dtype=torch.int32, device=dev)
        ends_g = torch.tensor(c["ends"], dtype=torch.int32, device=dev)
        blocks, refs = {}, {}
        for rel, (r, src) in RING_BLOCKS.items():
            offsets = (r * Tl, src * Tl)
            starts, ends = _block_windows(starts_g, ends_g, src, Tl)
            out, lse = flash_attention_fwd_lse_offset(q, k, v, starts, ends, offsets, causal)
            ref_out, ref_lse = flash_attention_lse_reference(*f32[:3], starts, ends, causal,
                                                             offsets)
            abs_out = flash_attention_lse_reference(*f32[:2], f32[2].abs(), starts, ends, causal,
                                                    offsets)[0]
            out_bound = B7_OUT_ATOL + B7_OUT_RTOL * (ref_out.abs() + abs_out)
            del abs_out
            delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
            args = (q, k, v, g, lse, delta, starts, ends, offsets, causal)
            dq = flash_attention_bwd_dq_offset(*args)
            dk, dv = flash_attention_bwd_dkv_offset(*args)
            torch.cuda.synchronize()
            ref = flash_attention_bwd_reference(*f32, lse, delta, starts, ends, causal, offsets)
            seen = ref_lse > -1e29  # (B, Hq, Tl): rows that see a key of this block
            rows = seen.any(1)  # (B, Tl)
            lse_bound = LSE_ATOL + LSE_RTOL * ref_lse.abs()
            lse_ratio = ((lse - ref_lse).abs() / lse_bound)[seen].max().item() if seen.any() else 0.0
            unseen_exact = bool((lse[~seen] == NEG_LSE).all())
            out_err = ((out.float() - ref_out).abs().amax(dim=(2, 3))[rows].max().item()
                       if rows.any() else 0.0)
            out_ratio = _out_ratio(torch, out, ref_out, out_bound, rows)
            # where no row sees a key every reference gradient is 0, and so
            # must the kernel's be (the bound is then 1e-12)
            ratios = {"dq": _row_ratio(torch, dq, ref[0], rows if rows.any() else None),
                      "dk": _row_ratio(torch, dk, ref[1]), "dv": _row_ratio(torch, dv, ref[2])}
            finite = all(torch.isfinite(t).all() for t in (out, lse, dq, dk, dv))
            if not (finite and unseen_exact and lse_ratio <= 1 and out_ratio <= 1
                    and max(ratios.values()) <= 1):
                raise AssertionError(f"B7 {name} {rel}: lse {lse_ratio} x bound, unseen rows "
                                     f"lse == -1e30 {unseen_exact}, out {out_ratio} x bound "
                                     f"(max err {out_err}), backward {ratios} x bound, "
                                     f"finite {finite}")
            blocks[rel] = dict(offsets=offsets, rows_seeing_a_key=int(rows.sum()),
                               lse_err_over_bound=lse_ratio, out_max_abs_err=out_err,
                               out_err_over_bound=out_ratio, out_bound_median=(
                                   out_bound[rows].median().item()
                                   if rows.any() else None),
                               bwd_err_over_bound=ratios, max_abs_err=max(
                                   out_err, (dq.float() - ref[0]).abs().max().item(),
                                   (dk.float() - ref[1]).abs().max().item(),
                                   (dv.float() - ref[2]).abs().max().item()))
            refs[rel] = (starts, ends, lse, delta, ref_lse, ref, rows, ref_out, out_bound)

        # faults a kernel could make, each through the plain version: in the
        # P.V product, V of the neighbouring KV head and the first k tile
        # dropped (its p still in the denominator); with the causal rule, the
        # offsets off by one, swapped, and the block past the causal
        # frontier not masked (offsets dropped)
        starts, ends, _, _, _, _, rows, ref_out, out_bound = refs["src<rank"]
        offsets = blocks["src<rank"]["offsets"]
        v_tile = f32[2].clone()
        v_tile[:, :64] = 0  # the kernels' k tile is 64 keys
        faults = {}
        for fname, v_bad in (("V of the wrong KV head", f32[2].roll(1, dims=2)),
                             ("first k tile dropped from P.V", v_tile)):
            m_out = flash_attention_lse_reference(*f32[:2], v_bad, starts, ends, causal,
                                                  offsets)[0]
            faults[fname] = _out_ratio(torch, m_out, ref_out, out_bound, rows)
        del v_tile, m_out
        if causal:
            mutants = {"q_off+1": ("src==rank", lambda o: (o[0] + 1, o[1])),
                       "k_off+1": ("src==rank", lambda o: (o[0], o[1] + 1)),
                       "offsets swapped": ("src<rank", lambda o: (o[1], o[0])),
                       "src>rank not masked": ("src>rank", lambda o: (0, 0))}
            for fname, (rel, mutate) in mutants.items():
                starts, ends, lse, delta, ref_lse, ref, *_ = refs[rel]
                off = mutate(blocks[rel]["offsets"])
                m_out, m_lse = flash_attention_lse_reference(*f32[:3], starts, ends, causal, off)
                m_bwd = flash_attention_bwd_reference(*f32, lse, delta, starts, ends, causal, off)
                lse_bound = LSE_ATOL + LSE_RTOL * ref_lse.abs()
                faults[fname] = max(
                    ((m_lse - ref_lse).abs() / lse_bound).max().item(),
                    _row_ratio(torch, m_bwd[0], ref[0]), _row_ratio(torch, m_bwd[1], ref[1]),
                    _row_ratio(torch, m_bwd[2], ref[2]))
        if min(faults.values()) <= 1:
            raise AssertionError(f"B7 {name}: the bounds do not reject every fault: {faults}")

        # times at the block with the most work (the first rel for both)
        rel = "src<rank"
        r, src = RING_BLOCKS[rel]
        starts, ends, lse, delta, *_ = refs[rel]
        offsets = blocks[rel]["offsets"]
        args = (q, k, v, g, lse, delta, starts, ends, offsets, causal)
        pairs = _ring_pairs(c, r, src)
        qo, kv = 2 * B * Tl * c["Hq"] * c["Dh"], 2 * B * Tl * c["Hkv"] * c["Dh"]
        rowf = 4 * B * c["Hq"] * Tl
        work = {"fwd": (2 * qo + 2 * kv + rowf, 4 * c["Dh"] * c["Hq"] * pairs),
                "dq": (3 * qo + 2 * kv + 2 * rowf, 6 * c["Dh"] * c["Hq"] * pairs),
                "dkv": (2 * qo + 4 * kv + 2 * rowf, 8 * c["Dh"] * c["Hq"] * pairs)}
        k_pos = torch.arange(Tl, device=dev) + src * Tl
        q_pos = torch.arange(Tl, device=dev) + r * Tl
        mask = ((k_pos[None, :] >= starts_g[:, None]) & (k_pos[None, :] < ends_g[:, None]))[:, None]
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])[None]
        mask = mask.expand(B, Tl, Tl)
        sdpa_fwd, sdpa_fwd_bwd = _sdpa_masked_calls(torch, q, k, v, g, mask)
        sdpa_f = device_ms(torch, sdpa_fwd, whole=False)
        sdpa_fb = device_ms(torch, sdpa_fwd_bwd, whole=False)
        plain_bwd = device_ms(torch, lambda: flash_attention_bwd_reference(
            q, k, v, g, lse, delta, starts, ends, causal, offsets), whole=False)
        res = {}
        for kname, fn, lib in (
                ("fwd", lambda: flash_attention_fwd_lse_offset(q, k, v, starts, ends, offsets,
                                                               causal), sdpa_f),
                ("dq", lambda: flash_attention_bwd_dq_offset(*args), sdpa_fb - sdpa_f),
                ("dkv", lambda: flash_attention_bwd_dkv_offset(*args), sdpa_fb - sdpa_f)):
            b_ms, b_by = bound_ms(*work[kname])
            res[kname] = dict(ms=device_ms(torch, fn), call_ms=call_ms(torch, fn), bound_ms=b_ms,
                              bound_by=b_by, library_ms=lib, bytes=work[kname][0],
                              flops=work[kname][1])
        res["fwd"]["plain_ms"] = device_ms(torch, lambda: flash_attention_lse_reference(
            q, k, v, starts, ends, causal, offsets), whole=False)
        res["dq"]["plain_ms"] = res["dkv"]["plain_ms"] = plain_bwd  # one plain backward
        for kname in res:
            res[kname]["max_abs_err"] = max(b["max_abs_err"] for b in blocks.values())
        results[name] = res
        emit("flash_ring", case=name, n=RING_N, shape=[B, Tl, c["Hq"], c["Hkv"], c["Dh"]],
             causal=causal, global_starts=c["starts"], global_ends=c["ends"], blocks=blocks,
             lse_atol=LSE_ATOL, lse_rtol=LSE_RTOL, out_atol=B7_OUT_ATOL,
             out_rtol_of_abs_out_plus_abs_pv=B7_OUT_RTOL, bwd_rtol=BWD_RTOL,
             bwd_atol_of_row_rms=BWD_ATOL, bwd_floor_of_rms=BWD_FLOOR,
             faults_over_bound=faults, timed_block=rel, sdpa_fwd_ms=sdpa_f,
             sdpa_fwd_bwd_ms=sdpa_fb, kernels=res, card=card)
    return results


# float32 training kernels: B1 + LSE and B6 at the training shapes (the LLM
# at the trainer's spliced length, HuBERT-large at 499 frames, Whisper's
# encoder at 500), then B7 at the ring's block relations
F32_TRAIN_HUBERT_RING_TL = 1000  # HuBERT's ring block, cut from RING_SHAPES' 3000


def _f32_train_cases(T_llm):
    return {
        "llm_train": dict(B=4, T=T_llm, Hq=24, Hkv=8, Dh=128, causal=True,
                          starts=[0, T_llm // 2, 37, 130], ends=[T_llm] * 4),
        "hubert_train": dict(B=4, T=499, Hq=16, Hkv=16, Dh=64, causal=False,
                             starts=[0] * 4, ends=[499, 300, 411, 77]),
        "whisper_train": dict(B=4, T=500, Hq=16, Hkv=16, Dh=64, causal=False,
                              starts=[0] * 4, ends=[500, 350, 431, 97]),
    }


def _f32_ring_shapes(tl=F32_TRAIN_HUBERT_RING_TL):
    """RING_SHAPES, HuBERT's block cut to ``tl`` frames (its windows scaled
    with it), the LLM's as published."""
    return {"llm_ring": RING_SHAPES["llm_ring"],
            "hubert_ring": dict(RING_SHAPES["hubert_ring"], Tl=tl,
                                ends=[2 * tl - 1, 4 * tl // 3, tl - 1, tl // 30])}


def _f64_bwd_magnitudes(torch, q, k, v, g, lse, delta, starts, ends, causal, offsets=None):
    """The magnitudes of the backward bound, float64 (see F32_OUT_ATOL): with
    p = exp(s - lse) in the mask and M = p (|dO|.|V|^T + |delta|),
    (Dh^-0.5 M.|K|, Dh^-0.5 M^T.|Q| over the group, P^T.|dO|)."""
    from llm_speech_summarization_tpu_torch.kernels.flash_attention import _masked_scores
    from llm_speech_summarization_tpu_torch.ops.attention import NEG_INF

    B, T, Hq, Dh = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    s, mask = _masked_scores(q.double(), k.double(), starts, ends, causal, offsets)
    p = torch.exp(torch.where(mask, s - lse.double().reshape(B, Hkv, G, T, 1), NEG_INF))
    del s, mask
    ag = g.double().abs().reshape(B, T, Hkv, G, Dh)
    m = torch.einsum("bthgd,bshd->bhgts", ag, v.double().abs())
    m += delta.double().abs().reshape(B, Hkv, G, T, 1)
    dv = torch.einsum("bhgts,bthgd->bshd", p, ag)
    m *= p
    del p
    scale = Dh ** -0.5
    dq = torch.einsum("bhgts,bshd->bthgd", m, k.double().abs()).reshape(B, T, Hq, Dh) * scale
    dk = torch.einsum("bhgts,bthgd->bshd", m, q.double().abs().reshape(B, T, Hkv, G, Dh)) * scale
    return dq, dk, dv


def _f64_bf16_p(torch, q, k, v, g, lse, delta, starts, ends, causal, offsets=None):
    """A fault: the float64 forward out and backward (dq, dk, dv) with p
    rounded to bf16 before P.V and P^T.dO, and ds before its products (the
    bf16 kernels' rounding on float32 operands)."""
    from llm_speech_summarization_tpu_torch.kernels.flash_attention import _masked_scores
    from llm_speech_summarization_tpu_torch.ops.attention import NEG_INF

    B, T, Hq, Dh = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv

    def bf(x):
        return x.to(torch.bfloat16).double()

    s, mask = _masked_scores(q.double(), k.double(), starts, ends, causal, offsets)
    sm = torch.where(mask, s, NEG_INF)
    mx = sm.amax(-1, keepdim=True)
    pf = torch.exp(sm - mx)
    del sm
    lf = pf.sum(-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bhgts,bshd->bthgd", bf(pf), v.double()) / lf.permute(0, 3, 1, 2, 4)
    del pf
    p = torch.exp(torch.where(mask, s - lse.double().reshape(B, Hkv, G, T, 1), NEG_INF))
    gg = g.double().reshape(B, T, Hkv, G, Dh)
    dv = torch.einsum("bhgts,bthgd->bshd", bf(p), gg)
    ds = bf(p * (torch.einsum("bthgd,bshd->bhgts", gg, v.double())
                 - delta.double().reshape(B, Hkv, G, T, 1)))
    scale = Dh ** -0.5
    dq = torch.einsum("bhgts,bshd->bthgd", ds, k.double()).reshape(B, T, Hq, Dh) * scale
    dk = torch.einsum("bhgts,bthgd->bshd", ds, q.double().reshape(B, T, Hkv, G, Dh)) * scale
    return out.reshape(B, T, Hq, Dh), dq, dk, dv


def _f32_train_case(torch, name, c, q, k, v, g, starts, ends, offsets, rows, entries):
    """One case of phase_flash_train_f32: the float32 kernels through the
    bf16 entry points (``entries``: fwd, dq, dkv; the counts must move on
    their float32 instances alone), held to the float64 plain versions
    within the F32 bounds; the faults through the float64 plain versions;
    returns the case's record and what the timings need."""
    from llm_speech_summarization_tpu_torch.kernels import flash_attention as fa

    causal = c["causal"]
    fwd, dq_fn, dkv_fn = entries
    extra = () if offsets is None else (offsets,)
    watched = [fa._F32_INSTANCES[w] for w in entries] + list(entries)
    before = [w.launches for w in watched]
    out, lse = fwd(q, k, v, starts, ends, *extra, causal)
    delta = (g * out).sum(-1).transpose(1, 2).contiguous()  # as FlashAttention.backward
    args = (q, k, v, g, lse, delta, starts, ends, *extra, causal)
    dq = dq_fn(*args)
    dk, dv = dkv_fn(*args)
    torch.cuda.synchronize()
    moved = [w.launches - b for w, b in zip(watched, before)]
    if moved != [1, 1, 1, 0, 0, 0] or {t.dtype for t in (out, dq, dk, dv)} != {torch.float32}:
        raise AssertionError(f"f32 train {name}: launches {moved} (float32 instances, bf16 "
                             f"entries), dtypes {[t.dtype for t in (out, dq, dk, dv)]}")
    f64 = [t.double() for t in (q, k, v, g)]
    ref_out, ref_lse = fa.flash_attention_lse_reference(*f64[:3], starts, ends, causal, offsets)
    abs_pv = fa.flash_attention_lse_reference(*f64[:2], f64[2].abs(), starts, ends, causal,
                                              offsets)[0]
    out_bound = F32_OUT_ATOL + F32_OUT_RTOL * (ref_out.abs() + abs_pv)
    del abs_pv
    lse_bound = F32_OUT_ATOL + F32_OUT_RTOL * (1 + ref_lse.abs())
    ref = fa.flash_attention_bwd_reference(*f64, lse, delta, starts, ends, causal, offsets)
    bwd_bounds = [F32_OUT_ATOL + F32_OUT_RTOL * m for m in _f64_bwd_magnitudes(
        torch, q, k, v, g, lse, delta, starts, ends, causal, offsets)]
    seen = ref_lse > -1e29  # (B, Hq, T): rows that see a key
    if rows is None:  # offset mode: the rows that see a key of the block
        rows = seen.any(1)

    def ratios(o, l_, grads):
        """err / bound of each output: out on ``rows``, lse on the rows that
        see a key, the gradients everywhere (NaN counts as infinitely far)."""
        r = {"out": _out_ratio(torch, o, ref_out, out_bound, rows)}
        if l_ is not None:
            r["lse"] = (torch.nan_to_num((l_.double() - ref_lse).abs() / lse_bound,
                                         nan=float("inf"))[seen].max().item()
                        if seen.any() else 0.0)
        for key, got, want, bound in zip(("dq", "dk", "dv"), grads, ref, bwd_bounds):
            r[key] = torch.nan_to_num((got.double() - want).abs() / bound,
                                      nan=float("inf")).max().item()
        return r

    got = ratios(out, lse, (dq, dk, dv))
    unseen_exact = bool((lse[~seen] == NEG_LSE).all())
    finite = all(torch.isfinite(t).all() for t in (out, lse, dq, dk, dv))
    if not (finite and unseen_exact and max(got.values()) <= 1):
        raise AssertionError(f"f32 train {name}: {got} x the bounds, rows without a key at "
                             f"lse -1e30 {unseen_exact}, finite {finite}")
    errs = {"fwd_lse": max((out.double() - ref_out).abs().amax(dim=(2, 3))[rows].max().item()
                           if rows.any() else 0.0,
                           (lse.double() - ref_lse)[seen].abs().max().item()
                           if seen.any() else 0.0),
            "dq": (dq.double() - ref[0]).abs().max().item(),
            "dkv": max((dk.double() - ref[1]).abs().max().item(),
                       (dv.double() - ref[2]).abs().max().item())}

    # faults a kernel could make, each through the float64 plain versions
    def plain(q_, k_, v_, g_, ends_=ends):
        o, l_ = fa.flash_attention_lse_reference(q_, k_, v_, starts, ends_, causal, offsets)
        return o, l_, fa.flash_attention_bwd_reference(q_, k_, v_, g_, lse, delta, starts, ends_,
                                                       causal, offsets)

    faults = {}  # none where no row sees a key (the causal src>rank block): all outputs 0
    for fname, make in () if not rows.any() else (
            ("operands rounded to tf32", lambda: plain(
                *[tf32_round(torch, x).double() for x in (q, k, v, g)])),
            ("p and ds rounded to bf16", lambda: (lambda r: (r[0], None, r[1:]))(_f64_bf16_p(
                torch, *f64, lse, delta, starts, ends, causal, offsets))),
            ("window end off by one", lambda: plain(*f64, ends - 1)),
            ("KV head of the wrong group", lambda: plain(f64[0], f64[1].roll(1, dims=2),
                                                        f64[2].roll(1, dims=2), f64[3]))):
        o, l_, grads = make()
        faults[fname] = ratios(o, l_, grads)
        del o, l_, grads
    worst = {f: max(r.values()) for f, r in faults.items()}
    if min(worst.values(), default=2) <= 1:
        raise AssertionError(f"f32 train {name}: the bounds do not reject every fault: {faults}")
    del ref, bwd_bounds, out_bound, lse_bound
    # S of the bounds' derivation: the largest Dh^-0.5 sum_d |q_d k_d|
    G = c["Hq"] // c["Hkv"]
    s_max = (q.abs().transpose(1, 2) @ k.abs().repeat_interleave(G, 2).permute(0, 2, 3, 1)
             ).max().item() * c["Dh"] ** -0.5
    record = dict(err_over_bound=got, faults_over_bound=faults, worst_fault_over_bound=worst,
                  s_max=s_max, lse_max_abs=ref_lse[seen].abs().max().item() if seen.any() else 0,
                  rows_seeing_a_key=int(rows.sum()))
    return record, errs, (out, lse, dq, dk, dv, delta, args)


def _f32_repeats(torch, entries, fwd_args, args, outs):
    """REPEATS rounds of the three kernels in the training order, each
    output held bit for bit to the first round's; the unequal ones counted."""
    fwd, dq_fn, dkv_fn = entries
    unequal = dict.fromkeys(("out", "lse", "dq", "dk", "dv"), 0)
    for _ in range(REPEATS):
        again = (*fwd(*fwd_args), dq_fn(*args), *dkv_fn(*args))
        for key, a, b in zip(unequal, outs, again):
            unequal[key] += not torch.equal(a, b)
    return unequal


def _f32_timings(torch, entries, fwd_args, args, plain_fwd, plain_bwd, sdpa, work):
    """Device ms of the three kernels beside the bound (3xTF32), the float32
    plain versions and SDPA at float32 (forward; forward + backward less
    forward for both backward kernels, which it computes in one call)."""
    fwd, dq_fn, dkv_fn = entries
    sdpa_f = device_ms(torch, sdpa[0], whole=False)
    sdpa_fb = device_ms(torch, sdpa[1], whole=False)
    plain_b = device_ms(torch, plain_bwd, whole=False)
    res = {}
    for kname, fn, lib, plain_ms in (
            ("fwd_lse", lambda: fwd(*fwd_args), sdpa_f,
             device_ms(torch, plain_fwd, whole=False)),
            ("dq", lambda: dq_fn(*args), sdpa_fb - sdpa_f, plain_b),
            ("dkv", lambda: dkv_fn(*args), sdpa_fb - sdpa_f, plain_b)):
        b_ms, b_by = bound_ms(*work[kname], F32_FLOPS_PER_S)
        res[kname] = dict(ms=device_ms(torch, fn), call_ms=call_ms(torch, fn), bound_ms=b_ms,
                          bound_by=b_by, plain_ms=plain_ms, library_ms=lib,
                          bytes=work[kname][0], flops=work[kname][1])
    b_ms, b_by = bound_ms(*work["bwd"], F32_FLOPS_PER_S)
    backward = dict(ms=res["dq"]["ms"] + res["dkv"]["ms"], bound_ms=b_ms, bound_by=b_by,
                    five_products_flops=work["bwd"][1], sdpa_fwd_bwd_ms=sdpa_fb)
    return res, backward


def phase_flash_train_f32(torch, card, hubert_ring_tl=F32_TRAIN_HUBERT_RING_TL):
    """The float32 training kernels: B1 + LSE, B6 dq and B6 dk/dv at the
    training shapes (``_f32_train_cases``: the LLM at the trainer's spliced
    length, HuBERT-large, Whisper's encoder), then B7 (the same three in
    offset mode) at the ring's three block relations (``_f32_ring_shapes``),
    every call through the bf16 entry points, which route float32 tensors
    to the float32 instances; every output held to the float64 plain
    version on the same float32 inputs within the F32 bounds (see
    F32_OUT_ATOL), faults outside them, REPEATS rounds bit-equal, device
    times beside the 3xTF32 bound, the float32 plain versions and SDPA at
    float32 on the same mask."""
    from llm_speech_summarization_tpu_torch.kernels import build, flash_attention as fa
    from llm_speech_summarization_tpu_torch.ops.ring_attention import _block_windows

    fa._f32_lib()
    fa._bwd_f32_lib(True)  # built, so that their logs can be read
    regs = {**flash_f32_registers(build, fa), **flash_bwd_f32_registers(build, fa)}
    rng = np.random.RandomState(11)
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)

    train = (fa.flash_attention_fwd_lse, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    ring = (fa.flash_attention_fwd_lse_offset, fa.flash_attention_bwd_dq_offset,
            fa.flash_attention_bwd_dkv_offset)
    results = {}
    for name, c in _f32_train_cases(_train_total_len()).items():
        B, T, causal = c["B"], c["T"], c["causal"]
        q, k, v = randn(B, T, c["Hq"], c["Dh"]), randn(B, T, c["Hkv"], c["Dh"]), randn(
            B, T, c["Hkv"], c["Dh"])
        starts = torch.tensor(c["starts"], dtype=torch.int32, device=dev)
        ends = torch.tensor(c["ends"], dtype=torch.int32, device=dev)
        pos = torch.arange(T, device=dev)[None, :]
        rows = (pos >= starts[:, None]) & (pos < ends[:, None])  # valid query rows
        g = randn(B, T, c["Hq"], c["Dh"]) * rows[:, :, None, None]  # masked downstream
        record, errs, (out, lse, dq, dk, dv, delta, args) = _f32_train_case(
            torch, name, c, q, k, v, g, starts, ends, None, rows, train)
        unequal = _f32_repeats(torch, train, (q, k, v, starts, ends, causal), args,
                               (out, lse, dq, dk, dv))
        if any(unequal.values()):
            raise AssertionError(f"f32 train {name}: of {REPEATS} identical calls, these many "
                                 f"differ from the first: {unequal}")
        res, backward = _f32_timings(
            torch, train, (q, k, v, starts, ends, causal), args,
            lambda: fa.flash_attention_lse_reference(q, k, v, starts, ends, causal),
            lambda: fa.flash_attention_bwd_reference(*args), _sdpa_train_calls(
                torch, q, k, v, g, rows, causal),
            _train_attn_work(c, T, elem_bytes=4))
        for kname in res:
            res[kname]["max_abs_err"] = errs[kname]
            res[kname]["registers_spill"] = regs.get(f"{kname.split('_')[0]} Dh={c['Dh']}")
        results[name] = res
        emit("flash_train_f32", case=name, shape=[B, T, c["Hq"], c["Hkv"], c["Dh"]],
             causal=causal, starts=c["starts"], ends=c["ends"], out_atol=F32_OUT_ATOL,
             rtol=F32_OUT_RTOL, repeats=REPEATS, unequal_repeats=unequal, kernels=res,
             backward=backward, **record, card=card)
        del q, k, v, g, out, lse, dq, dk, dv, delta, args

    for name, c in _f32_ring_shapes(hubert_ring_tl).items():
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        B, Tl, causal = c["B"], c["Tl"], c["causal"]
        q, k, v = randn(B, Tl, c["Hq"], c["Dh"]), randn(B, Tl, c["Hkv"], c["Dh"]), randn(
            B, Tl, c["Hkv"], c["Dh"])
        g = randn(B, Tl, c["Hq"], c["Dh"])
        starts_g = torch.tensor(c["starts"], dtype=torch.int32, device=dev)
        ends_g = torch.tensor(c["ends"], dtype=torch.int32, device=dev)
        blocks = {}
        for rel, (r, src) in RING_BLOCKS.items():
            offsets = (r * Tl, src * Tl)
            starts, ends = _block_windows(starts_g, ends_g, src, Tl)
            record, errs, kept = _f32_train_case(
                torch, f"{name} {rel}", c, q, k, v, g, starts, ends, offsets, None, ring)
            blocks[rel] = dict(offsets=offsets, errs=errs, **record)
            if rel == "src<rank":  # the block with the most work: repeats and times
                out, lse, dq, dk, dv, delta, args = kept
                fwd_args = (q, k, v, starts, ends, offsets, causal)
                unequal = _f32_repeats(torch, ring, fwd_args, args, (out, lse, dq, dk, dv))
                if any(unequal.values()):
                    raise AssertionError(f"f32 ring {name}: of {REPEATS} identical calls, these "
                                         f"many differ from the first: {unequal}")
                k_pos = torch.arange(Tl, device=dev) + src * Tl
                q_pos = torch.arange(Tl, device=dev) + r * Tl
                mask = ((k_pos[None, :] >= starts_g[:, None])
                        & (k_pos[None, :] < ends_g[:, None]))[:, None]
                if causal:
                    mask = mask & (k_pos[None, :] <= q_pos[:, None])[None]
                res, backward = _f32_timings(
                    torch, ring, fwd_args, args,
                    lambda: fa.flash_attention_lse_reference(q, k, v, starts, ends, causal,
                                                             offsets),
                    lambda: fa.flash_attention_bwd_reference(q, k, v, g, lse, delta, starts,
                                                             ends, causal, offsets),
                    _sdpa_masked_calls(torch, q, k, v, g, mask.expand(B, Tl, Tl)),
                    _train_attn_work(c, Tl, 4, _ring_pairs(c, r, src)))
                del kept, out, lse, dq, dk, dv, delta, args
        for kname in res:
            res[kname]["max_abs_err"] = max(b["errs"][kname] for b in blocks.values())
            res[kname]["registers_spill"] = regs.get(f"{kname.split('_')[0]} Dh={c['Dh']}")
        results[name] = res
        emit("flash_ring_f32", case=name, n=RING_N, shape=[B, Tl, c["Hq"], c["Hkv"], c["Dh"]],
             causal=causal, global_starts=c["starts"], global_ends=c["ends"], blocks=blocks,
             out_atol=F32_OUT_ATOL, rtol=F32_OUT_RTOL, repeats=REPEATS, unequal_repeats=unequal,
             timed_block="src<rank", kernels=res, backward=backward,
             wall_s=time.perf_counter() - t0, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
             reduced=([] if Tl == RING_SHAPES[name]["Tl"] else
                      [f"HuBERT's ring block at Tl={Tl}, not {RING_SHAPES[name]['Tl']}: "
                       f"chip_smoke's time (PERF.md)"]),
             card=card)
        del q, k, v, g
        gc.collect()
        torch.cuda.empty_cache()
    return results


def _small_train_config(base=False):
    from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config

    cfg = (_minichat_base_config("ctc_pool") if base
           else load_config(str(YAML_DIR / "llama3_hubert.yaml")))
    cfg.model.llm_embedding_channels = 256
    cfg.data.source = "synthetic"
    cfg.train.buckets.audio_samples = (32000,)
    cfg.train.buckets.max_text_tokens = 64
    cfg.train.buckets.max_response_tokens = 64
    cfg.train.fd_loss_connector_layers = (0, 1, 2)  # embeddings and both blocks
    return cfg


def _small_train_setup(torch, base=False):
    """train_small's config, encoder setup, LLM config, weights (the int8
    LLM, the float32 encoder), prompt ids, batch and spliced length."""
    import dataclasses

    from llm_speech_summarization_tpu_torch.data.collate import collate_batch
    from llm_speech_summarization_tpu_torch.data.datasets import SyntheticSpeechDataset
    from llm_speech_summarization_tpu_torch.models.audio_encoder import (
        encoder_setup_from_config, init_audio_encoder,
    )
    from llm_speech_summarization_tpu_torch.models.hubert import HubertConfig
    from llm_speech_summarization_tpu_torch.models.llama import (
        LlamaConfig, init_llama_params, quantize_llama_params,
    )
    from llm_speech_summarization_tpu_torch.train.trainer import max_pool_ranges, spliced_length
    from llm_speech_summarization_tpu_torch.utils.prompts import prompt_template_for
    from llm_speech_summarization_tpu_torch.utils.tokenizer import ByteTokenizer

    cfg = _small_train_config(base)
    llm_cfg = LlamaConfig(hidden_size=256, intermediate_size=1024, num_layers=2, num_heads=6,
                          num_kv_heads=2, head_dim=128)
    enc_cfg = HubertConfig(hidden_size=256, num_layers=2, num_heads=4, intermediate_size=1024)
    if base:
        llm_cfg, enc_cfg = _small_base_models()
        cfg.train.remat = True
    setup = dataclasses.replace(encoder_setup_from_config(cfg), encoder_cfg=enc_cfg)
    llm = quantize_llama_params(init_llama_params(torch.Generator().manual_seed(5), llm_cfg))
    enc = init_audio_encoder(torch.Generator().manual_seed(6), setup, dtype=torch.float32)
    tok = ByteTokenizer()
    tpl = prompt_template_for(cfg.model.llm_type)
    prefix, suffix = tok.encode(tpl.prefix, add_bos=True), tok.encode(tpl.suffix, add_bos=False)
    ds = SyntheticSpeechDataset(tok, num_samples=4, max_seconds=2.0)
    b = cfg.train.buckets
    batch = collate_batch([ds[i] for i in range(4)], audio_buckets=b.audio_samples,
                          max_text_tokens=b.max_text_tokens,
                          max_response_tokens=b.max_response_tokens,
                          max_pool_ranges=max_pool_ranges(cfg, setup))
    total_len = spliced_length(cfg, setup, len(prefix), len(suffix), batch.wav.shape[1])
    return cfg, setup, llm_cfg, llm, enc, prefix, suffix, batch, total_len


def phase_train_small(torch, card, base=False):
    """One KD train step at a small kernel-legal width (2 layers, Dh 128 in
    the LLM and 64 in HuBERT) on the CPU and on the card; with ``base``,
    BASELINE config #1's layout (hubert-base under remat, the ``ctc_pool``
    projector over the collated ``pool_ranges_4``, an MHA LLM)."""
    from llm_speech_summarization_tpu_torch.train import make_train_state, make_train_step
    from llm_speech_summarization_tpu_torch.train.state import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, setup, llm_cfg, llm, enc, prefix, suffix, batch, total_len = _small_train_setup(
        torch, base)
    runs = {}
    for dev in ("cpu", "cuda"):
        state, opt = make_train_state(cfg, _to(enc, dev), total_opt_steps=100)
        step = make_train_step(cfg, setup, llm_cfg, opt, prefix, suffix, total_len, device=dev)
        state, metrics = step(state, _to(llm, dev), batch)
        runs[dev] = ({k: v.item() for k, v in metrics.items()},
                     [p.detach().cpu() for p in tree_leaves(state.enc_params)])
    (m_c, p_c), (m_g, p_g) = runs["cpu"], runs["cuda"]
    lr = cfg.train.optimizer.lr
    p0 = [p.float() for p in tree_leaves(enc)]
    moved = agree = 0
    for a, b_, s in zip(p_c, p_g, p0):
        du_c, du_g = a - s, b_ - s
        big = du_c.abs() > lr / 2
        moved += int(big.sum())
        agree += int((big & ((du_c - du_g).abs() <= lr / 4)).sum())
    loss_err = {k: abs(m_g[k] - m_c[k]) / abs(m_c[k]) for k in m_c if k != "grad_norm"}
    gnorm_err = abs(m_g["grad_norm"] - m_c["grad_norm"]) / m_c["grad_norm"]
    agree_share = agree / max(moved, 1)
    finite = all(np.isfinite(v) for v in (*m_c.values(), *m_g.values()))
    if not (finite and max(loss_err.values()) <= TRAIN_LOSS_RTOL and gnorm_err <= TRAIN_GNORM_RTOL
            and agree_share >= TRAIN_SIGN_AGREE and moved > 0):
        raise AssertionError(f"train_small: CPU {m_c} vs card {m_g}: loss rel err {loss_err}, "
                             f"grad_norm rel err {gnorm_err}, update agreement {agree_share} "
                             f"of {moved}")
    emit("train_small", variant="minichat_hubert_base_ctc_pool" if base else "llama3_hubert",
         total_len=total_len, batch=4, audio_samples=int(batch.wav.shape[1]),
         cpu=m_c, card_metrics=m_g, loss_rel_err=loss_err, loss_rtol=TRAIN_LOSS_RTOL,
         grad_norm_rel_err=gnorm_err, grad_norm_rtol=TRAIN_GNORM_RTOL,
         update_agreement=agree_share, update_agreement_min=TRAIN_SIGN_AGREE,
         params_moved=moved, tf32=False, card=card)


def _f32_names(counts, f32):
    """``counts`` under the float32 instances' names where ``f32`` (a
    float32 run launches those and not the bf16 kernels)."""
    return {f"{k}_f32": v for k, v in counts.items()} if f32 else counts


def _expected_train_launches(enc_layers, llm_layers, remat, steps, n_eval_batches, eng_counts,
                             remat_policy="full", f32=False):
    """What a trainer run launches: per train step the student's LLM and
    HuBERT layers run B1 + LSE once, and with remat once more in the
    backward's recompute (except the LLM's under ``remat_policy``
    "save_qkv", whose backward reads the saved attention), and B6 once
    each; the teacher's LLM layers B1; every validate's eval batch runs B1
    in HuBERT and the stacked (audio, text) LLM forward; the generations
    run B1 per encoder forward and prefill and B2 per decode step. ``f32``:
    a run at compute_dtype float32, which launches the float32 instances."""
    both = enc_layers + llm_layers
    llm_fwd = 2 if remat and remat_policy != "save_qkv" else 1
    return _f32_names({
        "flash_attention": llm_layers * steps + both * n_eval_batches
        + enc_layers * eng_counts.get("encoder_forwards", 0)
        + llm_layers * eng_counts.get("prefills", 0),
        "flash_attention_lse": ((2 if remat else 1) * enc_layers + llm_fwd * llm_layers) * steps,
        "flash_attention_bwd_dq": both * steps,
        "flash_attention_bwd_dkv": both * steps,
        "fused_decode": llm_layers * eng_counts.get("decode_steps", 0),
    }, f32)


def _trainer_run(torch, trainer, what):
    """Train with every launch count at 0 first; check the counts against
    what the trainer ran; the per-step losses and times from its metrics."""
    import math

    eng_before = dict(trainer._val_engine.counts) if trainer._val_engine else {}
    step0 = trainer.step
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    eng = trainer._val_engine.counts if trainer._val_engine else {}
    eng_counts = {k: eng.get(k, 0) - eng_before.get(k, 0) for k in set(eng) | set(eng_before)}
    steps = trainer.step - step0
    val_bs = min(trainer.config.train.batch_size, 8)
    n_eval = -(-len(trainer.val_ds) // val_bs)  # one validate per run here
    check_launches(what, launches, _expected_train_launches(
        trainer.enc_setup.encoder_cfg.num_layers, trainer.llm_cfg.num_layers,
        trainer.config.train.remat, steps, n_eval, eng_counts, trainer.config.train.remat_policy,
        trainer.config.model.compute_dtype == "float32"))
    records = [json.loads(line) for line in open(os.path.join(trainer.log_dir, "metrics.jsonl"))]
    per_step = {}
    for r in records:
        for k, v in r.items():
            if k.startswith("train/") and step0 < r["step"] <= trainer.step:
                per_step.setdefault(r["step"], {})[k[len("train/"):]] = v
    bad = [s for s, m in per_step.items() for k, v in m.items() if not math.isfinite(v)]
    if len(per_step) != steps or bad:
        raise AssertionError(f"{what}: {len(per_step)} logged steps of {steps}, "
                             f"non-finite at steps {bad}")
    return dict(steps=steps, wall_s=wall, per_step=per_step, launches=launches,
                engine_counts=eng_counts, eval_batches=n_eval)


def _profile_step(torch, trainer):
    """Device-busy share of one train step (torch.profiler; the union of
    the kernels' device intervals over the step's host-clock wall)."""
    from torch.profiler import ProfilerActivity, profile

    batch = next(trainer._batches(trainer.train_ds, trainer.config.train.batch_size, True, 99))
    trainer.train_step(batch)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch)
        float(metrics["total_loss"])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.events()
    busy = _busy_ms(events)
    by_name = {}
    for e in events:
        if e.device_type.name == "CUDA":
            ms = (e.time_range.end - e.time_range.start) / 1e3
            by_name[e.name] = by_name.get(e.name, 0.0) + ms
    ours = {k: sum(ms for name, ms in by_name.items() if k in name)
            for k in ("flash_fwd_kernel", "bwd_dq_kernel", "bwd_dkv_kernel")}
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12])
    return dict(wall_ms=wall_ms, device_busy_ms=busy, busy_share=busy / wall_ms,
                attention_kernels_ms=ours, attention_share_of_busy=sum(ours.values()) / busy,
                top_kernels_ms=top)


def _busy_ms(events) -> float:
    """Union of device kernel intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type.name == "CUDA")
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


def phase_train_full(torch, card, export_to):
    """The full-width ``llama3_hubert.yaml`` trainer on synthetic data: a
    few optimizer steps and the closing validate() (eval perplexity, two
    sampled generations, a checkpoint) into a temporary directory; then a
    second Trainer resumes from that checkpoint and takes one more step
    (and validates). Launch counts are checked for both runs; then one
    profiled step of the resumed trainer gives the device-busy share, and
    its encoder is exported to the file ``export_to`` (``export_encoder``)
    for ckpt_full. Returns the two runs' launches and the first run's ms a
    step and peak memory (train_f32_full prints them beside its own)."""
    import copy
    import shutil
    import tempfile

    from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
    from llm_speech_summarization_tpu_torch.train.checkpoint import export_encoder
    from llm_speech_summarization_tpu_torch.train.trainer import Trainer

    steps = 3
    tmp = tempfile.mkdtemp(prefix="lss_train_")
    try:
        cfg = load_config(str(YAML_DIR / "llama3_hubert.yaml"))
        cfg.data.source = "synthetic"
        cfg.data.synthetic_num_samples = 64  # 4 train batches of 16, 8 val clips
        cfg.train.steps = steps
        cfg.log.checkpoint_dir = os.path.join(tmp, "ckpt")
        cfg.log.log_dir = os.path.join(tmp, "logs")
        cfg.log.log_interval = 1
        cfg.log.num_generate_samples = 2
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = Trainer(cfg, run_name="smoke")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        first = _trainer_run(torch, trainer, "train_full")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        total_len = trainer.total_len(max(cfg.train.buckets.audio_samples))
        B = cfg.train.batch_size
        times = [first["per_step"][s]["step_time_s"] for s in sorted(first["per_step"])]
        del trainer
        torch.cuda.empty_cache()

        cfg2 = copy.deepcopy(cfg)
        cfg2.train.steps = steps + 1
        cfg2.log.num_generate_samples = 0
        resumed = Trainer(cfg2, run_name="smoke")
        if resumed.step != steps or resumed._resume_epoch_step != steps:
            raise AssertionError(f"resume: at step {resumed.step}, "
                                 f"+{resumed._resume_epoch_step} batches, not {steps}")
        second = _trainer_run(torch, resumed, "train_full resumed")
        if resumed.step != steps + 1:
            raise AssertionError(f"resume: ended at step {resumed.step}")
        profile_ = _profile_step(torch, resumed)
        export_encoder(export_to, resumed.state.enc_params)
        del resumed
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tokens = B * total_len
    emit("train_full", config="llama3_hubert.yaml", data="synthetic", batch=B,
         total_len=total_len, audio_samples=160000, init_s=init_s, steps=first["steps"],
         per_step=first["per_step"], ms_per_step=[1e3 * t for t in times],
         tokens_per_s=[tokens / t for t in times], steady_ms_per_step=1e3 * min(times[1:]),
         steady_tokens_per_s=tokens / min(times[1:]), run_wall_s=first["wall_s"],
         max_memory_allocated_gb=peak_gb, launches=first["launches"],
         engine_counts=first["engine_counts"], eval_batches=first["eval_batches"],
         resumed=dict(steps=second["steps"], per_step=second["per_step"],
                      wall_s=second["wall_s"], launches=second["launches"]),
         profiled_step=profile_, card=card)
    summary = dict(batch=B, total_len=total_len, ms_per_step=[1e3 * t for t in times],
                   steady_ms_per_step=1e3 * min(times[1:]), max_memory_allocated_gb=peak_gb)
    return first["launches"], second["launches"], summary


SAVE_QKV_STEPS = 4  # the trace window covers steps 3 and 4
TRACE_KERNELS = ("flash_fwd_kernel", "bwd_dq_kernel", "bwd_dkv_kernel")


def _trace_kernel_counts(logdir):
    """CUDA kernel events by name fragment in the one Chrome trace that
    ``obs.profile.trace`` wrote into ``logdir``."""
    import glob

    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"trace window: {len(files)} trace files in {logdir}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    return ({k: sum(k in n for n in kernels) for k in TRACE_KERNELS},
            os.path.getsize(files[0]))


def _policy_grads(torch, trainer, batch, policy):
    """One KD forward and backward of ``trainer``'s step under remat
    ``policy``, without the optimizer: (total loss, encoder gradients, ms,
    peak GB above the memory held before, launches)."""
    import copy

    from llm_speech_summarization_tpu_torch.train.state import tree_leaves
    from llm_speech_summarization_tpu_torch.train.step import _device_ids, _forward_losses

    cfg = copy.deepcopy(trainer.config)
    cfg.train.remat_policy = policy
    leaves = tree_leaves(trainer.state.enc_params)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    total, _ = _forward_losses(
        trainer.state.enc_params, trainer.llm_params, batch, enc_setup=trainer.enc_setup,
        llm_cfg=trainer.llm_cfg, cfg=cfg,
        prefix_ids=_device_ids(trainer.prefix_ids, trainer.device),
        suffix_ids=_device_ids(trainer.suffix_ids, trainer.device),
        total_len=trainer.total_len(int(batch.wav.shape[1])), remat=cfg.train.remat)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return total.detach(), grads, ms, peak, read_launches()


def phase_train_save_qkv_full(torch, card):
    """The full-width ``llama3_hubert.yaml`` trainer under remat_policy
    "save_qkv" (B=16, 10 s bucket, int8 frozen LLM, synthetic data): 4
    steps with LSS_PROFILE_DIR set and LSS_PROFILE_STEPS=2, so the trace
    window holds steps 3 and 4, launch counts checked (the student LLM's
    backward reads the saved attention: no B1 + LSE relaunch), the trace
    file's CUDA events of B1 (+ LSE) and B6 those of exactly two steps;
    then, from the trained state and one batch, the step's forward and
    backward under "full" and "save_qkv" in turns (full, save_qkv, full,
    save_qkv): the loss and every encoder gradient equal bit for bit, B1 +
    LSE lower by the LLM's layers, ms and peak memory of each."""
    import shutil
    import tempfile

    from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
    from llm_speech_summarization_tpu_torch.train.trainer import Trainer

    tmp = tempfile.mkdtemp(prefix="lss_save_qkv_")
    prof_dir = os.path.join(tmp, "trace")
    env = {k: os.environ.get(k) for k in ("LSS_PROFILE_DIR", "LSS_PROFILE_STEPS")}
    try:
        cfg = load_config(str(YAML_DIR / "llama3_hubert.yaml"))
        cfg.data.source = "synthetic"
        cfg.data.synthetic_num_samples = 64  # 4 train batches of 16, 8 val clips
        cfg.train.steps = SAVE_QKV_STEPS
        cfg.train.remat_policy = "save_qkv"
        cfg.log.checkpoint_dir = os.path.join(tmp, "ckpt")
        cfg.log.log_dir = os.path.join(tmp, "logs")
        cfg.log.log_interval = 1
        cfg.log.num_generate_samples = 0
        if not cfg.train.remat:
            raise AssertionError("llama3_hubert.yaml no longer sets train.remat")
        os.environ["LSS_PROFILE_DIR"] = prof_dir
        os.environ["LSS_PROFILE_STEPS"] = "2"
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(cfg, run_name="save_qkv")
        run = _trainer_run(torch, trainer, "train_save_qkv_full")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        enc_layers = trainer.enc_setup.encoder_cfg.num_layers
        L = trainer.llm_cfg.num_layers
        # the window's kernels: two steps of the teacher's B1, the student's
        # B1 + LSE (HuBERT's twice under remat, the LLM's once) and B6
        traced, trace_bytes = _trace_kernel_counts(prof_dir)
        per_step = {"flash_fwd_kernel": L + 2 * enc_layers + L,
                    "bwd_dq_kernel": enc_layers + L, "bwd_dkv_kernel": enc_layers + L}
        want = {k: 2 * v for k, v in per_step.items()}
        if traced != want:
            raise AssertionError(f"trace window: kernel events {traced}, want two steps' {want}")
        times = {s: 1e3 * run["per_step"][s]["step_time_s"] for s in sorted(run["per_step"])}

        # full against save_qkv on the same state and batch
        batch = next(trainer._batches(trainer.train_ds, cfg.train.batch_size, True, 99))
        batch = batch.to_device(trainer.device)
        runs, grads = {"full": [], "save_qkv": []}, {}
        for policy in ("full", "save_qkv", "full", "save_qkv"):
            loss, g, ms, peak, launches = _policy_grads(torch, trainer, batch, policy)
            grads.setdefault(policy, g)  # the first run's; the second repeats it
            runs[policy].append((loss, ms, peak, launches))
            del g
        (loss_f, _, _, lf), (loss_s, _, _, ls) = runs["full"][0], runs["save_qkv"][0]
        grads_f, grads_s = grads["full"], grads["save_qkv"]
        equal_loss = torch.equal(loss_f, loss_s)
        equal_grads = all(torch.equal(a, b) for a, b in zip(grads_f, grads_s))
        repeat = all(torch.equal(r[0][0], r[1][0]) for r in runs.values())
        if not (equal_loss and equal_grads and repeat):
            gn_f = torch.sqrt(sum(g.float().square().sum() for g in grads_f)).item()
            gn_s = torch.sqrt(sum(g.float().square().sum() for g in grads_s)).item()
            raise AssertionError(f"save_qkv: loss {loss_s.item()} vs full {loss_f.item()}, "
                                 f"grad norm {gn_s} vs {gn_f}; equal loss {equal_loss}, "
                                 f"grads {equal_grads}, repeats {repeat}")
        if not torch.isfinite(loss_f):
            raise AssertionError(f"save_qkv: loss {loss_f.item()}")
        want_f = {"flash_attention": L, "flash_attention_lse": 2 * (enc_layers + L),
                  "flash_attention_bwd_dq": enc_layers + L, "flash_attention_bwd_dkv": enc_layers + L}
        check_launches("full step", lf, want_f)
        check_launches("save_qkv step", ls, {**want_f, "flash_attention_lse": 2 * enc_layers + L})
        policies = {p: dict(ms=[r[1] for r in rs], peak_gb_above_held=[r[2] for r in rs],
                            lse_launches=rs[0][3]["flash_attention_lse"])
                    for p, rs in runs.items()}
        del grads, grads_f, grads_s, runs, trainer, batch
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    untraced = [times[s] for s in times if s <= 2]
    traced_ms = [times[s] for s in times if s > 2]
    emit("train_save_qkv_full", config="llama3_hubert.yaml", remat_policy="save_qkv",
         batch=cfg.train.batch_size, steps=run["steps"], ms_per_step=list(times.values()),
         steady_ms_per_step=untraced[-1], traced_ms_per_step=traced_ms,
         trace_cost=statistics.mean(traced_ms) / untraced[-1], run_wall_s=run["wall_s"],
         max_memory_allocated_gb=peak_gb, launches=run["launches"],
         trace=dict(steps=[3, 4], kernel_events=traced, bytes=trace_bytes),
         policies=policies, loss=loss_f.item(), bit_equal=True,
         lse_launches_saved_per_step=policies["full"]["lse_launches"]
         - policies["save_qkv"]["lse_launches"], llm_layers=L, card=card)
    return run["launches"]


# train_ring_full: llama3_hubert_long.yaml's trainer on a seq ring of
# RING_RANKS processes over gloo, all on the one card (seq 2 instead of 8:
# eight replicas of the frozen 3B LLM with the encoder's float32 optimizer
# state do not fit 80 GB). The CLI's synthetic source makes 1-8 s clips; the
# ranks make them RING_CLIP_S long, all in the 1,920,000-sample bucket.
RING_RANKS = 2
# train_ring_full, train_dp_full and train_tp_full: Llama-3.2-3B and
# HuBERT-large cut to RANK_LAYERS blocks at their published widths. Every
# block's exchanges are staged through the host (27.4 GB a ring step at the
# published 28 + 24 blocks, 24.6 s of a 24.6 s step; NVIDIA H100 80GB HBM3,
# 700 W), so at full depth the three took 290 s of chip_smoke's 1200 s on a
# fast host and more than twice that on a slow one. The single-process
# trainers (train_full, train_f32_full, train_whisper_full) run the
# published depth.
RANK_LAYERS = 4
RING_STEPS = 2  # the first launch; the resumed launch takes one more
RING_CLIP_S = (118.0, 120.0)
RING_BUCKET = 1920000
RING_TIMEOUT_S = 420  # per launch of the ranks
# the ring step's losses and grad_norm against one unsharded step in one
# process on the same weights and batch: within RING_RTOL * max(1, |a|),
# the bound of the CPU test against the JAX package's unsharded step
RING_RTOL = 5e-3


@contextlib.contextmanager
def _ring_data():
    """The synthetic source of train_ring_full while the context is open:
    the CLI's, with 118-120 s clips (every batch in the 1,920,000-sample
    bucket)."""
    import functools

    from llm_speech_summarization_tpu_torch.data import datasets

    plain = datasets.SyntheticSpeechDataset
    datasets.SyntheticSpeechDataset = functools.partial(
        plain, min_seconds=RING_CLIP_S[0], max_seconds=RING_CLIP_S[1])
    try:
        yield
    finally:
        datasets.SyntheticSpeechDataset = plain


def train_rank(report_dir: str, mode: str, cli_args) -> int:
    """One rank of a multi-process training phase, started by
    ``_rank_launch``: the training CLI's main() with Llama-3.2-3B and
    HuBERT-large cut to RANK_LAYERS blocks (``mode`` "ring": on the ring's
    118-120 s synthetic clips; "dp", "tp") or SHALLOW_LAYERS ("3d",
    "ring_f32"); "tp", "3d" and "ring_f32" take their
    steps and skip the closing validate:
    no eval, generation or checkpoint); each train step is timed and its
    host-staged bytes recorded; the rank's launch counts, the validation
    engine's counts, its peak memory, its optimizer-state bytes, the steps
    and the wall clock of its stages go to ``report_dir/rank<r>.json``.
    The ranks run offline with no local HF tokenizer, so ``load_tokenizer``
    falls back to bytes, as in this process; ``transformers`` is kept from
    importing first (on the card's host the import alone took ~20 s a
    process, and the unsharded steps it is compared with use the same
    tokens)."""
    entered = time.time()
    sys.modules["transformers"] = None  # `import transformers` raises ImportError
    import torch

    from llm_speech_summarization_tpu_torch.cli import train as cli
    from llm_speech_summarization_tpu_torch.parallel.comm import COMM_STATS
    from llm_speech_summarization_tpu_torch.train.state import tree_leaves
    from llm_speech_summarization_tpu_torch.train.trainer import Trainer

    patches = contextlib.ExitStack()  # open for the rank's whole run
    if mode == "ring":
        patches.enter_context(_ring_data())
    patches.enter_context(_shallow(RANK_LAYERS if mode in ("ring", "dp", "tp")
                                   else SHALLOW_LAYERS))
    steps, seen = [], {"validate_s": 0.0}
    train_step, validate = Trainer.train_step, Trainer.validate

    def timed_step(self, batch):
        seen.setdefault("first_step_at", time.time())
        seen["trainer"] = self
        seen["backend"] = torch.distributed.get_backend()
        torch.cuda.synchronize()
        b0, ms0, t0 = COMM_STATS["bytes"], COMM_STATS["ms"], time.perf_counter()
        metrics = train_step(self, batch)
        float(metrics["total_loss"])
        torch.cuda.synchronize()
        steps.append(dict(step=self.step, ms=1e3 * (time.perf_counter() - t0),
                          staged_bytes=COMM_STATS["bytes"] - b0,
                          staged_ms=COMM_STATS["ms"] - ms0, B=int(batch.wav.shape[0]),
                          audio_samples=int(batch.wav.shape[1]),
                          total_len=self.total_len(batch.wav.shape[1])))
        return metrics

    def counted_validate(self, epoch):
        if mode in ("tp", "3d", "ring_f32"):
            return
        t0 = time.time()
        seen["validations"] = seen.get("validations", 0) + 1
        val_bs = min(self.config.train.batch_size, 8)
        seen["eval_batches"] = seen.get("eval_batches", 0) + -(-len(self.val_ds) // val_bs)
        validate(self, epoch)
        seen["validate_s"] += time.time() - t0

    Trainer.train_step, Trainer.validate = timed_step, counted_validate
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    started = time.time()
    cli.main(cli_args)
    trainer = seen["trainer"]
    # epoch seconds: the launcher reads the process's start from entered_at
    stages = dict(entered_at=entered, imports_s=started - entered, warm_cuda_s=_WARM_S,
                  init_s=seen["first_step_at"] - started,
                  steps_s=sum(st["ms"] for st in steps) / 1e3, validate_s=seen["validate_s"],
                  main_s=time.time() - started)
    rank = trainer.mesh.rank
    opt = trainer.state.opt_state
    report = dict(rank=rank, backend=seen["backend"], launches=read_launches(), steps=steps,
                  validations=seen.get("validations", 0), eval_batches=seen.get("eval_batches", 0),
                  engine_counts=dict(trainer._val_engine.counts) if trainer._val_engine else {},
                  peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                  staged=dict(COMM_STATS), enc_layers=trainer.enc_setup.encoder_cfg.num_layers,
                  llm_layers=trainer.llm_cfg.num_layers, remat=trainer.config.train.remat,
                  remat_policy=trainer.config.train.remat_policy,
                  compute_dtype=trainer.config.model.compute_dtype,
                  mesh=[trainer.mesh.data, trainer.mesh.seq, trainer.mesh.model],
                  stages=stages, opt_state_bytes=sum(t.numel() * t.element_size() for k in ("mu", "nu", "acc")
                                      if k in opt for t in tree_leaves(opt[k])),
                  replicated_opt_state_bytes=sum(
                      (3 if "acc" in opt else 2) * 4 * p.numel()
                      for p in tree_leaves(trainer.state.enc_params)))
    with open(os.path.join(report_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    return 0


def _expected_ring_launches(r):
    """What one rank of a ring run launches (n ranks): each ring attention
    call runs n blocks, each block one B7 forward, and in the backward one
    B7 dq and one B7 dk/dv. Per train step: the student's LLM and HuBERT
    layers run the forward once, and with remat once more in the
    backward's recompute, and the backward once; the teacher's LLM layers
    the forward. Each eval batch runs HuBERT and the stacked LLM forward.
    Rank 0's generations run the unsharded engine: B1 per encoder forward
    and prefill, B2 per decode step."""
    n, enc, llm = RING_RANKS, r["enc_layers"], r["llm_layers"]
    steps, evals, eng = len(r["steps"]), r["eval_batches"], r["engine_counts"]
    rm = 2 if r["remat"] else 1
    return _f32_names({
        "flash_attention_lse_offset": n * (steps * (rm * (llm + enc) + llm) + evals * (enc + llm)),
        "flash_attention_bwd_dq_offset": n * steps * (llm + enc),
        "flash_attention_bwd_dkv_offset": n * steps * (llm + enc),
        "flash_attention": enc * eng.get("encoder_forwards", 0) + llm * eng.get("prefills", 0),
        "fused_decode": llm * eng.get("decode_steps", 0),
    }, r["compute_dtype"] == "float32")


def _edited_yaml(what, name, tmp, edits):
    """The port's ``name`` config with each (old, new) of ``edits`` made
    (each old text must be in it once), written under ``tmp``."""
    from llm_speech_summarization_tpu_torch.configs import YAML_DIR

    text = (YAML_DIR / name).read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise AssertionError(f"{what}: {old!r} is not in {name} once")
        text = text.replace(old, new)
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        f.write(text)
    return path


def _ring_yaml(tmp):
    """llama3_hubert_long.yaml with the cell's settings: synthetic data (16
    clips: 4 train batches and one validation batch of 2), the 120 s
    bucket alone, logs and checkpoints under ``tmp``, a log line per step,
    one sampled generation per validate, the feature-distillation layers
    of an LLM of RANK_LAYERS blocks."""
    return _edited_yaml("train_ring_full", "llama3_hubert_long.yaml", tmp, [
        ("data:\n", "data:\n  source: synthetic\n  synthetic_num_samples: 16\n"),
        ("audio_samples: [320000, 960000, 1920000]", f"audio_samples: [{RING_BUCKET}]"),
        ("checkpoint_dir: checkpoints", f"checkpoint_dir: {tmp}/ckpt"),
        ("log_dir: logs", f"log_dir: {tmp}/logs"),
        ("log_interval: 10", "log_interval: 1"),
        ("num_generate_samples: 5", "num_generate_samples: 1"),
        ("fd_loss_connector_layers: [0, 5, 11, 17, 23]",
         f"fd_loss_connector_layers: {list(range(RANK_LAYERS + 1))}")])


def _start_ranks(torch, n, argv, log):
    """Start n processes of this file with ``argv``: the ranks of one group,
    in the environment torch.distributed.run gives its workers
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK,
    LOCAL_WORLD_SIZE, OMP_NUM_THREADS 1), but without its agent, which
    took ~8 s to start the ranks of a launch and ~2.5 s to stop on the
    card's host. The rendezvous store is hosted here as the agent hosts
    it, on a port of the system's choosing that stays bound until the
    ranks are joined, and every rank joins it as a client. Each rank in a
    session of its own (``_stop_ranks`` kills what it started), its output
    to ``log``. Returns the processes and the store, to be kept until they
    end."""
    store = torch.distributed.TCPStore("127.0.0.1", 0, n, is_master=True,
                                       wait_for_workers=False)
    envs = [dict(MASTER_PORT=str(store.port), WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
                 RANK=str(r), LOCAL_RANK=str(r)) for r in range(n)]
    return _POOL.take(argv, envs, log.name), store


class _RankPool:
    """Processes of this file (``--pooled-rank``) that have imported torch
    and the port's training and serving modules and run one small train
    step on the card (``_warm_cuda``), and wait for a rank's job: a launch
    takes them, and the pool starts as many again, which get ready while
    that launch runs. A rank so starts ~7 s sooner (torch's import took
    6.7 s on an H100 host) and its first step runs as fast as its second.
    An idle process exits when this one ends."""

    def __init__(self, keep):
        import tempfile

        self.keep, self.idle, self.started = keep, [], 0
        self.dir = tempfile.mkdtemp(prefix="lss_pool_")

    def fill(self, n=None):
        """Start processes until ``n`` (default ``keep``) wait idle."""
        # torch.distributed.run's environment, without its agent: the
        # launcher hosts the store
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", TORCHELASTIC_USE_AGENT_STORE="True",
                   TORCHELASTIC_RESTART_COUNT="0")
        env.setdefault("OMP_NUM_THREADS", "1")
        while len(self.idle) < (self.keep if n is None else n):
            job = os.path.join(self.dir, f"job{self.started}.json")
            self.started += 1
            with open(job + ".log", "w") as out:
                proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                         "--pooled-rank", job], env=env, stdout=out,
                                        stderr=subprocess.STDOUT, start_new_session=True)
            self.idle.append((proc, job))

    def take(self, argv, envs, log_path):
        """One process per entry of ``envs`` (a rank's own environment)
        runs this file with ``argv``, its output appended to
        ``log_path``; returns the processes."""
        self.fill(len(envs))
        taken, self.idle = self.idle[:len(envs)], self.idle[len(envs):]
        for (_, job), env in zip(taken, envs):
            with open(job + ".tmp", "w") as f:
                json.dump(dict(argv=argv, env=env, log=log_path), f)
            os.replace(job + ".tmp", job)
        self.fill()
        return [proc for proc, _ in taken]

    def close(self):
        import shutil

        _stop_ranks([proc for proc, _ in self.idle])
        self.idle = []
        shutil.rmtree(self.dir, ignore_errors=True)


_POOL = None  # main()'s _RankPool, which every launch takes its ranks from
_WARM_S = None  # a pooled rank's seconds in _warm_cuda, reported by the rank


def _warm_cuda(torch):
    """What a rank's first step would otherwise load on first use: one KD
    train step at train_small's width on the card (bf16, remat), which
    runs the kernels of the full-width step at other shapes. On an NVIDIA
    H100 80GB HBM3 host at 700 W a fresh rank's first train step took 8-19
    s more than its second, outside the host-staged exchanges; a
    convolution and a product in each dtype did not shorten it, this step
    does (PERF.md §6, PR 16)."""
    from llm_speech_summarization_tpu_torch.train import make_train_state, make_train_step

    cfg, setup, llm_cfg, llm, enc, prefix, suffix, batch, total_len = _small_train_setup(torch)
    cfg.train.remat = True
    state, opt = make_train_state(cfg, _to(enc, "cuda"), total_opt_steps=100)
    step = make_train_step(cfg, setup, llm_cfg, opt, prefix, suffix, total_len, device="cuda")
    float(step(state, _to(llm, "cuda"), batch)[1]["total_loss"])
    del state, opt, step
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def pooled_rank(job_path: str) -> int:
    """A process of ``_RankPool``: import what a rank runs, load the card's
    libraries, wait for the job file, then run the rank with its
    environment and output."""
    global _WARM_S
    parent = os.getppid()
    sys.modules["transformers"] = None  # as train_rank and tp_rank keep it out
    import torch

    from llm_speech_summarization_tpu_torch.cli import serve, train  # noqa: F401
    from llm_speech_summarization_tpu_torch.infer import engine, generate, slots  # noqa: F401
    from llm_speech_summarization_tpu_torch.train import trainer  # noqa: F401

    t0 = time.perf_counter()
    _warm_cuda(torch)
    _WARM_S = time.perf_counter() - t0
    while not os.path.exists(job_path):
        if os.getppid() != parent:  # the launcher is gone
            return 1
        time.sleep(0.02)
    with open(job_path) as f:
        job = json.load(f)
    os.environ.update(job["env"])
    sys.stdout.flush()
    sys.stderr.flush()
    fd = os.open(job["log"], os.O_WRONLY | os.O_APPEND)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)
    return _rank_main(job["argv"])


def _rank_main(argv) -> int:
    if argv[0] == "--train-rank":  # one rank of a multi-process training phase
        return train_rank(argv[1], argv[2], argv[4:])
    return tp_rank(argv[1], argv[2], argv[4:])  # "--tp-rank": one rank of serving_tp_full


def _stop_ranks(procs):
    import signal

    for p in procs:
        if p.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(p.pid, signal.SIGKILL)
    for p in procs:
        p.wait()


def _join_ranks(procs, deadline):
    """Wait for the ranks until every one has ended, one has failed (the
    agent stops the others then too) or ``deadline`` (time.monotonic())
    has passed; no rank runs after it returns. Returns the exit codes (None
    for a rank that was still running), or None past the deadline."""
    try:
        while True:
            codes = [p.poll() for p in procs]
            if None not in codes or any(codes):
                return codes
            if time.monotonic() > deadline:
                return None
            time.sleep(0.1)
    finally:
        _stop_ranks(procs)


def _rank_launch(what, mode, yaml_path, steps, report_dir, mesh, expected, timeout):
    """Launch a training phase's ranks (``train_rank`` in ``mode``, started
    by ``_start_ranks``) through the training CLI at ``--mesh D,S,M`` (the
    CLI picks gloo, as the ranks share the card); every process is killed if
    the launch outlives ``timeout`` s, and a rank's failure fails the
    phase. Each rank's launch counts must equal ``expected(report)``.
    Returns the ranks' reports (with each rank's stage seconds) and the
    wall seconds."""
    import torch

    n = mesh[0] * mesh[1] * mesh[2]
    os.makedirs(report_dir, exist_ok=True)
    argv = ["--train-rank", report_dir, mode, "--", "-c", yaml_path, "-n", mode, "--mesh",
            ",".join(map(str, mesh)), "--steps", str(steps)]
    log_path = os.path.join(report_dir, "launch.log")
    t0, t0_epoch = time.perf_counter(), time.time()
    with open(log_path, "w") as log:
        procs, store = _start_ranks(torch, n, argv, log)
        codes = _join_ranks(procs, time.monotonic() + timeout)
    del store
    wall = time.perf_counter() - t0
    with open(log_path) as f:
        out = f.read()
    if codes is None:
        raise AssertionError(f"{what}: the ranks outlived {timeout} s:\n{out[-6000:]}")
    if any(codes):
        raise AssertionError(f"{what}: the ranks exited {codes}:\n{out[-6000:]}")
    reports = []
    for r in range(n):
        with open(os.path.join(report_dir, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    for rep in reports:
        # seconds from the launch to the rank's program
        rep["stages"]["start_s"] = rep["stages"].pop("entered_at") - t0_epoch
        if rep["backend"] != "gloo":
            raise AssertionError(f"{what}: rank {rep['rank']} ran over {rep['backend']}, not "
                                 f"gloo, with ranks that share a card")
        check_launches(f"{what} rank {rep['rank']}", rep["launches"], expected(rep))
    return reports, wall


def _logged_steps(log_dir):
    per_step = {}
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            for k, v in rec.items():
                if k.startswith("train/"):
                    per_step.setdefault(rec["step"], {})[k[len("train/"):]] = v
    return per_step


def phase_train_ring_full(torch, card):
    """``llama3_hubert_long.yaml`` at published widths, the models cut to
    RANK_LAYERS blocks, on a ring
    of RING_RANKS ranks on the one card: RING_STEPS steps, validate and a
    checkpoint; a second launch resumes and takes one step. Then, in this
    process, one unsharded step (seq 1, no ring) on the same weights and
    the first batch, which the ring's first step must match."""
    import copy
    import shutil
    import tempfile

    from llm_speech_summarization_tpu_torch.configs import load_config
    from llm_speech_summarization_tpu_torch.train.trainer import Trainer

    tmp = tempfile.mkdtemp(prefix="lss_ring_")
    try:
        yaml_path = _ring_yaml(tmp)
        args = ((1, RING_RANKS, 1), _expected_ring_launches, RING_TIMEOUT_S)
        first, first_wall = _rank_launch("train_ring_full", "ring", yaml_path, RING_STEPS,
                                         os.path.join(tmp, "r1"), *args)
        resumed, resumed_wall = _rank_launch("train_ring_full", "ring", yaml_path,
                                             RING_STEPS + 1, os.path.join(tmp, "r2"), *args)
        logged = _logged_steps(os.path.join(tmp, "logs", "ring"))
        if sorted(logged) != list(range(1, RING_STEPS + 2)):
            raise AssertionError(f"train_ring_full: logged steps {sorted(logged)}")
        if [s["step"] for s in resumed[0]["steps"]] != [RING_STEPS + 1]:
            raise AssertionError(f"train_ring_full: the resumed launch ran "
                                 f"{resumed[0]['steps']}, not step {RING_STEPS + 1} alone")
        bad = [s for s, m in logged.items() for v in m.values() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"train_ring_full: non-finite metrics at steps {bad}")

        # the unsharded step on the same weights and first batch
        cfg = load_config(yaml_path)
        cfg = copy.deepcopy(cfg)
        cfg.train.use_ring_attention = cfg.train.encoder_sp = False
        cfg.train.mesh.seq = 1
        cfg.log.checkpoint_dir = os.path.join(tmp, "plain_ckpt")
        cfg.log.log_dir = os.path.join(tmp, "plain_logs")
        torch.cuda.reset_peak_memory_stats()
        with _ring_data(), _shallow(RANK_LAYERS):  # the datasets are made here
            trainer = Trainer(cfg, run_name="plain")
        batch = next(trainer._batches(trainer.train_ds, cfg.train.batch_size, True,
                                      cfg.seed_everything))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = {k: float(v) for k, v in trainer.train_step(batch).items()}
        plain_ms = 1e3 * (time.perf_counter() - t0)
        plain_peak = torch.cuda.max_memory_allocated() / 1e9
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ring = logged[1]
    rel = _rel(ring, plain)
    if not max(rel.values()) <= RING_RTOL:
        raise AssertionError(f"train_ring_full: ring step {ring} vs unsharded {plain}: "
                             f"{rel} x max(1, |a|) > {RING_RTOL}")
    steps0 = first[0]["steps"]
    tokens = steps0[0]["B"] * steps0[0]["total_len"]
    ms = [s["ms"] for s in steps0]
    launches = [sum(rep["launches"][k] for rep in first + resumed) for k in first[0]["launches"]]
    launches = dict(zip(first[0]["launches"], launches))
    emit("train_ring_full", config="llama3_hubert_long.yaml", data="synthetic",
         clip_s=list(RING_CLIP_S), audio_samples=RING_BUCKET, batch=steps0[0]["B"],
         total_len=steps0[0]["total_len"], ranks=RING_RANKS, backend="gloo",
         reduced=[f"seq {RING_RANKS} instead of 8 (two ranks share the one card)",
                  f"Llama-3.2-3B and HuBERT-large cut to {RANK_LAYERS} of their 28 and 24 "
                  f"blocks (every block's exchanges are staged through the host)",
                  "synthetic data, random weights"],
         llm_layers=first[0]["llm_layers"], encoder_layers=first[0]["enc_layers"],
         ms_per_step=ms, tokens_per_s=[tokens / (m / 1e3) for m in ms],
         steady_ms_per_step=min(ms[1:] or ms), steady_tokens_per_s=tokens / (min(ms[1:] or ms) / 1e3),
         staged_bytes_per_step=[s["staged_bytes"] for s in steps0],
         staged_ms_per_step=[s["staged_ms"] for s in steps0],
         peak_gb_per_rank=[rep["peak_gb"] for rep in first],
         resumed_peak_gb_per_rank=[rep["peak_gb"] for rep in resumed],
         launch_wall_s=[first_wall, resumed_wall],
         rank0_stages=[first[0]["stages"], resumed[0]["stages"]], logged=logged,
         plain_step=plain, plain_step_ms=plain_ms, plain_peak_gb=plain_peak,
         rel_diff_vs_plain=rel, rtol=RING_RTOL, launches=launches,
         per_rank_launches=[rep["launches"] for rep in first + resumed],
         engine_counts=[rep["engine_counts"] for rep in first + resumed], card=card)
    return launches


MESH_STEPS = 2  # train_dp_full and train_tp_full; the dp resume takes one more
MESH_TIMEOUT_S = 480  # per launch of the ranks of the dp, tp and 3-D phases
# synthetic 1-8 s clips of the mesh phases: 4 train batches of 16 and 8
# validation clips for the dp phase (its resume's third step stays inside
# the first epoch), 2 and 4 for the tp and 3-D phases
MESH_CLIPS = {"dp": 64, "tp": 32, "3d": 32}
# train_3d_small and train_ring_f32: Llama-3.2-3B and HuBERT-large blocks
SHALLOW_LAYERS = 2
# Each multi-rank step against the unsharded step on the same weights and
# global batch, within rtol * max(1, |unsharded|). Only the order of
# summation differs; the card's kernels are not bit-reproducible run to run.
# The first data-parallel step: its losses equal the unsharded step's to
# the bit and grad_norm came within 3.1e-6 to 4.1e-5 in seven runs (NVIDIA
# H100 80GB HBM3, 700 W; 28 + 24 blocks). The first tensor-parallel step
# (28 blocks): the bf16 partial sums of a rank's heads round apart, losses
# within 1.2e-4 and grad_norm 1.0e-4 to 3.1e-4 in five runs.
DP_RTOL = 1e-4
TP_RTOL = 1e-3
# Steps after an optimizer update (the data-parallel steps 2 and 3, whose
# parameters come from ZeRO-1's gathered slices and from the gathered
# checkpoint; the tensor-parallel step 2): the first update carries the
# first step's rounding into every parameter that AdamW moves by about lr,
# so step 2's grad_norm itself moved by 3.9e-4 between runs of the same
# data-parallel code on the card; against the unsharded steps, data
# -parallel steps 2 and 3 came within 4.9e-4 and 6.6e-4 in three runs,
# tensor-parallel step 2 within 4.6e-4. A wrong slice or moment moves
# them by orders of magnitude more.
UPDATED_RTOL = 2e-3


@contextlib.contextmanager
def _shallow(layers, encoder=True):
    """Llama-3.2-3B and (with ``encoder``) HuBERT-large cut to ``layers``
    blocks at their published widths while the context is open (the
    presets the configs name)."""
    import dataclasses

    from llm_speech_summarization_tpu_torch.models import hubert, llama

    saved = dict(llama._PRESETS), dict(hubert._PRESETS)
    llama._PRESETS["llama3_3b"] = dataclasses.replace(llama._PRESETS["llama3_3b"],
                                                      num_layers=layers)
    if encoder:
        hubert._PRESETS["hubert_large"] = dataclasses.replace(hubert._PRESETS["hubert_large"],
                                                              num_layers=layers)
    try:
        yield
    finally:
        for table, old in zip((llama._PRESETS, hubert._PRESETS), saved):
            table.clear()
            table.update(old)


def _mesh_yaml(tmp, mode, extra_train="", fd_layers=None, generations=1):
    """llama3_hubert.yaml for the dp, tp and 3-D phases: synthetic data
    (MESH_CLIPS[mode] clips), logs and checkpoints under ``tmp``, a log line per
    step, ``generations`` sampled generations per validate; ``extra_train``:
    lines added to the train section; ``fd_layers``: the
    feature-distillation layers (for a model cut in depth)."""
    edits = [("data:\n",
              f"data:\n  source: synthetic\n  synthetic_num_samples: {MESH_CLIPS[mode]}\n"),
             ("checkpoint_dir: checkpoints", f"checkpoint_dir: {tmp}/ckpt"),
             ("log_dir: logs", f"log_dir: {tmp}/logs"),
             ("log_interval: 10", "log_interval: 1"),
             ("num_generate_samples: 5", f"num_generate_samples: {generations}"),
             ("  batch_size: 16\n", "  batch_size: 16\n" + extra_train)]
    if fd_layers is not None:
        edits.append(("fd_loss_connector_layers: [0, 5, 11, 17, 23]",
                      f"fd_loss_connector_layers: {list(fd_layers)}"))
    return _edited_yaml("mesh phases", "llama3_hubert.yaml", tmp, edits)


def _expected_mesh_launches(r):
    """One rank of a data- or tensor-parallel run launches what a trainer
    does for its steps, eval batches and generations (each at its rows or
    its heads)."""
    return _expected_train_launches(r["enc_layers"], r["llm_layers"], r["remat"], len(r["steps"]),
                                    r["eval_batches"], r["engine_counts"], r["remat_policy"],
                                    r["compute_dtype"] == "float32")


def _plain_mesh_steps(torch, yaml_path, n):
    """``n`` unsharded steps (mesh 1,1,1) in this process on the weights and
    the first ``n`` global batches of ``yaml_path``'s runs: (metrics per
    step, ms per step, peak GB)."""
    import copy

    from llm_speech_summarization_tpu_torch.configs import load_config
    from llm_speech_summarization_tpu_torch.train.trainer import Trainer

    cfg = copy.deepcopy(load_config(yaml_path))
    cfg.train.use_ring_attention = cfg.train.encoder_sp = False
    cfg.train.mesh.data = cfg.train.mesh.seq = cfg.train.mesh.model = 1
    cfg.log.checkpoint_dir += "_plain"
    cfg.log.log_dir += "_plain"
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, run_name="plain")
    batches = trainer._batches(trainer.train_ds, cfg.train.batch_size, True, cfg.seed_everything)
    metrics, ms = [], []
    for _ in range(n):
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append({k: float(v) for k, v in trainer.train_step(batch).items()})
        ms.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() / 1e9
    del trainer, batches
    gc.collect()
    torch.cuda.empty_cache()
    return metrics, ms, peak


def _mesh_summary(reports, logged, plain, rel):
    """The per-step numbers of a launch's ranks (rank 0's steps, times and
    staged bytes; every rank's peak and optimizer-state bytes; rank 0's
    stage seconds)."""
    steps0 = reports[0]["steps"]
    data = reports[0]["mesh"][0]
    tokens = data * steps0[0]["B"] * steps0[0]["total_len"]
    ms = [s["ms"] for s in steps0]
    launches = {k: sum(rep["launches"][k] for rep in reports) for k in reports[0]["launches"]}
    return dict(batch=data * steps0[0]["B"], total_len=steps0[0]["total_len"],
                llm_layers=reports[0]["llm_layers"], encoder_layers=reports[0]["enc_layers"],
                ms_per_step=ms, tokens_per_s=[tokens / (m / 1e3) for m in ms],
                steady_ms_per_step=min(ms[1:] or ms),
                steady_tokens_per_s=tokens / (min(ms[1:] or ms) / 1e3),
                staged_bytes_per_step=[s["staged_bytes"] for s in steps0],
                staged_ms_per_step=[s["staged_ms"] for s in steps0],
                peak_gb_per_rank=[rep["peak_gb"] for rep in reports],
                opt_state_bytes_per_rank=[rep["opt_state_bytes"] for rep in reports],
                replicated_opt_state_bytes=reports[0]["replicated_opt_state_bytes"],
                rank0_stages=reports[0]["stages"],
                logged=logged, plain_steps=plain[0], plain_ms_per_step=plain[1],
                plain_peak_gb=plain[2], rel_diff_vs_plain=rel, launches=launches,
                per_rank_launches=[rep["launches"] for rep in reports],
                engine_counts=[rep["engine_counts"] for rep in reports])


def _rel(logged_step, plain):
    return {k: abs(logged_step[k] - plain[k]) / max(1.0, abs(plain[k])) for k in plain}


def _held(what, got, plain, first_rtol):
    """Each step's metrics in ``got`` ({step: metrics}, steps 1..n) against
    the unsharded ``plain`` (a list): step 1 within ``first_rtol``, later
    steps within UPDATED_RTOL; every value finite. Returns {step: rel}."""
    rel = {s: _rel(got[s], plain[s - 1]) for s in sorted(got)}
    over = {s: r for s, r in rel.items()
            if not max(r.values()) <= (first_rtol if s == 1 else UPDATED_RTOL)}
    bad = [s for s, m in got.items() for v in m.values() if not np.isfinite(v)]
    if over or bad:
        raise AssertionError(f"{what}: steps {got} vs unsharded {plain}: {over} x max(1, |a|) "
                             f"over {first_rtol} (step 1) / {UPDATED_RTOL} (later), non-finite "
                             f"at {bad}")
    return rel


def phase_train_dp_full(torch, card):
    """``llama3_hubert.yaml`` at published widths, the models cut to
    RANK_LAYERS blocks (int8 LLM, remat "full"), over ``--mesh 2,1,1``: two gloo ranks on the card, each 8 rows
    of every global batch of 16, ZeRO-1 optimizer slices; MESH_STEPS steps,
    validate and a checkpoint (the whole state, gathered). Then in this
    process a trainer on mesh 1,1,1 resumes from that file and takes one
    step, and an unsharded trainer takes three steps on the same global
    batches: the data-parallel first step must match within DP_RTOL, its
    second (after ZeRO-1's update and gather) and the resumed third (after
    the gathered checkpoint) within UPDATED_RTOL."""
    import shutil
    import tempfile

    from llm_speech_summarization_tpu_torch.configs import load_config
    from llm_speech_summarization_tpu_torch.train.state import tree_leaves
    from llm_speech_summarization_tpu_torch.train.trainer import Trainer

    tmp = tempfile.mkdtemp(prefix="lss_dp_")
    try:
        yaml_path = _mesh_yaml(tmp, "dp", fd_layers=range(RANK_LAYERS + 1))
        reports, wall = _rank_launch("train_dp_full", "dp", yaml_path, MESH_STEPS,
                                     os.path.join(tmp, "r1"), (2, 1, 1), _expected_mesh_launches,
                                     MESH_TIMEOUT_S)
        logged = _logged_steps(os.path.join(tmp, "logs", "dp"))
        if sorted(logged) != list(range(1, MESH_STEPS + 1)):
            raise AssertionError(f"train_dp_full: logged steps {sorted(logged)}")
        cfg = load_config(yaml_path)
        cfg.train.steps = MESH_STEPS + 1
        cfg.log.num_generate_samples = 0
        with _shallow(RANK_LAYERS):
            resumed = Trainer(cfg, run_name="dp")  # mesh 1,1,1: this process alone
            whole = all(m.shape == p.shape
                        for m, p in zip(tree_leaves(resumed.state.opt_state["mu"]),
                                        tree_leaves(resumed.state.enc_params)))
            if resumed.step != MESH_STEPS or not whole:
                raise AssertionError(f"train_dp_full: the 1,1,1 trainer resumed at step "
                                     f"{resumed.step} (whole moments: {whole})")
            resumed_run = _trainer_run(torch, resumed, "train_dp_full resumed on mesh 1,1,1")
            if resumed.step != MESH_STEPS + 1:
                raise AssertionError(f"train_dp_full: the resumed run ended at step "
                                     f"{resumed.step}")
            del resumed
            gc.collect()
            torch.cuda.empty_cache()
            plain = _plain_mesh_steps(torch, yaml_path, MESH_STEPS + 1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rel = _held("train_dp_full", {**logged, **resumed_run["per_step"]}, plain[0], DP_RTOL)
    summary = _mesh_summary(reports, logged, plain, rel)
    summary["launches"] = {k: v + resumed_run["launches"][k]
                           for k, v in summary["launches"].items()}
    emit("train_dp_full", config="llama3_hubert.yaml", data="synthetic", mesh=[2, 1, 1],
         ranks=2, backend="gloo", zero1=True, audio_samples=reports[0]["steps"][0]["audio_samples"],
         reduced=[f"Llama-3.2-3B and HuBERT-large cut to {RANK_LAYERS} of their 28 and 24 "
                  f"blocks", "data 2 on one card: two ranks share it over gloo, every "
                  "exchange staged through the host", "synthetic data, random weights"],
         launch_wall_s=wall, resumed_on_111=dict(steps=resumed_run["steps"],
                                                  per_step=resumed_run["per_step"],
                                                  wall_s=resumed_run["wall_s"]),
         rtol=DP_RTOL, updated_rtol=UPDATED_RTOL, card=card, **summary)
    return summary["launches"]


def phase_train_tp_full(torch, card):
    """The same config over ``--mesh 1,1,2``, the models cut to RANK_LAYERS
    blocks at their published widths: the frozen int8 LLM sharded over two gloo ranks on the card
    (12/4 heads, half the MLP and the vocab each; the fused loss
    vocab-parallel); MESH_STEPS steps and no validate (every block's
    exchanges are staged through the host; train_dp_full validates and
    checkpoints). The steps are held to MESH_STEPS unsharded steps: the
    first within TP_RTOL, the second within UPDATED_RTOL."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="lss_tp_")
    try:
        yaml_path = _mesh_yaml(tmp, "tp", generations=0,
                               fd_layers=range(RANK_LAYERS + 1))
        reports, wall = _rank_launch("train_tp_full", "tp", yaml_path, MESH_STEPS,
                                     os.path.join(tmp, "r1"), (1, 1, 2), _expected_mesh_launches,
                                     MESH_TIMEOUT_S)
        logged = _logged_steps(os.path.join(tmp, "logs", "tp"))
        with _shallow(RANK_LAYERS):
            plain = _plain_mesh_steps(torch, yaml_path, MESH_STEPS)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if sorted(logged) != list(range(1, MESH_STEPS + 1)):
        raise AssertionError(f"train_tp_full: logged steps {sorted(logged)}")
    rel = _held("train_tp_full", logged, plain[0], TP_RTOL)
    summary = _mesh_summary(reports, logged, plain, rel)
    emit("train_tp_full", config="llama3_hubert.yaml", data="synthetic", mesh=[1, 1, 2],
         ranks=2, backend="gloo", llm_heads_per_rank=[12, 4],
         reduced=[f"Llama-3.2-3B and HuBERT-large cut to {RANK_LAYERS} of their 28 and 24 "
                  f"blocks", "model 2 on one card: two ranks share it over gloo, every "
                  "exchange staged through the host", "synthetic data, random weights"],
         launch_wall_s=wall, rtol=TP_RTOL, updated_rtol=UPDATED_RTOL, card=card, **summary)
    return summary["launches"]


def phase_train_3d_small(torch, card):
    """The counterpart of the JAX package's ``dryrun_multichip``:
    ``--mesh 2,2,2`` on eight gloo ranks on the card, with the ring and
    encoder SP over each seq pair, the LLM sharded over each model pair and
    ZeRO-1 over each data pair; published widths, Llama-3.2-3B and
    HuBERT-large cut to SHALLOW_LAYERS blocks. One step (no validate), held
    to the unsharded step on the same weights and first global batch
    within RING_RTOL."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="lss_3d_")
    try:
        yaml_path = _mesh_yaml(tmp, "3d", "  use_ring_attention: True\n  encoder_sp: True\n",
                               fd_layers=range(SHALLOW_LAYERS + 1))
        reports, wall = _rank_launch("train_3d_small", "3d", yaml_path, 1,
                                     os.path.join(tmp, "r1"), (2, 2, 2), _expected_ring_launches,
                                     MESH_TIMEOUT_S)
        logged = _logged_steps(os.path.join(tmp, "logs", "3d"))
        with _shallow(SHALLOW_LAYERS):
            plain = _plain_mesh_steps(torch, yaml_path, 1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if sorted(logged) != [1]:
        raise AssertionError(f"train_3d_small: logged steps {sorted(logged)}")
    rel = _held("train_3d_small", logged, plain[0], RING_RTOL)
    summary = _mesh_summary(reports, logged, plain, rel)
    emit("train_3d_small", config="llama3_hubert.yaml", data="synthetic", mesh=[2, 2, 2],
         ranks=8, backend="gloo", ring=True, encoder_sp=True, zero1=True,
         reduced=[f"Llama-3.2-3B and HuBERT-large cut to {SHALLOW_LAYERS} blocks (eight ranks "
                  f"share the one card, every exchange staged through the host)",
                  "synthetic data, random weights"],
         launch_wall_s=wall, rtol=RING_RTOL, card=card, **summary)
    return summary["launches"]


# train_f32_full: llama3_hubert.yaml at compute_dtype float32 (param_dtype
# float32: the encoder, the norms and the LLM's activations in float32; the
# published int8 LLM weights). Its first step against the same step (same
# state, same batch) through the plain attention on the card, both in
# float32 with TF32 off: only the summation order differs, so the losses
# and grad_norm agree within F32_TRAIN_RTOL * max(1, |plain|), 22x what a
# run of this phase read (grad_norm 4.5e-7, the losses equal; NVIDIA H100
# 80GB HBM3, 700 W). The tolerance catches a wrong attention, not a
# rounding: no run showed that TF32 operands or p and ds rounded to bf16
# would move a step past it. Those faults are rejected by the kernel
# bounds of phase_flash_train_f32, and TF32 in the backward by the spy on
# its flags below.
F32_TRAIN_STEPS = 2
# B=8, not the published 16: chip_smoke's time (a float32 step at B=16 takes
# 7.2-8.4 s on an NVIDIA H100 80GB HBM3 at 700 W)
F32_TRAIN_BATCH = 8
F32_TRAIN_RTOL = 1e-5


def _f32_train_raw(tmp, batch, samples, steps, generations):
    """llama3_hubert.yaml as a dict at param_dtype and compute_dtype float32,
    on synthetic data, logs and checkpoints under ``tmp``."""
    from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
    from llm_speech_summarization_tpu_torch.configs.config import config_to_dict

    raw = config_to_dict(load_config(str(YAML_DIR / "llama3_hubert.yaml")))
    raw["model"].update(compute_dtype="float32", param_dtype="float32")
    raw["data"].update(source="synthetic", synthetic_num_samples=samples)
    raw["train"].update(steps=steps, batch_size=batch)
    raw["log"].update(checkpoint_dir=os.path.join(tmp, "ckpt"), log_dir=os.path.join(tmp, "logs"),
                      log_interval=1, num_generate_samples=generations)
    return raw


def phase_train_f32_full(torch, card, bf16):
    """The full-width trainer at compute_dtype float32 (``_f32_train_raw``:
    the published int8 LLM, HuBERT-large, remat, B=F32_TRAIN_BATCH, the
    published buckets). First one step from the trainer's initial state on
    its first batch through the plain attention (``plain_attention``, no
    kernel launched); then the trainer's F32_TRAIN_STEPS optimizer steps and
    the closing validate (eval, a generation through the float32 decode
    instances, a checkpoint), every launch counted under the float32
    instances (B1 + LSE, B6 dq and dk/dv, B1 and B2), its first step held to
    the plain one within F32_TRAIN_RTOL, and every backward under a spy on
    ``torch.autograd.grad`` that reads the TF32 flags as it starts (cuDNN's
    is on outside, as PyTorch leaves it, and must be off inside). ``bf16``:
    train_full's numbers, printed beside these."""
    import shutil
    import tempfile

    from llm_speech_summarization_tpu_torch.configs import load_config
    from llm_speech_summarization_tpu_torch.train import make_train_state
    from llm_speech_summarization_tpu_torch.train.state import tree_leaves, tree_map
    from llm_speech_summarization_tpu_torch.train.trainer import Trainer

    tmp = tempfile.mkdtemp(prefix="lss_f32_train_")
    grad, seen = torch.autograd.grad, []
    saved_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default; train_small turns it off
    outside = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)

    def spy(*args, **kw):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return grad(*args, **kw)

    try:
        cfg = load_config(_f32_train_raw(tmp, F32_TRAIN_BATCH, 4 * F32_TRAIN_BATCH,
                                         F32_TRAIN_STEPS, 1))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = Trainer(cfg, run_name="f32")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        if not any(t.dtype == torch.int8 for t in tree_leaves(trainer.llm_params)):
            raise AssertionError("train_f32_full: the LLM is not the published int8 one")
        # the trainer's first step, from its state on its first batch, through
        # the plain attention
        batch = next(trainer._batches(trainer.train_ds, cfg.train.batch_size, True,
                                      cfg.seed_everything))
        bucket = int(batch.wav.shape[1])
        params = tree_map(lambda p: p.detach().clone().requires_grad_(),
                          trainer.state.enc_params)
        state, _ = make_train_state(cfg, params, trainer.total_opt_steps)
        reset_launches()
        with plain_attention():
            plain = {k: v.item() for k, v in trainer._get_train_step(bucket)(
                state, trainer.llm_params, batch)[1].items()}
        plain_launches = {k: v for k, v in read_launches().items() if v}
        del state, params
        torch.autograd.grad = spy
        try:
            run = _trainer_run(torch, trainer, "train_f32_full")
        finally:
            torch.autograd.grad = grad
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        total_len = trainer.total_len(bucket)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32 = saved_tf32
        shutil.rmtree(tmp, ignore_errors=True)
    first = {k: run["per_step"][1][k] for k in plain}
    rel = {k: abs(first[k] - plain[k]) / max(1.0, abs(plain[k])) for k in plain}
    finite = all(np.isfinite(v) for v in (*first.values(), *plain.values()))
    if not (finite and max(rel.values()) <= F32_TRAIN_RTOL) or plain_launches:
        raise AssertionError(f"train_f32_full: step 1 {first} vs plain attention {plain}: "
                             f"{rel} x max(1, |plain|) over {F32_TRAIN_RTOL}; the plain step "
                             f"launched {plain_launches}")
    if len(seen) != run["steps"] or any(any(flags) for flags in seen) or not outside[0]:
        raise AssertionError(f"train_f32_full: TF32 flags (cuDNN, matmul) {seen} as the "
                             f"backwards started, {outside} outside the steps")
    times = [run["per_step"][s]["step_time_s"] for s in sorted(run["per_step"])]
    B = cfg.train.batch_size
    tokens = B * total_len
    emit("train_f32_full", config="llama3_hubert.yaml", compute_dtype="float32",
         param_dtype="float32", llm_weight_dtype=cfg.model.llm_weight_dtype,
         remat=cfg.train.remat, data="synthetic", batch=B, audio_samples=bucket,
         total_len=total_len, init_s=init_s, steps=run["steps"], per_step=run["per_step"],
         ms_per_step=[1e3 * t for t in times], tokens_per_s=[tokens / t for t in times],
         steady_ms_per_step=1e3 * min(times[1:] or times), run_wall_s=run["wall_s"],
         max_memory_allocated_gb=peak_gb, launches=run["launches"],
         engine_counts=run["engine_counts"], eval_batches=run["eval_batches"],
         plain_check=dict(kernels_step1=first, plain=plain, rel_diff=rel, rtol=F32_TRAIN_RTOL),
         tf32_flags_at_backward=seen, tf32_flags_outside=outside,
         bf16_train_full=bf16, card=card)
    return run["launches"]


# the float32 ring step against the unsharded float32 step: only the order
# of summation differs (1.4e-7 at most in a run on the same card)
F32_RING_RTOL = 1e-5


def phase_train_ring_f32(torch, card):
    """``cli/train.py --mesh 1,2,1`` on two gloo ranks on the card at the
    float32 config (``llama3_hubert.yaml`` at param_dtype and compute_dtype
    float32, the ring and encoder SP), Llama-3.2-3B and HuBERT-large cut to
    SHALLOW_LAYERS blocks at published widths, B=4: one step (no validate),
    B7's float32 instances launched on both ranks, held to the unsharded
    float32 step on the same weights and batch within F32_RING_RTOL."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="lss_ring_f32_")
    try:
        yaml_path = _edited_yaml("train_ring_f32", "llama3_hubert.yaml", tmp, [
            ("data:\n", "data:\n  source: synthetic\n  synthetic_num_samples: 16\n"),
            ("param_dtype: bfloat16", "param_dtype: float32"),
            ("compute_dtype: bfloat16", "compute_dtype: float32"),
            ("  batch_size: 16\n",
             "  batch_size: 4\n  use_ring_attention: True\n  encoder_sp: True\n"),
            ("fd_loss_connector_layers: [0, 5, 11, 17, 23]",
             f"fd_loss_connector_layers: {list(range(SHALLOW_LAYERS + 1))}"),
            ("checkpoint_dir: checkpoints", f"checkpoint_dir: {tmp}/ckpt"),
            ("log_dir: logs", f"log_dir: {tmp}/logs"),
            ("log_interval: 10", "log_interval: 1"),
            ("num_generate_samples: 5", "num_generate_samples: 0")])
        reports, wall = _rank_launch("train_ring_f32", "ring_f32", yaml_path, 1,
                                     os.path.join(tmp, "r1"), (1, 2, 1), _expected_ring_launches,
                                     MESH_TIMEOUT_S)
        logged = _logged_steps(os.path.join(tmp, "logs", "ring_f32"))
        with _shallow(SHALLOW_LAYERS):
            plain = _plain_mesh_steps(torch, yaml_path, 1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if sorted(logged) != [1]:
        raise AssertionError(f"train_ring_f32: logged steps {sorted(logged)}")
    offsets = [k for k in ("flash_attention_lse_offset_f32", "flash_attention_bwd_dq_offset_f32",
                           "flash_attention_bwd_dkv_offset_f32")
               if not all(rep["launches"][k] for rep in reports)]
    if offsets:
        raise AssertionError(f"train_ring_f32: a rank did not launch {offsets}")
    rel = _held("train_ring_f32", logged, plain[0], F32_RING_RTOL)
    summary = _mesh_summary(reports, logged, plain, rel)
    emit("train_ring_f32", config="llama3_hubert.yaml", compute_dtype="float32",
         param_dtype="float32", data="synthetic", mesh=[1, 2, 1], ranks=2, backend="gloo",
         ring=True, encoder_sp=True,
         reduced=[f"Llama-3.2-3B and HuBERT-large cut to {SHALLOW_LAYERS} blocks, B=4 (the "
                  f"ranks share the one card, every exchange staged through the host)",
                  "synthetic data, random weights"],
         launch_wall_s=wall, rtol=F32_RING_RTOL, card=card, **summary)
    return summary["launches"]


def _wrappers():
    from llm_speech_summarization_tpu_torch.kernels import flash_attention as fa
    from llm_speech_summarization_tpu_torch.kernels.decode_attention import decode_attention
    from llm_speech_summarization_tpu_torch.kernels.fused_decode import (
        fused_decode, fused_decode_attention_write,
    )
    from llm_speech_summarization_tpu_torch.kernels.fused_paged import fused_paged_decode
    from llm_speech_summarization_tpu_torch.kernels.paged_attention import paged_decode_attention

    from llm_speech_summarization_tpu_torch.kernels.decode_attention import (
        decode_attention_f32, decode_attention_mixed,
    )
    from llm_speech_summarization_tpu_torch.kernels.fused_decode import (
        fused_decode_attention_write_f32, fused_decode_attention_write_mixed, fused_decode_f32,
    )
    from llm_speech_summarization_tpu_torch.kernels.fused_paged import (
        fused_paged_decode_f32, fused_paged_decode_mixed,
    )
    from llm_speech_summarization_tpu_torch.kernels.paged_attention import (
        paged_decode_attention_f32, paged_decode_attention_mixed,
    )

    return {"flash_attention": fa.flash_attention_fwd,
            "flash_attention_f32": fa.flash_attention_fwd_f32, "fused_decode": fused_decode,
            "flash_attention_lse_f32": fa.flash_attention_fwd_lse_f32,
            "flash_attention_bwd_dq_f32": fa.flash_attention_bwd_dq_f32,
            "flash_attention_bwd_dkv_f32": fa.flash_attention_bwd_dkv_f32,
            "flash_attention_lse_offset_f32": fa.flash_attention_fwd_lse_offset_f32,
            "flash_attention_bwd_dq_offset_f32": fa.flash_attention_bwd_dq_offset_f32,
            "flash_attention_bwd_dkv_offset_f32": fa.flash_attention_bwd_dkv_offset_f32,
            "paged_attention": paged_decode_attention, "fused_paged": fused_paged_decode,
            "flash_attention_lse": fa.flash_attention_fwd_lse,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
            "flash_attention_lse_offset": fa.flash_attention_fwd_lse_offset,
            "flash_attention_bwd_dq_offset": fa.flash_attention_bwd_dq_offset,
            "flash_attention_bwd_dkv_offset": fa.flash_attention_bwd_dkv_offset,
            "fused_decode_attention_write": fused_decode_attention_write,
            "decode_attention": decode_attention, "fused_decode_f32": fused_decode_f32,
            "fused_decode_attention_write_f32": fused_decode_attention_write_f32,
            "paged_attention_f32": paged_decode_attention_f32,
            "fused_paged_f32": fused_paged_decode_f32, "decode_attention_f32": decode_attention_f32,
            "fused_decode_attention_write_mixed": fused_decode_attention_write_mixed,
            "decode_attention_mixed": decode_attention_mixed,
            "paged_attention_mixed": paged_decode_attention_mixed,
            "fused_paged_mixed": fused_paged_decode_mixed}


def decode_suffix(torch, eng) -> str:
    """The launch-count suffix of the decode instances ``eng`` takes: its
    decode steps run in the norms' dtype (as the JAX engine's), so "_f32"
    for float32 norms, "_mixed" for bf16 norms over a float32 cache, ""
    (the bf16 kernels) for bf16 norms over an int8 or bf16 cache."""
    if eng.llm_params["final_norm"].dtype == torch.float32:
        return "_f32"
    return "_mixed" if eng.cache_dtype == torch.float32 else ""


def reset_launches() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def check_launches(what: str, got: dict, want: dict) -> None:
    """``want`` names the kernels the run should launch; every other kernel
    must have launched no time."""
    want = {**{k: 0 for k in got}, **want}
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got} != expected {want}")


def _stage_breakdown(torch, eng, clips, what, ranges=None, steps=16):
    """Host ms of one batch's prompt build (upload, encoder, splice), its
    prefill, and a decode step (the mean of ``steps`` - 1 greedy steps on an
    int8 cache), each between synchronizes; not counted in the launches.
    Fails on logits that are not finite or of the wrong shape."""
    from llm_speech_summarization_tpu_torch.models.llama import init_kv_cache, llama_forward

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embeds, mask = eng.build_audio_prompt_batch(clips, ctc_pool_ranges=ranges)
    torch.cuda.synchronize()
    enc_ms = 1e3 * (time.perf_counter() - t0)
    B, Lp, _ = embeds.shape
    cache = init_kv_cache(eng.llm_cfg, B, Lp + steps, torch.int8, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = llama_forward(eng.llm_params, eng.llm_cfg, inputs_embeds=embeds, attn_mask=mask,
                        kv_cache=cache, cache_offset=0, last_logit_only=True)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    logits = out.logits[:, -1]
    if logits.shape != (B, eng.llm_cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"{what}: prefill logits are not finite / of the expected shape")
    lens = mask.to(torch.int32).sum(1)
    pads = (Lp - lens).to(torch.int32)
    tok = logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(1, steps):
        out = llama_forward(eng.llm_params, eng.llm_cfg, input_ids=tok[:, None],
                            positions=(lens + step - 1)[:, None], kv_cache=cache,
                            cache_offset=Lp + step - 1, kv_pad_lens=pads)
        tok = out.logits[:, 0].argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    decode_ms = 1e3 * (time.perf_counter() - t0) / (steps - 1)
    if not torch.isfinite(out.logits).all():
        raise AssertionError(f"{what}: decode logits are not finite")
    return enc_ms, prefill_ms, decode_ms, Lp


def phase_full(torch, card):
    from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
    from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference

    torch.cuda.reset_peak_memory_stats()
    cfg = load_config(str(YAML_DIR / "llama3_hubert.yaml"))
    t0 = time.perf_counter()
    eng = LLMSpeechTextInference(cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    enc_layers = eng.encoder_setup.encoder_cfg.num_layers
    llm_layers = eng.llm_cfg.num_layers
    rng = np.random.RandomState(0)
    clips = [(0.1 * rng.randn(160000)).astype(np.float32) for _ in range(8)]  # 8 x 10 s
    max_new = 32
    eng.generate_audio_response_batch(clips, max_new_tokens=max_new)  # warm-up
    torch.cuda.synchronize()

    # --- the main path, counted: every launch here comes from the engine
    reset_launches()
    eng.counts.clear()
    t0 = time.perf_counter()
    texts = eng.generate_audio_response_batch(clips, max_new_tokens=max_new)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    texts2 = eng.generate_audio_response_batches([clips, clips], max_new_tokens=max_new)
    torch.cuda.synchronize()
    batches_s = time.perf_counter() - t0
    launches = read_launches()
    counts = dict(eng.counts)
    # ---
    check_launches("full batch path", launches, {
        "flash_attention": enc_layers * counts["encoder_forwards"]
        + llm_layers * counts["prefills"],
        "fused_decode": llm_layers * counts["decode_steps"],
        "paged_attention": 0, "fused_paged": 0})
    if len(texts) != 8 or len(texts2) != 2 or any(len(t) != 8 for t in texts2):
        raise AssertionError("full: wrong number of responses")

    enc_ms, prefill_ms, decode_ms, Lp = _stage_breakdown(torch, eng, clips, "full")
    emit("full_width", config="llama3_hubert.yaml", batch=8, clip_s=10, max_new_tokens=max_new,
         prompt_len=Lp, init_s=round(init_s, 3), batch_call_s=batch_s,
         utt_per_s=8 / batch_s, batches_call_s=batches_s, batches_utt_per_s=16 / batches_s,
         encoder_ms=enc_ms, prefill_ms=prefill_ms, decode_ms_per_step=decode_ms,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches=launches, engine_counts=counts, card=card)
    return launches, eng


def _expected_batch_launches(eng, counts) -> dict:
    """What a batch-path run launches: B1 per encoder layer per prompt build
    and per LLM layer per prefill, B2 per LLM layer per decode step."""
    return {"flash_attention": eng.encoder_setup.encoder_cfg.num_layers
            * counts["encoder_forwards"] + eng.llm_cfg.num_layers * counts["prefills"],
            "fused_decode": eng.llm_cfg.num_layers * counts["decode_steps"]}


def phase_minichat_base_full(torch, card):
    """BASELINE config #1 at published widths: ``minichat_hubert.yaml`` with
    the hubert-base encoder (12 layers, 12/12 heads, Dh=64) and MiniChat-3B
    (24 layers, 24/24 heads, Dh=128, vocab 49216) on int8 weights and an
    int8 cache, B=8 clips of 10 s and 32 new tokens through
    ``generate_audio_response_batch``: once with the ``pool`` projector and
    once with ``ctc_pool`` over synthetic ranges (4-frame ranges tiling each
    clip's frames), from the same weights. Launch counts zeroed before and
    checked after each counted run; utt/s, the stage breakdown and peak
    memory printed."""
    from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference
    from llm_speech_summarization_tpu_torch.models.audio_encoder import audio_embed_lengths

    torch.cuda.reset_peak_memory_stats()
    rng = np.random.RandomState(2)
    clips = [(0.1 * rng.randn(160000)).astype(np.float32) for _ in range(8)]  # 8 x 10 s
    ranges = [synthetic_pool_ranges(len(c)) for c in clips]
    max_new = 32
    runs, eng = [], None
    for method in ("pool", "ctc_pool"):
        cfg = _minichat_base_config(method)
        t0 = time.perf_counter()
        if eng is None:
            eng = LLMSpeechTextInference(cfg)
        else:  # the same weights: only the projector's pooling differs
            eng = LLMSpeechTextInference(cfg, llm_params=eng.llm_params,
                                         audio_encoder_params=eng.audio_encoder_params)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        what = f"minichat_base_full {method}"
        kw = dict(ctc_pool_ranges=ranges if method == "ctc_pool" else None)
        eng.generate_audio_response_batch(clips, max_new_tokens=max_new, **kw)  # warm-up
        torch.cuda.synchronize()

        # --- the main path, counted
        reset_launches()
        eng.counts.clear()
        t0 = time.perf_counter()
        texts = eng.generate_audio_response_batch(clips, max_new_tokens=max_new, **kw)
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
        launches = read_launches()
        counts = dict(eng.counts)
        # ---
        check_launches(what, launches, _expected_batch_launches(eng, counts))
        if len(texts) != 8:
            raise AssertionError(f"{what}: wrong number of responses")
        # every clip's audio positions in its prompt: one per range, or the
        # reference's length arithmetic for the average pool
        embeds, mask = eng.build_audio_prompt_batch(clips, **kw)
        audio_rows = (mask.to(torch.int32).sum(1) - eng.prefix_ids.shape[0]
                      - eng.suffix_ids.shape[0])
        want_rows = ([len(r) for r in ranges] if method == "ctc_pool" else audio_embed_lengths(
            eng.encoder_setup, torch.full((8,), 160000)).tolist())
        if audio_rows.tolist() != want_rows or not torch.isfinite(embeds).all():
            raise AssertionError(f"{what}: {audio_rows.tolist()} audio positions spliced, "
                                 f"want {want_rows}")
        del embeds, mask
        enc_ms, prefill_ms, decode_ms, Lp = _stage_breakdown(torch, eng, clips, what,
                                                             ranges=kw["ctc_pool_ranges"])
        emit("minichat_base_full", config="minichat_hubert.yaml",
             encoder=cfg.model.audio_encoder.type, projector=method,
             llm=cfg.model.llm_type, llm_heads=[eng.llm_cfg.num_heads, eng.llm_cfg.num_kv_heads],
             batch=8, clip_s=10, max_new_tokens=max_new, prompt_len=Lp,
             audio_positions=audio_rows.tolist()[0], init_s=round(init_s, 3),
             batch_call_s=batch_s, utt_per_s=8 / batch_s, encoder_ms=enc_ms,
             prefill_ms=prefill_ms, decode_ms_per_step=decode_ms,
             max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
             launches=launches, engine_counts=counts, card=card)
        runs.append(launches)
    return runs


@contextlib.contextmanager
def recorded_tokens(tokenizer_cls):
    """Every token row that ``tokenizer_cls.decode`` turns into text in the
    block, so two runs compare by token stream (a byte tokenizer drops the
    ids of a random full-width model's vocabulary above 255 from the text)."""
    rows = []
    decode = tokenizer_cls.decode

    def record(self, ids, *args, **kw):
        rows.append(list(ids))
        return decode(self, ids, *args, **kw)

    tokenizer_cls.decode = record
    try:
        yield rows
    finally:
        tokenizer_cls.decode = decode


BULK_CLIPS = 32  # half WAV, half FLAC, 6-10 s
BULK_AB_BATCHES = 2  # x B=32 x 10 s clips, 64 new tokens, for pipelined vs serial


def _write_clips(d, n, seed):
    """``n`` clips of 6-10 s of int16 noise, alternately WAV (scipy) and
    FLAC (the test fixtures' encoder)."""
    from scipy.io import wavfile

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from flac_writer import encode_flac

    rng = np.random.RandomState(seed)
    for i in range(n):
        pcm = np.clip(0.1 * rng.randn(int(rng.uniform(6.0, 10.0) * 16000)) * 32767,
                      -32768, 32767).astype(np.int16)
        if i % 2:
            with open(os.path.join(d, f"clip{i:02d}.flac"), "wb") as f:
                f.write(encode_flac([pcm.astype(np.int64)], blocksize=4096, mode="fixed2"))
        else:
            wavfile.write(os.path.join(d, f"clip{i:02d}.wav"), 16000, pcm)


def phase_bulk_full(torch, card):
    """The bulk entry point at full width: ``cli/infer.py --audio_dir`` over
    BULK_CLIPS WAV and FLAC clips, ``--batch_size 8``, on
    ``llama3_hubert.yaml``, run in this process with the launch counts
    zeroed before and checked after; 32 JSONL rows in size order, each
    response and token stream equal to the per-batch engine call on the
    loaded audio. Then the pipelined ``generate_audio_response_batches``
    against a loop of ``generate_audio_response_batch`` over the same
    BULK_AB_BATCHES batches of 32 10 s clips with 64 new tokens, in the
    order ABBA (A pipelined, B serial) after a warm-up of each: utt/s per
    run, and the host ms per decode step inside the generate calls (the
    prefill included) while the builder thread works beside them; token
    streams equal between the two."""
    import tempfile

    from llm_speech_summarization_tpu_torch.cli import infer as cli_infer
    from llm_speech_summarization_tpu_torch.configs import YAML_DIR
    from llm_speech_summarization_tpu_torch.data.audio_io import load_audio
    from llm_speech_summarization_tpu_torch.utils.tokenizer import ByteTokenizer

    max_new = 32
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "clips")
        os.makedirs(d)
        t0 = time.perf_counter()
        _write_clips(d, BULK_CLIPS, seed=3)
        write_s = time.perf_counter() - t0
        out = os.path.join(tmp, "bulk.jsonl")

        # --- the main path, counted: the CLI end to end
        reset_launches()
        t0 = time.perf_counter()
        with recorded_tokens(ByteTokenizer) as cli_rows:
            eng = cli_infer.main(["-c", str(YAML_DIR / "llama3_hubert.yaml"), "--audio_dir", d,
                                  "--output", out, "--batch_size", "8",
                                  "--max_new_tokens", str(max_new)])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = read_launches()
        counts = dict(eng.counts)
        # ---
        check_launches("bulk_full cli", launches, _expected_batch_launches(eng, counts))
        if not isinstance(eng.tokenizer, ByteTokenizer):
            raise AssertionError(f"bulk_full: token streams are read through ByteTokenizer, "
                                 f"the engine has {type(eng.tokenizer).__name__}")
        with open(out) as f:
            rows = [json.loads(x) for x in f]
        paths = cli_infer.audio_paths(d)
        if len(rows) != BULK_CLIPS or [r["file"] for r in rows] != paths:
            raise AssertionError(f"bulk_full: {len(rows)} JSONL rows, want {BULK_CLIPS} "
                                 "in size order")
        audio = [load_audio(p) for p in paths]
        kinds = sorted({os.path.splitext(p)[1] for p in paths})
    with recorded_tokens(ByteTokenizer) as ref_rows:
        want = [t for i in range(0, BULK_CLIPS, 8)
                for t in eng.generate_audio_response_batch(audio[i:i + 8],
                                                           max_new_tokens=max_new)]
    if [r["response"] for r in rows] != want or cli_rows != ref_rows:
        raise AssertionError("bulk_full: the CLI's responses differ from the per-batch calls")
    emit("bulk_full", config="llama3_hubert.yaml", clips=BULK_CLIPS, kinds=kinds,
         batch_size=8, max_new_tokens=max_new, write_clips_s=write_s, cli_s=cli_s,
         rows=len(rows), responses_equal=True, token_rows_compared=len(cli_rows),
         launches=launches, engine_counts=counts, card=card)

    # pipelined against serial, ABBA, on the same engine
    rng = np.random.RandomState(4)
    batches = [[(0.1 * rng.randn(160000)).astype(np.float32) for _ in range(32)]
               for _ in range(BULK_AB_BATCHES)]
    gen = eng._generate_from_embeds
    gen_s = []

    def timed_gen(*args, **kw):  # ends in a copy to the host: synchronized
        t = time.perf_counter()
        try:
            return gen(*args, **kw)
        finally:
            gen_s.append(time.perf_counter() - t)

    modes = {"A": lambda b: eng.generate_audio_response_batches(b, max_new_tokens=64),
             "B": lambda b: [eng.generate_audio_response_batch(x, max_new_tokens=64)
                             for x in b]}
    for tag in "AB":  # warm-up: the B=32 shapes, the side stream, pinned buffers
        modes[tag](batches[:2])
    eng._generate_from_embeds = timed_gen
    runs = {"A": [], "B": []}
    streams = {}
    try:
        for tag in "ABBA":
            gen_s.clear()
            eng.counts.clear()
            torch.cuda.synchronize()
            with recorded_tokens(ByteTokenizer) as tok_rows:
                t0 = time.perf_counter()
                outs = modes[tag](batches)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            if [len(o) for o in outs] != [32] * BULK_AB_BATCHES:
                raise AssertionError(f"bulk_full: mode {tag} returned {[len(o) for o in outs]}")
            if tok_rows != streams.setdefault("first run", tok_rows):
                raise AssertionError("bulk_full: pipelined and serial token streams differ")
            runs[tag].append({"utt_per_s": 32 * BULK_AB_BATCHES / wall, "wall_s": wall,
                              "generate_ms_per_step": 1e3 * sum(gen_s)
                              / max(eng.counts["decode_steps"], 1),
                              "encoder_forwards": eng.counts["encoder_forwards"]})
    finally:
        eng._generate_from_embeds = gen
    summary = {}
    for tag, name in (("A", "pipelined"), ("B", "serial")):
        ups = [r["utt_per_s"] for r in runs[tag]]
        steps_ms = [r["generate_ms_per_step"] for r in runs[tag]]
        summary[name] = {"utt_per_s": ups, "utt_per_s_mean": statistics.mean(ups),
                         "utt_per_s_spread": max(ups) - min(ups),
                         "generate_ms_per_step": steps_ms}
    emit("bulk_pipelined_vs_serial", config="llama3_hubert.yaml", order="ABBA",
         batches=BULK_AB_BATCHES, batch=32, clip_s=10, max_new_tokens=64,
         token_streams_equal=True, **summary, card=card)
    return launches, eng


def _b3_margins(torch, eng, embeds, mask, tokens, steps, cache_dtype=None):
    """Teacher-force the B3 stream ``tokens`` through prefill and decode
    steps on a bf16 cache (or ``cache_dtype``'s, where B2 decodes): per step
    the logits' argmax and top-2 margin (B, steps), the margin-aware
    contract's reference."""
    from llm_speech_summarization_tpu_torch.models.llama import init_kv_cache, llama_forward

    B, Lp, _ = embeds.shape
    cache = init_kv_cache(eng.llm_cfg, B, Lp + steps, cache_dtype or torch.bfloat16,
                          device="cuda")
    out = llama_forward(eng.llm_params, eng.llm_cfg, inputs_embeds=embeds, attn_mask=mask,
                        kv_cache=cache, cache_offset=0, last_logit_only=True)
    lens = mask.to(torch.int32).sum(1)
    pads = (Lp - lens).to(torch.int32)
    argmax, margin = [], []
    for step in range(steps):
        logits = out.logits[:, -1]
        top2 = torch.topk(logits, 2, dim=-1).values
        argmax.append(logits.argmax(-1))
        margin.append(top2[:, 0] - top2[:, 1])
        if step + 1 < steps:
            out = llama_forward(eng.llm_params, eng.llm_cfg, input_ids=tokens[:, step, None],
                                positions=(lens + step)[:, None], kv_cache=cache,
                                cache_offset=Lp + step, kv_pad_lens=pads)
    return torch.stack(argmax, 1).cpu(), torch.stack(margin, 1).float().cpu()


def phase_whisper_full(torch, card):
    """The full-width ``llama3_whisper.yaml`` batch path on a bf16 KV cache
    (Whisper-medium with dynamic frames, bf16 Llama-3.2-3B): 8 x 10 s clips
    through ``generate_audio_response_batch`` (B1 in the encoder and the
    prefill, B3 per decode step); then ``greedy_generate(attn_impl=
    "pallas")`` on the same prompts (B8 per step), its stream held to the
    B3 stream under the margin-aware contract; then a dense HTTP server on
    the same engine with 4 requests."""
    from collections import Counter

    from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
    from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference
    from llm_speech_summarization_tpu_torch.infer.generate import greedy_generate
    from llm_speech_summarization_tpu_torch.models.llama import init_kv_cache, llama_forward

    torch.cuda.reset_peak_memory_stats()
    cfg = load_config(str(YAML_DIR / "llama3_whisper.yaml"))
    cfg.model.kv_cache_dtype = "bfloat16"
    t0 = time.perf_counter()
    eng = LLMSpeechTextInference(cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    enc_layers, L = eng.encoder_setup.encoder_cfg.num_layers, eng.llm_cfg.num_layers
    rng = np.random.RandomState(0)
    clips = [(0.1 * rng.randn(160000)).astype(np.float32) for _ in range(8)]  # 8 x 10 s
    max_new = 32
    eng.generate_audio_response_batch(clips, max_new_tokens=max_new)  # warm-up
    torch.cuda.synchronize()

    # --- the main path, counted
    reset_launches()
    eng.counts.clear()
    t0 = time.perf_counter()
    texts = eng.generate_audio_response_batch(clips, max_new_tokens=max_new)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    launches = read_launches()
    counts = dict(eng.counts)
    check_launches("whisper batch path", launches, {
        "flash_attention": enc_layers * counts["encoder_forwards"] + L * counts["prefills"],
        "fused_decode_attention_write": L * counts["decode_steps"]})
    if len(texts) != 8:
        raise AssertionError("whisper_full: wrong number of responses")

    # --- breakdown of one batch, stage by stage (not counted)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embeds, mask = eng.build_audio_prompt_batch(clips)
    torch.cuda.synchronize()
    enc_ms = 1e3 * (time.perf_counter() - t0)
    B, Lp, _ = embeds.shape
    steps = 16
    cache = init_kv_cache(eng.llm_cfg, B, Lp + steps, torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = llama_forward(eng.llm_params, eng.llm_cfg, inputs_embeds=embeds, attn_mask=mask,
                        kv_cache=cache, cache_offset=0, last_logit_only=True)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    if not torch.isfinite(out.logits).all():
        raise AssertionError("whisper_full: prefill logits are not finite")
    lens = mask.to(torch.int32).sum(1)
    pads = (Lp - lens).to(torch.int32)
    tok = out.logits[:, -1].argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(1, steps):
        out = llama_forward(eng.llm_params, eng.llm_cfg, input_ids=tok[:, None],
                            positions=(lens + step - 1)[:, None], kv_cache=cache,
                            cache_offset=Lp + step - 1, kv_pad_lens=pads)
        tok = out.logits[:, 0].argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    decode_ms = 1e3 * (time.perf_counter() - t0) / (steps - 1)
    if not torch.isfinite(out.logits).all():
        raise AssertionError("whisper_full: decode logits are not finite")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9  # the batch path's

    # --- B8: greedy_generate(attn_impl="pallas") on the same prompts, counted
    gen = dict(max_new_tokens=64, eos_id=eng.tokenizer.eos_id, cache_dtype=torch.bfloat16,
               num_steps=max_new)
    tok_b3, n_b3 = greedy_generate(eng.llm_params, eng.llm_cfg, embeds, mask, **gen)
    b8_counts = Counter()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    tok_b8, n_b8 = greedy_generate(eng.llm_params, eng.llm_cfg, embeds, mask, attn_impl="pallas",
                                   counts=b8_counts, **gen)
    torch.cuda.synchronize()
    b8_s = time.perf_counter() - t0
    b8_launches = read_launches()
    check_launches("greedy_generate(attn_impl='pallas')", b8_launches, {
        "flash_attention": L * b8_counts["prefills"],
        "decode_attention": L * b8_counts["decode_steps"]})
    # the margin-aware contract: a row's B8 stream may part from its B3
    # stream only at a step where B3's top-2 margin is under 2 * LOGIT_TOL
    # (each row up to its own length: a finished row emits EOS from then on)
    n_b3, n_b8 = n_b3.tolist(), n_b8.tolist()
    argmax_b3, margins = _b3_margins(torch, eng, embeds, mask, tok_b3, max(n_b3))
    b3_host = tok_b3.cpu().long()
    if any(not torch.equal(argmax_b3[r, :n_b3[r]], b3_host[r, :n_b3[r]]) for r in range(B)):
        raise AssertionError("whisper_full: the teacher-forced B3 stream is not the B3 stream")
    parted = {}
    for r in range(B):
        n = min(n_b3[r], n_b8[r])
        diff = (tok_b8[r, :n] != tok_b3[r, :n]).nonzero()
        if not len(diff) and n_b3[r] != n_b8[r]:
            raise AssertionError(f"whisper_full: row {r} ends at {n_b8[r]} with B8, {n_b3[r]} "
                                 f"with B3, on equal tokens")
        if len(diff):
            t = int(diff[0])
            parted[r] = dict(step=t, margin=margins[r, t].item())
            if margins[r, t] > 2 * LOGIT_TOL:
                raise AssertionError(f"whisper_full: the B8 stream parts from B3's at row {r} "
                                     f"step {t}, where B3's top-2 margin is {margins[r, t]}")

    rng = np.random.RandomState(8)
    srv_clips = [(0.1 * rng.randn(int(16000 * rng.uniform(6.0, 10.0)))).astype(np.float32)
                 for _ in range(4)]
    server = _serve_burst(
        torch, card, eng, "whisper_dense",
        [("/v1/audio_summary", {"audio": c.tolist(), "max_new_tokens": 32}, False)
         for c in srv_clips],
        paged=False, n_slots=16, max_new_tokens=64, device="cuda")
    emit("whisper_full", config="llama3_whisper.yaml", kv_cache="bfloat16", batch=8,
         clip_s=10, max_new_tokens=max_new, prompt_len=Lp, init_s=init_s, batch_call_s=batch_s,
         utt_per_s=8 / batch_s, encoder_ms=enc_ms, prefill_ms=prefill_ms,
         decode_ms_per_step=decode_ms, max_memory_allocated_gb=peak_gb,
         launches=launches, engine_counts=counts,
         pallas_stream=dict(call_s=b8_s, steps=b8_counts["decode_steps"], launches=b8_launches,
                            rows_parted=parted, min_margin=margins.min().item(),
                            streams_equal=torch.equal(tok_b8, tok_b3)),
         server=dict(requests_per_s=server["requests_per_s"],
                     p50_first_token_s=server["p50_first_token_s"]), card=card)
    return [launches, b8_launches, server["launches"]]


def _http(port, path, body=None, stream=False):
    """(status, JSON body) of a GET or POST on 127.0.0.1; with ``stream``,
    (status, ndjson objects, seconds from the request to the first delta)."""
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="GET" if body is None else "POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        if not stream:
            return resp.status, json.loads(resp.read())
        objs, first = [], None
        for line in resp:
            if line.strip():
                objs.append(json.loads(line))
                if first is None and "delta" in objs[-1]:
                    first = time.perf_counter() - t0
        return resp.status, objs, first


def _serve_burst(torch, card, eng, name, requests, **server_kw):
    """Start a server on an ephemeral port, warm it with one request, set
    every launch count to 0, send ``requests`` ((path, body, stream)
    tuples) at once, read /metrics, drain, and check the launches against
    the decoder's and engine's own counts."""
    import threading

    from llm_speech_summarization_tpu_torch.serve.server import SummarizationServer

    srv = SummarizationServer(eng, host="127.0.0.1", port=0, continuous=True, **server_kw)
    srv.start_background()
    try:
        status, _ = _http(srv.port, "/v1/text_response", {"text": "warm up", "max_new_tokens": 2})
        if status != 200:
            raise AssertionError(f"{name}: warm-up request failed with {status}")
        dec = srv.batcher.decoder
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        eng.counts.clear()
        dec.counts.clear()
        srv.batcher.chunk_seconds, srv.batcher.chunk_steps_run = 0.0, 0
        srv.batcher.first_token_s.clear()
        results = [None] * len(requests)

        def send(i, path, body, stream):
            results[i] = _http(srv.port, path, body, stream)

        threads = [threading.Thread(target=send, args=(i, *r)) for i, r in enumerate(requests)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        launches = read_launches()
        counts, eng_counts = dict(dec.counts), dict(eng.counts)
        _, metrics = _http(srv.port, "/metrics")
    finally:
        drained = srv.drain(timeout=60)
    if not drained:
        raise AssertionError(f"{name}: the server did not drain")
    for (path, body, stream), res in zip(requests, results):
        if res is None or res[0] != 200:
            raise AssertionError(f"{name}: a request to {path} failed: {res}")
        final = res[1][-1] if stream else res[1]
        if not isinstance(final.get("response"), str):
            raise AssertionError(f"{name}: no response in {final}")
        if stream and "".join(o.get("delta", "") for o in res[1][:-1]) != final["response"]:
            raise AssertionError(f"{name}: streamed deltas do not add up to the response")
    L = eng.llm_cfg.num_layers
    enc_layers = eng.encoder_setup.encoder_cfg.num_layers
    paged = server_kw.get("paged", False)
    steps, rounds = counts.get("steps", 0), counts.get("spec_rounds", 0)
    # a dense step: B2 over an int8 cache, B3 over a float one; a float32
    # engine prefills with B1's float32 instance and decodes with the
    # instances of its norms' dtype over its cache (decode_suffix)
    f32 = "_f32" if eng.dtype == torch.float32 else ""
    dec = decode_suffix(torch, eng)
    dense = "fused_decode" if eng.cache_dtype == torch.int8 else "fused_decode_attention_write"
    check_launches(name, launches, {
        "flash_attention" + f32: L * counts.get("prefills", 0)
        + enc_layers * eng_counts.get("encoder_forwards", 0),
        dense + dec: 0 if paged else L * (steps + rounds),
        "paged_attention" + dec: L * rounds if paged else 0,
        "fused_paged" + dec: L * steps if paged else 0})
    firsts = sorted(r[2] for (_, _, stream), r in zip(requests, results)
                    if stream and r[2] is not None)
    out = dict(requests=len(requests), wall_s=wall, requests_per_s=len(requests) / wall,
               p50_first_delta_s=statistics.median(firsts) if firsts else None,
               p50_first_token_s=metrics.get("first_token_s_p50"),
               decode_ms_per_step=metrics.get("decode_ms_per_step"),
               chunks=metrics.get("batches_run"),
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches, decoder_counts=counts, engine_counts=eng_counts,
               server_kw={k: v for k, v in server_kw.items() if k != "device"})
    emit("serving_full", name=name, **out, card=card)
    return out


def phase_serving_full(torch, card, eng):
    """The full-width serving path on ``llama3_hubert.yaml``: 12 concurrent
    6-10 s audio requests (two streamed, two sampled with fixed seeds) and
    one text request on the paged int8 cache; 4 greedy requests with
    speculative chunks (spec_k=3); 4 on the dense cache."""
    rng = np.random.RandomState(7)
    clips = [(0.1 * rng.randn(int(16000 * rng.uniform(6.0, 10.0)))).astype(np.float32)
             for _ in range(12)]

    def audio(i, **extra):
        return ("/v1/audio_summary", {"audio": clips[i].tolist(), "max_new_tokens": 32, **extra},
                bool(extra.get("stream")))

    burst = [audio(0, stream=True), audio(1, stream=True),
             audio(2, temperature=0.8, top_k=50, seed=11),
             audio(3, temperature=0.8, top_p=0.9, seed=12)]
    burst += [audio(i) for i in range(4, 12)]
    burst.append(("/v1/text_response", {"text": "Summarize the call in one line.",
                                        "max_new_tokens": 32}, False))
    common = dict(n_slots=16, max_new_tokens=64, device="cuda")
    runs = {
        "paged": _serve_burst(torch, card, eng, "paged", burst, paged=True, **common),
        "paged_spec3": _serve_burst(torch, card, eng, "paged_spec3",
                                    [audio(i) for i in range(4)], paged=True, spec_k=3,
                                    **common),
        "dense": _serve_burst(torch, card, eng, "dense", [audio(i) for i in range(4)],
                              paged=False, **common),
    }
    if runs["paged"]["launches"]["fused_paged"] == 0:
        raise AssertionError("serving: the paged path never launched B5")
    if runs["paged_spec3"]["launches"]["paged_attention"] == 0:
        raise AssertionError("serving: the speculative paged path never launched B4")
    return runs


# f32_full: the near-tie of the margin-aware contract between the float32
# engine's greedy stream and the same engine with every attention on its
# plain version (teacher-forced on the kernel stream, both in float32; a
# token may differ only where the plain top-2 margin is under twice this).
# The float32 decode instances sit at 0.4-2% of their 2e-5-relative output
# bound (phase_decode_f32): over a float32 cache the two paths' logits
# differed by 5.5e-5 on an NVIDIA H100, over the int8 cache by 1.4e-3, where a
# value the two paths compute a hair apart lands on the other side of an
# int8 rounding step of the cache quantizer
F32_LOGIT_TOL = 5e-3
F32_FULL_NEW = 32  # new tokens of the int8-cache batch; the float32-cache batch takes half
F32_FULL_YAML = "llama3_hubert.yaml"


def _float32_tree(tree):
    """A copy of a parameter tree with every float leaf but the int8
    weights' bf16 scales in float32: the tree a ``param_dtype: float32``
    engine holds (its norms, an unquantized encoder), on the same values."""
    if isinstance(tree, dict):
        return {k: (v if k.endswith("_scale") else _float32_tree(v)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_float32_tree(v) for v in tree]
    return tree.float() if tree.is_floating_point() else tree


def _forced_logits(torch, eng, embeds, mask, tokens, steps):
    """float32 logits (B, steps, V) of the streams ``tokens`` (B, steps)
    teacher-forced through the prefill and steps - 1 decode steps on a
    fresh cache of the engine's cache dtype."""
    from llm_speech_summarization_tpu_torch.models.llama import init_kv_cache, llama_forward

    B, Lp, _ = embeds.shape
    cache = init_kv_cache(eng.llm_cfg, B, Lp + steps, eng.cache_dtype, device=embeds.device)
    out = llama_forward(eng.llm_params, eng.llm_cfg, inputs_embeds=embeds, attn_mask=mask,
                        kv_cache=cache, cache_offset=0, last_logit_only=True)
    lens = mask.to(torch.int32).sum(1)
    pads = (Lp - lens).to(torch.int32)
    logits = [out.logits[:, -1]]
    for step in range(steps - 1):
        out = llama_forward(eng.llm_params, eng.llm_cfg, input_ids=tokens[:, step, None],
                            positions=(lens + step)[:, None], kv_cache=cache,
                            cache_offset=Lp + step, kv_pad_lens=pads)
        logits.append(out.logits[:, 0])
    return torch.stack(logits, 1)


def _f32_batch_held(torch, eng, clips, max_new, what, tol=F32_LOGIT_TOL):
    """The batch path of an engine at compute_dtype float32 on ``clips``,
    counted: B1's float32 instance in the encoder and the prefill, B2 (int8
    cache) or B3 (float32 cache) per decode step in the instance of the
    engine's norms' dtype (``decode_suffix``: float32, or the mixed one for
    bf16 norms over a float32 cache), nothing else; then its greedy rows
    teacher-forced through the kernels (which must give the same rows) and
    through the plain attention, the rows held to the latter under the
    margin-aware contract (a row may differ only where the plain top-2
    margin is under 2 * ``tol``). Returns the phase's numbers."""
    from llm_speech_summarization_tpu_torch.utils.tokenizer import ByteTokenizer

    eng.generate_audio_response_batch(clips, max_new_tokens=max_new)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    eng.counts.clear()
    with recorded_tokens(ByteTokenizer) as rows:
        t0 = time.perf_counter()
        texts = eng.generate_audio_response_batch(clips, max_new_tokens=max_new)
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
    launches, counts = read_launches(), dict(eng.counts)
    L, enc_layers = eng.llm_cfg.num_layers, eng.encoder_setup.encoder_cfg.num_layers
    dense = ("fused_decode" if eng.cache_dtype == torch.int8 else
             "fused_decode_attention_write") + decode_suffix(torch, eng)
    check_launches(what, launches, {
        "flash_attention_f32": enc_layers * counts["encoder_forwards"]
        + L * counts["prefills"], dense: L * counts["decode_steps"]})
    if len(texts) != len(clips) or len(rows) != len(clips):
        raise AssertionError(f"{what}: wrong number of responses")
    embeds, mask = eng.build_audio_prompt_batch(clips)
    if embeds.dtype != torch.float32:
        raise AssertionError(f"{what}: the prompt is {embeds.dtype}")
    B, eos = embeds.shape[0], eng.tokenizer.eos_id
    n = [len(r) for r in rows]
    forced = torch.full((B, max_new), eos, dtype=torch.int32, device=embeds.device)
    for r, row in enumerate(rows):
        forced[r, :len(row)] = torch.tensor(row, dtype=torch.int32)
    got = _forced_logits(torch, eng, embeds, mask, forced, max_new)
    with plain_attention():
        plain = _forced_logits(torch, eng, embeds, mask, forced, max_new)
    if not (torch.isfinite(got).all() and torch.isfinite(plain).all()):
        raise AssertionError(f"{what}: logits are not finite")
    k_arg, p_arg = got.argmax(-1).cpu(), plain.argmax(-1).cpu()
    top2 = torch.topk(plain, 2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).cpu()
    delta = max((got[r, :n[r]] - plain[r, :n[r]]).abs().max().item() for r in range(B))
    parted = {}
    for r in range(B):
        if k_arg[r, :n[r]].tolist() != rows[r]:
            raise AssertionError(f"{what}: row {r} teacher-forced through the kernels is not "
                                 f"the batch path's stream")
        for t in (k_arg[r, :n[r]] != p_arg[r, :n[r]]).nonzero().flatten().tolist():
            parted.setdefault(r, []).append(dict(step=t, margin=margin[r, t].item()))
            if margin[r, t] > 2 * tol:
                raise AssertionError(f"{what}: row {r} step {t}: the kernels pick another token "
                                     f"than the plain attention where its top-2 margin is "
                                     f"{margin[r, t].item()}")
    return dict(batch=len(clips), max_new_tokens=max_new, prompt_len=embeds.shape[1],
                batch_call_s=batch_s, utt_per_s=len(clips) / batch_s, launches=launches,
                engine_counts=counts, rows=rows, plain_margin=margin,
                max_logit_delta_vs_plain=delta, rows_parting_from_plain=parted,
                min_plain_margin=min(margin[r, :n[r]].min().item() for r in range(B)))


def _held_to_rows(rows, got, margins, what, tol):
    """Each row of ``got`` equal to the same row of ``rows`` or parting
    only at a step where ``margins`` (the plain attention's top-2 margin on
    ``rows``' stream) is at most 2 * ``tol``; returns {row: parting}."""
    parted = {}
    for r, row in enumerate(got):
        want = rows[r]
        t = next((j for j, (x, y) in enumerate(zip(row, want)) if x != y), None)
        if t is None:
            if len(row) != len(want):
                raise AssertionError(f"{what}: row {r} ends at {len(row)}, the batch row at "
                                     f"{len(want)}, on equal tokens")
            continue
        parted[r] = dict(step=t, margin=margins[r, t].item())
        if parted[r]["margin"] > 2 * tol:
            raise AssertionError(f"{what}: row {r} parts from the batch row at step {t}, where "
                                 f"the plain top-2 margin is {parted[r]['margin']}")
    return parted


def phase_f32_full(torch, card, eng):
    """``llama3_hubert.yaml`` at ``compute_dtype: float32`` on the card, on
    the weights of the bf16 engine ``eng`` (its int8 LLM and bf16 scales,
    its norms and HuBERT-large in float32, as a ``param_dtype: float32``
    engine holds them: the JAX engine's decode steps run in the norms'
    dtype, so float32 serving needs float32 parameters), the config built
    as a dict through ``load_config``: (a) the batch path, B=8 x 10 s,
    F32_FULL_NEW new tokens, over the published int8 cache (B1 float32 in
    the encoder and the prefill, B2 float32 per step); (b) a shorter batch
    with ``kv_cache_dtype`` null, a float32 cache (B3 float32), each held
    to the plain attention (``_f32_batch_held``), and ``greedy_generate(
    attn_impl="pallas")`` on its prompts (B8 float32), held to its B3
    rows; (c) a paged server with
    speculative chunks: a burst of 8 audio requests, two sampled with fewer
    new tokens, whose launches show B4 and B5 at float32; (d) the tokens in
    which (a) differs from the bf16 engine's batch path, for information."""
    from collections import Counter

    from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
    from llm_speech_summarization_tpu_torch.configs.config import config_to_dict
    from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference
    from llm_speech_summarization_tpu_torch.infer.generate import greedy_generate
    from llm_speech_summarization_tpu_torch.utils.tokenizer import ByteTokenizer

    t_phase = time.perf_counter()
    raw = config_to_dict(load_config(str(YAML_DIR / F32_FULL_YAML)))
    raw["model"].update(compute_dtype="float32", param_dtype="float32")
    llm32 = _float32_tree(eng.llm_params)
    enc32 = _float32_tree(eng.audio_encoder_params)

    def engine(kv_cache_dtype):
        cfg = dict(raw, model=dict(raw["model"], kv_cache_dtype=kv_cache_dtype))
        return LLMSpeechTextInference(load_config(cfg), llm_params=llm32,
                                      audio_encoder_params=enc32, device=eng.device)

    torch.cuda.reset_peak_memory_stats()
    eng32 = engine("int8")
    rng = np.random.RandomState(0)
    clips = [(0.1 * rng.randn(160000)).astype(np.float32) for _ in range(8)]  # 8 x 10 s
    int8_run = _f32_batch_held(torch, eng32, clips, F32_FULL_NEW, "f32_full int8 cache")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    eng_fc = engine(None)
    f32_run = _f32_batch_held(torch, eng_fc, clips, F32_FULL_NEW // 2,
                              "f32_full float32 cache")

    # B8 at float32: greedy_generate(attn_impl="pallas") on the same
    # prompts over a float32 cache, counted, its rows held to the B3 rows
    # margin-aware (the plain attention's margins on B3's stream)
    embeds, mask = eng_fc.build_audio_prompt_batch(clips)
    b8_counts = Counter()
    reset_launches()
    tok8, n8 = greedy_generate(eng_fc.llm_params, eng_fc.llm_cfg, embeds, mask,
                               max_new_tokens=64, eos_id=eng_fc.tokenizer.eos_id,
                               cache_dtype=torch.float32, num_steps=F32_FULL_NEW // 2,
                               attn_impl="pallas", counts=b8_counts)
    b8_launches = read_launches()
    L = eng_fc.llm_cfg.num_layers
    check_launches("f32_full attn_impl='pallas'", b8_launches, {
        "flash_attention_f32": L * b8_counts["prefills"],
        "decode_attention_f32": L * b8_counts["decode_steps"]})
    b8_parted = _held_to_rows(f32_run["rows"],
                              [tok8[r, :int(n8[r])].tolist() for r in range(len(clips))],
                              f32_run["plain_margin"], "f32_full attn_impl='pallas'",
                              F32_LOGIT_TOL)

    srv_rng = np.random.RandomState(9)
    srv_clips = [(0.1 * srv_rng.randn(int(16000 * srv_rng.uniform(6.0, 10.0))))
                 .astype(np.float32) for _ in range(8)]
    burst = [("/v1/audio_summary", {"audio": c.tolist(), "max_new_tokens": 32}, False)
             for c in srv_clips[:6]]
    burst += [("/v1/audio_summary", {"audio": c.tolist(), "max_new_tokens": 8,
                                     "temperature": 0.8, "seed": 20 + i}, False)
              for i, c in enumerate(srv_clips[6:])]
    server = _serve_burst(torch, card, eng32, "f32_paged_spec3", burst, paged=True, spec_k=3,
                          n_slots=16, max_new_tokens=64, device=eng.device.type)
    if not (server["launches"]["paged_attention_f32"] and server["launches"]["fused_paged_f32"]):
        raise AssertionError(f"f32_full: the paged server did not launch both B4 and B5 at "
                             f"float32: {server['launches']}")

    # for information: the tokens in which the float32 rows differ from the
    # bf16 engine's on the same clips and weights
    with recorded_tokens(ByteTokenizer) as bf16_rows:
        eng.generate_audio_response_batch(clips, max_new_tokens=F32_FULL_NEW)
    differ = [sum(a != b for a, b in zip(r32, r16)) + abs(len(r32) - len(r16))
              for r32, r16 in zip(int8_run.pop("rows"), bf16_rows)]
    for run in (int8_run, f32_run):
        run.pop("plain_margin")
        run.pop("rows", None)
    emit("f32_full", config="llama3_hubert.yaml compute_dtype float32 (param_dtype float32: "
         "the bf16 engine's int8 LLM, float32 norms and HuBERT-large)", clip_s=10,
         int8_cache=int8_run, float32_cache=f32_run, max_memory_allocated_gb=peak_gb,
         logit_tol=F32_LOGIT_TOL,
         pallas_stream=dict(steps=b8_counts["decode_steps"], launches=b8_launches,
                            rows_parted=b8_parted),
         server=dict(requests_per_s=server["requests_per_s"],
                     p50_first_token_s=server["p50_first_token_s"],
                     decode_ms_per_step=server["decode_ms_per_step"],
                     launches=server["launches"], decoder_counts=server["decoder_counts"]),
         tokens_differing_from_bf16_engine=differ, phase_s=time.perf_counter() - t_phase,
         card=card)
    return [int8_run["launches"], f32_run["launches"], b8_launches, server["launches"]]


# mixed_full: llama3_hubert.yaml at compute_dtype float32 and kv_cache_dtype
# null with its published bf16 parameters, so the prefill (float32) fills a
# float32 cache and the decode steps run in the norms' bf16 over it (the
# mixed instances). The rows are held to the plain attention's under the
# margin-aware contract at the bf16 tolerance: the decode runs in bf16
MIXED_LOGIT_TOL = LOGIT_TOL
MIXED_FULL_NEW = 16  # new tokens of the batch path, the B8 stream and the spec engine
MIXED_SPEC_CLIPS = 2  # clips of the speculative engine (speculative_k=3)


def phase_mixed_full(torch, card, eng):
    """``llama3_hubert.yaml`` at ``compute_dtype: float32`` and
    ``kv_cache_dtype`` null (a float32 cache; the published int8 cache
    would decode through B2), the rest as published (bf16 parameters, the
    int8 LLM), on the trees of the bf16 engine ``eng`` (no float32
    copy: the parameters stay bf16, as the JAX engine keeps them): (a) the
    batch path, B=8 x 10 s, MIXED_FULL_NEW new tokens (B1 float32 in the
    encoder and the prefill, B3's mixed instance per decode step), held to
    the plain attention (``_f32_batch_held`` at MIXED_LOGIT_TOL); (b)
    ``greedy_generate(attn_impl="pallas")`` on its prompts (B8's mixed
    instance), held to the batch rows; (c) the engine with
    ``speculative_k=3`` on MIXED_SPEC_CLIPS clips (B3's mixed instance at T
    = 4), held to their batch rows; (d) a paged server with speculative
    chunks, a burst of 8 audio requests, two sampled with fewer new tokens
    (B4's and B5's mixed instances)."""
    from collections import Counter

    from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
    from llm_speech_summarization_tpu_torch.configs.config import config_to_dict
    from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference
    from llm_speech_summarization_tpu_torch.infer.generate import greedy_generate
    from llm_speech_summarization_tpu_torch.utils.tokenizer import ByteTokenizer

    t_phase = time.perf_counter()
    marks = {}

    def mark(stage):
        marks[stage] = round(time.perf_counter() - t_phase, 3)

    raw = config_to_dict(load_config(str(YAML_DIR / "llama3_hubert.yaml")))
    if raw["model"]["param_dtype"] != "bfloat16" or raw["model"]["llm_weight_dtype"] != "int8":
        raise AssertionError(f"mixed_full: llama3_hubert.yaml is not the published config: "
                             f"{raw['model']}")
    raw["model"].update(compute_dtype="float32", kv_cache_dtype=None)

    def engine(**kw):
        return LLMSpeechTextInference(load_config(raw), llm_params=eng.llm_params,
                                      audio_encoder_params=eng.audio_encoder_params,
                                      device=eng.device, **kw)

    torch.cuda.reset_peak_memory_stats()
    emx = engine()
    if emx.cache_dtype != torch.float32 or emx.llm_params["final_norm"].dtype != torch.bfloat16 \
            or decode_suffix(torch, emx) != "_mixed":
        raise AssertionError(f"mixed_full: the engine decodes in {emx.llm_params['final_norm'].dtype} "
                             f"over a {emx.cache_dtype} cache")
    rng = np.random.RandomState(0)
    clips = [(0.1 * rng.randn(160000)).astype(np.float32) for _ in range(8)]  # 8 x 10 s
    run = _f32_batch_held(torch, emx, clips, MIXED_FULL_NEW, "mixed_full batch",
                          tol=MIXED_LOGIT_TOL)
    rows, margins = run.pop("rows"), run.pop("plain_margin")
    mark("batch")

    # B8's mixed instance: greedy_generate(attn_impl="pallas") on the same
    # prompts over a float32 cache, held to the batch rows margin-aware
    embeds, mask = emx.build_audio_prompt_batch(clips)
    b8_counts = Counter()
    reset_launches()
    tok8, n8 = greedy_generate(emx.llm_params, emx.llm_cfg, embeds, mask, max_new_tokens=64,
                               eos_id=emx.tokenizer.eos_id, cache_dtype=torch.float32,
                               num_steps=MIXED_FULL_NEW, attn_impl="pallas", counts=b8_counts)
    b8_launches = read_launches()
    L, enc_layers = emx.llm_cfg.num_layers, emx.encoder_setup.encoder_cfg.num_layers
    check_launches("mixed_full attn_impl='pallas'", b8_launches, {
        "flash_attention_f32": L * b8_counts["prefills"],
        "decode_attention_mixed": L * b8_counts["decode_steps"]})
    b8_parted = _held_to_rows(rows, [tok8[r, :int(n8[r])].tolist() for r in range(len(clips))],
                              margins, "mixed_full attn_impl='pallas'", MIXED_LOGIT_TOL)
    mark("pallas")

    # B3's mixed instance at T = k + 1 = 4: the speculative engine
    spec = engine(speculative_k=3)
    spec_clips = clips[:MIXED_SPEC_CLIPS]
    spec.generate_audio_response_batch(spec_clips, max_new_tokens=MIXED_FULL_NEW)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    spec.counts.clear()
    with recorded_tokens(ByteTokenizer) as spec_rows:
        t0 = time.perf_counter()
        spec.generate_audio_response_batch(spec_clips, max_new_tokens=MIXED_FULL_NEW)
        torch.cuda.synchronize()
        spec_s = time.perf_counter() - t0
    spec_launches, spec_counts = read_launches(), dict(spec.counts)
    check_launches("mixed_full speculative_k=3", spec_launches, {
        "flash_attention_f32": enc_layers * spec_counts["encoder_forwards"]
        + L * spec_counts["prefills"],
        "fused_decode_attention_write_mixed": L * spec_counts["spec_rounds"]})
    if not spec_counts.get("spec_rounds"):
        raise AssertionError("mixed_full: the speculative engine ran no verification round")
    spec_parted = _held_to_rows(rows, spec_rows, margins, "mixed_full speculative_k=3",
                                MIXED_LOGIT_TOL)
    del spec
    mark("speculative")

    srv_rng = np.random.RandomState(9)
    srv_clips = [(0.1 * srv_rng.randn(int(16000 * srv_rng.uniform(6.0, 10.0))))
                 .astype(np.float32) for _ in range(8)]
    burst = [("/v1/audio_summary", {"audio": c.tolist(), "max_new_tokens": 32}, False)
             for c in srv_clips[:6]]
    burst += [("/v1/audio_summary", {"audio": c.tolist(), "max_new_tokens": 8,
                                     "temperature": 0.8, "seed": 20 + i}, False)
              for i, c in enumerate(srv_clips[6:])]
    server = _serve_burst(torch, card, emx, "mixed_paged_spec3", burst, paged=True, spec_k=3,
                          n_slots=16, max_new_tokens=64, device=eng.device.type)
    if not (server["launches"]["paged_attention_mixed"]
            and server["launches"]["fused_paged_mixed"]):
        raise AssertionError(f"mixed_full: the paged server did not launch both B4 and B5's "
                             f"mixed instances: {server['launches']}")
    mark("server")
    emit("mixed_full", config="llama3_hubert.yaml at compute_dtype float32 (param_dtype "
         "bfloat16, llm_weight_dtype int8 as published; kv_cache_dtype null: a float32 cache; "
         "decode steps in bf16)", clip_s=10, batch=run, logit_tol=MIXED_LOGIT_TOL,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         pallas_stream=dict(steps=b8_counts["decode_steps"], launches=b8_launches,
                            rows_parted=b8_parted),
         speculative=dict(clips=len(spec_clips), k=3, batch_call_s=spec_s,
                          utt_per_s=len(spec_clips) / spec_s, launches=spec_launches,
                          engine_counts=spec_counts, rows_parted=spec_parted),
         server=dict(requests_per_s=server["requests_per_s"],
                     p50_first_token_s=server["p50_first_token_s"],
                     decode_ms_per_step=server["decode_ms_per_step"],
                     max_memory_allocated_gb=server["max_memory_allocated_gb"],
                     launches=server["launches"], decoder_counts=server["decoder_counts"]),
         marks=marks, phase_s=time.perf_counter() - t_phase, card=card)
    del emx
    return [run["launches"], b8_launches, spec_launches, server["launches"]]


TP_RANKS = 2
# serving_tp_full's Llama-3.2-3B blocks (HuBERT-large as published): each
# block's two all-reduces a decode step are staged through the host, 178 ms
# a step at the published 28 blocks against 44 ms unsharded (NVIDIA H100
# 80GB HBM3, 700 W), a correctness path on one card
TP_SERVE_LAYERS = 8
TP_TIMEOUT_S = 600  # the one launch of the ranks (batch path and both servers)
TP_MAX_NEW = 32
TP_PORT_WAIT_S = 300  # rank 0's engine init at full width, before it serves
TP_TOPK = 8  # the rank's top logits per row and step, compared teacher-forced
# the model group's logits against the unsharded engine in the group's
# arithmetic (``tp_rounding``), teacher-forced on the group's tokens: where
# both launch the decode kernels alike, equal but for the float32 head
# product of another shape (TP_EXACT_TOL); where the rank's smaller grid
# takes another split or warp count of the window (``dense_splits``, the
# 16-warp instance), the attention's float32 sums are reordered and 28
# random-weight layers amplify that: at most TP_NOISE_TOL, twice the bf16
# CPU-vs-card LOGIT_TOL. Rows may part only where the reference's top-2
# margin is at most twice the largest difference measured in the call
TP_EXACT_TOL = 1e-4
TP_NOISE_TOL = 4 * LOGIT_TOL


@contextlib.contextmanager
def tp_rounding(cfg, parts=TP_RANKS):
    """The unsharded forward in the model group's arithmetic: every weight
    product taken as the ``parts`` ranks take it, over each rank's columns
    (``wq``/``wk``/``wv``/``w_gate``/``w_up``, and the fused ``wqkv`` and
    ``w_gateup`` as [its q | k | v] and [its gate | up], each one product
    of the rank's shape) or each rank's slice of the in axis (``wo``,
    ``w_down``: the products rounded to the activation dtype, scaled, then
    summed in it, as the ranks' all-reduce sums them); and the decode
    kernels split each window as a rank's Hkv/parts heads make them
    (``dense_splits``). A GEMM of another shape, or another split of the
    window, accumulates in another order, and 28 random-weight layers
    amplify a bf16 rounding: this is the reference the group is held to
    under LOGIT_TOL, the unsharded engine itself the one it is compared
    with."""
    import torch

    from llm_speech_summarization_tpu_torch.kernels import fused_decode as fd_mod
    from llm_speech_summarization_tpu_torch.models import llama

    mm, rule = llama._mm, fd_mod.dense_splits
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    inter = cfg.intermediate_size
    columns = {"wq": [q], "wk": [kv], "wv": [kv], "wqkv": [q, kv, kv], "w_gate": [inter],
               "w_up": [inter], "w_gateup": [inter, inter]}

    def rank_cols(x, widths, r):
        return torch.cat([p[..., r * (w // parts):(r + 1) * (w // parts)]
                          for p, w in zip(x.split(widths, dim=-1), widths)], -1).contiguous()

    def split_mm(h, lp, name):
        scale = lp.get(name + "_scale")
        if name in ("wo", "w_down"):
            K = h.shape[-1] // parts
            out = None
            for r in range(parts):
                sub = {name: lp[name][r * K:(r + 1) * K].contiguous(), name + "_scale": scale}
                part = mm(h[..., r * K:(r + 1) * K], sub, name)
                out = part if out is None else out + part
            return out
        widths = columns[name]
        outs = [mm(h, {name: rank_cols(lp[name], widths, r), name + "_scale":
                       None if scale is None else rank_cols(scale, widths, r)}, name)
                for r in range(parts)]
        # back to the full layout: each segment's columns in rank order
        pieces = [o.split([w // parts for w in widths], dim=-1) for o in outs]
        return torch.cat([pieces[r][j] for j in range(len(widths)) for r in range(parts)], -1)

    llama._mm = split_mm
    fd_mod.dense_splits = lambda B, Hkv, max_offset, sms: rule(B, Hkv // parts, max_offset, sms)
    try:
        yield
    finally:
        llama._mm, fd_mod.dense_splits = mm, rule


def _tp_clips(seed, lengths):
    rng = np.random.RandomState(seed)
    return [(0.1 * rng.randn(n)).astype(np.float32) for n in lengths]


def _tp_batch_clips():
    return _tp_clips(21, [160000] * 8)  # 8 x 10 s, the batch path's shape


def _tp_burst_clips():
    # 6-10 s, every length its own: rank 0 keys each request's row by it
    return _tp_clips(22, [96000 + 8000 * i for i in range(8)])


def tp_rank(report_dir: str, mode: str, cli_args) -> int:
    """One rank of serving_tp_full, started by ``_tp_launch``: the stages of
    one launch on one engine build. First ``batch``: the tensor-parallel
    engine on ``llama3_hubert.yaml`` (a mesh with a model group of every
    rank), one warm-up and one counted ``generate_audio_response_batch``
    over ``_tp_batch_clips``; then one server stage for each part of
    ``cli_args`` (split at "--then", named by ``mode``'s comma-separated
    names): ``cli/serve.py`` with those arguments on the same engine
    (SIGTERM to rank 0 drains the server, and the ranks go on to the next
    stage). Each rank writes ``report_dir/<stage>_rank<r>.json`` at the end
    of each stage: its launch counts, the engine's and decoder's counts, the
    host-staged exchanges and wall of every decode step (batch) or decode
    chunk (serve), the token rows (per request on rank 0 of the server: its
    clip length or text, its row, its time to first token), the stage's
    seconds and peak memory, and the peak memory after the engine was
    built.
    ``transformers`` is kept from importing, as in ``train_rank``: offline
    with no local HF tokenizer ``load_tokenizer`` falls back to bytes
    either way (the unsharded engine it is compared with too), and the
    import alone took ~20 s a process on the card's host."""
    sys.modules["transformers"] = None  # `import transformers` raises ImportError
    import threading

    import torch

    from llm_speech_summarization_tpu_torch.infer import generate
    from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference
    from llm_speech_summarization_tpu_torch.infer.slots import SlotDecoder
    from llm_speech_summarization_tpu_torch.parallel.comm import COMM_STATS
    from llm_speech_summarization_tpu_torch.serve import server as server_mod
    from llm_speech_summarization_tpu_torch.utils.tokenizer import ByteTokenizer

    rank = int(os.environ["RANK"])
    patches = contextlib.ExitStack()  # open for the rank's whole run
    patches.enter_context(_shallow(TP_SERVE_LAYERS, encoder=False))
    seen = {"decoders": []}
    report = {"rank": rank, "mode": "batch", "steps": [], "chunks": [], "requests": [],
              "warm_cuda_s": _WARM_S}

    def staged():
        return COMM_STATS["calls"], COMM_STATS["bytes"], COMM_STATS["ms"]

    def delta(before):
        return [a - b for a, b in zip(staged(), before)]

    engine_init = LLMSpeechTextInference.__init__

    def counted_engine_init(self, *a, **kw):
        engine_init(self, *a, **kw)
        torch.cuda.synchronize()
        report["init_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        seen["engine"] = self
        report["backend"] = torch.distributed.get_backend()  # the CLI leaves its group

    decoder_init, decode_chunk = SlotDecoder.__init__, SlotDecoder.decode_chunk
    harvest = SlotDecoder.harvest
    report["harvested"] = []

    def recorded_harvest(self, flags=None):
        got = harvest(self, flags)
        report["harvested"].extend([int(t) for t in tok[:n]] for _, tok, n in got)
        return got

    def counted_decoder_init(self, *a, **kw):
        decoder_init(self, *a, **kw)
        seen["decoders"].append(self)

    def timed_chunk(self, *a, **kw):
        torch.cuda.synchronize()
        t0, c0 = time.time(), staged()
        out = decode_chunk(self, *a, **kw)
        report["chunks"].append(dict(t=t0, s=time.time() - t0, steps=self.last_chunk_steps,
                                     staged=delta(c0)))
        return out

    forward = generate.llama_forward
    report["top"] = []  # per forward: the rows' TP_TOPK (ids, logits)

    def timed_forward(*a, **kw):
        prefill = kw.get("input_ids") is None
        if not prefill:
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), staged()
        out = forward(*a, **kw)
        if not prefill:
            torch.cuda.synchronize()
            report["steps"].append(dict(s=time.perf_counter() - t0, staged=delta(c0)))
        vals, ids = out.logits[:, -1].float().topk(TP_TOPK, dim=-1)
        report["top"].append([ids.tolist(), vals.tolist()])
        return out

    LLMSpeechTextInference.__init__ = counted_engine_init
    SlotDecoder.__init__, SlotDecoder.decode_chunk = counted_decoder_init, timed_chunk
    SlotDecoder.harvest = recorded_harvest
    generate.llama_forward = timed_forward
    reset_launches()
    from llm_speech_summarization_tpu_torch.cli import serve as cli
    from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
    from llm_speech_summarization_tpu_torch.infer import engine as engine_mod
    from llm_speech_summarization_tpu_torch.parallel.mesh import (
        distributed_init, mesh_from_ranks,
    )

    t_stage = time.perf_counter()

    def finish_stage(stage):
        """Write this stage's report and start the next one from zero."""
        nonlocal t_stage
        eng = seen["engine"]
        report.update(
            stage_s=time.perf_counter() - t_stage, launches=read_launches(),
            engine_counts=dict(eng.counts),
            decoder_counts=[dict(d.counts) for d in seen["decoders"]],
            peak_gb=torch.cuda.max_memory_allocated() / 1e9, llm_layers=eng.llm_cfg.num_layers,
            enc_layers=eng.encoder_setup.encoder_cfg.num_layers,
            builds_prompts=eng.builds_prompts,
            kv_heads=[int((d.state.cache.k_pool if d.paged else d.state.cache.k).shape[2])
                      for d in seen["decoders"]])
        with open(os.path.join(report_dir, f"{stage}_rank{rank}.json"), "w") as f:
            json.dump(report, f)
        for key in ("steps", "chunks", "requests", "top", "harvested"):
            report[key] = []
        report.pop("rows", None)
        report["mode"] = "serve"
        seen["decoders"] = []
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        eng.counts.clear()
        t_stage = time.perf_counter()

    distributed_init()
    eng = LLMSpeechTextInference(load_config(str(YAML_DIR / "llama3_hubert.yaml")),
                                 mesh=mesh_from_ranks(model=TP_RANKS))
    clips = _tp_batch_clips()
    eng.generate_audio_response_batch(clips, max_new_tokens=TP_MAX_NEW)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    eng.counts.clear()
    report["steps"].clear()
    report["top"].clear()
    with recorded_tokens(ByteTokenizer) as rows:
        t0 = time.perf_counter()
        eng.generate_audio_response_batch(clips, max_new_tokens=TP_MAX_NEW)
        torch.cuda.synchronize()
        report["batch_s"] = time.perf_counter() - t0
    report["rows"] = [[int(t) for t in r] for r in rows]
    finish_stage("batch")

    # the servers on the same engine: cli/serve.py builds none (it is handed
    # this one) and leaves the group only after the last stage
    # rank 0: each request's row, keyed by its payload, and its TTFT
    last = threading.local()
    decode = ByteTokenizer.decode

    def recorded_decode(self, ids, *a, **kw):
        last.ids = [int(i) for i in ids]
        return decode(self, ids, *a, **kw)

    def recorded_setattr(self, name, value):
        if name == "result" and getattr(last, "ids", None) is not None:
            ttft = (self.t_first_token - self.t_submit) if self.t_first_token else None
            report["requests"].append(dict(
                key=len(self.payload) if self.kind == "audio" else self.payload,
                row=last.ids, ttft_s=ttft))
            last.ids = None
        object.__setattr__(self, name, value)

    ByteTokenizer.decode = recorded_decode
    server_mod._Request.__setattr__ = recorded_setattr
    engine_mod.LLMSpeechTextInference = lambda *a, **kw: eng
    leave = torch.distributed.destroy_process_group
    torch.distributed.destroy_process_group = lambda *a, **kw: None
    servers, args = [], []
    for a in [*cli_args, "--then"]:
        if a == "--then":
            servers.append(args)
            args = []
        else:
            args.append(a)
    try:
        for stage, server_args in zip(mode.split(","), servers):
            cli.main(server_args)
            finish_stage(stage)
    finally:
        torch.distributed.destroy_process_group = leave
        leave()
    return 0


def _tp_launch(report_dir, servers):
    """Run the TP_RANKS ranks of ``tp_rank`` (started by ``_start_ranks``;
    the CLI picks gloo: the ranks share the card), one launch: the batch
    stage, then a server stage for each of ``servers`` ((name, cli args,
    port, drive), ``drive`` a function of the port): each ``drive`` runs
    once rank 0 answers /healthz on its port, then SIGTERM drains rank 0
    and the ranks go on to the next stage. Every process is killed past
    TP_TIMEOUT_S; a nonzero exit fails the phase. Returns the ranks'
    reports by stage, the launch's wall seconds, the seconds from its start
    to each server's first answer, and what each ``drive`` returned."""
    import signal

    import torch

    os.makedirs(report_dir, exist_ok=True)
    log_path = os.path.join(report_dir, "launch.log")
    t0 = time.perf_counter()
    results, serving_at = {}, {}

    def tail():
        with open(log_path) as f:
            return f.read()[-6000:]

    argv = ["--tp-rank", report_dir, ",".join(name for name, *_ in servers), "--"]
    for i, (_, cli_args, _, _) in enumerate(servers):
        argv += (["--then"] if i else []) + list(cli_args)
    with open(log_path, "w") as log:
        procs, store = _start_ranks(torch, TP_RANKS, argv, log)
        try:
            for name, _, port, drive in servers:
                deadline = time.monotonic() + TP_PORT_WAIT_S
                while True:
                    if any(p.poll() is not None for p in procs):
                        raise AssertionError(f"serving_tp_full: the ranks exited "
                                             f"{[p.poll() for p in procs]} before serving "
                                             f"{name}")
                    try:
                        if _http(port, "/healthz")[0] == 200:
                            break
                    except OSError:
                        pass
                    if time.monotonic() > deadline:
                        raise AssertionError(f"serving_tp_full: rank 0 did not serve {name} "
                                             f"within {TP_PORT_WAIT_S} s")
                    time.sleep(0.2)
                serving_at[name] = time.perf_counter() - t0
                results[name] = drive(port)
                os.kill(procs[0].pid, signal.SIGTERM)
            codes = _join_ranks(procs, time.monotonic() + TP_TIMEOUT_S - (time.perf_counter()
                                                                          - t0))
        except BaseException as e:
            _stop_ranks(procs)
            raise AssertionError(f"serving_tp_full: the launch failed ({e!r}):\n{tail()}")
        finally:
            del store
    wall = time.perf_counter() - t0
    if codes is None or any(codes):
        raise AssertionError(f"serving_tp_full: the ranks exited {codes} (None: outlived "
                             f"{TP_TIMEOUT_S} s):\n{tail()}")
    reports = {}
    for stage in ["batch"] + [name for name, *_ in servers]:
        reports[stage] = []
        for r in range(TP_RANKS):
            with open(os.path.join(report_dir, f"{stage}_rank{r}.json")) as f:
                reports[stage].append(json.load(f))
    for rep in reports["batch"]:
        if rep["backend"] != "gloo":
            raise AssertionError(f"serving_tp_full: rank {rep['rank']} ran over "
                                 f"{rep['backend']}, not gloo, with ranks that share a card")
    return reports, wall, serving_at, results


def _tp_logit_delta(torch, eng, clips, rows, top):
    """The largest |logit| difference between the model group (``top``: its
    TP_TOPK ids and logits per row at each step of ``rows``, its own greedy
    stream) and the unsharded engine teacher-forced on the same tokens over
    the same B=len(clips) prompt, on an int8 cache; per step, the rows still
    emitting."""
    from llm_speech_summarization_tpu_torch.models.llama import init_kv_cache, llama_forward

    embeds, mask = eng.build_audio_prompt_batch(clips)
    B, Lp, _ = embeds.shape
    steps = min(len(top), max(len(r) for r in rows))
    tokens = torch.full((B, steps), eng.tokenizer.eos_id, dtype=torch.int32, device="cuda")
    for b, r in enumerate(rows):
        tokens[b, :min(len(r), steps)] = torch.tensor(r[:steps], dtype=torch.int32)
    cache = init_kv_cache(eng.llm_cfg, B, Lp + steps, torch.int8, device="cuda")
    out = llama_forward(eng.llm_params, eng.llm_cfg, inputs_embeds=embeds, attn_mask=mask,
                        kv_cache=cache, cache_offset=0, last_logit_only=True)
    lens = mask.to(torch.int32).sum(1)
    pads = (Lp - lens).to(torch.int32)
    per_step = []
    for step in range(steps):
        ids = torch.tensor(top[step][0], device="cuda")[:len(clips)]
        vals = torch.tensor(top[step][1], device="cuda")[:len(clips)]
        live = torch.tensor([step < len(r) for r in rows], device="cuda")
        d = (out.logits[:len(clips), -1].float().gather(1, ids) - vals).abs().amax(1)
        per_step.append(d[live].max().item() if bool(live.any()) else 0.0)
        if step + 1 < steps:
            out = llama_forward(eng.llm_params, eng.llm_cfg, input_ids=tokens[:, step, None],
                                positions=(lens + step)[:, None], kv_cache=cache,
                                cache_offset=Lp + step, kv_pad_lens=pads)
    return per_step


def _tp_same_launch(eng, B, Lp, steps, parts=TP_RANKS):
    """Per logit step of a B-row greedy stream over a prompt of Lp tokens
    (the prefill, then decode steps at max offset Lp + s - 1): whether a
    rank's B2 launch (Hkv/parts heads) and the unsharded one under
    ``tp_rounding`` (the rank's split count) take the same instance, i.e.
    both grids fit the SMs (16 warps) or neither does."""
    from llm_speech_summarization_tpu_torch.kernels import fused_decode as fd_mod

    sms = fd_mod.sm_count(0)
    hkv = eng.llm_cfg.num_kv_heads
    same = [True]
    for s in range(1, steps):
        n = fd_mod.dense_splits(B, hkv // parts, Lp + s - 1, sms)
        same.append((B * (hkv // parts) * n <= sms) == (B * hkv * n <= sms))
    return same


def _tp_held(torch, eng, clips, got, want, what, margin_tol):
    """Each of ``got``'s token rows equal to ``want``'s, or parting only at a
    step where the reference's top-2 margin on ``want``'s stream (an int8
    cache, B2; under ``tp_rounding`` where the caller is) is at most
    ``margin_tol``. Returns {row: parting}."""
    parted = {}
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        t = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        if t >= min(len(a), len(b)):
            raise AssertionError(f"{what}: row {i} has {len(a)} tokens, the unsharded "
                                 f"engine's {len(b)}, on equal tokens")
        embeds, mask = eng.build_audio_prompt_batch([clips[i]])
        _, margins = _b3_margins(torch, eng, embeds, mask,
                                 torch.tensor([b], dtype=torch.int32, device="cuda"), t + 1,
                                 cache_dtype=torch.int8)
        parted[i] = dict(step=t, margin=margins[0, t].item())
        if margins[0, t] > margin_tol:
            raise AssertionError(f"{what}: row {i} parts from the reference's at step "
                                 f"{t}, where its top-2 margin is {margins[0, t].item()}")
    return parted


def _tp_expected_launches(rep, paged):
    """What one rank ran: B1 per LLM layer per prefill and (rank 0) per
    encoder layer per prompt; per decode step B2 (dense) or B5 (paged), per
    speculative round B2 at T = k + 1 (dense) or B4 (paged)."""
    L, enc = rep["llm_layers"], rep["enc_layers"]
    if rep["mode"] == "batch":
        c = rep["engine_counts"]
        return {"flash_attention": L * c.get("prefills", 0)
                + enc * c.get("encoder_forwards", 0),
                "fused_decode": L * c.get("decode_steps", 0)}
    dc = rep["decoder_counts"]
    prefills = sum(d.get("prefills", 0) for d in dc)
    steps = sum(d.get("steps", 0) for d in dc)
    rounds = sum(d.get("spec_rounds", 0) for d in dc)
    want = {"flash_attention": L * prefills
            + enc * rep["engine_counts"].get("encoder_forwards", 0)}
    if paged:
        want.update(fused_paged=L * steps, paged_attention=L * rounds)
    else:
        want["fused_decode"] = L * (steps + rounds)
    return want


def _per_step(entries):
    """(ms per step, host-staged calls, bytes and ms per step) over decode
    steps or chunks."""
    steps = sum(e.get("steps", 1) for e in entries) or 1
    staged = [sum(e["staged"][i] for e in entries) / steps for i in range(3)]
    return dict(ms_per_step=1e3 * sum(e["s"] for e in entries) / steps, steps=steps,
                staged_calls_per_step=staged[0], staged_bytes_per_step=staged[1],
                staged_ms_per_step=staged[2])


def phase_serving_tp_full(torch, card):
    """``llama3_hubert.yaml`` at published widths, Llama-3.2-3B cut to
    TP_SERVE_LAYERS blocks (int8 weights and cache, random weights from the
    seed), on a model group of TP_RANKS ranks sharing the card over gloo,
    each holding its shard (12 query and 4 KV heads): (a) the batch path, B=8 x 10 s, TP_MAX_NEW new tokens; (b)
    ``cli/serve.py --tp`` on the dense cache and (c) with ``--paged
    --speculative_k 3``, a burst of 8 audio requests each after one warm-up
    request. The reference is the unsharded engine ``eng``, built here at
    the same depth (the same weights: the same seed), in the group's
    arithmetic (``tp_rounding``):
    the batch path's logits on the group's tokens within TP_EXACT_TOL where
    both launch alike and TP_NOISE_TOL elsewhere, every greedy row under
    the margin-aware contract; rank 1's rows and logits equal rank 0's;
    each rank's launches equal what its engine and decoder ran; the
    unsharded engine's own batch path and servers run the same work in this
    call beside them. Every measurement is emitted before a failed check
    raises."""
    import shutil
    import socket
    import tempfile
    import threading

    from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
    from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference
    from llm_speech_summarization_tpu_torch.utils.tokenizer import ByteTokenizer

    t_phase = time.perf_counter()
    with _shallow(TP_SERVE_LAYERS, encoder=False):
        eng = LLMSpeechTextInference(load_config(str(YAML_DIR / "llama3_hubert.yaml")))
    marks, failures, out = {}, [], {}

    def mark(stage):
        marks[stage] = round(time.perf_counter() - t_phase, 3)
        print(f"serving_tp_full: {stage} at {marks[stage]} s", file=sys.stderr, flush=True)

    def check(ok, message):
        if not ok:
            failures.append(message)

    batch_clips, burst_clips = _tp_batch_clips(), _tp_burst_clips()
    with recorded_tokens(ByteTokenizer) as rows:
        eng.generate_audio_response_batch(batch_clips, max_new_tokens=TP_MAX_NEW)
    plain_batch_rows = [[int(t) for t in r] for r in rows]
    with tp_rounding(eng.llm_cfg), recorded_tokens(ByteTokenizer) as rows:
        eng.generate_audio_response_batch(batch_clips, max_new_tokens=TP_MAX_NEW)
    want_batch = [[int(t) for t in r] for r in rows]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate_audio_response_batch(batch_clips, max_new_tokens=TP_MAX_NEW)
    torch.cuda.synchronize()
    plain_batch_s = time.perf_counter() - t0
    plain_decode_ms = _stage_breakdown(torch, eng, batch_clips, "serving_tp_full")[2]
    with tp_rounding(eng.llm_cfg), recorded_tokens(ByteTokenizer) as rows:
        eng.generate_audio_response_batch(burst_clips, max_new_tokens=TP_MAX_NEW)
    want_burst = [[int(t) for t in r] for r in rows]
    mark("references")
    burst = [("/v1/audio_summary", {"audio": c.tolist(), "max_new_tokens": TP_MAX_NEW}, False)
             for c in burst_clips]
    yaml_path = str(YAML_DIR / "llama3_hubert.yaml")
    launches = {k: 0 for k in read_launches()}
    tmp = tempfile.mkdtemp(prefix="lss_tp_")
    servers = []
    for name, flags in (("dense", []), ("paged_spec3", ["--paged", "--speculative_k", "3"])):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]

        def drive(port, name=name):
            if _http(port, "/v1/text_response",
                     {"text": "warm up", "max_new_tokens": 2})[0] != 200:
                raise AssertionError(f"serving_tp_full {name}: the warm-up failed")
            results = [None] * len(burst)

            def send(i, path, body, stream):
                results[i] = _http(port, path, body, stream)

            threads = [threading.Thread(target=send, args=(i, *r)) for i, r in enumerate(burst)]
            t_start, t0 = time.time(), time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            wall = time.perf_counter() - t0
            return dict(t_start=t_start, wall=wall, results=results,
                        metrics=_http(port, "/metrics")[1])

        cli_args = ["-c", yaml_path, "--tp", str(TP_RANKS), "--host", "127.0.0.1",
                    "--port", str(port), "--no_warmup", "--scheduler", "continuous",
                    "--slots", "16", "--max_new_tokens", "64", *flags]
        servers.append((name, cli_args, port, drive))
    try:
        # one launch of the ranks and one engine build: the batch path,
        # then the dense server, then the paged one with speculative chunks
        stage_reports, wall, serving_at, runs = _tp_launch(os.path.join(tmp, "tp"), servers)
        mark("launch")
        out["launch"] = dict(wall_s=wall, serving_at_s=serving_at,
                             stage_s={stage: [rep["stage_s"] for rep in reps]
                                      for stage, reps in stage_reports.items()})
        reports = stage_reports["batch"]
        for rep in reports:
            want = {**{k: 0 for k in rep["launches"]}, **_tp_expected_launches(rep, False)}
            check(rep["launches"] == want, f"batch rank {rep['rank']}: launches "
                  f"{rep['launches']} != expected {want}")
            for k, v in rep["launches"].items():
                launches[k] += v
        check(reports[1]["rows"] == reports[0]["rows"], "batch: rank 1's rows differ")
        check(reports[1]["top"] == reports[0]["top"], "batch: rank 1's logits differ")
        rows0 = reports[0]["rows"]
        # on the model group's own tokens: its logits against the reference
        # (held) and against the unsharded engine itself (reported: what the
        # bf16 partial sums move)
        with tp_rounding(eng.llm_cfg):
            deltas = _tp_logit_delta(torch, eng, batch_clips, rows0, reports[0]["top"])
        plain_deltas = _tp_logit_delta(torch, eng, batch_clips, rows0, reports[0]["top"])
        Lp = eng.build_audio_prompt_batch(batch_clips)[0].shape[1]
        same = _tp_same_launch(eng, len(batch_clips), Lp, len(deltas))
        exact = [d for d, sm in zip(deltas, same) if sm]
        check(exact and max(exact) <= TP_EXACT_TOL,
              f"batch: logits differ by {max(exact or [0])} > {TP_EXACT_TOL} at steps that "
              f"launch alike")
        check(max(deltas) <= TP_NOISE_TOL, f"batch: logits differ by {max(deltas)} > "
              f"{TP_NOISE_TOL}")
        margin_tol = 2 * max(max(deltas), LOGIT_TOL)
        parted = {}
        try:
            with tp_rounding(eng.llm_cfg):
                parted = _tp_held(torch, eng, batch_clips, rows0, want_batch,
                                  "serving_tp_full batch", margin_tol)
        except AssertionError as e:
            failures.append(str(e))
        mark("batch checks")
        out["batch"] = dict(
            logit_delta_per_step=deltas, same_launch_per_step=same,
            exact_tol=TP_EXACT_TOL, noise_tol=TP_NOISE_TOL, margin_tol=margin_tol,
            plain_logit_delta_per_step=plain_deltas,
            rows_equal=[a == b for a, b in zip(rows0, want_batch)], parted=parted,
            rows_equal_plain=[a == b for a, b in zip(rows0, plain_batch_rows)],
            stage_s=reports[0]["stage_s"], batch_s=reports[0]["batch_s"],
            utt_per_s=len(batch_clips) / reports[0]["batch_s"],
            plain_utt_per_s=len(batch_clips) / plain_batch_s,
            plain_decode_ms_per_step=plain_decode_ms,
            per_rank=[dict(_per_step(rep["steps"]), peak_gb=rep["peak_gb"],
                           init_peak_gb=rep["init_peak_gb"], kv_heads=rep["kv_heads"],
                           launches=rep["launches"], engine_counts=rep["engine_counts"])
                      for rep in reports])

        for name, kw in (("dense", dict(paged=False)),
                         ("paged_spec3", dict(paged=True, spec_k=3))):
            reports, run = stage_reports[name], runs[name]
            check(all(r is not None and r[0] == 200 for r in run["results"]),
                  f"{name}: a request failed: {run['results']}")
            for rep in reports:
                want = {**{k: 0 for k in rep["launches"]},
                        **_tp_expected_launches(rep, kw["paged"])}
                check(rep["launches"] == want, f"{name} rank {rep['rank']}: launches "
                      f"{rep['launches']} != expected {want}")
                for k, v in rep["launches"].items():
                    launches[k] += v
            check(reports[1]["harvested"] == reports[0]["harvested"],
                  f"{name}: rank 1 harvested other rows")
            if kw["paged"]:
                check(reports[0]["launches"]["paged_attention"] > 0,
                      f"{name}: the speculative rounds never launched B4")
            by_len = {r["key"]: r for r in reports[0]["requests"]}
            got = [by_len[len(c)]["row"] for c in burst_clips]
            parted = {}
            try:
                with tp_rounding(eng.llm_cfg):
                    parted = _tp_held(torch, eng, burst_clips, got, want_burst,
                                      f"serving_tp_full {name}", margin_tol)
            except AssertionError as e:
                failures.append(str(e))
            ttft = [by_len[len(c)]["ttft_s"] for c in burst_clips]
            plain = _serve_burst(torch, card, eng, f"tp_plain_{name}", burst, n_slots=16,
                                 max_new_tokens=64, device="cuda", **kw)
            mark(f"{name} plain burst")
            for k, v in plain["launches"].items():
                launches[k] += v
            out[name] = dict(
                stage_s=reports[0]["stage_s"], requests=len(burst), burst_wall_s=run["wall"],
                requests_per_s=len(burst) / run["wall"],
                p50_first_token_s=statistics.median(ttft),
                rows_equal=[a == b for a, b in zip(got, want_burst)], parted=parted,
                per_rank=[dict(_per_step([c for c in rep["chunks"] if c["t"] >= run["t_start"]]),
                               peak_gb=rep["peak_gb"], init_peak_gb=rep["init_peak_gb"],
                               kv_heads=rep["kv_heads"], launches=rep["launches"],
                               decoder_counts=rep["decoder_counts"])
                          for rep in reports],
                metrics=run["metrics"],
                plain=dict(requests_per_s=plain["requests_per_s"],
                           p50_first_token_s=plain["p50_first_token_s"],
                           decode_ms_per_step=plain["decode_ms_per_step"],
                           peak_gb=plain["max_memory_allocated_gb"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        emit("serving_tp_full", config="llama3_hubert.yaml", ranks=TP_RANKS, backend="gloo",
             llm_heads_per_rank=[eng.llm_cfg.num_heads // TP_RANKS,
                                 eng.llm_cfg.num_kv_heads // TP_RANKS],
             reduced=[f"Llama-3.2-3B cut to {TP_SERVE_LAYERS} of its 28 blocks (HuBERT-large "
                      f"as published)", f"{TP_RANKS} ranks share the one card over gloo (NCCL "
                      f"refuses two ranks on one card)", "random weights"], **out, launches=launches,
             marks=marks, failures=failures, card=card)
    if failures:
        raise AssertionError("serving_tp_full: " + "; ".join(failures))
    return launches


ROUTER_N_BURST = 16  # audio requests at once, beside one text request
ROUTER_N_DRAIN = 8  # audio requests sent after replica A left the rotation
ROUTER_N_GREEDY = 4  # one at a time, through the router and then direct


def _router_imports(stderr: str) -> list:
    """The top-level packages a ``python -X importtime`` process imported,
    from its stderr."""
    names = set()
    for line in stderr.splitlines():
        if line.startswith("import time:") and "|" in line:
            name = line.rsplit("|", 1)[1].strip()
            if name and name != "imported package":  # the header line
                names.add(name.split(".")[0])
    return sorted(names)


def phase_router_full(torch, card):
    """BASELINE config #1 behind the replica router: one engine
    (``minichat_hubert.yaml`` with hubert-base and the ``pool`` projector,
    int8 weights and cache, published widths, random weights) served by two
    in-process ``SummarizationServer`` replicas on the card, A paged and B
    paged with speculative chunks (spec_k=3), n_slots=8 and a 64-token cap
    each, fronted by ``python -m llm_speech_summarization_tpu_torch.cli.
    route --port 0 --health_interval 0.5`` (a subprocess that must load
    neither jax nor the JAX package). Each replica is warmed with one
    request; with every launch count at 0, four greedy requests go one at a
    time through the router (the least-loaded tie breaks round-robin: two
    reach each replica) and then straight to the replica that served each,
    and their token rows must agree (equal on A; on B equal, or parting only
    at a top-2 near-tie, since its governor may run a request on B4 rounds
    one time and B5 steps the other); then a burst of 16 audio requests of
    6-10 s (two streamed, two sampled with fixed seeds) and one text request
    at once; then A drains while 8 more audio requests go in, sent after the
    router's probe ejected A, so that all reach B. Every request answers
    200, streamed deltas add up to their response, both replicas served
    requests, and the launches equal what the two decoders and the engine
    ran: B5 per plain paged step, B4 per speculative round."""
    import threading

    from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference
    from llm_speech_summarization_tpu_torch.serve.server import SummarizationServer

    torch.cuda.reset_peak_memory_stats()
    cfg = _minichat_base_config("pool")
    t0 = time.perf_counter()
    eng = LLMSpeechTextInference(cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    L, enc_layers = eng.llm_cfg.num_layers, eng.encoder_setup.encoder_cfg.num_layers
    common = dict(host="127.0.0.1", port=0, continuous=True, paged=True, n_slots=8,
                  max_new_tokens=64, device="cuda")
    replicas = {"A": SummarizationServer(eng, **common),
                "B": SummarizationServer(eng, spec_k=3, **common)}
    for r in replicas.values():
        r.start_background()
    urls = {name: f"http://127.0.0.1:{r.port}" for name, r in replicas.items()}
    router = subprocess.Popen(
        [sys.executable, "-X", "importtime", "-m", "llm_speech_summarization_tpu_torch.cli.route",
         "--backends", f"{urls['A']},{urls['B']}", "--host", "127.0.0.1", "--port", "0",
         "--health_interval", "0.5"],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    rng = np.random.RandomState(9)
    n_clips = ROUTER_N_GREEDY + ROUTER_N_BURST + ROUTER_N_DRAIN
    clips = [(0.1 * rng.randn(int(16000 * rng.uniform(6.0, 10.0)))).astype(np.float32)
             for _ in range(n_clips)]

    def audio(i, **extra):
        return {"audio": clips[i].tolist(), "max_new_tokens": 32, **extra}

    def send_all(bodies, port):
        """POST every (path, body, stream) at once; (results, wall s)."""
        results = [None] * len(bodies)

        def send(i, path, body, stream):
            results[i] = _http(port, path, body, stream)

        threads = [threading.Thread(target=send, args=(i, *b)) for i, b in enumerate(bodies)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        return results, time.perf_counter() - t0

    drainer = None
    try:
        line = router.stdout.readline()
        m = re.fullmatch(r"routing 2 replicas on 127\.0\.0\.1:(\d+)\s*", line)
        if not m:
            raise AssertionError(f"router_full: the router printed {line!r}")
        port = int(m.group(1))

        def served():
            _, metrics = _http(port, "/metrics")
            return {name: b["served"] for name, b in zip(("A", "B"), metrics["backends"])}

        for name, r in replicas.items():
            status, _ = _http(r.port, "/v1/audio_summary", audio(0, max_new_tokens=2))
            if status != 200:
                raise AssertionError(f"router_full: warming replica {name} gave {status}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # --- the main path, counted
        reset_launches()
        eng.counts.clear()
        for r in replicas.values():
            r.batcher.decoder.counts.clear()
            r.batcher.chunk_seconds, r.batcher.chunk_steps_run = 0.0, 0
            r.batcher.first_token_s.clear()
        served_by, texts = [], {"router": [], "direct": []}
        with recorded_tokens(type(eng.tokenizer)) as rows:
            for i in range(ROUTER_N_GREEDY):
                before = served()
                status, body = _http(port, "/v1/audio_summary", audio(i))
                after = served()
                which = [n for n in after if after[n] > before[n]]
                if status != 200 or len(which) != 1:
                    raise AssertionError(f"router_full: greedy request {i}: {status}, served "
                                         f"{before} -> {after}")
                served_by.append(which[0])
                texts["router"].append(body["response"])
            for i, name in enumerate(served_by):
                status, body = _http(replicas[name].port, "/v1/audio_summary", audio(i))
                if status != 200:
                    raise AssertionError(f"router_full: direct request {i} gave {status}")
                texts["direct"].append(body["response"])
        if sorted(served_by) != ["A", "A", "B", "B"] or len(rows) != 2 * ROUTER_N_GREEDY:
            raise AssertionError(f"router_full: greedy requests served by {served_by}, "
                                 f"{len(rows)} token rows decoded")

        burst = [("/v1/audio_summary", audio(ROUTER_N_GREEDY + 0, stream=True), True),
                 ("/v1/audio_summary", audio(ROUTER_N_GREEDY + 1, stream=True), True),
                 ("/v1/audio_summary", audio(ROUTER_N_GREEDY + 2, temperature=0.8, top_k=50,
                                             seed=11), False),
                 ("/v1/audio_summary", audio(ROUTER_N_GREEDY + 3, temperature=0.8, top_p=0.9,
                                             seed=12), False)]
        burst += [("/v1/audio_summary", audio(ROUTER_N_GREEDY + i), False)
                  for i in range(4, ROUTER_N_BURST)]
        burst.append(("/v1/text_response", {"text": "Summarize the call in one line.",
                                            "max_new_tokens": 32}, False))
        burst_results, burst_s = send_all(burst, port)
        served_burst = served()

        # drain A: its /healthz answers 503, the router's probe ejects it
        drained = {}
        drainer = threading.Thread(
            target=lambda: drained.setdefault("A", replicas["A"].drain(timeout=120)))
        t_drain = time.perf_counter()
        drainer.start()
        deadline = time.monotonic() + 30
        while True:
            _, metrics = _http(port, "/metrics")
            if not metrics["backends"][0]["healthy"]:
                break
            if time.monotonic() > deadline:
                raise AssertionError("router_full: the router never ejected draining replica A")
            time.sleep(0.05)
        ejected_s = time.perf_counter() - t_drain
        before_drain = served()
        first = ROUTER_N_GREEDY + ROUTER_N_BURST
        after_ejection = [("/v1/audio_summary", audio(first + i), False)
                          for i in range(ROUTER_N_DRAIN)]
        drain_results, drain_s = send_all(after_ejection, port)
        drainer.join(180)
        after_drain = served()
        launches = read_launches()
        counts = {name: dict(r.batcher.decoder.counts) for name, r in replicas.items()}
        eng_counts = dict(eng.counts)
        _, router_metrics = _http(port, "/metrics")
        metrics = {"A": replicas["A"].metrics(), "B": _http(replicas["B"].port, "/metrics")[1]}
        # ---
    finally:
        router.terminate()
        _, router_err = router.communicate(timeout=60)
        if drainer is not None:
            drainer.join(180)
        for name, r in replicas.items():
            if not r._draining:
                r.drain(timeout=120)
    if drained.get("A") is not True:
        raise AssertionError("router_full: replica A did not drain")
    leaked = [m for m in _router_imports(router_err)
              if m in ("jax", "jaxlib", "llm_speech_summarization_tpu")]
    if leaked:
        raise AssertionError(f"router_full: the router process imported {leaked}")

    for (path, body, stream), res in zip(burst + after_ejection, burst_results + drain_results):
        if res is None or res[0] != 200:
            raise AssertionError(f"router_full: a request failed: {res}")
        final = res[1][-1] if stream else res[1]
        if not isinstance(final.get("response"), str):
            raise AssertionError(f"router_full: no response in {final}")
        if stream and "".join(o.get("delta", "") for o in res[1][:-1]) != final["response"]:
            raise AssertionError("router_full: streamed deltas do not add up to the response")
    if after_drain["A"] != before_drain["A"] or \
            after_drain["B"] != before_drain["B"] + ROUTER_N_DRAIN:
        raise AssertionError(f"router_full: after A's ejection the router served "
                             f"{before_drain} -> {after_drain}")
    backends = router_metrics["backends"]
    if backends[0]["healthy"] or not backends[1]["healthy"] or backends[0]["ejections"] < 1 \
            or min(b["served"] for b in backends) == 0:
        raise AssertionError(f"router_full: router metrics {router_metrics}")

    # the one-at-a-time greedy requests: router against direct, token rows
    parted = {}
    for i, name in enumerate(served_by):
        got, want = rows[i], rows[ROUTER_N_GREEDY + i]
        if got == want:
            if texts["router"][i] != texts["direct"][i]:
                raise AssertionError(f"router_full: request {i}: equal tokens, other texts")
            continue
        t = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got),
                                                                               len(want)))
        if name == "A" or t >= min(len(got), len(want)):
            raise AssertionError(f"router_full: request {i} on replica {name}: the router's "
                                 f"tokens {got} differ from the direct ones {want} at {t}")
        embeds, mask = eng.build_audio_prompt_batch([clips[i]])
        _, margins = _b3_margins(torch, eng, embeds, mask,
                                 torch.tensor([got], dtype=torch.int32, device="cuda"), t + 1,
                                 cache_dtype=torch.int8)
        parted[i] = dict(step=t, margin=margins[0, t].item())
        if margins[0, t] > 2 * LOGIT_TOL:
            raise AssertionError(f"router_full: request {i} on B parts at step {t}, where the "
                                 f"top-2 margin is {margins[0, t].item()}")

    steps = {n: c.get("steps", 0) for n, c in counts.items()}
    rounds = {n: c.get("spec_rounds", 0) for n, c in counts.items()}
    check_launches("router_full", launches, {
        "flash_attention": L * sum(c.get("prefills", 0) for c in counts.values())
        + enc_layers * eng_counts.get("encoder_forwards", 0),
        "fused_paged": L * sum(steps.values()), "paged_attention": L * sum(rounds.values())})
    if rounds["A"] or not launches["fused_paged"] or not launches["paged_attention"]:
        raise AssertionError(f"router_full: B5 and B4 must both launch (steps {steps}, "
                             f"rounds {rounds})")
    n_burst = len(burst)
    emit("router_full", config="minichat_hubert.yaml", encoder=cfg.model.audio_encoder.type,
         projector="pool", llm_heads=[eng.llm_cfg.num_heads, eng.llm_cfg.num_kv_heads],
         replicas={"A": "paged", "B": "paged, spec_k=3"}, n_slots=8, init_s=init_s,
         burst_requests=n_burst, burst_wall_s=burst_s, requests_per_s=n_burst / burst_s,
         drain_requests=ROUTER_N_DRAIN, drain_wall_s=drain_s,
         drain_requests_per_s=ROUTER_N_DRAIN / drain_s, ejected_after_s=ejected_s,
         served_after_burst=served_burst, served=after_drain, greedy_served_by=served_by,
         greedy_rows_equal=[rows[i] == rows[ROUTER_N_GREEDY + i]
                            for i in range(ROUTER_N_GREEDY)], greedy_parted=parted,
         p50_first_token_s={n: m.get("first_token_s_p50") for n, m in metrics.items()},
         decode_ms_per_step={n: m.get("decode_ms_per_step") for n, m in metrics.items()},
         spec_acceptance=metrics["B"].get("spec_acceptance"), router=router_metrics,
         router_loaded_torch="torch" in _router_imports(router_err),
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches=launches, decoder_counts=counts, engine_counts=eng_counts, card=card)
    return launches


# one A/B run: this file's kernel phases (its path is argv[1]) against the
# package of the checkout the process runs in
AB_RUN = ("import importlib.util, sys, torch\n"
          "spec = importlib.util.spec_from_file_location('chip_smoke', sys.argv[1])\n"
          "cs = importlib.util.module_from_spec(spec)\n"
          "spec.loader.exec_module(cs)\n"
          "torch.set_grad_enabled(False)\n"
          "card = cs.phase_env(torch)\n"
          "cs.phase_build(card, require_no_spill=False)\n"
          "f32 = sys.argv[2] == 'f32'\n"
          "if not f32:\n"
          "    cs.phase_flash(torch, card)\n"
          "cs.phase_flash_f32(torch, card)\n"
          "if f32:\n"
          "    cs.phase_flash_train_f32(torch, card)\n"
          "    cs.phase_decode_f32(torch, card)\n"
          "    cs.phase_decode_mixed(torch, card)\n"
          "else:\n"
          "    with torch.enable_grad():\n"
          "        cs.phase_flash_train(torch, card)\n"
          "        cs.phase_flash_ring(torch, card)\n"
          "    cs.phase_fused(torch, card)\n"
          "    cs.phase_paged(torch, card)\n"
          "    cs.phase_fused_paged(torch, card)\n"
          "    cs.phase_dense_decode(torch, card)\n")


def _ab_times(lines) -> dict:
    """Device ms and call ms (host dispatch included) per kernel and shape
    from one run's kernel phase lines."""
    names = {"fwd_lse": "B1 + LSE", "fwd": "B7 fwd", "dq": "dq", "dkv": "dk/dv"}
    times = {}
    for x in lines:
        if x.get("phase") == "flash_attention":
            times[f"B1 {x['case']}"] = x
        elif x.get("phase") == "flash_attention_f32":
            times[f"B1 f32 {x['case']}"] = x
        elif x.get("phase") == "fused_decode":
            heads = "" if x["shape"][3] == 8 else f" Hkv={x['shape'][3]}"
            times[f"B2 B={x['shape'][1]} T={x['T']} S={x['shape'][4]}{heads}"] = x
        elif x.get("phase") == "dense_decode":
            times[f"{x['kernel']} {x['case']}"] = x
        elif x.get("phase") in ("paged_attention", "fused_paged"):
            times[f"{'B4' if x['phase'] == 'paged_attention' else 'B5'} T={x['T']}"] = x
        elif x.get("phase") in ("flash_train", "flash_ring"):
            tag = "B6" if x["phase"] == "flash_train" else "B7"
            for k, r in x["kernels"].items():
                name = names[k] if k in ("fwd_lse", "fwd") else f"{tag} {names[k]}"
                times[f"{name} {x['case']}"] = r
        elif x.get("phase") in ("flash_train_f32", "flash_ring_f32"):
            tag = "B6" if x["phase"] == "flash_train_f32" else "B7"
            for k, r in x["kernels"].items():
                name = ("B1 + LSE" if tag == "B6" else "B7 fwd") if k == "fwd_lse" else \
                    f"{tag} {names[k]}"
                times[f"{name} f32 {x['case']}"] = r
        elif x.get("phase") in ("decode_f32", "decode_mixed"):
            times[f"{x['kernel']} {x['case']}"] = x
    return {k: {"ms": r["ms"], "call_ms": r["call_ms"]} for k, r in times.items()}


def ab_kernels(argv) -> int:
    """``python3 chip_smoke.py --ab-kernels BASE_DIR [ORDER] [f32]``: the
    kernel phases (flash, flash_f32, flash_train, flash_ring, fused, paged,
    fused_paged, dense_decode; with ``f32``: the float32 ones, flash_f32,
    flash_train_f32, decode_f32 and decode_mixed) of two checkouts on one
    card, each run a fresh process in its checkout that runs this
    chip_smoke.py's phases on that checkout's package (A = BASE_DIR, B =
    this checkout), in ORDER (default ABBA, so drift spreads over both).
    Prints one line per run and a last line with the median device ms and
    call ms (CUDA events around one call, host dispatch included) of each
    kernel and shape per checkout, device ms B over A, and the card's name
    and power limit."""
    roots = {"A": os.path.abspath(argv[0]), "B": os.path.dirname(os.path.abspath(__file__))}
    order = argv[1] if len(argv) > 1 else "ABBA"
    phases = argv[2] if len(argv) > 2 else "all"
    env = dict(os.environ, HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1")
    runs = {"A": [], "B": []}
    card = None
    for tag in order:
        proc = subprocess.run([sys.executable, "-c", AB_RUN, os.path.abspath(__file__), phases],
                              cwd=roots[tag], env=env, capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"{roots[tag]}: exit {proc.returncode}\n{proc.stdout[-4000:]}\n"
                             f"{proc.stderr[-4000:]}")
        lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
        card = next(x for x in lines if x.get("phase") == "env")["card"]
        runs[tag].append(_ab_times(lines))
        emit("ab_kernels_run", checkout=tag, root=roots[tag], ms=runs[tag][-1], card=card)
    median = {tag: {k: {m: statistics.median(r[k][m] for r in rs) for m in ("ms", "call_ms")}
                    for k in rs[0]}
              for tag, rs in runs.items() if rs}
    ratio = {k: median["B"][k]["ms"] / median["A"][k]["ms"] for k in median.get("A", {})
             if k in median.get("B", {})}
    emit("ab_kernels", order=order, median=median, device_ms_b_over_a=ratio, card=card)
    return 0


SWEEP_BATCHES = (1, 2, 4, 8)
SWEEP_OFFSETS = (255, 383, 511, 767, 1023, 1663, 2047)
SWEEP_SPLITS = (1, 2, 3, 4, 6, 8)
# the float32 body: B2's float32 instance over an int8 cache and B8's mixed
# instance over a float32 cache (a bf16 query: the serving path of bf16
# parameters at compute_dtype float32), at these batches, SWEEP_OFFSETS and
# these split counts and the rule's (those that leave at most 8 blocks an
# SM, and 1 and 2)
SWEEP_F32_BATCHES = (1, 8, 16, 128)
SWEEP_F32_SPLITS = (1, 2, 3, 4, 5, 6, 8, 12, 16)


def split_sweep_f32(torch, card) -> None:
    """The float32 body's device ms per call (the split body and the merge
    kernel together) at T=1 and the llama3 widths (24/8 heads, Dh=128),
    every row at one max offset, for each split count forced in place of
    ``f32_splits``' choice, which is printed beside them with its ms over
    the fastest: the numbers its constants come from."""
    from llm_speech_summarization_tpu_torch.kernels import decode_attention as da
    from llm_speech_summarization_tpu_torch.kernels import fused_decode as fd_mod

    rng = np.random.RandomState(6)
    dev = torch.device("cuda")
    Hq, Hkv, Dh, S = 24, 8, 128, max(SWEEP_OFFSETS) + 1
    sms = fd_mod.sm_count(0)

    def randn(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)

    for B in SWEEP_F32_BATCHES:
        q, kn, vn = (randn(B, 1, h, Dh) for h in (Hq, Hkv, Hkv))
        kc8, vc8 = (torch.from_numpy(rng.randint(-127, 128, size=(1, B, Hkv, S, Dh))
                                     .astype(np.int8)).to(dev) for _ in range(2))
        ks, vs = (torch.from_numpy((0.02 + 0.1 * rng.rand(1, B, Hkv, S)).astype(np.float32))
                  .to(dev, torch.bfloat16) for _ in range(2))
        kc32, vc32 = (randn(B, Hkv, S, Dh) for _ in range(2))
        q16, kn16, vn16 = (x.bfloat16() for x in (q, kn, vn))
        pads = torch.zeros(B, dtype=torch.int32, device=dev)
        calls = {
            "b2_f32_int8": lambda mo, offs: fd_mod.fused_decode(
                q, kc8, vc8, ks, vs, kn, vn, pads, offs, 0, max_offset=mo),
            "b8_mixed_float32": lambda mo, offs: da.decode_attention(
                q16, kc32, vc32, kn16, vn16, pads, mo),
        }
        for inst, fn in calls.items():
            for mo in SWEEP_OFFSETS:
                offs = torch.full((B,), mo, dtype=torch.int32, device=dev)
                ms = {}
                rule = fd_mod.f32_splits(B, Hkv, mo, sms)
                for n in sorted(set(SWEEP_F32_SPLITS) | {rule}):
                    if n > 2 and B * Hkv * n > 8 * sms:
                        continue
                    with forced_splits(fd_mod, n, "f32_splits"):
                        try:
                            ms[n] = device_ms(torch, lambda fn=fn, mo=mo, offs=offs:
                                              fn(mo, offs), whole=False)
                        except AssertionError:  # the profiler lost events: not timed
                            continue
                fastest = min(ms, key=ms.get)
                emit("split_sweep_f32", instance=inst, B=B, max_offset=mo, ms_by_splits=ms,
                     rule=rule, rule_over_fastest=ms[rule] / ms[fastest] if rule in ms else None,
                     fastest=fastest, card=card)
        del q, kn, vn, kc8, vc8, ks, vs, kc32, vc32, q16, kn16, vn16
        torch.cuda.empty_cache()


def split_sweep(argv=()) -> int:
    """``python3 chip_smoke.py --split-sweep [f32]``: B2's device ms per call
    (the split body and the merge kernel together) at T=1 and the llama3
    widths (24/8 heads, Dh=128, int8 cache), every row at one max offset,
    for each batch of SWEEP_BATCHES, each offset of SWEEP_OFFSETS and each
    split count of SWEEP_SPLITS forced in place of ``dense_splits``'
    choice, which is printed beside them: the numbers its thresholds come
    from. Then phase_fused, which holds the split shapes to the plain
    version. Then (or, with ``f32``, only) the float32 body's sweep
    (``split_sweep_f32``) and its phases, decode_f32 and decode_mixed, which
    hold the rule's split shapes to the plain versions."""
    import torch

    from llm_speech_summarization_tpu_torch.kernels import fused_decode as fd_mod

    card = phase_env(torch)
    torch.set_grad_enabled(False)
    t0 = time.perf_counter()
    fd_mod._lib()
    fd_mod._f32_lib()
    emit("build", seconds=round(time.perf_counter() - t0, 3), card=card)
    if list(argv[:1]) != ["f32"]:
        bf16_split_sweep(torch, card, fd_mod)
    split_sweep_f32(torch, card)
    phase_decode_f32(torch, card)
    phase_decode_mixed(torch, card)
    return 0


def bf16_split_sweep(torch, card, fd_mod) -> None:
    """The bf16 body's sweep of ``split_sweep``, then phase_fused."""
    rng = np.random.RandomState(5)
    dev = torch.device("cuda")
    Hq, Hkv, Dh, S = 24, 8, 128, max(SWEEP_OFFSETS) + 1
    sms = fd_mod.sm_count(0)
    for B in SWEEP_BATCHES:
        q, kn, vn = (torch.from_numpy(rng.randn(B, 1, h, Dh).astype(np.float32))
                     .to(dev, torch.bfloat16) for h in (Hq, Hkv, Hkv))
        kc, vc = (torch.from_numpy(rng.randint(-127, 128, size=(1, B, Hkv, S, Dh))
                                   .astype(np.int8)).to(dev) for _ in range(2))
        ks, vs = (torch.from_numpy((0.02 + 0.1 * rng.rand(1, B, Hkv, S)).astype(np.float32))
                  .to(dev, torch.bfloat16) for _ in range(2))
        pads = torch.zeros(B, dtype=torch.int32, device=dev)
        for mo in SWEEP_OFFSETS:
            offs = torch.full((B,), mo, dtype=torch.int32, device=dev)
            ms = {}
            for n in SWEEP_SPLITS:
                with forced_splits(fd_mod, n):
                    ms[n] = device_ms(torch, lambda: fd_mod.fused_decode(
                        q, kc, vc, ks, vs, kn, vn, pads, offs, 0, max_offset=mo), whole=False)
            emit("split_sweep", B=B, max_offset=mo, ms_by_splits=ms,
                 rule=fd_mod.dense_splits(B, Hkv, mo, sms), fastest=min(ms, key=ms.get),
                 card=card)
    phase_fused(torch, card)


def f32_train_kernels(argv) -> int:
    """``python3 chip_smoke.py --f32-train-kernels [TL]``: B1's float32
    phase, then the float32 training kernels' phase with HuBERT's ring
    block at TL frames (default F32_TRAIN_HUBERT_RING_TL; RING_SHAPES has
    3000), each ring case's wall and peak device memory in its line: what
    that block's cut is read from. The libraries build at first use."""
    import torch

    card = phase_env(torch)
    torch.set_grad_enabled(False)
    phase_flash_f32(torch, card)
    with torch.enable_grad():
        phase_flash_train_f32(torch, card, int(argv[0]) if argv else F32_TRAIN_HUBERT_RING_TL)
    return 0


# ---------------------------------------------------------------------------
# the offline pipeline: convert_full, preprocess_full, eval_full, ckpt_full,
# train_whisper_full. The HF checkpoints are drawn at published widths from
# seeded generators on the card, under the published HF parameter names, and
# written by write_safetensors below (test tooling, not part of the package).

OFFLINE_DISK_GB = 15.0  # the most the offline phases hold on disk at once
ST_DTYPES = {"BF16": (2, "bfloat16"), "F32": (4, "float32")}
# the CTC model's float32 logits through B1's float32 instance against the
# same forward with the plain attention (both float32, TF32 off), per logit:
# the attention differs by at most F32_OUT_RTOL relative per layer, and the
# logits of the drawn model are ~1 in size
CTC_F32_LOGIT_TOL = 1e-3


def write_safetensors(torch, path, specs, make):
    """A ``.safetensors`` file: the 8-byte little-endian header length, the
    JSON header, then each tensor's bytes in ``specs`` order. ``specs`` is
    [(name, shape, "BF16" | "F32")]; ``make(name, shape, dtype)`` returns
    the tensor (drawn on the card, one at a time). Returns the bytes."""
    import struct

    header, off = {}, 0
    for name, shape, dt in specs:
        n = int(np.prod(shape)) * ST_DTYPES[dt][0]
        header[name] = {"dtype": dt, "shape": list(shape), "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name, shape, dt in specs:
            t = make(name, shape, getattr(torch, ST_DTYPES[dt][1])).contiguous().cpu()
            f.write(t.view(torch.uint8).numpy())
    return 8 + len(head) + off


def _hf_draw(torch, seed):
    """make(name, shape, dtype): norms and biases near 1 / 0, weights
    normal(0.02), from one card generator seeded ``seed``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def make(name, shape, dtype):
        x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
        if "norm" in name and name.endswith("weight"):
            x = 1.0 + 0.02 * x
        elif "original0" in name:  # the weight norm's g
            x = 1.0 + 0.1 * x.abs()
        else:
            x = 0.02 * x
        return x.to(dtype)

    return make


def llama3_hf_specs(dt="BF16"):
    """Llama-3.2-3B's HF names and shapes (28 layers, d 3072, 24/8 heads of
    128, FFN 8192, vocab 128256, tied head: no lm_head.weight)."""
    D, I, L, V, KV = 3072, 8192, 28, 128256, 1024
    specs = [("model.embed_tokens.weight", (V, D), dt)]
    for i in range(L):
        p = f"model.layers.{i}."
        specs += [(p + "input_layernorm.weight", (D,), dt),
                  (p + "self_attn.q_proj.weight", (D, D), dt),
                  (p + "self_attn.k_proj.weight", (KV, D), dt),
                  (p + "self_attn.v_proj.weight", (KV, D), dt),
                  (p + "self_attn.o_proj.weight", (D, D), dt),
                  (p + "post_attention_layernorm.weight", (D,), dt),
                  (p + "mlp.gate_proj.weight", (I, D), dt),
                  (p + "mlp.up_proj.weight", (I, D), dt),
                  (p + "mlp.down_proj.weight", (D, I), dt)]
    specs.append(("model.norm.weight", (D,), dt))
    return specs


def hubert_large_hf_specs(prefix="", dt="F32"):
    """hubert-large's HubertModel names and shapes (the layer-normed conv
    stem with bias, 24 pre-LN layers of 1024, the weight-normed positional
    conv in the parametrization spelling)."""
    D, F_, L = 1024, 4096, 24
    specs, c_in = [], 1
    for i, k in enumerate((10, 3, 3, 3, 3, 2, 2)):
        p = f"{prefix}feature_extractor.conv_layers.{i}."
        specs += [(p + "conv.weight", (512, c_in, k), dt), (p + "conv.bias", (512,), dt),
                  (p + "layer_norm.weight", (512,), dt), (p + "layer_norm.bias", (512,), dt)]
        c_in = 512
    p = f"{prefix}feature_projection."
    specs += [(p + "layer_norm.weight", (512,), dt), (p + "layer_norm.bias", (512,), dt),
              (p + "projection.weight", (D, 512), dt), (p + "projection.bias", (D,), dt)]
    p = f"{prefix}encoder.pos_conv_embed.conv."
    specs += [(p + "bias", (D,), dt), (p + "parametrizations.weight.original0", (1, 1, 128), dt),
              (p + "parametrizations.weight.original1", (D, D // 16, 128), dt)]
    for i in range(L):
        p = f"{prefix}encoder.layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            specs += [(p + f"attention.{n}.weight", (D, D), dt), (p + f"attention.{n}.bias", (D,), dt)]
        specs += [(p + "layer_norm.weight", (D,), dt), (p + "layer_norm.bias", (D,), dt),
                  (p + "feed_forward.intermediate_dense.weight", (F_, D), dt),
                  (p + "feed_forward.intermediate_dense.bias", (F_,), dt),
                  (p + "feed_forward.output_dense.weight", (D, F_), dt),
                  (p + "feed_forward.output_dense.bias", (D,), dt),
                  (p + "final_layer_norm.weight", (D,), dt), (p + "final_layer_norm.bias", (D,), dt)]
    specs += [(f"{prefix}encoder.layer_norm.weight", (D,), dt),
              (f"{prefix}encoder.layer_norm.bias", (D,), dt),
              (f"{prefix}masked_spec_embed", (D,), dt)]  # unused by the converter
    return specs


@contextlib.contextmanager
def timed_calls(module, names, into):
    """Wrap ``module``'s functions ``names`` to add their wall seconds to
    ``into[name]`` (callers that import them at call time see the wrappers)."""
    saved = {n: getattr(module, n) for n in names}

    def wrap(n, fn):
        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                into[n] = into.get(n, 0.0) + time.perf_counter() - t0
        return timed

    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield into
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def _rss_gb() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6  # KiB → GB


def _convert(torch, kind, hf_dir, out, extra):
    """cli/convert.py ``kind`` on ``hf_dir``: the read (the shards' headers
    and maps), convert and write seconds, GB/s over the shards' bytes, the
    process's host peak RSS after it, the bytes written."""
    from llm_speech_summarization_tpu_torch.cli import convert as cli_convert
    from llm_speech_summarization_tpu_torch.models import convert as conv_mod
    from llm_speech_summarization_tpu_torch.train import checkpoint as ckpt_mod

    shard_bytes = sum(os.path.getsize(os.path.join(hf_dir, f)) for f in os.listdir(hf_dir))
    secs = {}
    t0 = time.perf_counter()
    with timed_calls(conv_mod, ("load_hf_state_dict", "convert_llama", "convert_hubert",
                                "convert_hubert_ctc"), secs), \
            timed_calls(ckpt_mod, ("save_params",), secs):
        cli_convert.main([kind, "--hf_dir", hf_dir, "--output", out] + extra)
    wall = time.perf_counter() - t0
    convert_s = sum(v for k, v in secs.items() if k.startswith("convert"))
    if kind == "ctc":  # convert_hubert runs inside convert_hubert_ctc
        convert_s = secs["convert_hubert_ctc"]
    elif kind == "encoder":
        convert_s = secs["convert_hubert"]
    return {"read_s": secs["load_hf_state_dict"], "convert_s": convert_s,
            "write_s": secs["save_params"], "wall_s": wall, "shard_bytes": shard_bytes,
            "read_convert_gb_per_s": shard_bytes / 1e9 / (secs["load_hf_state_dict"] + convert_s),
            "written_bytes": os.path.getsize(out), "host_peak_rss_gb": _rss_gb()}


def phase_convert_full(torch, card, work):
    """HF checkpoints at published widths → the port's files through
    ``cli/convert.py``: Llama-3.2-3B (bf16, two safetensors shards;
    ``llm --preset llama3_3b``), HuBERT-large (float32, one shard;
    ``encoder`` on ``llama3_hubert.yaml``) and HuBERT-large CTC with a
    32-class head (float32; ``ctc``), each shard directory deleted after
    its conversion. Then ``llama3_hubert.yaml`` (int8) with
    ``model.llm_checkpoint`` and ``model.encoder_checkpoint`` set runs
    ``generate_audio_response_batch`` at B=8 x 10 s, 32 tokens, counted;
    its token rows equal, bit for bit, those of an engine handed the same
    converted trees in memory (the LLM fused and quantized as the loading
    engine does). Returns (launches, the loading engine, the files)."""
    import shutil

    from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
    from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference
    from llm_speech_summarization_tpu_torch.models.llama import (
        fuse_llama_params, quantize_llama_params,
    )
    from llm_speech_summarization_tpu_torch.train.checkpoint import load_encoder, load_params
    from llm_speech_summarization_tpu_torch.utils.tokenizer import ByteTokenizer

    free_gb = shutil.disk_usage(work).free / 1e9
    print(json.dumps({"phase": "convert_full", "work_dir_free_gb": free_gb,
                      "needed_gb": OFFLINE_DISK_GB}), flush=True)
    if free_gb < OFFLINE_DISK_GB:
        raise AssertionError(f"convert_full: {free_gb:.1f} GB free under {work}, "
                             f"{OFFLINE_DISK_GB} GB needed")
    files, stats = {}, {}
    jobs = (
        ("llm", llama3_hf_specs("BF16"), 2, ["--preset", "llama3_3b"], 21),
        ("encoder", hubert_large_hf_specs("", "F32"), 1,
         ["-c", str(YAML_DIR / "llama3_hubert.yaml")], 22),
        ("ctc", hubert_large_hf_specs("hubert.", "F32")
         + [("lm_head.weight", (32, 1024), "F32"), ("lm_head.bias", (32,), "F32")], 1, [], 23),
    )
    for kind, specs, n_shards, extra, seed in jobs:
        hf_dir = os.path.join(work, f"hf_{kind}")
        os.makedirs(hf_dir)
        make = _hf_draw(torch, seed)
        t0 = time.perf_counter()
        per = -(-len(specs) // n_shards)
        disk = sum(write_safetensors(torch, os.path.join(
            hf_dir, f"model-{i + 1:05d}-of-{n_shards:05d}.safetensors"),
            specs[i * per:(i + 1) * per], make) for i in range(n_shards))
        write_hf_s = time.perf_counter() - t0
        files[kind] = os.path.join(work, f"{kind}.pt")
        stats[kind] = dict(_convert(torch, kind, hf_dir, files[kind], extra),
                           hf_write_s=write_hf_s, hf_bytes=disk, hf_shards=n_shards,
                           dtype_in=specs[0][2], dtype_out="bfloat16")
        shutil.rmtree(hf_dir)

    torch.cuda.reset_peak_memory_stats()
    cfg = load_config(str(YAML_DIR / "llama3_hubert.yaml"))
    cfg.model.llm_checkpoint = files["llm"]
    cfg.model.encoder_checkpoint = files["encoder"]
    t0 = time.perf_counter()
    eng = LLMSpeechTextInference(cfg)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if eng.llm_params["layers"]["wqkv"].dtype != torch.int8:
        raise AssertionError("convert_full: the loading engine did not quantize its LLM")
    rng = np.random.RandomState(5)
    clips = [(0.1 * rng.randn(160000)).astype(np.float32) for _ in range(8)]
    max_new = 32
    eng.generate_audio_response_batch(clips, max_new_tokens=max_new)  # warm-up

    # --- the main path, counted
    torch.cuda.synchronize()
    reset_launches()
    eng.counts.clear()
    t0 = time.perf_counter()
    with recorded_tokens(ByteTokenizer) as rows:
        texts = eng.generate_audio_response_batch(clips, max_new_tokens=max_new)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    launches = read_launches()
    counts = dict(eng.counts)
    # ---
    check_launches("convert_full", launches, _expected_batch_launches(eng, counts))
    mem_cfg = load_config(str(YAML_DIR / "llama3_hubert.yaml"))
    mem = LLMSpeechTextInference(
        mem_cfg, llm_params=quantize_llama_params(fuse_llama_params(
            load_params(files["llm"], "cuda")["llm_params"])),
        audio_encoder_params=load_encoder(files["encoder"], "cuda"))
    with recorded_tokens(ByteTokenizer) as mem_rows:
        mem_texts = mem.generate_audio_response_batch(clips, max_new_tokens=max_new)
    if rows != mem_rows or texts != mem_texts or len(rows) != 8:
        raise AssertionError("convert_full: the converted-file engine's token rows differ from "
                             "the in-memory engine's")
    del mem
    gc.collect()
    torch.cuda.empty_cache()
    emit("convert_full", conversions=stats, engine_load_s=load_s, batch=8, clip_s=10,
         max_new_tokens=max_new, batch_call_s=batch_s, token_rows_equal=True,
         token_rows_compared=len(rows), max_memory_allocated_gb=torch.cuda.max_memory_allocated()
         / 1e9, launches=launches, engine_counts=counts, card=card)
    return launches, eng, files


@contextlib.contextmanager
def plain_attention():
    """Every model's ``flash_attention`` (LLM, HuBERT, Whisper) runs its
    plain version (dense masked attention, differentiable) for the block,
    and so does every decode attention the LLM calls (``models/llama.py``:
    B2, B3, B8, B4 and B5, cache and page writes included). A train step
    under it launches no kernel: the forward with a gradient (B1 + LSE
    where the kernels run) and its backward (B6) go through autograd on
    the dense attention, in bf16 or float32."""
    from llm_speech_summarization_tpu_torch.kernels.decode_attention import (
        decode_attention_reference,
    )
    from llm_speech_summarization_tpu_torch.kernels.flash_attention import (
        flash_attention_reference,
    )
    from llm_speech_summarization_tpu_torch.kernels.fused_decode import (
        fused_decode_attention_write_reference, fused_decode_reference,
    )
    from llm_speech_summarization_tpu_torch.kernels.fused_paged import fused_paged_reference
    from llm_speech_summarization_tpu_torch.kernels.paged_attention import paged_reference
    from llm_speech_summarization_tpu_torch.models import hubert, llama, whisper

    def plain(q, k, v, starts, ends, causal=True):
        return flash_attention_reference(q, k, v, starts, ends, causal=causal)

    def host_bound(fn):  # the kernels' host-side bound of the offsets, unused here
        return lambda *args, max_offset=None: fn(*args)

    saved = [(m, "flash_attention", m.flash_attention) for m in (hubert, llama, whisper)]
    for name, fn in (("fused_decode", host_bound(fused_decode_reference)),
                     ("fused_decode_attention_write",
                      host_bound(fused_decode_attention_write_reference)),
                     ("decode_attention", decode_attention_reference),
                     ("paged_decode_attention", paged_reference),
                     ("fused_paged_decode", fused_paged_reference)):
        saved.append((llama, name, getattr(llama, name)))
        setattr(llama, name, fn)
    for m in (hubert, llama, whisper):
        m.flash_attention = plain
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


PREPROCESS_EXAMPLES = 32  # 6-10 s clips, 10-15 word transcripts, plus one of 21 s


def phase_preprocess_full(torch, card, eng, ctc_file):
    """``iter_preprocess_examples`` at full width: the converted-checkpoint
    engine (``llama3_hubert.yaml``, int8) generates the responses in one
    length-sorted batch of 32 (budget 2x the prompt), the converted
    HuBERT-large CTC model gives each clip's word offsets and pool ranges;
    the 21 s clip is filtered; ``load_ctc_fn`` runs the bf16 file in
    float32. Counted: B1 per LLM layer per prefill, B1's float32 instance
    per HuBERT layer per CTC clip, B2 per LLM layer per decode step. Then
    one clip's float32 CTC logits through the float32 B1 against the same
    forward with the plain float32 attention on the card: the argmax may
    differ only where the plain logits' top-2 margin is at most 2 *
    CTC_F32_LOGIT_TOL; the frames whose argmax the file's bf16 forward
    flips are counted, TF32 is shown off inside the CTC forward and the
    caller's setting back after it, and CTC ms per clip in float32 and
    bf16 are timed in turns over 8 clips."""
    from llm_speech_summarization_tpu_torch.data.preprocess import (
        iter_preprocess_examples, load_ctc_fn,
    )
    from llm_speech_summarization_tpu_torch.models import hubert as hubert_mod
    from llm_speech_summarization_tpu_torch.models.hubert import hubert_ctc_logits, hubert_preset
    from llm_speech_summarization_tpu_torch.train.checkpoint import load_params
    from llm_speech_summarization_tpu_torch.train.state import tree_map
    from llm_speech_summarization_tpu_torch.utils.tokenizer import ByteTokenizer

    rng = np.random.RandomState(9)
    words = ("the quick brown fox jumps over a lazy dog near the river while birds sing "
             "about distant mountains and quiet valleys").split()
    examples = []
    for i in range(PREPROCESS_EXAMPLES + 1):
        secs = 21.0 if i == 5 else rng.uniform(6.0, 10.0)
        examples.append({"audio": (0.1 * rng.randn(int(secs * 16000))).astype(np.float32),
                         "text": " ".join(rng.choice(words, rng.randint(10, 16)))})
    ctc_fn = load_ctc_fn(ctc_file, "hubert_large", 32)
    ctc_s = []

    def timed_ctc(audio):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ctc_fn(audio)  # ends in a copy to the host
        ctc_s.append(time.perf_counter() - t0)
        return out

    ctc_fn(examples[0]["audio"])  # warm-up (the 10 s bucket)
    gen = eng.generate_text_response_batch
    gen_s = []

    def timed_gen(*a, **k):
        t0 = time.perf_counter()
        try:
            return gen(*a, **k)
        finally:
            gen_s.append(time.perf_counter() - t0)

    eng.generate_text_response_batch = timed_gen
    # --- the main path, counted
    torch.cuda.synchronize()
    reset_launches()
    eng.counts.clear()
    try:
        t0 = time.perf_counter()
        with recorded_tokens(ByteTokenizer) as rows:
            out = list(iter_preprocess_examples(examples, eng, eng.tokenizer, ctc_fn=timed_ctc,
                                                response_batch_size=32))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del eng.generate_text_response_batch
    launches = read_launches()
    counts = dict(eng.counts)
    # ---
    L, H = eng.llm_cfg.num_layers, hubert_preset("hubert_large").num_layers
    check_launches("preprocess_full", launches, {
        "flash_attention": L * counts["prefills"], "flash_attention_f32": H * len(ctc_s),
        "fused_decode": L * counts["decode_steps"]})
    if len(out) != PREPROCESS_EXAMPLES or len(ctc_s) != PREPROCESS_EXAMPLES:
        raise AssertionError(f"preprocess_full: {len(out)} rows, {len(ctc_s)} CTC clips")
    for r in out:
        pr = np.asarray(r["pool_ranges_4"])
        if (pr.ndim != 2 or pr.shape[1] != 2 or r["text_input_ids"][0] != eng.tokenizer.bos_id
                or not isinstance(r["llm_response"], str)):
            raise AssertionError("preprocess_full: a row out of the schema")
    generated = sum(len(x) for x in rows[:PREPROCESS_EXAMPLES])

    # one clip: the float32 B1 against the plain attention, margin-aware
    cfg = hubert_preset("hubert_large")
    payload = load_params(ctc_file, "cuda")  # as stored: bf16
    enc16, head16 = payload["enc_params"], payload["head_params"]
    enc, head = (tree_map(lambda t: t.float(), x) for x in (enc16, head16))
    wav = torch.from_numpy(examples[0]["audio"][None]).to("cuda")
    forward, inside = hubert_mod.hubert_forward, []

    def recorded(*a, **k):  # the TF32 settings the CTC forward runs under
        inside.append((torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()))
        return forward(*a, **k)

    caller = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # the package default, as a caller would leave it
    hubert_mod.hubert_forward = recorded
    logits = {}
    try:
        for plain in (False, True):
            with torch.no_grad(), (plain_attention() if plain else contextlib.nullcontext()):
                logits[plain] = hubert_ctc_logits(enc, head, cfg, wav)[0][0]
        restored = torch.backends.cudnn.allow_tf32
    finally:
        hubert_mod.hubert_forward = forward
        torch.backends.cudnn.allow_tf32 = caller
    if inside != [(False, "highest")] * 2 or restored is not True:
        raise AssertionError(f"preprocess_full: TF32 settings inside the CTC forward {inside}, "
                             f"cuDNN's after it {restored}")
    with torch.no_grad():
        logits_bf16 = hubert_ctc_logits(enc16, head16, cfg, wav.bfloat16())[0][0]
    ids_k, ids_p = logits[False].argmax(-1), logits[True].argmax(-1)
    top2 = torch.topk(logits[True], 2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    flips = (ids_k != ids_p)
    if bool((flips & (margin > 2 * CTC_F32_LOGIT_TOL)).any()):
        raise AssertionError(f"preprocess_full: CTC ids flip where the plain margin exceeds "
                             f"{2 * CTC_F32_LOGIT_TOL}: {int(flips.sum())} flips")
    bf16_flips = int((logits_bf16.argmax(-1) != ids_k).sum())

    # CTC ms per clip, float32 (``ctc_fn``) and the file's bf16, in turns
    def bf16_ctc(audio):  # make_ctc_fn's bucketing on the bf16 trees
        n = len(audio)
        padded = np.zeros((1, max(16000, -(-n // 16000) * 16000)), np.float32)
        padded[0, :n] = audio
        mask = torch.zeros(padded.shape, dtype=torch.bool)
        mask[0, :n] = True
        mask = mask.to("cuda")
        with torch.no_grad():
            lg, fm = hubert_ctc_logits(enc16, head16, cfg,
                                       torch.from_numpy(padded).to("cuda", torch.bfloat16), mask)
            return lg[0, :int(fm[0].sum())].argmax(-1).cpu().numpy()

    turns = {"float32": [], "bfloat16": []}
    for i, e in enumerate(examples[:8]):
        order = (("float32", ctc_fn), ("bfloat16", bf16_ctc))
        for dt, fn in (order if i % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(e["audio"])  # ends in a copy to the host
            turns[dt].append(1e3 * (time.perf_counter() - t0))
    emit("preprocess_full", config="llama3_hubert.yaml", llm="converted checkpoint, int8",
         ctc="converted hubert-large CTC, vocab 32", examples=len(examples),
         rows_kept=len(out), response_batch_size=32, response_s=sum(gen_s),
         generated_tokens=generated, generated_tokens_per_s=generated / sum(gen_s),
         decode_steps=counts["decode_steps"], ctc_clips=len(ctc_s),
         ctc_ms_per_clip=1e3 * statistics.mean(ctc_s), ctc_ms_max=1e3 * max(ctc_s),
         wall_s=wall, ranges_per_clip=statistics.mean(len(r["pool_ranges_4"]) for r in out),
         ctc_dtype="float32", ctc_frames_checked=int(ids_k.numel()),
         ctc_id_flips=int(flips.sum()),
         ctc_max_abs_logit_diff=float((logits[False] - logits[True]).abs().max()),
         ctc_logit_tol=CTC_F32_LOGIT_TOL, ctc_id_flips_bf16_vs_f32=bf16_flips,
         ctc_max_abs_logit_diff_bf16_vs_f32=float((logits_bf16 - logits[False]).abs().max()),
         tf32_inside_ctc_forward=inside, cudnn_tf32_after=restored,
         ctc_ms_per_clip_turns={dt: statistics.mean(v) for dt, v in turns.items()},
         ctc_turns_clips=len(turns["float32"]), launches=launches, engine_counts=counts,
         card=card)
    return launches


def phase_eval_full(torch, card, eng):
    """``evaluate_engine`` over 16 synthetic examples at full width on the
    converted-checkpoint engine, with ``LlamaEmbedder`` (the full-width
    Llama, layer num_layers // 2) for BERTScore and the latency probes;
    counted: B1 per encoder layer per prompt build, per LLM layer per
    prefill and per embedder forward, B2 per LLM layer per decode step.
    With random weights the scores need only be finite and in [0, 1]."""
    from llm_speech_summarization_tpu_torch.data.datasets import SyntheticSpeechDataset
    from llm_speech_summarization_tpu_torch.eval import bertscore
    from llm_speech_summarization_tpu_torch.eval.evaluate import evaluate_engine

    ds = SyntheticSpeechDataset(eng.tokenizer, num_samples=16, seed=77)
    embedder = bertscore.LlamaEmbedder(eng.llm_params, eng.llm_cfg, eng.tokenizer)
    n_embed = []
    call = bertscore.LlamaEmbedder.__call__

    def counted(self, texts):
        n_embed.append(-(-len(texts) // self.batch_size))
        return call(self, texts)

    # --- the main path, counted
    torch.cuda.synchronize()
    reset_launches()
    eng.counts.clear()
    bertscore.LlamaEmbedder.__call__ = counted
    try:
        t0 = time.perf_counter()
        m = evaluate_engine(eng, ds, num_samples=16, batch_size=16, max_new_tokens=32,
                            bertscore_embedder=embedder)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        bertscore.LlamaEmbedder.__call__ = call
    launches = read_launches()
    counts = dict(eng.counts)
    # ---
    want = _expected_batch_launches(eng, counts)
    want["flash_attention"] += eng.llm_cfg.num_layers * sum(n_embed)
    check_launches("eval_full", launches, want)
    # a random full-width model's byte-tokenized texts are mostly empty, so
    # its BERTScore is 0; the embedder also scores the set's transcripts
    # against its responses (not counted), which have text on both sides
    texts = [ds[i]["text"] for i in range(16)]
    refs = [ds[i]["llm_response"] for i in range(16)]
    m["bertscore_f1_text_vs_response"] = bertscore.bert_score(texts, refs, embedder,
                                                              idf=True)["f1"]
    scores = {k: m[k] for k in ("rouge1", "rouge2", "rougeL", "bertscore_precision",
                                "bertscore_recall", "bertscore_f1",
                                "bertscore_f1_text_vs_response")}
    if not all(np.isfinite(v) and -1e-9 <= v <= 1.0 + 1e-9 for v in scores.values()):
        raise AssertionError(f"eval_full: scores {scores}")
    emit("eval_full", config="llama3_hubert.yaml", llm="converted checkpoint, int8",
         utterances=int(m["num_samples"]), wall_s=wall, scores=scores,
         embedder_layer=embedder.layer, embedder_forwards=sum(n_embed),
         ttft_p50_s=m["ttft_p50_s"], latency_p50_s=m["latency_p50_s"],
         latency_p90_s=m["latency_p90_s"], launches=launches, engine_counts=counts, card=card)
    return launches


def _minichat_ctc_yaml(path):
    """BASELINE config #1 as a YAML for the CLI: ``minichat_hubert.yaml``
    with the hubert-base encoder, ``ctc_pool`` and int8 LLM weights."""
    from llm_speech_summarization_tpu_torch.configs import YAML_DIR

    text = open(YAML_DIR / "minichat_hubert.yaml").read()
    for old, new in (("type: facebook/hubert-large-ls960-ft", "type: facebook/hubert-base-ls960"),
                     ("downsample_method: pool", "downsample_method: ctc_pool"),
                     ("  kv_cache_dtype: int8\n", "  kv_cache_dtype: int8\n  llm_weight_dtype: int8\n")):
        if old not in text:
            raise AssertionError(f"minichat_hubert.yaml lacks {old!r}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return path


def phase_ckpt_full(torch, card, export_file, ctc_file):
    """Checkpoints into the entry points: ``cli/infer.py -p <train_full's
    exported encoder> --audio_dir`` over the bulk phase's 32 clips on
    ``llama3_hubert.yaml`` (counted), its rows equal to per-batch calls of
    an engine handed the same encoder tree; then ``cli/infer.py --ctc
    <converted CTC>`` on BASELINE config #1 (``minichat_hubert.yaml``,
    hubert-base, ``ctc_pool``, int8) over 8 of those clips (counted; the CTC
    model in float32, B1's float32 instance per HuBERT-large layer per
    clip): CTC ms per clip and utt/s."""
    import shutil
    import tempfile

    from llm_speech_summarization_tpu_torch.cli import infer as cli_infer
    from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
    from llm_speech_summarization_tpu_torch.data import preprocess as pre_mod
    from llm_speech_summarization_tpu_torch.data.audio_io import load_audio
    from llm_speech_summarization_tpu_torch.infer import engine as engine_mod
    from llm_speech_summarization_tpu_torch.models.hubert import hubert_preset
    from llm_speech_summarization_tpu_torch.train.checkpoint import load_encoder
    from llm_speech_summarization_tpu_torch.utils.tokenizer import ByteTokenizer

    max_new = 32
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "clips")
        os.makedirs(d)
        _write_clips(d, BULK_CLIPS, seed=3)  # the bulk phase's clips
        out = os.path.join(tmp, "p.jsonl")
        # --- the main path, counted: -p through the CLI
        reset_launches()
        t0 = time.perf_counter()
        with recorded_tokens(ByteTokenizer) as cli_rows:
            eng = cli_infer.main(["-c", str(YAML_DIR / "llama3_hubert.yaml"), "-p", export_file,
                                  "--audio_dir", d, "--output", out, "--batch_size", "8",
                                  "--max_new_tokens", str(max_new)])
        torch.cuda.synchronize()
        p_s = time.perf_counter() - t0
        launches = read_launches()
        counts = dict(eng.counts)
        # ---
        check_launches("ckpt_full -p", launches, _expected_batch_launches(eng, counts))
        runs.append(launches)
        with open(out) as f:
            rows = [json.loads(x) for x in f]
        paths = cli_infer.audio_paths(d)
        if [r["file"] for r in rows] != paths:
            raise AssertionError("ckpt_full: -p rows out of order")
        audio = [load_audio(p) for p in paths]
        mem = engine_mod.LLMSpeechTextInference(
            load_config(str(YAML_DIR / "llama3_hubert.yaml")), llm_params=eng.llm_params,
            audio_encoder_params=load_encoder(export_file, "cuda"))
        with recorded_tokens(ByteTokenizer) as ref_rows:
            want = [t for i in range(0, BULK_CLIPS, 8)
                    for t in mem.generate_audio_response_batch(audio[i:i + 8],
                                                               max_new_tokens=max_new)]
        if [r["response"] for r in rows] != want or cli_rows != ref_rows:
            raise AssertionError("ckpt_full: the -p rows differ from the in-memory engine's")
        del eng, mem
        gc.collect()
        torch.cuda.empty_cache()

        # --ctc on BASELINE config #1, 8 clips
        d8 = os.path.join(tmp, "clips8")
        os.makedirs(d8)
        for p in paths[-8:]:
            shutil.copy(p, d8)
        yaml_path = _minichat_ctc_yaml(os.path.join(tmp, "minichat_base_ctc.yaml"))
        secs, init = {}, {}
        base = engine_mod.LLMSpeechTextInference

        class Timed(base):
            def __init__(self, *a, **k):
                t0 = time.perf_counter()
                super().__init__(*a, **k)
                init["s"] = time.perf_counter() - t0

        out8 = os.path.join(tmp, "ctc.jsonl")
        engine_mod.LLMSpeechTextInference = Timed
        try:
            reset_launches()
            t0 = time.perf_counter()
            with timed_calls(pre_mod, ("pool_ranges_for_audio",), secs):
                eng = cli_infer.main(["-c", yaml_path, "--ctc", ctc_file, "--audio_dir", d8,
                                      "--output", out8, "--batch_size", "8",
                                      "--max_new_tokens", str(max_new)])
            torch.cuda.synchronize()
            ctc_wall = time.perf_counter() - t0
        finally:
            engine_mod.LLMSpeechTextInference = base
        launches8 = read_launches()
        counts8 = dict(eng.counts)
        want8 = _expected_batch_launches(eng, counts8)
        want8["flash_attention_f32"] = hubert_preset("hubert_large").num_layers * 8
        check_launches("ckpt_full --ctc", launches8, want8)
        runs.append(launches8)
        with open(out8) as f:
            rows8 = [json.loads(x) for x in f]
        if len(rows8) != 8 or eng.encoder_setup.downsample_method != "ctc_pool":
            raise AssertionError("ckpt_full: --ctc rows")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    emit("ckpt_full", p_config="llama3_hubert.yaml", p_clips=BULK_CLIPS, p_cli_s=p_s,
         p_rows_equal=True, p_token_rows_compared=len(cli_rows), p_launches=launches,
         p_engine_counts=counts, ctc_config="minichat_hubert.yaml + hubert-base + ctc_pool",
         ctc_clips=8, ctc_cli_s=ctc_wall, ctc_engine_init_s=init["s"],
         ctc_ms_per_clip=1e3 * secs["pool_ranges_for_audio"] / 8,
         ctc_utt_per_s=8 / (ctc_wall - init["s"]), ctc_launches=launches8,
         ctc_engine_counts=counts8, card=card)
    return runs


def phase_train_whisper_full(torch, card):
    """Whisper KD at full width: ``llama3_whisper.yaml`` (Whisper-medium on
    dynamic frames, remat as configured) with the int8 frozen Llama-3.2-3B
    (``llm_weight_dtype`` int8 set here), B=16 synthetic clips in the 10 s
    bucket (500 encoder frames): a few steps and the closing validate (eval
    perplexity, two generations, a checkpoint), then a Trainer that resumes
    and takes one more step, both counted; one profiled step; then one step
    from the same state with the kernels and with the plain attention on
    the card, held to TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL and
    TRAIN_SIGN_AGREE."""
    import copy
    import shutil
    import tempfile

    from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
    from llm_speech_summarization_tpu_torch.train import make_train_state
    from llm_speech_summarization_tpu_torch.train.state import tree_leaves, tree_map
    from llm_speech_summarization_tpu_torch.train.trainer import Trainer

    steps = 3
    tmp = tempfile.mkdtemp(prefix="lss_whisper_")
    try:
        cfg = load_config(str(YAML_DIR / "llama3_whisper.yaml"))
        cfg.model.llm_weight_dtype = "int8"
        cfg.data.source = "synthetic"
        cfg.data.synthetic_num_samples = 64
        cfg.train.steps = steps
        cfg.log.checkpoint_dir = os.path.join(tmp, "ckpt")
        cfg.log.log_dir = os.path.join(tmp, "logs")
        cfg.log.log_interval = 1
        cfg.log.num_generate_samples = 2
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = Trainer(cfg, run_name="whisper")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        first = _trainer_run(torch, trainer, "train_whisper_full")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        batch = next(trainer._batches(trainer.train_ds, cfg.train.batch_size, True, 99))
        bucket = int(batch.wav.shape[1])
        total_len = trainer.total_len(bucket)
        B = cfg.train.batch_size
        times = [first["per_step"][s]["step_time_s"] for s in sorted(first["per_step"])]
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

        cfg2 = copy.deepcopy(cfg)
        cfg2.train.steps = steps + 1
        cfg2.log.num_generate_samples = 0
        resumed = Trainer(cfg2, run_name="whisper")
        if resumed.step != steps or resumed._resume_epoch_step != steps:
            raise AssertionError(f"whisper resume: at step {resumed.step}, "
                                 f"+{resumed._resume_epoch_step} batches, not {steps}")
        second = _trainer_run(torch, resumed, "train_whisper_full resumed")
        if resumed.step != steps + 1:
            raise AssertionError(f"whisper resume: ended at step {resumed.step}")
        profile_ = _profile_step(torch, resumed)

        # one step from the same state: kernels, then the plain attention
        step_fn = resumed._get_train_step(bucket)
        start = [p.detach().clone() for p in tree_leaves(resumed.state.enc_params)]
        runs = {}
        for plain in (False, True):
            it = iter(start)
            params = tree_map(lambda p: next(it).clone().requires_grad_(),
                              resumed.state.enc_params)
            state, _ = make_train_state(cfg2, params, resumed.total_opt_steps)
            with plain_attention() if plain else contextlib.nullcontext():
                state, metrics = step_fn(state, resumed.llm_params, batch)
            runs[plain] = ({k: v.item() for k, v in metrics.items()},
                           [p.detach() for p in tree_leaves(state.enc_params)])
            del state
        (m_k, p_k), (m_p, p_p) = runs[False], runs[True]
        lr = cfg.train.optimizer.lr
        moved = agree = 0
        for a, b_, s in zip(p_p, p_k, start):
            du_p, du_k = a - s, b_ - s
            big = du_p.abs() > lr / 2
            moved += int(big.sum())
            agree += int((big & ((du_p - du_k).abs() <= lr / 4)).sum())
        loss_err = {k: abs(m_k[k] - m_p[k]) / abs(m_p[k]) for k in m_p if k != "grad_norm"}
        gnorm_err = abs(m_k["grad_norm"] - m_p["grad_norm"]) / m_p["grad_norm"]
        agree_share = agree / max(moved, 1)
        finite = all(np.isfinite(v) for v in (*m_k.values(), *m_p.values()))
        if not (finite and max(loss_err.values()) <= TRAIN_LOSS_RTOL
                and gnorm_err <= TRAIN_GNORM_RTOL and agree_share >= TRAIN_SIGN_AGREE
                and moved > 0):
            raise AssertionError(f"train_whisper_full: kernels {m_k} vs plain {m_p}: loss rel "
                                 f"err {loss_err}, grad_norm rel err {gnorm_err}, update "
                                 f"agreement {agree_share} of {moved}")
        del runs, start, p_k, p_p
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tokens = B * total_len
    emit("train_whisper_full", config="llama3_whisper.yaml", llm_weight_dtype="int8",
         remat=cfg.train.remat, data="synthetic", batch=B, audio_samples=bucket,
         encoder_frames=bucket // 320, total_len=total_len, init_s=init_s,
         steps=first["steps"], per_step=first["per_step"], ms_per_step=[1e3 * t for t in times],
         tokens_per_s=[tokens / t for t in times], steady_ms_per_step=1e3 * min(times[1:]),
         steady_tokens_per_s=tokens / min(times[1:]), run_wall_s=first["wall_s"],
         max_memory_allocated_gb=peak_gb, launches=first["launches"],
         engine_counts=first["engine_counts"], eval_batches=first["eval_batches"],
         resumed=dict(steps=second["steps"], wall_s=second["wall_s"],
                      launches=second["launches"]),
         profiled_step=profile_, plain_check=dict(kernels=m_k, plain=m_p, loss_rel_err=loss_err,
                                                  loss_rtol=TRAIN_LOSS_RTOL,
                                                  grad_norm_rel_err=gnorm_err,
                                                  grad_norm_rtol=TRAIN_GNORM_RTOL,
                                                  update_agreement=agree_share,
                                                  update_agreement_min=TRAIN_SIGN_AGREE,
                                                  params_moved=moved),
         card=card)
    return first["launches"], second["launches"]


_WALLS = []  # (phase, seconds) of every phase main() ran, in order


def run_phase(fn, *args, **kw):
    """``fn(*args, **kw)``, its wall seconds kept under its name (without
    ``phase_``; repeated phases numbered) for the closing "walls" line."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        _WALLS.append((fn.__name__[len("phase_"):], round(time.perf_counter() - t0, 1)))


def main() -> int:
    # the tokenizer loader looks for a local HF tokenizer; never reach out
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
    import torch

    # outside a checkout of the repo this import fails before any output
    import llm_speech_summarization_tpu_torch  # noqa: F401

    card = run_phase(phase_env, torch)
    torch.set_grad_enabled(False)
    builds = start_builds()
    for fut in builds[0]:  # the flash libraries; the decode ones build on
        fut.result()
    flash = run_phase(phase_flash, torch, card)
    flash_f32 = run_phase(phase_flash_f32, torch, card)
    with torch.enable_grad():  # the SDPA yardstick's backward
        flash_train = run_phase(phase_flash_train, torch, card)
        flash_ring = run_phase(phase_flash_ring, torch, card)
        flash_train_f32 = run_phase(phase_flash_train_f32, torch, card)
    run_phase(phase_build, card, builds=builds)
    fused = run_phase(phase_fused, torch, card)
    paged = run_phase(phase_paged, torch, card)
    paged_mha = run_phase(phase_paged, torch, card, PAGED_MHA_SHAPE)
    paged_tp = run_phase(phase_paged, torch, card, PAGED_TP_SHAPE)
    fpaged = run_phase(phase_fused_paged, torch, card)
    fpaged_mha = run_phase(phase_fused_paged, torch, card, PAGED_MHA_SHAPE)
    fpaged_tp = run_phase(phase_fused_paged, torch, card, PAGED_TP_SHAPE)
    dense = run_phase(phase_dense_decode, torch, card)
    decode32 = run_phase(phase_decode_f32, torch, card)
    mixed = run_phase(phase_decode_mixed, torch, card)
    # serving_tp_full's ranks get ready from here on, after the timed
    # kernel phases
    global _POOL
    _POOL = _RankPool(keep=TP_RANKS)
    atexit.register(_POOL.close)
    _POOL.fill(TP_RANKS)
    run_phase(phase_serving_small, torch, card, *run_phase(phase_slice, torch, card))
    run_phase(phase_slice, torch, card, whisper=True)
    run_phase(phase_slice, torch, card, base=True)
    with torch.enable_grad():
        run_phase(phase_train_small, torch, card)
        run_phase(phase_train_small, torch, card, base=True)
    launches, eng = run_phase(phase_full, torch, card)
    serving = run_phase(phase_serving_full, torch, card, eng)
    gc.collect()
    tp_launches = run_phase(phase_serving_tp_full, torch, card)
    gc.collect()
    f32_runs = run_phase(phase_f32_full, torch, card, eng)
    gc.collect()
    mixed_runs = run_phase(phase_mixed_full, torch, card, eng)
    del eng
    # the servers' threads leave the engine in reference cycles: collect
    # them, or its weights stay allocated into the next phase's peak memory
    gc.collect()
    torch.cuda.empty_cache()
    minichat_runs = run_phase(phase_minichat_base_full, torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    router_launches = run_phase(phase_router_full, torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    bulk_launches, eng = run_phase(phase_bulk_full, torch, card)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    whisper_runs = run_phase(phase_whisper_full, torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="lss_offline_")  # the offline phases' files
    try:
        export = os.path.join(work, "train_full_encoder.pt")
        with torch.enable_grad():
            *train_runs, train_bf16 = run_phase(phase_train_full, torch, card, export)
            gc.collect()
            torch.cuda.empty_cache()
            save_qkv_launches = run_phase(phase_train_save_qkv_full, torch, card)
            gc.collect()
            torch.cuda.empty_cache()
            f32_train_launches = run_phase(phase_train_f32_full, torch, card, train_bf16)
        gc.collect()
        torch.cuda.empty_cache()
        convert_launches, eng, files = run_phase(phase_convert_full, torch, card, work)
        os.remove(files["llm"])  # the engine holds the LLM now
        preprocess_launches = run_phase(phase_preprocess_full, torch, card, eng, files["ctc"])
        _POOL.fill(2 * RING_RANKS + 2 + 2)  # ring (two launches), dp, tp
        eval_launches = run_phase(phase_eval_full, torch, card, eng)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        ckpt_runs = run_phase(phase_ckpt_full, torch, card, export, files["ctc"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    with torch.enable_grad():
        whisper_train_runs = run_phase(phase_train_whisper_full, torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    with torch.enable_grad():
        ring_launches = run_phase(phase_train_ring_full, torch, card)
        gc.collect()
        torch.cuda.empty_cache()
        _POOL.fill(2 + 2 + 8 + 2)  # dp, tp, the eight of 3-D and the float32 ring
        dp_launches = run_phase(phase_train_dp_full, torch, card)
        tp_launches_train = run_phase(phase_train_tp_full, torch, card)
        td_launches = run_phase(phase_train_3d_small, torch, card)
        ring_f32_launches = run_phase(phase_train_ring_f32, torch, card)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "llm_speech_summarization_tpu"))
    if leaked:
        raise AssertionError(f"the port imported {leaked}")
    # launches: the sum over the main-path runs (batch path, three servers,
    # the tensor-parallel ranks, the float32 engine's two batches, B8 stream
    # and paged server, the mixed engine's batch, B8 stream, speculative
    # engine and paged server, MiniChat + HuBERT-base with both projectors, its two replicas behind
    # the router, the bulk CLI, the Whisper batch path, its B8 stream and
    # server, the trainer, the resumed trainer and the save_qkv trainer,
    # the float32 trainer, the converted-checkpoint engine, preprocessing,
    # evaluation, -p and --ctc through the CLI, the Whisper trainer and its
    # resume, the ring trainer's ranks in both its launches, the
    # data-parallel (with its resume on mesh 1,1,1), tensor-parallel and
    # 2,2,2 trainers' ranks, and the float32 ring trainer's ranks)
    for run in ([r["launches"] for r in serving.values()] + [tp_launches] + f32_runs
                + mixed_runs + minichat_runs
                + [router_launches]
                + [bulk_launches] + whisper_runs + train_runs + [save_qkv_launches]
                + [f32_train_launches]
                + [convert_launches, preprocess_launches, eval_launches] + ckpt_runs
                + list(whisper_train_runs) + [ring_launches, dp_launches, tp_launches_train,
                                               td_launches, ring_f32_launches]):
        for k, v in run.items():
            launches[k] += v
    csrc = "llm_speech_summarization_tpu_torch/kernels/csrc/"
    kpkg = "llm_speech_summarization_tpu/kernels/"

    def entry(name, source, replaces, key, res, errs):
        return {"name": name, "route": "cuda", "source": csrc + source,
                "replaces": kpkg + replaces, "launches": launches[key],
                "max_abs_err": max(errs), "ms": res["ms"], "plain_ms": res["plain_ms"],
                "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
                "library_ms": res.get("library_ms")}

    kernels = [
        entry("flash_attention_fwd", "flash_attention.cu", "flash_attention.py:37",
              "flash_attention", flash["llm_prefill"], [r["max_abs_err"] for r in flash.values()]),
        entry("flash_attention_fwd_f32", "flash_attention_f32.cu", "flash_attention.py:37",
              "flash_attention_f32", flash_f32["ctc_10s"],
              [r["max_abs_err"] for r in flash_f32.values()]),
        entry("fused_decode", "fused_decode.cu", "fused_decode.py:375", "fused_decode",
              fused[(16, 1, 384)], [r["max_abs_err"] for r in fused.values()]),
        entry("paged_decode_attention", "paged_attention.cu", "paged_attention.py:115",
              "paged_attention", paged, [r["max_abs_err"] for r in (paged, paged_mha, paged_tp)]),
        entry("fused_paged_decode", "fused_paged.cu", "fused_paged.py:118", "fused_paged",
              fpaged, [r["max_abs_err"] for r in (fpaged, fpaged_mha, fpaged_tp)]),
        entry("fused_decode_attention_write", "fused_decode.cu", "fused_decode.py:169",
              "fused_decode_attention_write", dense["b3_bf16_T1"],
              [r["max_abs_err"] for k, r in dense.items() if k.startswith("b3")]),
        entry("decode_attention", "decode_attention.cu", "decode_attention.py:47",
              "decode_attention", dense["b8_bf16"],
              [r["max_abs_err"] for k, r in dense.items() if k.startswith("b8")]),
    ]
    for name, replaces, key, case, prefix in (  # the float32 instances, decode_f32.cu
            ("fused_decode_f32", "fused_decode.py:375", "fused_decode_f32", "b2_int8_B16_T1",
             "b2"),
            ("fused_decode_attention_write_f32", "fused_decode.py:169",
             "fused_decode_attention_write_f32", "b3_float32_T1", "b3"),
            ("paged_decode_attention_f32", "paged_attention.py:115", "paged_attention_f32",
             "b4_int8_T4", "b4"),
            ("fused_paged_decode_f32", "fused_paged.py:118", "fused_paged_f32", "b5_int8_T1",
             "b5"),
            ("decode_attention_f32", "decode_attention.py:47", "decode_attention_f32",
             "b8_float32", "b8")):
        kernels.append(entry(name, "decode_f32.cu", replaces, key, decode32[case],
                             [r["max_abs_err"] for k, r in decode32.items()
                              if k.startswith(prefix)]))
    for name, replaces, key, case, prefix in (  # the mixed instances, decode_f32.cu
            ("fused_decode_attention_write_mixed", "fused_decode.py:169",
             "fused_decode_attention_write_mixed", "b3_mixed_T1", "b3"),
            ("paged_decode_attention_mixed", "paged_attention.py:115", "paged_attention_mixed",
             "b4_mixed_T4", "b4"),
            ("fused_paged_decode_mixed", "fused_paged.py:118", "fused_paged_mixed",
             "b5_mixed_T1", "b5"),
            ("decode_attention_mixed", "decode_attention.py:47", "decode_attention_mixed",
             "b8_mixed", "b8")):
        kernels.append(entry(name, "decode_f32.cu", replaces, key, mixed[case],
                             [r["max_abs_err"] for k, r in mixed.items()
                              if k.startswith(prefix)]))
    for name, source, replaces, key in (
            ("flash_attention_lse", "flash_attention.cu", "flash_attention.py:37", "fwd_lse"),
            ("flash_attention_bwd_dq", "flash_attention_bwd.cu", "flash_attention.py:202", "dq"),
            ("flash_attention_bwd_dkv", "flash_attention_bwd_dkv.cu", "flash_attention.py:257",
             "dkv")):
        kernels.append(entry(name, source, replaces, name, flash_train["llm_train"][key],
                             [r[key]["max_abs_err"] for r in flash_train.values()]))
    for name, source, replaces, key in (  # B7: the offset mode, at the LLM ring's block
            ("flash_attention_lse_offset", "flash_attention.cu", "flash_attention.py:37", "fwd"),
            ("flash_attention_bwd_dq_offset", "flash_attention_bwd.cu", "flash_attention.py:202",
             "dq"),
            ("flash_attention_bwd_dkv_offset", "flash_attention_bwd_dkv.cu",
             "flash_attention.py:257", "dkv")):
        kernels.append(entry(name, source, replaces, name, flash_ring["llm_ring"][key],
                             [r[key]["max_abs_err"] for r in flash_ring.values()]))
    f32_train = {k: r for k, r in flash_train_f32.items() if not k.endswith("_ring")}
    f32_ring = {k: r for k, r in flash_train_f32.items() if k.endswith("_ring")}
    for name, source, replaces, key, results, case in (  # the float32 training instances
            ("flash_attention_lse_f32", "flash_attention_f32.cu", "flash_attention.py:37",
             "fwd_lse", f32_train, "llm_train"),
            ("flash_attention_bwd_dq_f32", "flash_attention_bwd_f32.cu",
             "flash_attention.py:202", "dq", f32_train, "llm_train"),
            ("flash_attention_bwd_dkv_f32", "flash_attention_bwd_f32.cu",
             "flash_attention.py:257", "dkv", f32_train, "llm_train"),
            ("flash_attention_lse_offset_f32", "flash_attention_f32.cu", "flash_attention.py:37",
             "fwd_lse", f32_ring, "llm_ring"),
            ("flash_attention_bwd_dq_offset_f32", "flash_attention_bwd_f32.cu",
             "flash_attention.py:202", "dq", f32_ring, "llm_ring"),
            ("flash_attention_bwd_dkv_offset_f32", "flash_attention_bwd_f32.cu",
             "flash_attention.py:257", "dkv", f32_ring, "llm_ring")):
        kernels.append(entry(name, source, replaces, name, results[case][key],
                             [r[key]["max_abs_err"] for r in results.values()]))
    kernels[0]["sdpa_ms"] = kernels[0]["library_ms"]
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise AssertionError(f"no main-path run launched {idle}")
    emit("walls", phases=[dict(phase=name, seconds=sec) for name, sec in _WALLS],
         total_s=round(time.perf_counter() - _START, 1), card=card)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--pooled-rank"]:  # a rank of a launch, waiting for its job
        sys.exit(pooled_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--ab-kernels"]:  # parent vs this checkout, kernel phases
        sys.exit(ab_kernels(sys.argv[2:]))
    if sys.argv[1:2] == ["--split-sweep"]:  # B2's split counts, timed
        sys.exit(split_sweep(sys.argv[2:]))
    if sys.argv[1:2] == ["--f32-train-kernels"]:  # the float32 kernel phases alone
        sys.exit(f32_train_kernels(sys.argv[2:]))
    sys.exit(main())

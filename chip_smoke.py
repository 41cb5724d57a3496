#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one H100 and check it.

    python3 chip_smoke.py

Phases, in order; each prints one line and any failure raises:
  1. environment: the card's name and power limit, torch/CUDA versions;
  2. build the five CUDA kernel libraries from ``llm_speech_summarization_tpu_
     torch/kernels/csrc`` with nvcc, one process per library, all at once;
  3. flash attention (B1) against its plain version at the main path's two
     shapes (LLM prefill, HuBERT self-attention), and the one PyTorch call
     that computes the same attention (timed only);
  4. the training attention kernels, B1 with its log-sum-exp and the
     backward B6 (dq; dk/dv), against their plain versions run in float32
     at the two training shapes (the LLM at the trainer's spliced length,
     HuBERT at 499 frames), with injected faults the bound must reject,
     bit-identical repeats, and SDPA forward + backward as the yardstick;
  5. fused decode (B2) against its plain version, including the in-place
     cache writes, at T=1 and T=3;
  6. paged decode attention (B4) and fused paged decode + page write (B5)
     against their plain versions at the serving shape, page writes
     bit-exact;
  7. the slice at a small kernel-legal width on the card and on the CPU,
     from the same weights: the batch path, then a paged ``SlotDecoder``
     teacher-forced through admissions and plain and speculative chunks;
  8. one KD train step at that width on the CPU and on the card, from the
     same weights and batch;
  9. the full-width ``llama3_hubert.yaml`` batch path through
     ``generate_audio_response_batch(es)``;
 10. the full-width serving path: ``SummarizationServer`` over HTTP with
     the paged cache, then with speculative chunks, then with the dense
     cache;
 11. the full-width trainer (``Trainer(...).train()`` on synthetic data): a
     few KD steps and the closing ``validate()``, then a second trainer
     that resumes from its checkpoint and takes one more step, and one
     profiled step for the device-busy share.
Every main-path run is driven with the launch counts set to 0 just before it
and checked just after against what the engine, decoder or trainer ran.
Then the card line, one JSON line with every kernel's summary, and the
status line.

Needs one CUDA card of compute capability 9.0; exits nonzero otherwise.
"""

from __future__ import annotations

import json
import os
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
# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a call is the larger
# of its bytes over the memory rate and its bf16 operations over the
# tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
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




def bound_ms(n_bytes: float, flops: float):
    """(least milliseconds the card could take, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def device_ms(torch, fn, reps: int = 20, sessions: int = 3, tries: int = 8,
              whole: bool = True) -> float:
    """Device milliseconds per call of ``fn``: the summed duration of the
    GPU work it launched (torch.profiler), without host dispatch gaps.
    A profiling session now and then loses device events, which lowers
    its sum and its event count, so a session counts only if it recorded
    as many device events as the fullest session, a whole number per
    call (``whole=False`` drops that second rule for calls of many
    kernels, where a session was seen to record one event fewer than a
    whole number per call every time); the median of ``sessions`` such
    sessions, out of at most ``tries``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    runs = []  # (device events, device microseconds) per session

    def complete():
        most = max(n for n, _ in runs)
        return [us for n, us in runs if n == most and (n % reps == 0 or not whole) and n > 0]

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


def phase_build(card):
    """One nvcc per kernel library, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from llm_speech_summarization_tpu_torch.kernels import (
        build, flash_attention, fused_decode, fused_paged, paged_attention,
    )

    t0 = time.perf_counter()
    libs = (flash_attention._lib, flash_attention._bwd_lib, fused_decode._lib,
            paged_attention._lib, fused_paged._lib)
    with ThreadPoolExecutor(max_workers=len(libs)) as pool:
        for fut in [pool.submit(lib) for lib in libs]:
            fut.result()
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds={k: round(v, 3) for k, v in build.build_seconds.items()}, card=card)


def phase_flash(torch, card):
    from llm_speech_summarization_tpu_torch.kernels.flash_attention import (
        flash_attention_fwd, flash_attention_reference,
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
    }
    for name, c in cases.items():
        B, T = c["B"], c["T"]
        q = torch.from_numpy(rng.randn(B, T, c["Hq"], c["Dh"]).astype(np.float32)).to(dev, torch.bfloat16)
        k = torch.from_numpy(rng.randn(B, T, c["Hkv"], c["Dh"]).astype(np.float32)).to(dev, torch.bfloat16)
        v = torch.from_numpy(rng.randn(B, T, c["Hkv"], c["Dh"]).astype(np.float32)).to(dev, torch.bfloat16)
        starts = torch.tensor(c["starts"], dtype=torch.int32, device=dev)
        ends = torch.tensor(c["ends"], dtype=torch.int32, device=dev)
        got = flash_attention_fwd(q, k, v, starts, ends, causal=c["causal"])
        ref = flash_attention_reference(q, k, v, starts, ends, causal=c["causal"])
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"B1 {name}: non-finite output (pad rows must stay finite)")
        pos = torch.arange(T, device=dev)[None, :]
        rows = (pos >= starts[:, None]) & (pos < ends[:, None])  # valid query rows
        err = (got.float() - ref.float()).abs().amax(dim=(2, 3))[rows].max().item()
        if not err <= B1_TOL:
            raise AssertionError(f"B1 {name}: max |err| {err} > {B1_TOL}")
        t = timings(torch, lambda: flash_attention_fwd(q, k, v, starts, ends, causal=c["causal"]),
                    lambda: flash_attention_reference(q, k, v, starts, ends, causal=c["causal"]))
        t["library_ms"] = device_ms(torch, _sdpa_call(torch, q, k, v, rows, c["causal"]))
        n_bytes, flops = _flash_work(c, T)
        t["bound_ms"], t["bound_by"] = bound_ms(n_bytes, flops)
        results[name] = dict(max_abs_err=err, **t)
        emit("flash_attention", case=name, shape=[B, T, c["Hq"], c["Hkv"], c["Dh"]],
             causal=c["causal"], max_abs_err=err, tol=B1_TOL, bytes=n_bytes, flops=flops, **t,
             card=card)
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


def _flash_work(c, T):
    """(bytes, flops) of one B1 call: q, k, v read and out written once in
    bf16; 2 flops per multiply-add of q.k and p.v over the valid
    (query, key) pairs of each window."""
    B, Hq, Hkv, Dh = c["B"], c["Hq"], c["Hkv"], c["Dh"]
    n_bytes = 2 * B * T * Dh * (2 * Hq + 2 * Hkv)
    pairs = 0
    for s0, e0 in zip(c["starts"], c["ends"]):
        n = e0 - s0
        pairs += n * (n + 1) // 2 if c["causal"] else n * n
    return float(n_bytes), float(4 * Dh * Hq * pairs)


def phase_fused(torch, card):
    from llm_speech_summarization_tpu_torch.kernels.fused_decode import (
        fused_decode, fused_decode_reference,
    )

    rng = np.random.RandomState(1)
    dev = torch.device("cuda")
    L, B, Hq, Hkv, S, Dh, layer = 2, 16, 24, 8, 384, 128, 1
    results = {}
    for T in (1, 3):
        q = torch.from_numpy(rng.randn(B, T, Hq, Dh).astype(np.float32)).to(dev, torch.bfloat16)
        kn = torch.from_numpy(rng.randn(B, T, Hkv, Dh).astype(np.float32)).to(dev, torch.bfloat16)
        vn = torch.from_numpy(rng.randn(B, T, Hkv, Dh).astype(np.float32)).to(dev, torch.bfloat16)
        kc = torch.from_numpy(rng.randint(-127, 128, size=(L, B, Hkv, S, Dh)).astype(np.int8)).to(dev)
        vc = torch.from_numpy(rng.randint(-127, 128, size=(L, B, Hkv, S, Dh)).astype(np.int8)).to(dev)
        ks = torch.from_numpy((0.02 + 0.1 * rng.rand(L, B, Hkv, S)).astype(np.float32)).to(dev, torch.bfloat16)
        vs = torch.from_numpy((0.02 + 0.1 * rng.rand(L, B, Hkv, S)).astype(np.float32)).to(dev, torch.bfloat16)
        pads = torch.from_numpy(rng.randint(0, 5, size=(B,)).astype(np.int32)).to(dev)
        offs_np = rng.randint(8, S - T, size=(B,)).astype(np.int32)
        offs_np[0] = S - T  # the last slot(s) of the cache
        offs_np[1] = 0  # nothing cached yet: only the fresh block
        offs = torch.from_numpy(offs_np).to(dev)
        snap = [t.clone() for t in (kc, vc, ks, vs)]
        ref_bufs = [t.clone() for t in snap]
        got_bufs = [t.clone() for t in snap]
        ref = fused_decode_reference(q, *ref_bufs, kn, vn, pads, offs, layer)
        got = fused_decode(q, *got_bufs, kn, vn, pads, offs, layer, max_offset=int(offs_np.max()))
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        if not torch.allclose(got.float(), ref.float(), atol=B2_ATOL, rtol=B2_RTOL):
            raise AssertionError(f"B2 T={T}: out differs from the plain version (max |err| {err})")
        written = torch.zeros((L, B, Hkv, S), dtype=torch.bool, device=dev)
        for b in range(B):
            written[layer, b, :, offs_np[b]:offs_np[b] + T] = True
        for name, g, r, s0 in zip(("k_cache", "v_cache", "k_scale", "v_scale"),
                                  got_bufs, ref_bufs, snap):
            if not torch.equal(g, r):
                raise AssertionError(f"B2 T={T}: {name} differs from the plain version's write "
                                     f"at {int((g != r).sum())} elements")
            if not torch.equal(g[~written], s0[~written]):
                raise AssertionError(f"B2 T={T}: {name} changed outside the written slots")
            if torch.equal(g[written], s0[written]):
                raise AssertionError(f"B2 T={T}: {name} was not written")
        t = timings(torch, lambda: fused_decode(q, *got_bufs, kn, vn, pads, offs, layer,
                                                max_offset=int(offs_np.max())),
                    lambda: fused_decode_reference(q, *ref_bufs, kn, vn, pads, offs, layer))
        # bytes: the valid int8 cache slots of k and v with their bf16
        # scales, q, the fresh k/v, the output and the written slots
        valid = np.clip(offs_np - pads.cpu().numpy(), 0, None).astype(np.int64)
        n_bytes = (valid.sum() * Hkv * (2 * Dh + 4) + 2 * B * T * (2 * Hq + 2 * Hkv) * Dh
                   + B * T * Hkv * 2 * (Dh + 2))
        flops = 4 * Dh * Hq * T * (valid.sum() + B * (T + 1) / 2)
        t["bound_ms"], t["bound_by"] = bound_ms(float(n_bytes), float(flops))
        results[T] = dict(max_abs_err=err, **t)
        emit("fused_decode", T=T, shape=[L, B, Hq, Hkv, S, Dh], max_abs_err=err,
             atol=B2_ATOL, rtol=B2_RTOL, cache_writes="bit-exact", bytes=float(n_bytes),
             flops=float(flops), **t, card=card)
    return results


PAGED_SHAPE = dict(B=16, Hq=24, Hkv=8, Dh=128, ps=128, mp=7, L=2)
PAGED_SEED = 4  # B4 and B5 read the same pages
PAGED_T_MAX = 4  # lengths leave room for this many fresh tokens at every T


def _paged_case(torch, seed, T, write, device="cuda"):
    """The serving shape, int8 pools with scattered pages, pad rows (one
    past the first page), rows at page boundaries, a row with only the
    fresh block; with ``write`` (B5) also a row at length == ps * mp and a
    released row (table of zeros). Pools, scales, table, pads and lengths
    come from ``seed`` alone, so every T (and B5) reads the same pages;
    q and the fresh k/v from ``(seed, T)``."""
    c = PAGED_SHAPE
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


def _paged_work(lengths, pads, T, write):
    """(bytes, flops) one call needs at PAGED_SHAPE: the valid positions'
    int8 k/v and bf16 scales, q, the fresh k/v and the output, plus the
    written slots (B5); 2 flops per multiply-add of q.k and p.v."""
    c = PAGED_SHAPE
    B, Hq, Hkv, Dh, ps, mp = (c[k] for k in ("B", "Hq", "Hkv", "Dh", "ps", "mp"))
    valid = np.clip(np.minimum(lengths, ps * mp) - pads, 0, None).astype(np.int64)
    n_bytes = valid.sum() * Hkv * (2 * Dh + 2 * 2) + 2 * B * T * (2 * Hq + 2 * Hkv) * Dh
    if write:
        n_bytes += B * Hkv * 2 * (Dh + 2)
    fresh_pairs = B * Hq * T * (T + 1) // 2
    flops = 4 * Dh * (Hq * T * valid.sum() + fresh_pairs)
    return float(n_bytes), float(flops)


def _paged_check(torch, what, got, plain, exact_fn, rows, lens, pads, ks, vs, table):
    """Hold ``got`` to the float32 plain version ``exact_fn()`` within
    PAGED_ATOL + PAGED_RTOL * |exact| on ``rows``, and show that bound
    rejects faults a kernel could make: ``exact_fn`` run with a pad or a
    length shifted by one, each row's first page dropped, the k or v
    scales shifted one slot, the tables of rows 0 and 1 swapped. Returns
    the check's numbers."""
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
    mutants = {
        "pad+1": dict(pads=pads + live),
        "length-1": dict(lens=lens - live),
        "first page dropped": dict(pads=torch.where(lens - pads > ps, (pads // ps + 1) * ps,
                                                    pads).int()),
        "k scale shifted": dict(ks=torch.roll(ks, 1, dims=-1)),
        "v scale shifted": dict(vs=torch.roll(vs, 1, dims=-1)),
        "tables swapped": dict(table=table[[1, 0] + list(range(2, table.shape[0]))].contiguous()),
    }
    rejected = {name: worst(exact_fn(**kw)) for name, kw in mutants.items()}
    if min(rejected.values()) <= 1:
        raise AssertionError(f"{what}: the bound does not reject every fault: {rejected}")
    a = exact[rows].abs()
    return dict(max_abs_err=err, err_over_bound=ratio,
                err_vs_bf16_plain=(got.float() - plain.float())[rows].abs().max().item(),
                out_rms=a.pow(2).mean().sqrt().item(), out_median_abs=a.median().item(),
                faults_over_bound=rejected)


def phase_paged(torch, card):
    """B4 against its plain version at the speculative-verification shape
    (T = spec_k + 1 = 4), reading layer 1 of (L, ...) pools in place."""
    from llm_speech_summarization_tpu_torch.kernels.paged_attention import (
        paged_decode_attention, paged_reference,
    )

    T, layer = 4, 1
    (q, kp, vp, ks, vs, table, lens, pads, kn, vn,
     lens_np, pads_np, _) = _paged_case(torch, PAGED_SEED, T, write=False)
    args = (q, kp[layer], vp[layer], table, lens, pads, kn, vn, ks[layer], vs[layer])
    snap = [t.clone() for t in (kp, vp, ks, vs)]
    got = paged_decode_attention(*args)
    plain = paged_reference(*args)

    def exact_fn(table=table, lens=lens, pads=pads, ks=ks, vs=vs):
        return paged_reference(q.float(), kp[layer], vp[layer], table, lens, pads, kn.float(),
                               vn.float(), ks[layer], vs[layer])

    rows = torch.ones(q.shape[0], dtype=torch.bool, device=q.device)
    check = _paged_check(torch, "B4", got, plain, exact_fn, rows, lens, pads, ks, vs, table)
    for t, s0 in zip((kp, vp, ks, vs), snap):
        if not torch.equal(t, s0):
            raise AssertionError("B4 wrote into the pools")
    t = timings(torch, lambda: paged_decode_attention(*args), lambda: paged_reference(*args))
    n_bytes, flops = _paged_work(lens_np, pads_np, T, write=False)
    b_ms, b_by = bound_ms(n_bytes, flops)
    emit("paged_attention", T=T, shape=PAGED_SHAPE, **check, atol=PAGED_ATOL, rtol=PAGED_RTOL,
         bytes=n_bytes, flops=flops, bound_ms=b_ms, bound_by=b_by, **t, card=card)
    return dict(max_abs_err=check["max_abs_err"], bound_ms=b_ms, bound_by=b_by, **t)


def phase_fused_paged(torch, card):
    """B5 against its plain version at the decode shape (T = 1, L = 2):
    outputs close, page writes bit-exact outside page 0, nothing else
    changed."""
    from llm_speech_summarization_tpu_torch.kernels.fused_paged import (
        _write_targets, fused_paged_decode, fused_paged_reference,
    )

    layer = 1
    (q, kp, vp, ks, vs, table, lens, pads, kn, vn,
     lens_np, pads_np, table_np) = _paged_case(torch, PAGED_SEED, 1, write=True)
    snap = [t.clone() for t in (kp, vp, ks, vs)]
    got_bufs = [t.clone() for t in snap]
    ref_bufs = [t.clone() for t in snap]
    got = fused_paged_decode(q, *got_bufs, table, lens, pads, kn, vn, layer)
    plain = fused_paged_reference(q, *ref_bufs, table, lens, pads, kn, vn, layer)

    def exact_fn(table=table, lens=lens, pads=pads, ks=snap[2], vs=snap[3]):
        return fused_paged_reference(q.float(), snap[0].clone(), snap[1].clone(), ks.clone(),
                                     vs.clone(), table, lens, pads, kn.float(), vn.float(), layer)

    # the released row reads page 0 while other rows write it: compare the rest
    rows = torch.from_numpy((table_np != 0).all(axis=1)).cuda()
    check = _paged_check(torch, "B5", got, plain, exact_fn, rows, lens, pads, snap[2], snap[3],
                         table)
    pid, slot = _write_targets(table, lens, PAGED_SHAPE["ps"])
    written = torch.zeros(snap[2].shape, dtype=torch.bool, device="cuda")  # (L, P, Hkv, ps)
    written[layer, pid, :, slot] = True
    written[:, 0] = True  # page 0 takes the boundary and released rows' tokens
    n_written = int((pid != 0).sum())
    for name, g, r, s0 in zip(("k_pool", "v_pool", "k_scale", "v_scale"), got_bufs, ref_bufs,
                              snap):
        if not torch.equal(g[:, 1:], r[:, 1:]):
            raise AssertionError(f"B5: {name} differs from the plain version's write outside "
                                 f"page 0 at {int((g[:, 1:] != r[:, 1:]).sum())} elements")
        if not torch.equal(g[~written], s0[~written]):
            raise AssertionError(f"B5: {name} changed outside the written slots")
        if torch.equal(g[:, 1:][written[:, 1:]], s0[:, 1:][written[:, 1:]]):
            raise AssertionError(f"B5: {name} was not written")
    t = timings(torch, lambda: fused_paged_decode(q, *got_bufs, table, lens, pads, kn, vn, layer),
                lambda: fused_paged_reference(q, *ref_bufs, table, lens, pads, kn, vn, layer))
    n_bytes, flops = _paged_work(lens_np, pads_np, 1, write=True)
    b_ms, b_by = bound_ms(n_bytes, flops)
    emit("fused_paged", T=1, shape=PAGED_SHAPE, **check, atol=PAGED_ATOL, rtol=PAGED_RTOL,
         page_writes="bit-exact outside page 0", rows_written=n_written, bytes=n_bytes,
         flops=flops, bound_ms=b_ms, bound_by=b_by, **t, card=card)
    return dict(max_abs_err=check["max_abs_err"], bound_ms=b_ms, bound_by=b_by, **t)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def phase_slice(torch, card):
    """Small kernel-legal width, same weights on the CPU (plain versions)
    and the card (kernels)."""
    from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
    from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference
    from llm_speech_summarization_tpu_torch.models.hubert import HubertConfig
    from llm_speech_summarization_tpu_torch.models.llama import (
        LlamaConfig, init_kv_cache, llama_forward,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(str(YAML_DIR / "llama3_hubert.yaml"))
    cfg.model.llm_embedding_channels = 256
    llm_cfg = LlamaConfig(hidden_size=256, intermediate_size=1024, num_layers=2,
                          num_heads=6, num_kv_heads=2, head_dim=128)
    enc_cfg = HubertConfig(hidden_size=256, num_layers=2, num_heads=4, intermediate_size=1024)
    cpu = LLMSpeechTextInference(cfg, llm_cfg=llm_cfg, encoder_cfg=enc_cfg, device="cpu")
    gpu = LLMSpeechTextInference(
        cfg, llm_params=_to(cpu.llm_params, "cuda"),
        audio_encoder_params=_to(cpu.audio_encoder_params, "cuda"),
        llm_cfg=llm_cfg, encoder_cfg=enc_cfg, device="cuda",
    )
    rng = np.random.RandomState(1)
    clips = [(0.1 * rng.randn(n)).astype(np.float32) for n in (16000, 11200)]

    e_c, m_c = cpu.build_audio_prompt_batch(clips)
    e_g, m_g = gpu.build_audio_prompt_batch(clips)
    if not torch.equal(m_c, m_g.cpu()):
        raise AssertionError("slice: splice masks differ between CPU and card")
    embed_err = (e_g.cpu().float() - e_c.float()).abs().max().item()
    if not torch.allclose(e_g.cpu().float(), e_c.float(), atol=EMBED_TOL, rtol=EMBED_TOL):
        raise AssertionError(f"slice: spliced embeds differ (max |err| {embed_err})")

    # prefill + teacher-forced decode from the CPU's embeds and tokens
    B, Lp, _ = e_c.shape
    steps = 16
    caches = [init_kv_cache(llm_cfg, B, Lp + steps, torch.int8, device=d) for d in ("cpu", "cuda")]
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

    text_c = cpu.generate_audio_response_batch(clips, max_new_tokens=steps)
    text_g = gpu.generate_audio_response_batch(clips, max_new_tokens=steps)
    emit("slice_small", embed_max_abs_err=embed_err, embed_tol=EMBED_TOL,
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


def _train_attn_work(c, T):
    """(bytes, flops) of B1 + LSE, B6 dq and B6 dk/dv at case ``c``: each
    input read once and each output written once (bf16 tensors, float32 lse
    and delta), 2 flops per multiply-add over the valid (query, key) pairs:
    two products in the forward, three for dq (s, dp, dq), four for dk/dv
    (s, dp, dv, dk)."""
    B, Hq, Hkv, Dh = c["B"], c["Hq"], c["Hkv"], c["Dh"]
    pairs = 0
    for s0, e0 in zip(c["starts"], c["ends"]):
        n = e0 - s0
        pairs += n * (n + 1) // 2 if c["causal"] else n * n
    qo = 2 * B * T * Hq * Dh  # one (B, T, Hq, Dh) bf16 tensor
    kv = 2 * B * T * Hkv * Dh
    rowf = 4 * B * Hq * T  # one (B, Hq, T) float32 tensor
    return {
        "fwd_lse": (float(2 * qo + 2 * kv + rowf), float(4 * Dh * Hq * pairs)),
        "dq": (float(3 * qo + 2 * kv + 2 * rowf), float(6 * Dh * Hq * pairs)),
        "dkv": (float(2 * qo + 4 * kv + 2 * rowf), float(8 * Dh * Hq * pairs)),
    }


def phase_flash_train(torch, card):
    """B1 + LSE and B6 (dq, dk/dv) against their float32 plain versions at
    the two training shapes, the injected faults, bit-identical repeats,
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

        # bit-identical repeats (the remat recompute relies on it)
        out2, lse2 = flash_attention_fwd_lse(q, k, v, starts, ends, causal)
        dq2 = flash_attention_bwd_dq(q, k, v, g, lse, delta, starts, ends, causal)
        dk2, dv2 = flash_attention_bwd_dkv(q, k, v, g, lse, delta, starts, ends, causal)
        same = {"out": torch.equal(out, out2), "lse": torch.equal(lse, lse2),
                "dq": torch.equal(dq, dq2), "dk": torch.equal(dk, dk2),
                "dv": torch.equal(dv, dv2)}
        if not all(same.values()):
            raise AssertionError(f"{name}: two identical calls differ: {same}")

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
             faults_over_bound=faults, bit_identical=same, sdpa_fwd_ms=sdpa_f,
             sdpa_fwd_bwd_ms=sdpa_fb, kernels=res, card=card)
    return results


def _small_train_config():
    from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config

    cfg = load_config(str(YAML_DIR / "llama3_hubert.yaml"))
    cfg.model.llm_embedding_channels = 256
    cfg.data.source = "synthetic"
    cfg.train.buckets.audio_samples = (32000,)
    cfg.train.buckets.max_text_tokens = 64
    cfg.train.buckets.max_response_tokens = 64
    cfg.train.fd_loss_connector_layers = (0, 1, 2)  # embeddings and both blocks
    return cfg


def phase_train_small(torch, card):
    """One KD train step at a small kernel-legal width (2 layers, Dh 128 in
    the LLM and 64 in HuBERT) on the CPU and on the card."""
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
    from llm_speech_summarization_tpu_torch.train import make_train_state, make_train_step
    from llm_speech_summarization_tpu_torch.train.state import tree_leaves
    from llm_speech_summarization_tpu_torch.train.trainer import spliced_length
    from llm_speech_summarization_tpu_torch.utils.prompts import prompt_template_for
    from llm_speech_summarization_tpu_torch.utils.tokenizer import ByteTokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _small_train_config()
    llm_cfg = LlamaConfig(hidden_size=256, intermediate_size=1024, num_layers=2, num_heads=6,
                          num_kv_heads=2, head_dim=128)
    setup = dataclasses.replace(encoder_setup_from_config(cfg), encoder_cfg=HubertConfig(
        hidden_size=256, num_layers=2, num_heads=4, intermediate_size=1024))
    llm = quantize_llama_params(init_llama_params(torch.Generator().manual_seed(5), llm_cfg))
    enc = init_audio_encoder(torch.Generator().manual_seed(6), setup, dtype=torch.float32)
    tok = ByteTokenizer()
    tpl = prompt_template_for(cfg.model.llm_type)
    prefix, suffix = tok.encode(tpl.prefix, add_bos=True), tok.encode(tpl.suffix, add_bos=False)
    ds = SyntheticSpeechDataset(tok, num_samples=4, max_seconds=2.0)
    b = cfg.train.buckets
    batch = collate_batch([ds[i] for i in range(4)], audio_buckets=b.audio_samples,
                          max_text_tokens=b.max_text_tokens,
                          max_response_tokens=b.max_response_tokens)
    total_len = spliced_length(cfg, setup, len(prefix), len(suffix), batch.wav.shape[1])
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
    emit("train_small", total_len=total_len, batch=4, audio_samples=int(batch.wav.shape[1]),
         cpu=m_c, card_metrics=m_g, loss_rel_err=loss_err, loss_rtol=TRAIN_LOSS_RTOL,
         grad_norm_rel_err=gnorm_err, grad_norm_rtol=TRAIN_GNORM_RTOL,
         update_agreement=agree_share, update_agreement_min=TRAIN_SIGN_AGREE,
         params_moved=moved, tf32=False, card=card)


def _expected_train_launches(enc_layers, llm_layers, remat, steps, n_eval_batches, eng_counts):
    """What a trainer run launches: per train step the student's LLM and
    HuBERT layers run B1 + LSE once, and with remat once more in the
    backward's recompute, and B6 once each; the teacher's LLM layers B1;
    every validate's eval batch runs B1 in HuBERT and the stacked (audio, text) LLM forward; the generations
    run B1 per encoder forward and prefill and B2 per decode step."""
    both = enc_layers + llm_layers
    return {
        "flash_attention": llm_layers * steps + both * n_eval_batches
        + enc_layers * eng_counts.get("encoder_forwards", 0)
        + llm_layers * eng_counts.get("prefills", 0),
        "flash_attention_lse": (2 if remat else 1) * both * steps,
        "flash_attention_bwd_dq": both * steps,
        "flash_attention_bwd_dkv": both * steps,
        "fused_decode": llm_layers * eng_counts.get("decode_steps", 0),
    }


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
        trainer.config.train.remat, steps, n_eval, eng_counts))
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


def phase_train_full(torch, card):
    """The full-width ``llama3_hubert.yaml`` trainer on synthetic data: a
    few optimizer steps and the closing validate() (eval perplexity, two
    sampled generations, a checkpoint) into a temporary directory; then a
    second Trainer resumes from that checkpoint and takes one more step
    (and validates). Launch counts are checked for both runs; then one
    profiled step of the resumed trainer gives the device-busy share."""
    import copy
    import shutil
    import tempfile

    from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
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
    return first["launches"], second["launches"]


def _wrappers():
    from llm_speech_summarization_tpu_torch.kernels import flash_attention as fa
    from llm_speech_summarization_tpu_torch.kernels.fused_decode import fused_decode
    from llm_speech_summarization_tpu_torch.kernels.fused_paged import fused_paged_decode
    from llm_speech_summarization_tpu_torch.kernels.paged_attention import paged_decode_attention

    return {"flash_attention": fa.flash_attention_fwd, "fused_decode": fused_decode,
            "paged_attention": paged_decode_attention, "fused_paged": fused_paged_decode,
            "flash_attention_lse": fa.flash_attention_fwd_lse,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv}


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


def phase_full(torch, card):
    from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
    from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference
    from llm_speech_summarization_tpu_torch.models.llama import init_kv_cache, llama_forward

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

    # --- breakdown of one batch, stage by stage (not counted)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embeds, mask = eng.build_audio_prompt_batch(clips)
    torch.cuda.synchronize()
    enc_ms = 1e3 * (time.perf_counter() - t0)
    B, Lp, _ = embeds.shape
    steps = 16
    cache = init_kv_cache(eng.llm_cfg, B, Lp + steps, torch.int8, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = llama_forward(eng.llm_params, eng.llm_cfg, inputs_embeds=embeds, attn_mask=mask,
                        kv_cache=cache, cache_offset=0, last_logit_only=True)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    logits = out.logits[:, -1]
    if logits.shape != (B, eng.llm_cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError("full: prefill logits are not finite / of the expected shape")
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
        raise AssertionError("full: decode logits are not finite")
    emit("full_width", config="llama3_hubert.yaml", batch=8, clip_s=10, max_new_tokens=max_new,
         prompt_len=Lp, init_s=round(init_s, 3), batch_call_s=batch_s,
         utt_per_s=8 / batch_s, batches_call_s=batches_s, batches_utt_per_s=16 / batches_s,
         encoder_ms=enc_ms, prefill_ms=prefill_ms, decode_ms_per_step=decode_ms,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches=launches, engine_counts=counts, card=card)
    return launches, eng


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
    check_launches(name, launches, {
        "flash_attention": L * counts.get("prefills", 0)
        + enc_layers * eng_counts.get("encoder_forwards", 0),
        "fused_decode": 0 if paged else L * (steps + rounds),
        "paged_attention": L * rounds if paged else 0,
        "fused_paged": L * steps if paged else 0})
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


def main() -> int:
    # the tokenizer loader looks for a local HF tokenizer; never reach out
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
    import torch

    # outside a checkout of the repo this import fails before any output
    import llm_speech_summarization_tpu_torch  # noqa: F401

    card = phase_env(torch)
    torch.set_grad_enabled(False)
    phase_build(card)
    flash = phase_flash(torch, card)
    with torch.enable_grad():  # the SDPA yardstick's backward
        flash_train = phase_flash_train(torch, card)
    fused = phase_fused(torch, card)
    paged = phase_paged(torch, card)
    fpaged = phase_fused_paged(torch, card)
    phase_serving_small(torch, card, *phase_slice(torch, card))
    with torch.enable_grad():
        phase_train_small(torch, card)
    launches, eng = phase_full(torch, card)
    serving = phase_serving_full(torch, card, eng)
    del eng
    torch.cuda.empty_cache()
    with torch.enable_grad():
        train_runs = phase_train_full(torch, card)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "llm_speech_summarization_tpu"))
    if leaked:
        raise AssertionError(f"the port imported {leaked}")
    # launches: the sum over the main-path runs (batch path, three servers,
    # the trainer and the resumed trainer)
    for run in [r["launches"] for r in serving.values()] + list(train_runs):
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
        entry("fused_decode", "fused_decode.cu", "fused_decode.py:375", "fused_decode", fused[1],
              [r["max_abs_err"] for r in fused.values()]),
        entry("paged_decode_attention", "paged_attention.cu", "paged_attention.py:115",
              "paged_attention", paged, [paged["max_abs_err"]]),
        entry("fused_paged_decode", "fused_paged.cu", "fused_paged.py:118", "fused_paged",
              fpaged, [fpaged["max_abs_err"]]),
    ]
    for name, source, replaces, key in (
            ("flash_attention_lse", "flash_attention.cu", "flash_attention.py:37", "fwd_lse"),
            ("flash_attention_bwd_dq", "flash_attention_bwd.cu", "flash_attention.py:202", "dq"),
            ("flash_attention_bwd_dkv", "flash_attention_bwd.cu", "flash_attention.py:257",
             "dkv")):
        kernels.append(entry(name, source, replaces, name, flash_train["llm_train"][key],
                             [r[key]["max_abs_err"] for r in flash_train.values()]))
    kernels[0]["sdpa_ms"] = kernels[0]["library_ms"]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

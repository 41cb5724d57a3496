#!/usr/bin/env python3
"""The issue rate of ``mma.sync.m16n8k8`` with TF32 operands on one CUDA
card: the ceiling of the float32 flash kernels' 3xTF32 products.

    python3 scripts/torch_mma_tf32_rate.py

Builds a small probe (nvcc, ``sm_90a``, into ``kernels/_build/``) in which
every warp issues nothing but m16n8k8 TF32 products on register operands:
CHAINS independent accumulators, each taking DEP products in a row (DEP = 3
is the 3xTF32 pattern of ``csrc/flash_f32.cuh``: lo.hi, hi.lo, hi.hi into
one accumulator), at 4 or 8 warps a block, 16 blocks for each SM. Prints one
JSON line per variant: device ms (CUDA events), TF32 TFLOP/s and its share
of the dense TF32 peak (494.7 TFLOP/s, NVIDIA's data sheet), which is also
the share of the 3xTF32 float32 bound (that peak over 3, as PERF.md and
chip_smoke.py take it) a kernel issuing only these products would reach;
then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int CHAINS, int DEP>
__global__ void probe(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1e-3f * (threadIdx.x + i));
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(1e-3f * (blockIdx.x + i));
  float acc[CHAINS][4];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int d = 0; d < DEP; ++d) {
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) mma(acc[c], a, b);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int CHAINS, int DEP>
int run(float* out, int blocks, int threads, int iters, cudaStream_t s) {
  probe<CHAINS, DEP><<<blocks, threads, 0, s>>>(out, iters);
  return (int)cudaGetLastError();
}

extern "C" int mma_probe(void* out, int blocks, int threads, int iters, int chains, int dep,
                         void* stream) {
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chains == 4 && dep == 1) return run<4, 1>(o, blocks, threads, iters, s);
  if (chains == 8 && dep == 1) return run<8, 1>(o, blocks, threads, iters, s);
  if (chains == 4 && dep == 3) return run<4, 3>(o, blocks, threads, iters, s);
  if (chains == 8 && dep == 3) return run<8, 3>(o, blocks, threads, iters, s);
  return (int)cudaErrorInvalidValue;
}
"""

TF32_PEAK = 494.7e12
ITERS = 4096


def build() -> ctypes.CDLL:
    from llm_speech_summarization_tpu_torch.kernels import build as kbuild

    kbuild.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = kbuild.BUILD_DIR / "mma_tf32_probe.cu"
    lib = kbuild.BUILD_DIR / "libmma_tf32_probe.so"
    src.write_text(SOURCE)
    subprocess.run([kbuild.find_nvcc(), *kbuild.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.mma_probe.argtypes = [p, i, i, i, i, i, p]
    dll.mma_probe.restype = i
    return dll


def main() -> int:
    import torch

    import chip_smoke as cs

    card = cs.phase_env(torch)
    dll = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for warps in (4, 8):
        for chains, dep in ((4, 1), (8, 1), (4, 3), (8, 3)):
            blocks, threads = 16 * sms, 32 * warps
            out = torch.empty(blocks * threads, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def call():
                rc = dll.mma_probe(out.data_ptr(), blocks, threads, ITERS, chains, dep, stream)
                if rc:
                    raise RuntimeError(f"mma_probe: cudaError {rc}")

            call()
            torch.cuda.synchronize()
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            reps = 5
            t0.record()
            for _ in range(reps):
                call()
            t1.record()
            torch.cuda.synchronize()
            ms = t0.elapsed_time(t1) / reps
            flops = blocks * warps * ITERS * chains * dep * 2 * 16 * 8 * 8
            rate = flops / (ms * 1e-3)
            print(json.dumps(dict(phase="mma_tf32_rate", warps_a_block=warps, chains=chains,
                                  dep=dep, ms=ms, tf32_tflops=rate / 1e12,
                                  share_of_tf32_peak=rate / TF32_PEAK, card=card)), flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

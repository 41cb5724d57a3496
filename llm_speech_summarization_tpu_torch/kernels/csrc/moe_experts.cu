// K1: the routed experts of a DeepSeek-V3 MoE layer (Moonlight-16B-A3B: 64
// experts of SwiGLU width 1408 over hidden size 2048, 6 a token), as two
// grouped GEMM launches over the token-expert pairs sorted by expert:
//
//   gate-up:  H[r, :] = silu(X[tok(r)] . Wg[e]^T) * (X[tok(r)] . Wu[e]^T)   (rows of expert e)
//   down:     Y[r, :] = H[r] . Wd[e]^T                                      (float32)
//   combine:  out[t, :] = sum_j w[t, j] Y[dest[t, j], :]                     (bf16)
//
// and, before them, the pairs' sort by expert (a count and a scatter).
//
// It replaces no TPU kernel: the JAX package has no sparse experts. It was
// added because a batch's routed experts are 92% of a decode step's weight
// bytes and most of a prefill's FLOPs, and no single PyTorch call computes a
// grouped product over device-side segments without reading them on the
// host (which a CUDA graph cannot capture).
//
// What bounds it on the H100: in decode (~12 rows an expert at B = 128) the
// weights, 17.3 MB an expert, are read at ~4 FLOPs a byte, far below the
// card's ~295: bytes. In a prefill (~1,800 rows an expert) each weight tile
// meets hundreds of rows: the tensor cores. The design: a tile of BM sorted
// rows by BN output columns, K streamed in 32-wide slices through a ring of
// cp.async stages (16-byte copies, the A rows gathered by token index, rows
// past the expert's segment zero-filled), bf16 mma.sync m16n8k16 fed by
// ldmatrix from XOR-swizzled shared memory, float32 sums. 32 x 64 tiles (4
// warps) for decode, so one row tile holds an expert's rows and its weights
// are read once a call, in enough blocks (~2,800 at B = 128) that the last
// wave's idle SMs cost little; 128 x 128 tiles (8 warps) for prefill. The grid's y walks the
// experts' row tiles: each block finds its expert from the device-side
// segment offsets (no host read, so a graph can capture it), and the grid is
// sized for the worst case (ceil(rows / BM) + experts), blocks past the last
// tile returning at once. The grid's x walks the column tiles, so the blocks
// of one row tile run together and its gathered rows come from memory once.
// Each output element is one thread's sum in a fixed order: repeats are
// bit-identical.
//
// Layouts (all contiguous): X (N, D) bf16; tok (rows,) int32; offsets
// (E + 1,) int32, expert e's rows [offsets[e], offsets[e + 1]); Wgu (E, 2I,
// D) bf16 with gate rows [0, I) then up rows [I, 2I); H (rows, I) bf16; Wd
// (E, D, I) bf16; Y (rows, D) float32. D % 128 == 0, I % 64 == 0, D and I
// multiples of 32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace moe {

constexpr int BK = 32;
constexpr int MAX_EXPERTS = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, zero-filled when !pred
__device__ __forceinline__ void cp16(void* dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldm_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                       const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a (rows x 32) bf16 tile of 64-byte rows, its four 16-byte chunks swizzled
// by bits 1-2 of the row so that ldmatrix's 8 rows hit 8 distinct bank groups
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * BK + ((chunk ^ ((row >> 1) & 3)) << 3);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Args {
  const __nv_bfloat16* a;   // X (gate-up) or H (down)
  const int* tok;           // token of each sorted row (gate-up)
  const int* offsets;       // (E + 1,)
  const __nv_bfloat16* w;   // Wgu or Wd
  void* out;                // H (bf16) or Y (float32)
  int E, K, I, D;           // K: the reduced width (D for gate-up, I for down)
};

// MODE 0: gate-up with the silu * mul epilogue; MODE 1: down. STAGES: the
// depth of the cp.async ring.
template <int MODE, int BM, int WM, int WN, int STAGES>
__global__ void __launch_bounds__(WM* WN * 32) moe_gemm(Args p) {
  constexpr int THREADS = WM * WN * 32;
  constexpr int BN = WN * 32;        // columns a block covers
  constexpr int WTM = BM / WM;       // rows a warp covers
  constexpr int MT = WTM / 16;       // m16 tiles a warp
  constexpr int WTN = 32;            // columns a warp covers
  constexpr int NT = WTN / 8;        // n8 tiles a warp (4)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sB = sA + STAGES * BM * BK;
  __shared__ int s_tile[MAX_EXPERTS + 1];

  const int tid = threadIdx.x;
  if (tid == 0) {
    int acc = 0;
    for (int e = 0; e < p.E; ++e) {
      s_tile[e] = acc;
      const int n = p.offsets[e + 1] - p.offsets[e];
      acc += (n + BM - 1) / BM;
    }
    s_tile[p.E] = acc;
  }
  __syncthreads();
  const int t = blockIdx.y;
  if (t >= s_tile[p.E]) return;
  int e = 0;
  while (s_tile[e + 1] <= t) ++e;  // experts with no rows have no tiles
  const int m0 = p.offsets[e] + (t - s_tile[e]) * BM;
  const int m_end = p.offsets[e + 1];

  // the block's BN weight rows: gate-up interleaves, per warp column group
  // of 32, 16 gate rows and the 16 up rows of the same intermediate columns
  const int nb = blockIdx.x;
  const __nv_bfloat16* wexp =
      p.w + static_cast<size_t>(e) * (MODE == 0 ? 2 * p.I : p.D) * p.K;
  auto wrow = [&](int rr) -> int {
    if (MODE == 0) {
      const int g = rr >> 5, w = rr & 31;
      const int j = nb * (BN / 2) + g * 16 + (w & 15);
      return w < 16 ? j : p.I + j;
    }
    return nb * BN + rr;
  };

  // each thread copies the same 16-byte chunks of the same rows at every
  // K slice: their sources are found once
  constexpr int A_PER = BM * 4 / THREADS, B_PER = BN * 4 / THREADS;
  static_assert(A_PER >= 1 && B_PER >= 1, "a chunk or more of each tile a thread");
  const __nv_bfloat16* a_src[A_PER];
  bool a_ok[A_PER];
  const __nv_bfloat16* b_src[B_PER];
#pragma unroll
  for (int j = 0; j < A_PER; ++j) {
    const int i = tid + j * THREADS, r = i >> 2, c = i & 3, m = m0 + r;
    a_ok[j] = m < m_end;
    const size_t row = a_ok[j] ? (MODE == 0 ? static_cast<size_t>(p.tok[m]) : static_cast<size_t>(m))
                               : 0;
    a_src[j] = p.a + row * p.K + c * 8;
  }
#pragma unroll
  for (int j = 0; j < B_PER; ++j) {
    const int i = tid + j * THREADS, r = i >> 2, c = i & 3;
    b_src[j] = wexp + static_cast<size_t>(wrow(r)) * p.K + c * 8;
  }

  const int KT = p.K / BK;
  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
    __nv_bfloat16* a = sA + stage * BM * BK;
    __nv_bfloat16* b = sB + stage * BN * BK;
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
      const int i = tid + j * THREADS;
      cp16(a + swz(i >> 2, i & 3), a_src[j] + k0, a_ok[j]);
    }
#pragma unroll
    for (int j = 0; j < B_PER; ++j) {
      const int i = tid + j * THREADS;
      cp16(b + swz(i >> 2, i & 3), b_src[j] + k0, true);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WN, wn = warp % WN;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = kt + STAGES - 1;
    if (nxt < KT) load_stage(nxt % STAGES, nxt);
    cp_commit();
    const __nv_bfloat16* a = sA + (kt % STAGES) * BM * BK;
    const __nv_bfloat16* b = sB + (kt % STAGES) * BN * BK;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm * WTM + i * 16 + (lane & 15);
        ldm_x4(af[i][0], af[i][1], af[i][2], af[i][3], a + swz(r, kk * 2 + (lane >> 4)));
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        const int r = wn * WTN + j * 8 + ((lane >> 4) << 3) + (lane & 7);
        uint32_t b0, b1, b2, b3;
        ldm_x4(b0, b1, b2, b3, b + swz(r, kk * 2 + ((lane >> 3) & 1)));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma16816(acc[i][j], af[i], b0, b1);
          mma16816(acc[i][j + 1], af[i], b2, b3);
        }
      }
    }
  }
  cp_wait<0>();

  // epilogue: rows lane/4 and lane/4 + 8 of each m16 tile, two columns each
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * WTM + i * 16 + (lane >> 2) + half * 8;
      if (m >= m_end) continue;
      if (MODE == 0) {
        __nv_bfloat16* h = static_cast<__nv_bfloat16*>(p.out) + static_cast<size_t>(m) * p.I;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = nb * (BN / 2) + wn * 16 + j * 8 + (lane & 3) * 2;
          float v[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            // the rounding of the plain version: gate and up to bf16, silu
            // of the rounded gate to bf16, their product to bf16
            const float g = bf16_round(acc[i][j][half * 2 + q]);
            const float u = bf16_round(acc[i][j + 2][half * 2 + q]);
            const float s = bf16_round(g / (1.f + expf(-g)));
            v[q] = s * u;
          }
          *reinterpret_cast<__nv_bfloat162*>(h + col) = __floats2bfloat162_rn(v[0], v[1]);
        }
      } else {
        float* y = static_cast<float*>(p.out) + static_cast<size_t>(m) * p.D;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = nb * BN + wn * WTN + j * 8 + (lane & 3) * 2;
          *reinterpret_cast<float2*>(y + col) =
              make_float2(acc[i][j][half * 2], acc[i][j][half * 2 + 1]);
        }
      }
    }
  }
}

template <int MODE, int BM, int WM, int WN, int STAGES>
int launch(const Args& a, int rows, cudaStream_t s) {
  constexpr int BN = WN * 32;
  const size_t smem = static_cast<size_t>(STAGES) * (BM + BN) * BK * sizeof(__nv_bfloat16);
  auto kern = moe_gemm<MODE, BM, WM, WN, STAGES>;
  static bool sized = false;  // once per instance: the launch may be under graph capture
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const int n_tiles = MODE == 0 ? a.I / (BN / 2) : a.D / BN;
  // x the 128-column tiles, y the row tiles: the blocks of one row tile run
  // together, so its gathered rows are read from memory once and meet
  // every column tile from L2
  dim3 grid(n_tiles, (rows + BM - 1) / BM + a.E);
  kern<<<grid, WM * WN * 32, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int dispatch(const Args& a, int rows, int bm, cudaStream_t s) {
  // 32 x 64 tiles, 6 stages (the weights' bytes in flight: 4 read 5-7% slower);
  // 128 x 128 tiles, 4 stages (64 KB: three blocks an SM)
  if (bm == 32) return launch<MODE, 32, 2, 2, 6>(a, rows, s);
  if (bm == 128) return launch<MODE, 128, 2, 4, 4>(a, rows, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the combine: out[t] = sum_j w[t, j] * y[dest[t, j]] in the order of the
// choices, each product and sum rounded as PyTorch's separate mul and add
// round them, to bf16 at the end; a block a token, 8 columns a thread
__global__ void __launch_bounds__(256) moe_combine(const float* y, const int64_t* dest,
                                                   const float* w, __nv_bfloat16* out, int k,
                                                   int D) {
  const int t = blockIdx.x;
  for (int c = threadIdx.x * 4; c < D; c += blockDim.x * 4) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < k; ++j) {
      const float wj = w[static_cast<size_t>(t) * k + j];
      const float4 v = *reinterpret_cast<const float4*>(
          y + static_cast<size_t>(dest[static_cast<size_t>(t) * k + j]) * D + c);
      const float4 m = make_float4(__fmul_rn(wj, v.x), __fmul_rn(wj, v.y), __fmul_rn(wj, v.z),
                                   __fmul_rn(wj, v.w));
      acc = j == 0 ? m
                   : make_float4(__fadd_rn(acc.x, m.x), __fadd_rn(acc.y, m.y),
                                 __fadd_rn(acc.z, m.z), __fadd_rn(acc.w, m.w));
    }
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(t) * D + c);
    o[0] = __floats2bfloat162_rn(acc.x, acc.y);
    o[1] = __floats2bfloat162_rn(acc.z, acc.w);
  }
}

// the pairs sorted by expert, in blocks of ALIGN_PER_BLOCK pairs. Count:
// each block ranks its pairs within their expert by shared-memory atomics
// (the order inside a segment varies from run to run; each row's products
// do not depend on its place, so the results do not) and writes its counts;
// the last block to finish turns every block's counts into its start in
// each segment (a scan over the blocks for each expert, then over the
// experts) and writes the offsets and counts. Scatter: each pair to its
// block's start plus its rank. Where one block holds every pair (a decode
// step's), it scatters at once and the second launch is left out. Tokens
// not valid go to the last group, which no launch computes.
constexpr int ALIGN_THREADS = 1024;
constexpr int ALIGN_PER_BLOCK = 4096;

__device__ __forceinline__ int pair_expert(const int64_t* sel, const uint8_t* valid, int k, int E,
                                           int p) {
  return valid != nullptr && !valid[p / k] ? E : static_cast<int>(sel[p]);
}

__device__ __forceinline__ void scan_experts(const int* cnt, int* off, int E) {
  if (threadIdx.x == 0) {
    int a = 0;
    for (int e = 0; e <= E; ++e) {
      off[e] = a;
      a += cnt[e];
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(ALIGN_THREADS) moe_align_count(
    const int64_t* sel, const uint8_t* valid, int N, int k, int E, int* tok, int* offsets,
    int64_t* dest, int* counts, int* rank, int* base, unsigned* done) {
  __shared__ int cnt[MAX_EXPERTS + 1];
  __shared__ int off[MAX_EXPERTS + 1];
  __shared__ bool last;
  const int nk = N * k;
  const int p0 = blockIdx.x * ALIGN_PER_BLOCK, p1 = min(nk, p0 + ALIGN_PER_BLOCK);
  for (int e = threadIdx.x; e <= E; e += blockDim.x) cnt[e] = 0;
  __syncthreads();
  for (int p = p0 + threadIdx.x; p < p1; p += blockDim.x)
    rank[p] = atomicAdd(&cnt[pair_expert(sel, valid, k, E, p)], 1);
  __syncthreads();
  if (gridDim.x == 1) {
    scan_experts(cnt, off, E);
    for (int e = threadIdx.x; e <= E; e += blockDim.x) {
      offsets[e] = off[e];
      if (e < E) counts[e] = cnt[e];
    }
    for (int p = threadIdx.x; p < nk; p += blockDim.x) {
      const int e = pair_expert(sel, valid, k, E, p), pos = off[e] + rank[p];
      tok[pos] = p / k;
      dest[p] = e == E ? nk : pos;
    }
    return;
  }
  int* mine = base + static_cast<size_t>(blockIdx.x) * (E + 1);
  for (int e = threadIdx.x; e <= E; e += blockDim.x) mine[e] = cnt[e];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = threadIdx.x; e <= E; e += blockDim.x) {
    int run = 0;
    for (int b = 0; b < gridDim.x; ++b) {
      int* at = base + static_cast<size_t>(b) * (E + 1) + e;
      const int c = __ldcg(at);
      *at = run;
      run += c;
    }
    cnt[e] = run;
  }
  __syncthreads();
  scan_experts(cnt, off, E);
  for (int e = threadIdx.x; e <= E; e += blockDim.x) {
    offsets[e] = off[e];
    if (e < E) counts[e] = cnt[e];
    for (int b = 0; b < gridDim.x; ++b) base[static_cast<size_t>(b) * (E + 1) + e] += off[e];
  }
}

__global__ void __launch_bounds__(ALIGN_THREADS) moe_align_scatter(
    const int64_t* sel, const uint8_t* valid, int N, int k, int E, int* tok, int64_t* dest,
    const int* rank, const int* base) {
  const int nk = N * k;
  const int p0 = blockIdx.x * ALIGN_PER_BLOCK, p1 = min(nk, p0 + ALIGN_PER_BLOCK);
  const int* mine = base + static_cast<size_t>(blockIdx.x) * (E + 1);
  for (int p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
    const int e = pair_expert(sel, valid, k, E, p), pos = mine[e] + rank[p];
    tok[pos] = p / k;
    dest[p] = e == E ? nk : pos;
  }
}

}  // namespace moe

// rows: the sorted rows' capacity (N * k), which sizes the grid; bm: 32 or
// 128. Returns the cudaError_t of the launch (0 on success).
extern "C" int lss_moe_gateup(const void* x, const void* tok, const void* offsets,
                              const void* w_gateup, void* h, int rows, int E, int D, int I,
                              int bm, void* stream) {
  if (E > moe::MAX_EXPERTS || D % moe::BK || I % 64) return (int)cudaErrorInvalidValue;
  moe::Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(tok),
              static_cast<const int*>(offsets), static_cast<const __nv_bfloat16*>(w_gateup), h,
              E, D, I, D};
  return moe::dispatch<0>(a, rows, bm, static_cast<cudaStream_t>(stream));
}

extern "C" int lss_moe_down(const void* h, const void* offsets, const void* w_down, void* y,
                            int rows, int E, int D, int I, int bm, void* stream) {
  if (E > moe::MAX_EXPERTS || I % moe::BK || D % 128) return (int)cudaErrorInvalidValue;
  moe::Args a{static_cast<const __nv_bfloat16*>(h), nullptr, static_cast<const int*>(offsets),
              static_cast<const __nv_bfloat16*>(w_down), y, E, I, I, D};
  return moe::dispatch<1>(a, rows, bm, static_cast<cudaStream_t>(stream));
}

extern "C" int lss_moe_combine(const void* y, const void* dest, const void* w, void* out, int N,
                               int k, int D, void* stream) {
  if (D % 4) return (int)cudaErrorInvalidValue;
  moe::moe_combine<<<N, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const int64_t*>(dest),
      static_cast<const float*>(w), static_cast<__nv_bfloat16*>(out), k, D);
  return static_cast<int>(cudaGetLastError());
}

// the blocks of ALIGN_PER_BLOCK pairs the sort takes (the workspace's rows)
extern "C" int lss_moe_align_blocks(int pairs) {
  return (pairs + moe::ALIGN_PER_BLOCK - 1) / moe::ALIGN_PER_BLOCK;
}

// base: (blocks, E + 1) int32 workspace; done: one zeroed uint32 (unread
// where one block holds every pair)
extern "C" int lss_moe_align(const void* sel, const void* valid, int N, int k, int E, void* tok,
                             void* offsets, void* dest, void* counts, void* rank, void* base,
                             void* done, void* stream) {
  if (E > moe::MAX_EXPERTS || N * k < 1) return (int)cudaErrorInvalidValue;
  const int blocks = lss_moe_align_blocks(N * k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* sel_ = static_cast<const int64_t*>(sel);
  const uint8_t* valid_ = static_cast<const uint8_t*>(valid);
  moe::moe_align_count<<<blocks, moe::ALIGN_THREADS, 0, s>>>(
      sel_, valid_, N, k, E, static_cast<int*>(tok), static_cast<int*>(offsets),
      static_cast<int64_t*>(dest), static_cast<int*>(counts), static_cast<int*>(rank),
      static_cast<int*>(base), static_cast<unsigned*>(done));
  if (blocks > 1) {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    moe::moe_align_scatter<<<blocks, moe::ALIGN_THREADS, 0, s>>>(
        sel_, valid_, N, k, E, static_cast<int*>(tok), static_cast<int64_t*>(dest),
        static_cast<const int*>(rank), static_cast<const int*>(base));
  }
  return static_cast<int>(cudaGetLastError());
}

// Dequantize-matmul for block-quantized weights on Hopper (sm_90a):
//   y[M,N] = x[M,K] · dequant(W[N,K])ᵀ, f32 accumulation.
//
// Replaces forge_tpu/ops/dequant_matmul.py `dequant_matmul` and its four
// Pallas bodies (`_kernel_q8`, `_kernel_4bit`, `_kernel_q8_asym`,
// `_kernel_4bit_asym`). As there, the weight stays packed in device memory
// (4 or 8 bits a value plus per-block scales) and is expanded tile by tile
// on chip, so no dequantized weight is ever written to device memory.
//
// Layout: W is read in the quantizers' native flat layout (ops/quant.py):
// `[out, in]` row-major, blocks of `block` values along the flattened rows.
// Each kind's own nibble order is decoded here, so nothing is repacked at
// load (the TPU kernel needed a 512-column half-pack copy for Mosaic):
//   q8_0 int8 × f16 scale;   nf4 hi nibble = even element, NF4 table × f32 absmax;
//   q4_0 lo nibble = j, hi = j+16 of each 32-block, (c−8) × f16 scale;
//   gq4  hi nibble = even element, c·s − m;   gq8 int8, c·s − m (f16 s and m).
// The NF4 table lives in __constant__ memory and is copied to shared memory
// per block: a warp's lookups hit different entries, which constant memory
// serializes.
//
// Two bodies, each with its own decoders; the entry point's `body` picks one
// (the wrapper's `dequant_body` decides: the tensor-core body for bf16, the
// SIMT body for f32).
//
// The SIMT body runs on the f32 CUDA cores (67 TFLOP/s peak), so the large
// products are bound by the FMA rate (~32 TFLOP/s at Flux's linear1); it
// keeps f32, where TF32 tensor cores would break the 1e-4 bound. Its decoder
// is a template parameter of one GEMM skeleton: one block of 256 threads per
// 128×128 output tile walks K in steps of 32. Per step it stages the x tile
// (transposed, f32) and the decoded weight tile (f32; rounded to bf16 first
// when x is bf16, as the reference casts the expanded tile to x's dtype) in
// shared memory; each thread then accumulates an 8×8 register tile, reading
// four 16-byte vectors from shared memory per 64 FMAs. The next step's x
// vectors and packed codes are loaded into registers while the current step
// computes. Each thread decodes one 16-value run of one weight row per step:
// a run never straddles a scale block (blocks are 16, 32 or 64), so it needs
// one scale and one min. M and N tails are masked; K is any multiple of the
// block (so of 16).
//
// The tensor-core body (below, `dequant_matmul_wgmma_kernel`) has its own
// note. Neither body uses atomics or split-K: reruns are bit-identical.
// Blocks allocate nothing and run on the caller's stream.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // 16 × 16
constexpr int BM = 128;        // output rows (M) per tile: 8 per thread row
constexpr int BN = 128;        // output columns (N) per tile: 8 per thread column
constexpr int BK = 32;         // K per staged step
constexpr int PAD = 4;         // keeps 16-byte alignment of shared rows
constexpr int RUN = 16;        // weight values one thread decodes per step

enum Kind { kQ8_0 = 0, kNF4 = 1, kQ4_0 = 2, kGQ4 = 3, kGQ8 = 4 };

__constant__ float kNF4Table[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.33791524171829224f, 0.44070982933044434f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f};

// The packed codes of one 16-value run, with its block's scale and min.
struct Run {
  uint4 q;   // 16 bytes (int8 kinds, q4_0's whole block) or 8 (nf4, gq4) in q.x, q.y
  float s;
  float m;
  int hi;    // q4_0: the run is the block's second half (hi nibbles)
};

__device__ __forceinline__ unsigned byte_of(const uint4& q, int i) {
  const unsigned w = i < 4 ? q.x : i < 8 ? q.y : i < 12 ? q.z : q.w;
  return (w >> (8 * (i & 3))) & 0xFFu;
}

// e = flat index n·K + k of the run's first value (a multiple of 16).
template <int KIND>
__device__ __forceinline__ Run load_run(const uint8_t* __restrict__ codes,
                                        const void* __restrict__ scales,
                                        const void* __restrict__ mins, long long e, int block) {
  Run r;
  r.m = 0.f;
  r.hi = 0;
  const long long b = e / block;
  if (KIND == kQ8_0 || KIND == kGQ8) {
    r.q = *reinterpret_cast<const uint4*>(codes + e);
  } else if (KIND == kQ4_0) {
    const long long start = e - (e & 31);  // the 32-value block, 16 bytes
    r.q = *reinterpret_cast<const uint4*>(codes + start / 2);
    r.hi = (e & 31) >= 16;
  } else {  // nf4, gq4: 8 bytes, two values a byte in element order
    const uint2 h = *reinterpret_cast<const uint2*>(codes + e / 2);
    r.q = make_uint4(h.x, h.y, 0u, 0u);
  }
  if (KIND == kNF4) {
    r.s = static_cast<const float*>(scales)[b];
  } else {
    r.s = __half2float(static_cast<const __half*>(scales)[b]);
  }
  if (KIND == kGQ4 || KIND == kGQ8) r.m = __half2float(static_cast<const __half*>(mins)[b]);
  return r;
}

// Value j (0..15) of a run, in f32. `nf4` is the NF4 table in shared memory.
template <int KIND>
__device__ __forceinline__ float run_value(const Run& r, int j, const float* nf4) {
  if (KIND == kQ8_0 || KIND == kGQ8) {
    const float c = static_cast<float>(static_cast<int8_t>(byte_of(r.q, j)));
    return KIND == kQ8_0 ? c * r.s : c * r.s - r.m;
  }
  if (KIND == kQ4_0) {
    const unsigned byte = byte_of(r.q, j);
    const unsigned c = r.hi ? byte >> 4 : byte & 0xFu;
    return (static_cast<float>(c) - 8.f) * r.s;
  }
  const unsigned byte = byte_of(r.q, j >> 1);
  const unsigned c = (j & 1) ? byte & 0xFu : byte >> 4;
  if (KIND == kNF4) return nf4[c] * r.s;
  return static_cast<float>(c) * r.s - r.m;  // gq4
}

template <typename T> __device__ __forceinline__ float round_as(float v);
template <> __device__ __forceinline__ float round_as<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_as<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void widen(const uint4& v, float* out, float) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void widen(const uint4& v, float* out, __nv_bfloat16) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads)
dequant_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ codes,
                      const void* __restrict__ scales, const void* __restrict__ mins,
                      T* __restrict__ y, int M, int N, int K, int block) {
  constexpr int VEC = 16 / sizeof(T);             // x values per 16-byte load
  constexpr int VPR = BK / VEC;                   // vectors per tile row
  constexpr int NV = BM * BK / VEC / kThreads;    // vectors per thread
  __shared__ __align__(16) float xs[BK][BM + PAD];
  __shared__ __align__(16) float ws[BK][BN + PAD];
  __shared__ float nf4[16];  // a warp's 32 lookups hit 16 banks, not 16 serialized constant reads

  const int tid = threadIdx.x;
  if (KIND == kNF4 && tid < 16) nf4[tid] = kNF4Table[tid];
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;

  // the weight run this thread decodes each step: row wn, columns wk..wk+15
  const int wn = tid & (BN - 1);
  const int wk = (tid / BN) * RUN;
  const bool w_row = n0 + wn < N;
  const long long w_base = static_cast<long long>(n0 + wn) * K;

  uint4 xr[NV];
  Run wr;
  bool w_live = false;

  auto load_step = [&](int k0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = tid + i * kThreads;
      const int row = v / VPR;
      const int kv = (v % VPR) * VEC;
      const bool ok = m0 + row < M && k0 + kv < K;
      xr[i] = ok ? *reinterpret_cast<const uint4*>(x + static_cast<size_t>(m0 + row) * K + k0 + kv)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
    w_live = w_row && k0 + wk < K;
    if (w_live) wr = load_run<KIND>(codes, scales, mins, w_base + k0 + wk, block);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load_step(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // the previous step's readers are done
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = tid + i * kThreads;
      const int row = v / VPR;
      const int kv = (v % VPR) * VEC;
      float vals[VEC];
      widen(xr[i], vals, T());
#pragma unroll
      for (int j = 0; j < VEC; ++j) xs[kv + j][row] = vals[j];
    }
#pragma unroll
    for (int j = 0; j < RUN; ++j)
      ws[wk + j][wn] = w_live ? round_as<T>(run_value<KIND>(wr, j, nf4)) : 0.f;
    __syncthreads();

    if (k0 + BK < K) load_step(k0 + BK);  // in flight while this step computes

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ws[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
    T* yr = y + static_cast<size_t>(m) * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < N) store_out(yr + n, acc[i][j]);
    }
  }
}

template <typename T, int KIND>
cudaError_t launch_kind(const void* x, const void* codes, const void* scales, const void* mins,
                        void* y, int M, int N, int K, int block, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  dequant_matmul_kernel<T, KIND><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(codes), scales, mins,
      static_cast<T*>(y), M, N, K, block);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core body (bf16 only), `dequant_matmul_wgmma_kernel`.
//
// It computes y in transposed tiles, yᵀ[128 weight rows × NT tokens] per
// block (NT = 256, or 128 when 256-token tiles would leave SMs idle), so the
// weight is wgmma's A operand and goes from the decoder straight into
// registers in A's fragment layout, and x is the B operand, read from shared
// memory. Both are K-major, so nothing is transposed. Two warpgroups own 64
// weight rows each and walk K in steps of 64 (one 128-byte row of bf16).
// Two steps ahead, one thread loads the step's x tile by TMA (128-byte
// swizzle, rows past M and columns past K arrive as zeros) into a ring of
// TC_STAGES slots, and every thread copies its share of the packed codes
// with cp.async. Per step, each thread decodes its two weight rows' fragment
// values from the codes in shared memory (16 bytes a lane, swizzled so a
// warp's 8 rows hit distinct banks), and each warpgroup issues 4 wgmma
// m64nNTk16 with A from registers; the products of step i run while the
// threads decode step i+1. Each value is decoded in f32 (c·s, (c−8)·s,
// table[c]·s or c·s − m, never contracted into an FMA; integer codes become
// floats by the exponent trick, not the quarter-rate I2F) and rounded once
// to bf16, as `quant.dequantize(leaf, bf16)` does. The epilogue swaps one
// value between lane pairs so each lane stores two neighbouring columns of
// one row of y.
//
// Design history and what bounds it (NVIDIA H100 80GB HBM3, 700 W, NF4,
// 4608×21504×3072; plain dequantize + cuBLAS 1.85–1.89 ms):
//  - the decoded weight tile in shared memory as wgmma's B operand (decode
//    stores, fence.proxy.async and a barrier before every step's products):
//    2.12 ms;
//  - the weight as a register A operand: 1.66 ms, but ptxas serialized
//    each step's wgmma behind the next step's decode (C7513), because the
//    two fragment sets shared physical registers;
//  - a use of the previous fragments after their wgmma retires (below)
//    keeps the sets apart and the overlap in: 1.52 ms;
//  - the x tile by TMA instead of 8 cp.async a thread a step: 1.33 ms,
//    458 TFLOP/s (this body).
// A producer warpgroup decoding into shared memory for the two consumers
// was slower (2.62 ms): one warpgroup's decode rate is below the products'.
// The decode still bounds it: each weight value is decoded M/NT times (18 at
// M = 4608), 32 values a thread a step against 2×64×256×64 MACs a block.
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 256;  // two warpgroups
constexpr int TC_BW = 128;       // weight rows (columns of y) a block: 64 a warpgroup
constexpr int TC_BK = 64;
constexpr int TC_STAGES = 4;     // ring slots of the x tile and the codes
constexpr int TC_AHEAD = 2;      // steps whose copies are in flight
constexpr int TC_C_BYTES = TC_BW * TC_BK;  // codes of a step: at most a byte a value

template <int NT>
struct TcShape {
  static constexpr int X_BYTES = NT * TC_BK * 2;
  // alignment slack for the swizzled x tiles, the ring, the NF4 table, the
  // x tiles' barriers: 99,424 bytes at NT = 128, 164,960 at NT = 256
  static constexpr int SMEM = 1024 + TC_STAGES * (X_BYTES + TC_C_BYTES) + 64 + TC_STAGES * 8;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 8 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// float(c) − bias for integers 0 <= c < 2^23 and bias, exactly: the exponent
// trick (one logic op and one add) instead of a quarter-rate I2F.
__device__ __forceinline__ float u2f(uint32_t c, float bias) {
  return __fsub_rn(__uint_as_float(0x4B000000u | c), bias);
}

// The bf16 pairs (elements 2t, 2t+1) of the eight 8-value chunks of one
// weight row's 64 values at this step → p[c]: what lane t of a quad holds of
// the row in wgmma's A fragment. `row` is the row's codes in the stage, in
// 16-byte units swizzled by `sw`; s[b] and m[b] are the scale and min of the
// step's BLOCK-value block b.
template <int KIND, int BLOCK>
__device__ __forceinline__ void decode_row(const uint8_t* row, int sw, int t,
                                           const float (&s)[64 / BLOCK],
                                           const float (&m)[64 / BLOCK], const float* nf4,
                                           uint32_t (&p)[8]) {
  if (KIND == kQ8_0 || KIND == kGQ8) {  // chunk c: bytes 8c..8c+7, unit c/2
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint4 q = *reinterpret_cast<const uint4*>(row + ((u ^ sw) << 4));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 2 * u + h;
        const uint32_t w = (t >> 1) ? (h ? q.w : q.y) : (h ? q.z : q.x);
        const uint32_t b = (w >> ((t & 1) * 16)) ^ 0x8080u;  // int8 + 128, two bytes
        float v0 = __fmul_rn(u2f(b & 0xFFu, 8388736.f), s[8 * c / BLOCK]);
        float v1 = __fmul_rn(u2f((b >> 8) & 0xFFu, 8388736.f), s[8 * c / BLOCK]);
        if (KIND == kGQ8) {
          v0 = __fsub_rn(v0, m[8 * c / BLOCK]);
          v1 = __fsub_rn(v1, m[8 * c / BLOCK]);
        }
        p[c] = pack_bf16(v0, v1);
      }
    }
  } else if (KIND == kQ4_0) {  // unit u = 32-block u: lo nibbles j, hi nibbles j+16
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const uint4 q = *reinterpret_cast<const uint4*>(row + ((u ^ sw) << 4));
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int h = cc & 1;
        const uint32_t w = (t >> 1) ? (h ? q.w : q.y) : (h ? q.z : q.x);
        const uint32_t b = w >> ((t & 1) * 16 + (cc >> 1) * 4);
        p[4 * u + cc] = pack_bf16(__fmul_rn(u2f(b & 0xFu, 8388616.f), s[u]),
                                  __fmul_rn(u2f((b >> 8) & 0xFu, 8388616.f), s[u]));
      }
    }
  } else {  // nf4, gq4: chunk c = word c of the row, byte t = elements 2t (hi), 2t+1 (lo)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const uint4 q = *reinterpret_cast<const uint4*>(row + ((u ^ sw) << 4));
      const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 4 * u + i;
        const uint32_t b = words[i] >> (8 * t);
        const float sc = s[8 * c / BLOCK];
        if (KIND == kNF4) {
          p[c] = pack_bf16(__fmul_rn(nf4[(b >> 4) & 0xFu], sc), __fmul_rn(nf4[b & 0xFu], sc));
        } else {
          const float mn = m[8 * c / BLOCK];
          p[c] = pack_bf16(__fsub_rn(__fmul_rn(u2f((b >> 4) & 0xFu, 8388608.f), sc), mn),
                           __fsub_rn(__fmul_rn(u2f(b & 0xFu, 8388608.f), sc), mn));
        }
      }
    }
  }
}

template <int KIND, int BLOCK, int NT>
__global__ void __launch_bounds__(TC_THREADS, 1)
dequant_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                            const uint8_t* __restrict__ codes, const void* __restrict__ scales,
                            const void* __restrict__ mins, __nv_bfloat16* __restrict__ y,
                            int M, int N, int K) {
  using S = TcShape<NT>;
  constexpr int STAGES = TC_STAGES, AHEAD = TC_AHEAD;
  constexpr bool kByte = KIND == kQ8_0 || KIND == kGQ8;  // one byte a code, else a nibble
  constexpr int RB = kByte ? TC_BK : TC_BK / 2;          // code bytes of a row per step
  constexpr int UPR = RB / 16;                           // 16-byte units of a row per step
  constexpr int NB = TC_BK / BLOCK;                      // scale blocks of a row per step
  constexpr bool kAsym = KIND == kGQ4 || KIND == kGQ8;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* xs = base;                          // [STAGES][NT rows × 128 B], written by TMA
  uint8_t* cs = xs + STAGES * S::X_BYTES;      // [STAGES][TC_BW rows × RB], units swizzled
  float* nf4 = reinterpret_cast<float*>(cs + STAGES * TC_C_BYTES);
  uint64_t* xfull = reinterpret_cast<uint64_t*>(nf4 + 16);  // [STAGES] x tile has landed

  const int tid = threadIdx.x;
  if (KIND == kNF4 && tid < 16) nf4[tid] = kNF4Table[tid];
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&xfull[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * TC_BW;
  const int m0 = blockIdx.y * NT;
  const int steps = (K + TC_BK - 1) / TC_BK;
  // this thread's weight rows in the tile: r0 and r0 + 8 (A fragment rows g, g+8)
  const int r0 = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + g;
  // unit swizzle: the 8 rows a warp reads at once hit 8 distinct 16-byte bank groups
  auto swz = [](int r) { return (r / (8 / UPR)) & (UPR - 1); };

  // Step j's x tile (TMA) and codes (cp.async) into ring slot j % STAGES;
  // out-of-range code pieces are zero-filled (src-size 0) from a valid address.
  auto issue = [&](int j) {
    const int k0 = j * TC_BK;
    uint8_t* cslot = cs + (j % STAGES) * TC_C_BYTES;
    if (tid == 0) {
      mbar_expect_tx(&xfull[j % STAGES], S::X_BYTES);
      tma_load_2d(xs + (j % STAGES) * S::X_BYTES, &xmap, k0, m0, &xfull[j % STAGES]);
    }
#pragma unroll
    for (int i = 0; i < TC_BW * 4 / TC_THREADS; ++i) {  // 16-value pieces
      const int c = tid + i * TC_THREADS;
      const int r = c >> 2, p = c & 3;
      const bool ok = n0 + r < N && k0 + p * 16 < K;
      const long long e = static_cast<long long>(n0 + r) * K + k0 + p * 16;
      if (kByte) {
        cp_async16(cslot + r * RB + ((p ^ swz(r)) << 4), ok ? codes + e : codes, ok);
      } else {
        cp_async8(cslot + r * RB + (((p >> 1) ^ swz(r)) << 4) + (p & 1) * 8,
                  ok ? codes + e / 2 : codes, ok);
      }
    }
  };

  // The scales (and mins) of this thread's two rows at step j; 0 outside
  // the matrix, so the zero-filled codes there decode to ±0.
  auto load_scales = [&](int j, float (&s)[2][NB], float (&m)[2][NB]) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int n = n0 + r0 + 8 * rr, k = j * TC_BK + b * BLOCK;
        s[rr][b] = 0.f;
        m[rr][b] = 0.f;
        if (n < N && k < K) {
          const long long idx = static_cast<long long>(n) * (K / BLOCK) + k / BLOCK;
          s[rr][b] = KIND == kNF4 ? static_cast<const float*>(scales)[idx]
                                  : __half2float(static_cast<const __half*>(scales)[idx]);
          if (kAsym) m[rr][b] = __half2float(static_cast<const __half*>(mins)[idx]);
        }
      }
  };

  float acc[NT / 2];  // written first by wgmma with accumulate = 0
  float sc[2][NB], mn[2][NB];
  load_scales(0, sc, mn);
#pragma unroll
  for (int j = 0; j < AHEAD; ++j) {
    if (j < steps) issue(j);
    cp_async_commit();
  }

  // One K step into the A fragments `a`; `a_prev` holds step i−1's, which
  // its wgmma may still be reading.
  auto step = [&](int i, uint32_t (&a)[4][4], uint32_t (&a_prev)[4][4]) {
    cp_async_wait<AHEAD - 1>();  // this thread's codes of step i have landed
    // Everyone's codes of step i are visible, and every warpgroup has
    // passed wgmma_wait<1> of step i−1, so step i−2's wgmma (the last reader
    // of the slot refilled below) is done.
    __syncthreads();
    if (i + AHEAD < steps) issue(i + AHEAD);
    cp_async_commit();
    float sn[2][NB], mnn[2][NB];
    load_scales(i + 1 < steps ? i + 1 : i, sn, mnn);

    const uint8_t* cslot = cs + (i % STAGES) * TC_C_BYTES;
    uint32_t pa[8], pb[8];
    decode_row<KIND, BLOCK>(cslot + r0 * RB, swz(r0), t, sc[0], mn[0], nf4, pa);
    decode_row<KIND, BLOCK>(cslot + (r0 + 8) * RB, swz(r0), t, sc[1], mn[1], nf4, pb);
#pragma unroll
    for (int s = 0; s < 4; ++s) {  // k16 slice s: chunks 2s, 2s+1 of rows g, g+8
      a[s][0] = pa[2 * s];
      a[s][1] = pb[2 * s];
      a[s][2] = pa[2 * s + 1];
      a[s][3] = pb[2 * s + 1];
    }
    const uint32_t xa = smem_u32(xs + (i % STAGES) * S::X_BYTES);
    mbar_wait(&xfull[i % STAGES], (i / STAGES) & 1);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < TC_BK / 16; ++s)  // a k16 slice moves 32 bytes inside the swizzled row
      wgmma_rs<NT>(acc, a[s], smem_desc(xa + s * 32), i > 0 || s > 0);
    wgmma_commit();
    wgmma_wait<1>();  // step i−1's products are done; step i's run on
    fence_acc(acc);
    {  // A use of step i−1's fragments after their wgmma retired (M < 0 never
       // holds): it keeps them live through this step's decode, so the two
       // sets get distinct registers and ptxas need not serialize (C7513).
      uint32_t z = 0;
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int j = 0; j < 4; ++j) z ^= a_prev[s][j];
      if (M < 0) y[z & 7] = __ushort_as_bfloat16(static_cast<unsigned short>(z));
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        sc[rr][b] = sn[rr][b];
        mn[rr][b] = mnn[rr][b];
      }
  };

  uint32_t a0[4][4], a1[4][4];
  for (int i = 0; i < steps; i += 2) {
    step(i, a0, a1);
    if (i + 1 < steps) step(i + 1, a1, a0);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // acc[4q + e] holds yᵀ at weight row g + 8·(e/2) of the warp's 16, token
  // 8q + 2t + (e & 1). Lanes g and g^1 swap one value so each stores two
  // neighbouring columns of one row of y: even g token 2t, odd g token 2t+1.
  const bool odd = g & 1;
  const int n_pair = n0 + r0 - (g & 1);
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int q = 0; q < NT / 8; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = acc[4 * q + 2 * h], v1 = acc[4 * q + 2 * h + 1];
      const float other = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 4);
      const int tok = m0 + 8 * q + 2 * t + (odd ? 1 : 0);
      const int n = n_pair + 8 * h;
      const float lo = odd ? other : v0, hi = odd ? v1 : other;
      if (tok >= M) continue;
      __nv_bfloat16* p = y + static_cast<size_t>(tok) * N + n;
      if (pairs && n + 1 < N) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
      } else {
        if (n < N) p[0] = __float2bfloat16(lo);
        if (n + 1 < N) p[1] = __float2bfloat16(hi);
      }
    }
}

// x [M, K] as a TMA map: [64 K × rows] boxes, 128-byte swizzle; rows past M
// and columns past K arrive as zeros.
cudaError_t encode_x_map(CUtensorMap* map, const void* x, int M, int K, int rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(TC_BK), static_cast<cuuint32_t>(rows)};
  return encode_bf16_map(map, x, 2, dims, strides, box);
}

template <int KIND, int BLOCK, int NT>
cudaError_t launch_wgmma(const void* x, const void* codes, const void* scales, const void* mins,
                         void* y, int M, int N, int K, cudaStream_t stream) {
  using S = TcShape<NT>;
  auto kernel = dequant_matmul_wgmma_kernel<KIND, BLOCK, NT>;
  // Above 48 KB, dynamic shared memory must be granted before the first
  // launch: once per instance, and a refusal is returned on every call.
  static const cudaError_t granted =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (granted != cudaSuccess) return granted;
  CUtensorMap xmap;
  const cudaError_t err = encode_x_map(&xmap, x, M, K, NT);
  if (err != cudaSuccess) return err;
  dim3 grid((N + TC_BW - 1) / TC_BW, (M + NT - 1) / NT);
  kernel<<<grid, TC_THREADS, S::SMEM, stream>>>(xmap, static_cast<const uint8_t*>(codes), scales,
                                                mins, static_cast<__nv_bfloat16*>(y), M, N, K);
  return cudaGetLastError();
}

// The token tile: 256 (each decode shared by twice the products) when that
// still gives every SM two tiles, else 128.
template <int KIND, int BLOCK>
cudaError_t launch_wgmma_block(const void* x, const void* codes, const void* scales,
                               const void* mins, void* y, int M, int N, int K,
                               cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>((M + 255) / 256) * ((N + TC_BW - 1) / TC_BW);
  if (tiles >= 2LL * sms) return launch_wgmma<KIND, BLOCK, 256>(x, codes, scales, mins, y, M, N, K, stream);
  return launch_wgmma<KIND, BLOCK, 128>(x, codes, scales, mins, y, M, N, K, stream);
}

template <int KIND>
cudaError_t launch_body(const void* x, const void* codes, const void* scales, const void* mins,
                        void* y, int M, int N, int K, int block, int dtype, int body,
                        cudaStream_t stream) {
  if (body == 0) {
    if (dtype == 0) return launch_kind<float, KIND>(x, codes, scales, mins, y, M, N, K, block, stream);
    return launch_kind<__nv_bfloat16, KIND>(x, codes, scales, mins, y, M, N, K, block, stream);
  }
  if constexpr (KIND == kQ4_0) {  // always 32-blocks
    return launch_wgmma_block<KIND, 32>(x, codes, scales, mins, y, M, N, K, stream);
  } else {
    if (block == 16) return launch_wgmma_block<KIND, 16>(x, codes, scales, mins, y, M, N, K, stream);
    if (block == 32) return launch_wgmma_block<KIND, 32>(x, codes, scales, mins, y, M, N, K, stream);
    return launch_wgmma_block<KIND, 64>(x, codes, scales, mins, y, M, N, K, stream);
  }
}

}  // namespace

// x [M,K] (dtype), packed codes / scales / mins of W [N,K] in the flat layout
// above → y [M,N] (dtype). kind: 0 q8_0, 1 nf4, 2 q4_0, 3 gq4, 4 gq8;
// block 16, 32 or 64 (32 for q4_0) dividing K; mins only for gq4/gq8.
// Every pointer 16-byte aligned. dtype: 0 = float32, 1 = bfloat16.
// body: 0 = the SIMT body, 1 = the tensor-core body (bfloat16 only).
// Returns a cudaError_t value (0 on success).
extern "C" int forge_dequant_matmul(const void* x, const void* codes, const void* scales,
                                    const void* mins, void* y, int M, int N, int K, int kind,
                                    int block, int dtype, int body, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  if ((block != 16 && block != 32 && block != 64) || K % block != 0) return (int)cudaErrorInvalidValue;
  if (kind == kQ4_0 && block != 32) return (int)cudaErrorInvalidValue;
  if ((kind == kGQ4 || kind == kGQ8) && mins == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if ((body != 0 && body != 1) || (body == 1 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kQ8_0: return (int)launch_body<kQ8_0>(x, codes, scales, mins, y, M, N, K, block, dtype, body, st);
    case kNF4: return (int)launch_body<kNF4>(x, codes, scales, mins, y, M, N, K, block, dtype, body, st);
    case kQ4_0: return (int)launch_body<kQ4_0>(x, codes, scales, mins, y, M, N, K, block, dtype, body, st);
    case kGQ4: return (int)launch_body<kGQ4>(x, codes, scales, mins, y, M, N, K, block, dtype, body, st);
    case kGQ8: return (int)launch_body<kGQ8>(x, codes, scales, mins, y, M, N, K, block, dtype, body, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the tensor-core body at a token tile of `rows`
// (128 or 256), in bytes; -1 for any other tile. ptxas reports only static
// shared memory.
extern "C" int forge_dequant_matmul_wgmma_smem(int rows) {
  return rows == 128 ? TcShape<128>::SMEM : rows == 256 ? TcShape<256>::SMEM : -1;
}

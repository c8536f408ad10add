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
// The decoder is a template parameter; the GEMM skeleton is shared. The NF4
// table lives in __constant__ memory and is copied to shared memory per block:
// a warp's lookups hit different entries, which constant memory serializes.
//
// What bounds it on the H100: this first version runs on the f32 CUDA cores
// (67 TFLOP/s peak), not the tensor cores, so the large Flux products are
// bound by the FMA rate. Its design: one block of 256 threads per 128×128
// output tile walks K in steps of 32. Per step it stages the x tile
// (transposed, f32) and the decoded weight tile (f32; rounded to bf16 first
// when x is bf16, as the reference casts the expanded tile to x's dtype) in
// shared memory; each thread then accumulates an 8×8 register tile, reading
// four 16-byte vectors from shared memory per 64 FMAs. The next step's x
// vectors and packed codes are loaded into registers while the current step
// computes. Each thread decodes one 16-value run of one weight row per step:
// a run never straddles a scale block (blocks are 16, 32 or 64), so it needs
// one scale and one min. M and N tails are masked; K is any multiple of the
// block (so of 16). M = 1 (adaLN modulation) runs the same tiles, mostly
// masked: right, not fast; a skinny-M path and `wgmma` tensor-core tiles fed
// by TMA are later work. No atomics and no split-K: reruns are bit-identical.
// Blocks allocate nothing and run on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename T>
cudaError_t launch(const void* x, const void* codes, const void* scales, const void* mins,
                   void* y, int M, int N, int K, int kind, int block, cudaStream_t stream) {
  switch (kind) {
    case kQ8_0: return launch_kind<T, kQ8_0>(x, codes, scales, mins, y, M, N, K, block, stream);
    case kNF4: return launch_kind<T, kNF4>(x, codes, scales, mins, y, M, N, K, block, stream);
    case kQ4_0: return launch_kind<T, kQ4_0>(x, codes, scales, mins, y, M, N, K, block, stream);
    case kGQ4: return launch_kind<T, kGQ4>(x, codes, scales, mins, y, M, N, K, block, stream);
    case kGQ8: return launch_kind<T, kGQ8>(x, codes, scales, mins, y, M, N, K, block, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x [M,K] (dtype), packed codes / scales / mins of W [N,K] in the flat layout
// above → y [M,N] (dtype). kind: 0 q8_0, 1 nf4, 2 q4_0, 3 gq4, 4 gq8;
// block 16, 32 or 64 (32 for q4_0) dividing K; mins only for gq4/gq8.
// Every pointer 16-byte aligned. dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t value (0 on success).
extern "C" int forge_dequant_matmul(const void* x, const void* codes, const void* scales,
                                    const void* mins, void* y, int M, int N, int K, int kind,
                                    int block, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  if ((block != 16 && block != 32 && block != 64) || K % block != 0) return (int)cudaErrorInvalidValue;
  if (kind == kQ4_0 && block != 32) return (int)cudaErrorInvalidValue;
  if ((kind == kGQ4 || kind == kGQ8) && mins == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, codes, scales, mins, y, M, N, K, kind, block, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, codes, scales, mins, y, M, N, K, kind, block, st);
  return (int)cudaErrorInvalidValue;
}

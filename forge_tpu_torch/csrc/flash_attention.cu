// Flash attention forward for Hopper (sm_90a): out = softmax(q·kᵀ·scale)·v.
//
// Replaces forge_tpu/ops/flash_attention.py `_flash_kernel` (run through
// `_flash_attention_own`) and the JAX-bundled TPU kernel reached through
// `_official_flash`: non-causal, no mask or bias, online softmax with the
// running max, denominator and accumulator in f32, the K/V tail masked to
// -1e30.
//
// Layout: q [BH, Lq, D], k/v [BH, Lk, D], contiguous; bf16 or f32 in, same out.
//
// What bounds it on the H100: this first version does its arithmetic on the
// f32 CUDA cores (67 TFLOP/s peak), not the tensor cores, so it is bound by
// FMA issue and shared-memory bandwidth, far below the card's bf16 rate. The
// design keeps every operand in shared memory as f32 and gives each thread a
// register micro-tile (TM×TN scores, TM×NC outputs) so that each shared
// memory load feeds several FMAs; the output accumulator lives in registers
// across the whole K loop, so nothing but the final rows reaches device
// memory. Odd row strides keep the column walks free of bank conflicts.
// Tensor cores (wgmma), TMA and a pipelined K loop are later work.
//
// One block owns BQ = 16·TM query rows of one (batch, head); it walks all K/V
// tiles of BK = 16·TN rows. D is a runtime value up to 16·NC; d = 512 (the
// VAE's single head) takes BQ = 16 so that the tiles fit in shared memory.
// Blocks allocate nothing, use no atomics, and run on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // a 16 × 16 thread grid
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int TM, int TN>
__host__ __device__ constexpr int tile_floats_fixed() {
  // p_s [BQ][BK+1] + m, l, alpha [BQ]
  return 16 * TM * (16 * TN + 1) + 3 * 16 * TM;
}

template <typename T, int TM, int TN, int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int Lq, int Lk, int D, float scale) {
  constexpr int BQ = 16 * TM;
  constexpr int BK = 16 * TN;
  constexpr int PS = BK + 1;
  extern __shared__ float smem[];
  const int DS = D | 1;        // odd stride: rows of q_s/k_s start on distinct banks
  float* q_s = smem;           // [BQ][DS]
  float* k_s = q_s + BQ * DS;  // [BK][DS]
  float* v_s = k_s + BK * DS;  // [BK][D]
  float* p_s = v_s + BK * D;   // [BQ][PS] scores, then probabilities
  float* m_s = p_s + BQ * PS;  // [BQ] running max
  float* l_s = m_s + BQ;       // [BQ] running denominator
  float* a_s = l_s + BQ;       // [BQ] rescale factor of the current tile

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const T* qb = q + bh * (size_t)Lq * D;
  const T* kb = k + bh * (size_t)Lk * D;
  const T* vb = v + bh * (size_t)Lk * D;
  T* ob = o + bh * (size_t)Lq * D;

  for (int e = tid; e < BQ * D; e += kThreads) {
    const int r = e / D;
    const int c = e - r * D;
    q_s[r * DS + c] = (q0 + r < Lq) ? to_f32(qb[(size_t)q0 * D + e]) : 0.f;
  }
  for (int r = tid; r < BQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  int col[NC];  // this thread's output columns, clamped so loads stay in range
#pragma unroll
  for (int b = 0; b < NC; ++b) col[b] = min(tx + 16 * b, D - 1);
  float acc[TM][NC];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < NC; ++b) acc[a][b] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done with k_s/v_s/p_s
    const int rows = min(BK, Lk - k0);
    for (int e = tid; e < BK * D; e += kThreads) {
      const int r = e / D;
      const int c = e - r * D;
      const bool ok = r < rows;
      const size_t g = (size_t)k0 * D + e;
      k_s[r * DS + c] = ok ? to_f32(kb[g]) : 0.f;
      v_s[r * D + c] = ok ? to_f32(vb[g]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty + 16a, columns tx + 16b
    float s[TM][TN];
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < TN; ++b) s[a][b] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[TM], kv[TN];
#pragma unroll
      for (int a = 0; a < TM; ++a) qv[a] = q_s[(ty + 16 * a) * DS + d];
#pragma unroll
      for (int b = 0; b < TN; ++b) kv[b] = k_s[(tx + 16 * b) * DS + d];
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TN; ++b) s[a][b] = fmaf(qv[a], kv[b], s[a][b]);
    }
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < TN; ++b) {
        const int j = tx + 16 * b;
        p_s[(ty + 16 * a) * PS + j] = (j < rows) ? s[a][b] * scale : kNegInf;
      }
    __syncthreads();

    // online softmax, one warp per row
    for (int r = warp; r < BQ; r += kThreads / 32) {
      float* row = p_s + r * PS;
      float mx = kNegInf;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float p = expf(row[j] - m_new);
        row[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc·alpha + p·v
#pragma unroll
    for (int a = 0; a < TM; ++a) {
      const float alpha = a_s[ty + 16 * a];
#pragma unroll
      for (int b = 0; b < NC; ++b) acc[a][b] *= alpha;
    }
    for (int j = 0; j < BK; ++j) {
      float pv[TM];
#pragma unroll
      for (int a = 0; a < TM; ++a) pv[a] = p_s[(ty + 16 * a) * PS + j];
      const float* vr = v_s + j * D;
#pragma unroll
      for (int b = 0; b < NC; ++b) {
        const float vv = vr[col[b]];
#pragma unroll
        for (int a = 0; a < TM; ++a) acc[a][b] = fmaf(pv[a], vv, acc[a][b]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int r = ty + 16 * a;
    if (q0 + r >= Lq) continue;
    const float inv_l = 1.f / l_s[r];
#pragma unroll
    for (int b = 0; b < NC; ++b) {
      const int c = tx + 16 * b;
      if (c < D) ob[(size_t)(q0 + r) * D + c] = from_f32<T>(acc[a][b] * inv_l);
    }
  }
}

template <typename T, int TM, int TN, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int lq,
                   int lk, int d, float scale, cudaStream_t stream) {
  constexpr int BQ = 16 * TM;
  constexpr int BK = 16 * TN;
  const int ds = d | 1;
  const size_t floats = (size_t)BQ * ds + (size_t)BK * ds + (size_t)BK * d +
                        (size_t)tile_floats_fixed<TM, TN>();
  const size_t smem = floats * sizeof(float);
  auto kern = flash_fwd_kernel<T, TM, TN, NC>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((lq + BQ - 1) / BQ, bh);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), static_cast<T*>(o), lq, lk,
                                         d, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int bh, int lq,
                     int lk, int d, float scale, cudaStream_t stream) {
  if (d <= 64) return launch<T, 4, 4, 4>(q, k, v, o, bh, lq, lk, d, scale, stream);
  if (d <= 128) return launch<T, 4, 4, 8>(q, k, v, o, bh, lq, lk, d, scale, stream);
  if (d <= 192) return launch<T, 2, 4, 12>(q, k, v, o, bh, lq, lk, d, scale, stream);
  return launch<T, 1, 2, 32>(q, k, v, o, bh, lq, lk, d, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t value (0 on success).
extern "C" int forge_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int bh, int lq, int lk, int d, float scale, int dtype,
                                     void* stream) {
  if (bh <= 0 || lq <= 0 || lk <= 0 || d <= 0 || d > 512 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(q, k, v, o, bh, lq, lk, d, scale, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(q, k, v, o, bh, lq, lk, d, scale, s);
  return (int)cudaErrorInvalidValue;
}

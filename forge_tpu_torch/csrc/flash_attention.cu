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
// Two bodies; the entry point's `body` picks one (the wrapper's `flash_body`
// decides: the tensor-core body for bf16 with D % 8 == 0, the SIMT body
// otherwise, which keeps f32, where TF32 tensor cores would break its 1e-4
// bound).
//
// The SIMT body does its arithmetic on the f32 CUDA cores (67 TFLOP/s
// peak), so it is bound by FMA issue and shared-memory bandwidth, far below
// the card's bf16 rate. It keeps every operand in shared memory as f32 and
// gives each thread a register micro-tile (TM×TN scores, TM×NC outputs) so
// that each shared memory load feeds several FMAs; the output accumulator
// lives in registers across the whole K loop, so nothing but the final rows
// reaches device memory. Odd row strides keep the column walks free of bank
// conflicts. One block owns BQ = 16·TM query rows of one (batch, head); it
// walks all K/V tiles of BK = 16·TN rows. D is a runtime value up to 16·NC;
// d = 512 (the VAE's single head) takes BQ = 16 so that the tiles fit in
// shared memory. Unlike the reference it keeps the probabilities in f32
// for p·v.
//
// The tensor-core body (below, `flash_fwd_wgmma_kernel`) has its own note.
// Neither body uses atomics or splits Lk: reruns are bit-identical. Blocks
// allocate nothing and run on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// The tensor-core body (bf16 only), `flash_fwd_wgmma_kernel`.
//
// It computes what the TPU kernel computes, down to its roundings: f32
// logits, the running max, denominator and accumulator in f32, the
// probabilities rounded to bf16 (v's dtype) before p·v with f32
// accumulation, and one division by the denominator at the end.
//
// A block owns FW_BQ = 128 query rows of one (batch, head): two warpgroups
// of 64 rows each. One thread loads the q tile once by TMA and the K/V
// tiles of BK rows by TMA into a ring of FW_STAGES slots (one mbarrier a
// slot for K and one for V, so q·kᵀ starts before V has landed). D is cut
// into 64-column boxes with the 128-byte swizzle; columns past D and rows
// past Lq or Lk arrive as zeros, so D needs only be a multiple of 8 (TMA's
// 16-byte row stride). Per K/V tile each warpgroup
//  - computes S = q·kᵀ with wgmma m64nBKk16, both operands K-major in shared
//    memory as they lie in device memory, over ⌈D/16⌉ k16 slices;
//  - takes the online softmax on the accumulator fragment in registers: a
//    row's values are spread over the 4 lanes of a quad (two shuffles), the
//    logits are scaled by scale·log2 e and exponentiated by ex2; columns past
//    Lk are masked to -1e30 by index (their zero-filled K rows would score 0);
//  - rounds P to bf16 and repacks the S fragment into wgmma's A fragments in
//    registers (no shuffle: the accumulator of columns 16s..16s+15 is the A
//    fragment of k16 slice s) and adds P·V with wgmma m64nNOk16, V as the
//    MN-major B operand (its transpose bit), read from the TMA boxes as
//    they are.
// The output's NO = 64·OB columns are this block's share of D: a 64 × 512
// f32 accumulator would need 256 registers a thread, so at d = 512 the grid
// has a third dimension of D/NO blocks, each recomputing S over the full D
// (1.5× the minimal FLOPs at NO = 256). The P·V product runs on D rounded
// up to 64 columns (zero-filled), q·kᵀ on D rounded up to 16.
//
// What bounds it: every product is on the tensor cores (989 TFLOP/s bf16),
// so the card's bound is the FLOPs (4·Lq·Lk·D a head) at every shape of the
// main paths. The body runs the two products and the softmax of a tile in
// sequence, both warpgroups in step (one block barrier a tile before thread
// 0 refills the slot), so the tensor cores idle while the softmax's ex2
// (16 a clock on an SM) and shuffles run: 48 % of the bound at Flux's
// q(1,24,4608,128), 12–25 % at d = 40, 80 and 512 (whose P·V runs on 64-
// column boxes, and whose S is recomputed for each output half). Turns of
// the two warpgroups on the tensor cores (below) did not gain, so that
// overlap alone is not what holds it at 48 %; timing each phase with
// clock64 marks is the next measurement.
//
// Design history (NVIDIA H100 80GB HBM3, 700 W, q(1,24,4608,128), the SIMT
// body 18.70 ms; each pair from one call):
//  - this body: 0.5429–0.5495 ms (475–481 TFLOP/s);
//  - the warpgroups taking turns on the tensor cores (named barriers; a
//    turn issues P·V of tile j−1 and q·kᵀ of tile j, so one's softmax runs
//    during the other's products; K and V slots freed by whichever
//    warpgroup finishes second): 0.7697–0.7777 ms against 0.5450–0.5493,
//    as ptxas C7520 serialized
//    the wgmma behind a fence it injected in a path it took as divergent;
//    with the warpgroup index made warp-uniform (__shfl_sync) 0.5412 ms
//    against 0.5437–0.5495: no gain, not kept;
//  - a 3-slot ring where it fits: 0.5415–0.5476 against 0.5429–0.5456: no
//    gain, not kept.
// ---------------------------------------------------------------------------

constexpr int FW_THREADS = 256;  // two warpgroups
constexpr int FW_BQ = 128;       // query rows a block: 64 a warpgroup
constexpr int FW_STAGES = 2;     // ring slots of the K and V tiles
constexpr int FW_BOX = 64;       // columns of a TMA box: 128 bytes of bf16

// DK: 64-column boxes of q and k (D ≤ 64·DK); OB: boxes of v and of the
// output a block takes; BK: keys a tile.
template <int DK, int OB, int BK>
struct FwShape {
  static constexpr int Q_BOX = FW_BQ * 128;  // bytes of one 128-row box
  static constexpr int KV_BOX = BK * 128;
  static constexpr int Q_BYTES = DK * Q_BOX;
  static constexpr int K_BYTES = DK * KV_BOX;
  static constexpr int V_BYTES = OB * KV_BOX;
  // alignment slack for the swizzled boxes, q, the ring, the barriers
  static constexpr int SMEM =
      1024 + Q_BYTES + FW_STAGES * (K_BYTES + V_BYTES) + 8 * (1 + 2 * FW_STAGES);
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DK, int OB, int BK>
__global__ void __launch_bounds__(FW_THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                       int Lq, int Lk, int D, float scale_log2) {
  using S = FwShape<DK, OB, BK>;
  constexpr int NO = FW_BOX * OB;  // output columns of the block
  constexpr int STAGES = FW_STAGES;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* qs = base;                       // [DK boxes][128 rows × 128 B]
  uint8_t* ks = qs + S::Q_BYTES;            // [STAGES][DK boxes][BK rows × 128 B]
  uint8_t* vs = ks + STAGES * S::K_BYTES;   // [STAGES][OB boxes][BK rows × 128 B]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(vs + STAGES * S::V_BYTES);
  uint64_t* kfull = qbar + 1;               // [STAGES] the slot's K tile has landed
  uint64_t* vfull = kfull + STAGES;         // [STAGES] the slot's V tile has landed

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * FW_BQ;
  const int bh = blockIdx.y;
  const int vb0 = blockIdx.z * OB;                 // the block's first box of v and the output
  const int nbox = (D + FW_BOX - 1) / FW_BOX;      // boxes of q and k that hold D
  // boxes of v this block loads; a box past D is never loaded, and only
  // output columns past D, which are not stored, read it
  const int nvb = min(OB, nbox - vb0);
  const int slices = (D + 15) / 16;                // k16 slices of q·kᵀ
  const int tiles = (Lk + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Tile j's K and V boxes into ring slot j % STAGES (thread 0).
  auto issue = [&](int j) {
    const int slot = j % STAGES, k0 = j * BK;
    mbar_expect_tx(&kfull[slot], nbox * S::KV_BOX);
    for (int b = 0; b < nbox; ++b)
      tma_load_3d(ks + slot * S::K_BYTES + b * S::KV_BOX, &kmap, b * FW_BOX, k0, bh, &kfull[slot]);
    mbar_expect_tx(&vfull[slot], nvb * S::KV_BOX);
    for (int b = 0; b < nvb; ++b)
      tma_load_3d(vs + slot * S::V_BYTES + b * S::KV_BOX, &vmap, (vb0 + b) * FW_BOX, k0, bh,
                  &vfull[slot]);
  };
  if (tid == 0) {
    mbar_expect_tx(qbar, nbox * S::Q_BOX);
    for (int b = 0; b < nbox; ++b) tma_load_3d(qs + b * S::Q_BOX, &qmap, b * FW_BOX, q0, bh, qbar);
    for (int j = 0; j < STAGES && j < tiles; ++j) issue(j);
  }

  float acc[NO / 2];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) acc[i] = 0.f;
  // this thread's rows g and g + 8 of its warp's 16: running max (log2
  // units) and its share of the denominator (a quad's four shares add up at
  // the end: the quad rescales them by the same factor)
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  const uint32_t qa = smem_u32(qs) + wg * 64 * 128;  // this warpgroup's 64 rows of each box
  mbar_wait(qbar, 0);

  for (int j = 0; j < tiles; ++j) {
    const int slot = j % STAGES, phase = (j / STAGES) & 1;
    const uint32_t ka = smem_u32(ks + slot * S::K_BYTES);
    const uint32_t va = smem_u32(vs + slot * S::V_BYTES);

    // S = q·kᵀ: k16 slice s is 32 bytes into the swizzled rows of box s/4
    float s_acc[BK / 2];
    mbar_wait(&kfull[slot], phase);
    wgmma_fence();
    for (int s = 0; s < slices; ++s) {
      const uint32_t off = (s & 3) * 32;
      wgmma_ss<BK>(s_acc, smem_desc(qa + (s >> 2) * S::Q_BOX + off),
                   smem_desc(ka + (s >> 2) * S::KV_BOX + off), s > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s_acc);

    // s_acc[4c + e] is row g + 8·(e/2), column 8c + 2t + (e & 1) of the tile
    const bool tail = (j + 1) * BK > Lk;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int c = 0; c < BK / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s_acc[4 * c + e] * scale_log2;
        if (tail && j * BK + 8 * c + 2 * t + (e & 1) >= Lk) x = kNegInf;
        s_acc[4 * c + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = ex2(m_run[r] - mx[r]);
      m_run[r] = mx[r];
      l_run[r] *= alpha[r];
    }
    // P in bf16 as the A fragments of the BK/16 k16 slices of P·V
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int c = 0; c < BK / 8; ++c) {
      const float p0 = ex2(s_acc[4 * c] - m_run[0]), p1 = ex2(s_acc[4 * c + 1] - m_run[0]);
      const float p2 = ex2(s_acc[4 * c + 2] - m_run[1]), p3 = ex2(s_acc[4 * c + 3] - m_run[1]);
      l_run[0] += p0 + p1;
      l_run[1] += p2 + p3;
      pa[c >> 1][(c & 1) * 2] = pack_bf16(p0, p1);
      pa[c >> 1][(c & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < NO / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P·V: k16 slice kk is keys 16kk..16kk+15, two 8-row groups of 1024 bytes
    mbar_wait(&vfull[slot], phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<NO, 1>(acc, pa[kk], smem_desc_mn(va + kk * 2048, S::KV_BOX), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);

    __syncthreads();  // both warpgroups are done with the slot
    if (tid == 0 && j + STAGES < tiles) issue(j + STAGES);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    inv[r] = 1.f / l_run[r];
  }
  const int row = q0 + wg * 64 + warp * 16 + g;
  __nv_bfloat16* ob = o + (static_cast<size_t>(bh) * Lq + row) * D;
#pragma unroll
  for (int c = 0; c < NO / 8; ++c) {
    const int col = vb0 * FW_BOX + 8 * c + 2 * t;  // D % 8 == 0: a pair is in or out
    if (col >= D) continue;
    if (row < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + col) =
          __floats2bfloat162_rn(acc[4 * c] * inv[0], acc[4 * c + 1] * inv[0]);
    if (row + 8 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * static_cast<size_t>(D) + col) =
          __floats2bfloat162_rn(acc[4 * c + 2] * inv[1], acc[4 * c + 3] * inv[1]);
  }
}

// x [BH, L, D] (bf16) as a TMA map of [64 columns × rows × 1] boxes.
cudaError_t encode_qkv_map(CUtensorMap* map, const void* x, int bh, int l, int d, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(l),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(l) * d * 2};
  const cuuint32_t box[3] = {FW_BOX, static_cast<cuuint32_t>(rows), 1};
  return encode_bf16_map(map, x, 3, dims, strides, box);
}

template <int DK, int OB, int BK>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, int bh, int lq,
                         int lk, int d, float scale, cudaStream_t stream) {
  using S = FwShape<DK, OB, BK>;
  auto kernel = flash_fwd_wgmma_kernel<DK, OB, BK>;
  // Above 48 KB, dynamic shared memory must be granted before the first
  // launch: once per instance, and a refusal is returned on every call.
  static const cudaError_t granted =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (granted != cudaSuccess) return granted;
  CUtensorMap qmap, kmap, vmap;
  cudaError_t err = encode_qkv_map(&qmap, q, bh, lq, d, FW_BQ);
  if (err == cudaSuccess) err = encode_qkv_map(&kmap, k, bh, lk, d, BK);
  if (err == cudaSuccess) err = encode_qkv_map(&vmap, v, bh, lk, d, BK);
  if (err != cudaSuccess) return err;
  const int nbox = (d + FW_BOX - 1) / FW_BOX;
  dim3 grid((lq + FW_BQ - 1) / FW_BQ, bh, (nbox + OB - 1) / OB);
  kernel<<<grid, FW_THREADS, S::SMEM, stream>>>(qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o),
                                                lq, lk, d, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// Instances by head dim: BK = 128 keys a tile where the ring fits, fewer at
// larger D; above 192 the output is split over blocks of 256 columns.
cudaError_t dispatch_wgmma(const void* q, const void* k, const void* v, void* o, int bh, int lq,
                           int lk, int d, float scale, cudaStream_t stream) {
  if (d <= 64) return launch_wgmma<1, 1, 128>(q, k, v, o, bh, lq, lk, d, scale, stream);
  if (d <= 128) return launch_wgmma<2, 2, 128>(q, k, v, o, bh, lq, lk, d, scale, stream);
  if (d <= 192) return launch_wgmma<3, 3, 64>(q, k, v, o, bh, lq, lk, d, scale, stream);
  return launch_wgmma<8, 4, 32>(q, k, v, o, bh, lq, lk, d, scale, stream);
}

int wgmma_smem(int d) {
  if (d <= 0 || d > 512) return -1;
  if (d <= 64) return FwShape<1, 1, 128>::SMEM;
  if (d <= 128) return FwShape<2, 2, 128>::SMEM;
  if (d <= 192) return FwShape<3, 3, 64>::SMEM;
  return FwShape<8, 4, 32>::SMEM;
}

}  // namespace

// q, k, v, o: [bh, lq or lk, d], contiguous. dtype: 0 = float32, 1 = bfloat16.
// body: 0 = the SIMT body, 1 = the tensor-core body (bfloat16, d % 8 == 0,
// every pointer 16-byte aligned). Returns a cudaError_t value (0 on success).
extern "C" int forge_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int bh, int lq, int lk, int d, float scale, int dtype,
                                     int body, void* stream) {
  if (bh <= 0 || lq <= 0 || lk <= 0 || d <= 0 || d > 512 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    const bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15) == 0;
    if (dtype != 1 || d % 8 != 0 || !aligned) return (int)cudaErrorInvalidValue;
    return (int)dispatch_wgmma(q, k, v, o, bh, lq, lk, d, scale, s);
  }
  if (body != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch<float>(q, k, v, o, bh, lq, lk, d, scale, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(q, k, v, o, bh, lq, lk, d, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the tensor-core body at head dim d, in bytes; -1
// where no instance takes d. ptxas reports only static shared memory.
extern "C" int forge_flash_attention_wgmma_smem(int d) { return wgmma_smem(d); }

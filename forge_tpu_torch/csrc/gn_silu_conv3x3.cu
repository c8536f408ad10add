// Fused GroupNorm-affine + SiLU + 3×3 convolution for Hopper (sm_90a), NCHW:
//   y = conv3x3(silu(x·a + s), w, pad 1) + bias
// with a = γ·rsqrt(var+eps) and s = β − mean·a per (batch, channel) in f32,
// reduced outside the kernel from one-pass group statistics.
//
// Replaces forge_tpu/ops/fused_gn_conv.py `_kernel` (run through `_fused`).
// As there, the normalized activation never reaches device memory: x is read
// once, normalized and activated while it is staged, and the padding is
// applied after the activation, so the pad is exactly 0 (torch pads the
// activated tensor) and not silu(s).
//
// Two bodies; the entry point's `body` picks one (the wrapper's `conv_body`
// decides: the tensor-core body for bf16 with C % 8 == 0, the SIMT body
// otherwise, which keeps f32, where TF32 tensor cores would break
// its 1e-4 bound).
//
// The SIMT body is an implicit GEMM on the f32 CUDA cores (67 TFLOP/s peak),
// so it is bound by FMA issue and shared-memory bandwidth. Each block owns a
// tile of TH×TW output pixels × BO output channels; per chunk of CC input
// channels it stages the (TH+2)×(TW+2) activated halo and the CC·9 × BO
// weight slab in shared memory as f32, and each thread accumulates a 4 pixel
// × 4 channel register tile over the 9 taps, so each shared-memory load
// feeds four FMAs. Bias is added in the f32 epilogue. For bf16 inputs the
// activation is rounded to bf16 before the product, as the reference stores
// it.
//
// The tensor-core body (below, `gn_silu_conv3x3_wgmma_kernel`) has its own
// note. Neither body uses atomics (the tensor-core body's parts of a split
// channel walk are added in a fixed order): reruns are bit-identical. Blocks
// allocate nothing (the caller passes the scratch) and run on the caller's
// stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // 16 × 16
constexpr int TH = 4;          // output rows per tile: one per micro-tile row
constexpr int TW = 16;         // output columns per tile: one per tx
constexpr int BO = 64;         // output channels per tile: 4 per ty
constexpr int CC = 8;          // input channels per staged chunk
constexpr int HALO = (TH + 2) * (TW + 2);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_silu_conv3x3_kernel(const T* __restrict__ x, const float* __restrict__ a,
                       const float* __restrict__ s, const T* __restrict__ w,
                       const float* __restrict__ bias, T* __restrict__ y, int C, int H, int W,
                       int O) {
  __shared__ float in_s[CC][TH + 2][TW + 2];
  __shared__ float w_s[CC * 9][BO + 1];  // odd stride: conflict-free transposed stores

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int tiles_w = (W + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_w) * TH;
  const int x0 = (blockIdx.x % tiles_w) * TW;
  const int o0 = blockIdx.y * BO;
  const int b = blockIdx.z;
  const size_t plane = (size_t)H * W;
  const T* xb = x + (size_t)b * C * plane;
  const float* ab = a + (size_t)b * C;
  const float* sb = s + (size_t)b * C;

  float acc[TH][4];
#pragma unroll
  for (int r = 0; r < TH; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    __syncthreads();  // the previous chunk's readers are done
    for (int e = tid; e < CC * HALO; e += kThreads) {
      const int ci = e / HALO;
      const int rem = e - ci * HALO;
      const int r = rem / (TW + 2);
      const int q = rem - r * (TW + 2);
      const int c = c0 + ci;
      const int gy = y0 - 1 + r;
      const int gx = x0 - 1 + q;
      float val = 0.f;  // the zero padding, applied after the activation
      if (c < C && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const float t = to_f32(xb[(size_t)c * plane + (size_t)gy * W + gx]) * ab[c] + sb[c];
        val = to_f32(from_f32<T>(t / (1.f + expf(-t))));
      }
      in_s[ci][r][q] = val;
    }
    for (int e = tid; e < BO * CC * 9; e += kThreads) {
      const int ol = e / (CC * 9);
      const int kk = e - ol * (CC * 9);
      const int o = o0 + ol;
      const bool ok = o < O && c0 + kk / 9 < C;
      w_s[kk][ol] = ok ? to_f32(w[((size_t)o * C + c0) * 9 + kk]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int ci = 0; ci < CC; ++ci)
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          float iv[TH], wv[4];
#pragma unroll
          for (int r = 0; r < TH; ++r) iv[r] = in_s[ci][r + ky][tx + kx];
#pragma unroll
          for (int j = 0; j < 4; ++j) wv[j] = w_s[ci * 9 + ky * 3 + kx][ty + 16 * j];
#pragma unroll
          for (int r = 0; r < TH; ++r)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(iv[r], wv[j], acc[r][j]);
        }
  }

  const int gx = x0 + tx;
  if (gx >= W) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = o0 + ty + 16 * j;
    if (o >= O) continue;
    const float bo = bias[o];
    T* yo = y + ((size_t)b * O + o) * plane;
#pragma unroll
    for (int r = 0; r < TH; ++r) {
      const int gy = y0 + r;
      if (gy < H) yo[(size_t)gy * W + gx] = from_f32<T>(acc[r][j] + bo);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* a, const void* s, const void* w, const void* bias,
                   void* y, int B, int C, int H, int W, int O, cudaStream_t stream) {
  const int tiles = ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  dim3 grid(tiles, (O + BO - 1) / BO, B);
  gn_silu_conv3x3_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const float*>(s),
      static_cast<const T*>(w), static_cast<const float*>(bias), static_cast<T*>(y), C, H, W,
      O);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core body (bf16 only), `gn_silu_conv3x3_wgmma_kernel`.
//
// An implicit GEMM: M = output pixels of one image, N = output channels,
// K = 9·C walked as (chunks of 64 input channels) × (9 taps). It computes
// what the TPU kernel computes, down to its roundings: x·a + s and SiLU in
// f32, the activation rounded to bf16, f32 accumulation, bias added in the
// f32 epilogue, the result rounded once to bf16.
//
// A block owns TC_BM = 128 output pixels (two warpgroups of 64) × BN output
// channels, BN = 64, 128, 160 or 256 picked per call with `splits`, the
// parts the channel walk is cut into (`wgmma_plan`, below). The pixels are
// a TH × TW patch: TW = min(W, 32), TH = 128 / TW, or, where that holds two
// whole images or more (UNet level 3 is 8 × 8), whole images of the batch
// (`tc_patch`). Per 64-channel chunk:
//  - the halo: each thread takes 8 channels of one position, reads them
//    from NCHW x (neighbouring threads on neighbouring pixels), applies
//    x·a+s, SiLU and the bf16 rounding once, and stores them as one 16-byte
//    row piece, so the halo lies channel-contiguous in shared memory (one
//    128-byte row a position, the pieces XOR-swizzled by position so that
//    eight neighbouring positions hit eight bank groups). Positions outside
//    the image are zeroed by index after the activation: the pad is exactly
//    0, not silu(s). The halo has two buffers: the next chunk's is staged,
//    one item a thread a tap with its loads issued a tap ahead, while this
//    chunk's products run;
//  - for each tap (ky, kx), A (the warp's 16 pixels × 16 channels of a k16
//    slice) comes by ldmatrix from the window shifted by (ky, kx): a pixel's
//    source is just another row address, so no copy of the halo is shifted;
//    then wgmma m64nBNk16 with A from registers and B, the tap's [BN × 64]
//    weight slice, K-major from shared memory.
// The weight is read in the layout [O, 3, 3, C] (torch's channels_last of
// the OIHW tensor; core/loader.py stores the fused convs' weights so on the
// card): a tap's slice of one chunk is then a [BN rows × 128 bytes] box of
// a 3-D TMA map {C, 9, O}, which thread 0 keeps coming into a ring of
// TC_STAGES slots (an mbarrier a slot for "landed" and one for "read by all
// 256 threads"); rows past O and channels past C arrive as zeros. Where the
// blocks would not fill the card (UNet levels 1-3), the channel walk is cut
// into parts whose f32 sums go to a scratch buffer, added in order with the
// bias by `gn_silu_conv3x3_splits_kernel`.
//
// What bounds it: the card's bound is the FLOPs (2·9·C·O a pixel) at every
// shape of the main paths but UNet level 3, whose 59 MB weight makes it the
// bytes; the body reaches 20-43 % of it. Not the tensor cores: at
// (2,320,64,64)→320 (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py --kernels
// in copies of the tree) the body takes 0.0532-0.0533 ms, 0.0434 ms with
// the wgmma taken out and 0.0493 ms with SiLU's arithmetic taken out. What
// is left is the halo's staging (its loads are issued only one tap, about
// 1 µs, ahead), the per-tap waits, and the weight slices, read from L2 once
// per pixel tile; which of them sets the pace is not measured yet.
//
// Design history (same card; (2,320,64,64)→320 / (1,512,128,128)→512 /
// (2,1280,16,16)→1280, ms; each pair from one call):
//  - staging then products in sequence, one halo buffer: 0.1002-0.1008 /
//    0.4057-0.4073 / 0.4536-0.4577 (SIMT body 0.70 / 3.39 / 1.29);
//  - two halo buffers, the next chunk staged during the products:
//    0.0816-0.1267 / 0.2785-0.2800 / 0.2818-0.2850;
//  - a and s loaded with x, and the ring slot of the step before refilled
//    (thread 0 no longer waits on every tap): 0.0815-0.0818 /
//    0.2749-0.2752 / 0.2752-0.2778 against 0.0813-0.0821 / 0.2803-0.2804 /
//    0.2855-0.2864, kept;
//  - each item's indices found once (float reciprocals instead of integer
//    division), SiLU by __fdividef, the channel walk split where blocks are
//    few, small images folded into one tile: 0.0528-0.0531 /
//    0.1840-0.1850 / 0.0646-0.0647;
//  - blocks walking chunks and taps from different starts, so that they
//    read different weight slices at once: no gain, not kept.
// (A ninth, producer warp made ptxas budget the registers of three
// warpgroups, 168 a thread, and spill at BN = 256: thread 0 issues instead.)
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 256;    // two warpgroups
constexpr int TC_BM = 128;         // output pixels a block: 64 a warpgroup
constexpr int TC_CK = 64;          // input channels a chunk: one 128-byte row of bf16
constexpr int TC_STAGES = 4;       // ring slots of the tap slices
constexpr int TC_HALO = 288;       // halo positions a buffer holds
constexpr int TC_MAX_SPLITS = 16;  // parts of the channel walk, at most

template <int BN>
struct TcShape {
  static constexpr int SLOT = BN * 128;  // one tap's [BN × 64] bf16 weight slice
  // alignment slack, the ring, two halo buffers, the barriers: 107,584 bytes
  // at BN = 64, 205,888 at BN = 256
  static constexpr int SMEM = 1024 + TC_STAGES * SLOT + 2 * TC_HALO * 128 + 2 * TC_STAGES * 8;
};

// The pixels of a block: nimg images' TH × TW patches. TW = min(W, 32),
// TH = 128 / TW; where that holds two whole images or more (small images:
// UNet level 3 is 8 × 8), TH = H and the patch takes nimg = 128 / (H·W)
// images of the batch. Images, then TH, are halved while the halo would not
// fit a buffer.
struct Patch {
  int th, tw, nimg;
};
__host__ __device__ inline Patch tc_patch(int B, int H, int W) {
  Patch p{TC_BM / (W < 32 ? W : 32), W < 32 ? W : 32, 1};
  if (p.tw == W && p.th >= 2 * H) {
    p.th = H;
    p.nimg = B < TC_BM / (H * W) ? B : TC_BM / (H * W);
  }
  while (p.nimg * (p.th + 2) * (p.tw + 2) > TC_HALO) {
    if (p.nimg > 1) p.nimg /= 2;
    else p.th /= 2;
  }
  return p;
}

template <int BN>
__global__ void __launch_bounds__(TC_THREADS, 1)
gn_silu_conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                             const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
                             const float* __restrict__ s, const float* __restrict__ bias,
                             __nv_bfloat16* __restrict__ y, float* __restrict__ part, int B,
                             int C, int H, int W, int O, int tiles_w, int splits) {
  using S = TcShape<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* ws = base;                      // [STAGES][BN rows × 128 B], by TMA
  uint8_t* hs = ws + TC_STAGES * S::SLOT;  // [2][TC_HALO positions × 128 B], swizzled
  uint64_t* full = reinterpret_cast<uint64_t*>(hs + 2 * TC_HALO * 128);  // [STAGES] landed
  uint64_t* empty = full + TC_STAGES;                                    // [STAGES] read

  const Patch pt = tc_patch(B, H, W);
  const int th = pt.th, tw = pt.tw, hw2 = tw + 2;
  const int hpi = (th + 2) * hw2;                // halo positions an image
  const int npos = pt.nimg * hpi;
  const int items = 8 * npos;                    // staging items a chunk: 8 channels each
  const int mine = (items + TC_THREADS - 1) / TC_THREADS;  // this block's items a thread
  const int tid = threadIdx.x;
  const int py0 = (blockIdx.x / tiles_w) * th, px0 = (blockIdx.x % tiles_w) * tw;
  const int o0 = blockIdx.y * BN;
  const int b0 = (blockIdx.z / splits) * pt.nimg, split = blockIdx.z % splits;
  // this block's part of the channel walk: chunks ch0 .. ch0 + nch − 1
  const int chunks = (C + TC_CK - 1) / TC_CK, per = (chunks + splits - 1) / splits;
  const int ch0 = split * per, nch = min(chunks, ch0 + per) - ch0;
  const int steps = 9 * nch;  // (chunk, tap) pairs, in that order
  const size_t plane = static_cast<size_t>(H) * W;

  if (tid == 0) {
    for (int i = 0; i < TC_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], TC_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // (chunk, tap) step j's weight slice into ring slot j % TC_STAGES (thread 0)
  auto issue = [&](int j) {
    const int slot = j % TC_STAGES;
    mbar_expect_tx(&full[slot], S::SLOT);
    tma_load_3d(ws + slot * S::SLOT, &wmap, (ch0 + j / 9) * TC_CK, j % 9, o0, &full[slot]);
  };
  if (tid == 0)
    for (int j = 0; j < TC_STAGES && j < steps; ++j) issue(j);

  // Staging item k of this thread in chunk ci: channels 8·grp..8·grp+7 of
  // halo position pos (C % 8 == 0: the 8 are all in C or all past it).
  // `fetch` finds it and starts its loads (x as raw bf16 pairs, and the 8
  // channels' a and s) one tap before `put` applies x·a+s, SiLU and the
  // rounding and stores the 16-byte piece into halo buffer hb, or zeros
  // where the position is outside the image (the pad, after the activation)
  // or the channels are past C. Quotients come from float reciprocals, exact
  // for these sizes (e < 2^16: the error stays below 1/(2·divisor)).
  const float inv_npos = 1.f / npos, inv_hpi = 1.f / hpi, inv_hw2 = 1.f / hw2;
  auto quot = [](int n, float inv) { return __float2int_rz((n + 0.5f) * inv); };
  struct Raw {
    uint32_t x[4];  // bf16 pairs
    float4 a[2], s[2];
    int dst;        // the piece's byte in a halo buffer, or -1 for no item
    bool in;        // inside the image and C
  };
  auto fetch = [&](int ci, int k, Raw& raw) {
    const int e = tid + k * TC_THREADS;
    const int grp = quot(e, inv_npos), pos = e - grp * npos;
    const int img = quot(pos, inv_hpi), hp = pos - img * hpi;
    const int hy = quot(hp, inv_hw2), hx = hp - hy * hw2;
    const int gy = py0 - 1 + hy, gx = px0 - 1 + hx, bi = b0 + img;
    const int c = ci * TC_CK + 8 * grp;
    raw.dst = e < items ? pos * 128 + ((grp ^ (pos & 7)) << 4) : -1;
    raw.in = e < items && bi < B && c < C && gy >= 0 && gy < H && gx >= 0 && gx < W;
    if (!raw.in) return;
    const size_t ac = static_cast<size_t>(bi) * C + c;
    const unsigned short* xp =
        reinterpret_cast<const unsigned short*>(x) + ac * plane + static_cast<size_t>(gy) * W + gx;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      raw.x[q] = static_cast<uint32_t>(__ldg(xp + 2 * q * plane)) |
                 (static_cast<uint32_t>(__ldg(xp + (2 * q + 1) * plane)) << 16);
    const float4* ap = reinterpret_cast<const float4*>(a + ac);
    const float4* sp = reinterpret_cast<const float4*>(s + ac);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      raw.a[q] = __ldg(ap + q);
      raw.s[q] = __ldg(sp + q);
    }
  };
  auto put = [&](const Raw& raw, uint8_t* hb) {
    if (raw.dst < 0) return;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (raw.in) {
      const float av[8] = {raw.a[0].x, raw.a[0].y, raw.a[0].z, raw.a[0].w,
                           raw.a[1].x, raw.a[1].y, raw.a[1].z, raw.a[1].w};
      const float sv[8] = {raw.s[0].x, raw.s[0].y, raw.s[0].z, raw.s[0].w,
                           raw.s[1].x, raw.s[1].y, raw.s[1].z, raw.s[1].w};
      uint32_t p[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float f[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float xv = __uint_as_float((raw.x[q] >> (16 * h)) << 16);  // bf16 → f32
          const float t = __fadd_rn(__fmul_rn(xv, av[2 * q + h]), sv[2 * q + h]);
          f[h] = __fdividef(t, 1.f + __expf(-t));  // → -0 where exp(-t) overflows
        }
        p[q] = pack_bf16(f[0], f[1]);
      }
      v = make_uint4(p[0], p[1], p[2], p[3]);
    }
    *reinterpret_cast<uint4*>(hb + raw.dst) = v;
  };

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int pix = th * tw;  // pixels of an image's patch
  // ldmatrix: lanes 8i..8i+7 address matrix i, whose rows are pixels 0-7 (i
  // even) or 8-15 (i odd) of the warp's 16 and whose columns are the low (i
  // < 2) or high 8 channels of a k16 slice
  const int mi = lane >> 3;
  const int pr = 64 * wg + 16 * warp + (lane & 7) + ((mi & 1) << 3);
  // a pixel row past the patch reads position 0 (its outputs are not stored)
  const int pq = pr % pix;
  const int pos0 = pr < pt.nimg * pix ? (pr / pix) * hpi + (pq / tw) * hw2 + pq % tw : 0;
  const int khi = mi >> 1;

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int k = 0; k < mine; ++k) {  // the first chunk's halo
    Raw raw;
    fetch(ch0, k, raw);
    put(raw, hs);
  }
  __syncthreads();

  for (int i = 0; i < nch; ++i) {
    const uint32_t hbase = smem_u32(hs + (i & 1) * TC_HALO * 128);
    uint8_t* hnext = hs + ((i + 1) & 1) * TC_HALO * 128;
    const int cn = ch0 + i + 1;  // the next chunk
    const bool more = i + 1 < nch;
    Raw cur;  // the next chunk's item `tap`, loaded one tap ahead
    if (more) fetch(cn, 0, cur);
    for (int tap = 0; tap < 9; ++tap) {
      const int j = 9 * i + tap, slot = j % TC_STAGES;
      const int pos = pos0 + (tap / 3) * hw2 + tap % 3;
      const uint32_t row = hbase + pos * 128;
      uint32_t af[TC_CK / 16][4];
#pragma unroll
      for (int k = 0; k < TC_CK / 16; ++k)
        ldmatrix_x4(af[k], row + (((2 * k + khi) ^ (pos & 7)) << 4));
      mbar_wait(&full[slot], (j / TC_STAGES) & 1);
      const uint32_t wa = smem_u32(ws + slot * S::SLOT);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < TC_CK / 16; ++k)  // a k16 slice is 32 bytes into the swizzled rows
        wgmma_rs<BN>(acc, af[k], smem_desc(wa + k * 32), 1);
      wgmma_commit();
      // while the products run: stage one item of the next chunk's halo
      if (more && tap < mine) {
        Raw nxt;
        nxt.dst = -1;
        if (tap + 1 < mine) fetch(cn, tap + 1, nxt);
        put(cur, hnext);
        cur = nxt;
      }
      wgmma_wait<0>();
      fence_acc(acc);
      mbar_arrive(&empty[slot]);
      // refill the slot of the step before, which every thread has read by
      // now (thread 0 seldom waits), so the ring runs TC_STAGES − 1 ahead
      if (tid == 0 && j > 0 && j - 1 + TC_STAGES < steps) {
        mbar_wait(&empty[(j - 1) % TC_STAGES], ((j - 1) / TC_STAGES) & 1);
        issue(j - 1 + TC_STAGES);
      }
    }
    if (more)
      for (int k = 9; k < mine; ++k) {  // items past the ninth (small W only)
        fetch(cn, k, cur);
        put(cur, hnext);
      }
    __syncthreads();  // the next chunk's halo is whole; no one reads this one's any more
  }

  // acc[4q + e] is pixel row g + 8·(e/2) of the warp's 16, channel 8q + 2t +
  // (e & 1): y with the bias, or with splits, this part's f32 sums
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = 64 * wg + 16 * warp + g + 8 * h, q = p % pix;
    const int bi = b0 + p / pix, gy = py0 + q / tw, gx = px0 + q % tw;
    if (p >= pt.nimg * pix || bi >= B || gy >= H || gx >= W) continue;
    const size_t at = static_cast<size_t>(bi) * O * plane + static_cast<size_t>(gy) * W + gx;
    if (splits == 1) {
#pragma unroll
      for (int q8 = 0; q8 < BN / 8; ++q8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = o0 + 8 * q8 + 2 * t + e;
          if (o < O) y[at + o * plane] = __float2bfloat16(acc[4 * q8 + 2 * h + e] + bias[o]);
        }
    } else {
      float* pp = part + static_cast<size_t>(split) * B * O * plane + at;
#pragma unroll
      for (int q8 = 0; q8 < BN / 8; ++q8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = o0 + 8 * q8 + 2 * t + e;
          if (o < O) pp[o * plane] = acc[4 * q8 + 2 * h + e];
        }
    }
  }
}

// y = bf16(Σ_split part[split] + bias), the parts added in order (no
// atomics: reruns are bit-identical).
__global__ void gn_silu_conv3x3_splits_kernel(const float* __restrict__ part,
                                              const float* __restrict__ bias,
                                              __nv_bfloat16* __restrict__ y, size_t n, int splits,
                                              int O, size_t plane) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float v = part[i];
    for (int k = 1; k < splits; ++k) v += part[k * n + i];
    y[i] = __float2bfloat16(v + bias[(i / plane) % O]);
  }
}

// How a call runs: BN, the output channels of a block, and `splits`, the
// parts its channel walk is cut into (each part's f32 sums to a scratch
// buffer, added in order by a second kernel). For each BN the card is filled
// once by splits where the blocks are fewer than the SMs (up to 16, each part
// at least one chunk); the plan with the fewest waves × chunks a block ×
// (BN + 64) is taken (a block's products grow with BN; its halo staging,
// about 64 channels' worth, does not), counting one block an SM and the
// masked channels past O. UNet level 0 (O = 320, 64 pixel tiles) takes BN
// 160 and no split; level 2 (4 tiles, 20 chunks) BN 160 in 4 parts.
struct Plan {
  int bn, splits;
};
Plan wgmma_plan(int B, int C, int H, int W, int O, int sms) {
  const Patch pt = tc_patch(B, H, W);
  const long long groups = static_cast<long long>((B + pt.nimg - 1) / pt.nimg) *
                           ((H + pt.th - 1) / pt.th) * ((W + pt.tw - 1) / pt.tw);
  const int chunks = (C + TC_CK - 1) / TC_CK;
  Plan best{0, 1};
  long long best_cost = 0;
  const int bns[4] = {256, 160, 128, 64};
  for (const int bn : bns) {
    const long long blocks = groups * ((O + bn - 1) / bn);
    int splits = 1;
    if (blocks < sms) {
      splits = static_cast<int>(std::min<long long>(std::min(chunks, TC_MAX_SPLITS), sms / blocks));
      splits = (chunks + (chunks + splits - 1) / splits - 1) / ((chunks + splits - 1) / splits);
    }
    const long long cost = ((blocks * splits + sms - 1) / sms) *
                           ((chunks + splits - 1) / splits) * (bn + 64);
    if (best.bn == 0 || cost < best_cost) {
      best = {bn, splits};
      best_cost = cost;
    }
  }
  return best;
}

// The current device's SMs, asked once a device.
cudaError_t sm_count(int* sms) {
  static int known[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && known[dev] > 0) {
    *sms = known[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) known[dev] = *sms;
  return err;
}

template <int BN>
cudaError_t launch_wgmma(const void* x, const void* a, const void* s, const void* w,
                         const void* bias, void* y, void* work, int B, int C, int H, int W,
                         int O, int splits, cudaStream_t stream) {
  using S = TcShape<BN>;
  auto kernel = gn_silu_conv3x3_wgmma_kernel<BN>;
  // Above 48 KB, dynamic shared memory must be granted before the first
  // launch: once per instance, and a refusal is returned on every call.
  static const cudaError_t granted =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (granted != cudaSuccess) return granted;
  // w as [O, 3, 3, C]: a 3-D map {C, 9 taps, O} of [64 channels × 1 tap × BN rows] boxes
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(C), 9, static_cast<cuuint64_t>(O)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(C) * 2, static_cast<cuuint64_t>(C) * 18};
  const cuuint32_t box[3] = {TC_CK, 1, BN};
  CUtensorMap wmap;
  cudaError_t err = encode_bf16_map(&wmap, w, 3, dims, strides, box);
  if (err != cudaSuccess) return err;
  const Patch pt = tc_patch(B, H, W);
  const int tiles_w = (W + pt.tw - 1) / pt.tw;
  dim3 grid(((H + pt.th - 1) / pt.th) * tiles_w, (O + BN - 1) / BN,
            ((B + pt.nimg - 1) / pt.nimg) * splits);
  kernel<<<grid, TC_THREADS, S::SMEM, stream>>>(
      wmap, static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(a),
      static_cast<const float*>(s), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(work), B, C, H, W, O, tiles_w, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = static_cast<size_t>(B) * O * H * W;
  const int blocks = static_cast<int>(std::min<size_t>((n + 255) / 256, 4096));
  gn_silu_conv3x3_splits_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(work), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(y), n, splits, O, static_cast<size_t>(H) * W);
  return cudaGetLastError();
}

cudaError_t dispatch_wgmma(const void* x, const void* a, const void* s, const void* w,
                           const void* bias, void* y, void* work, int B, int C, int H, int W,
                           int O, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const Plan plan = wgmma_plan(B, C, H, W, O, sms);
  if (plan.splits > 1 && work == nullptr) return cudaErrorInvalidValue;
  switch (plan.bn) {
    case 256: return launch_wgmma<256>(x, a, s, w, bias, y, work, B, C, H, W, O, plan.splits, stream);
    case 160: return launch_wgmma<160>(x, a, s, w, bias, y, work, B, C, H, W, O, plan.splits, stream);
    case 128: return launch_wgmma<128>(x, a, s, w, bias, y, work, B, C, H, W, O, plan.splits, stream);
    default: return launch_wgmma<64>(x, a, s, w, bias, y, work, B, C, H, W, O, plan.splits, stream);
  }
}

}  // namespace

// x [B,C,H,W] (dtype), a/s [B,C] f32, bias [O] f32 → y [B,O,H,W] (dtype).
// w is [O,C,3,3] (dtype): OIHW contiguous for the SIMT body, [O,3,3,C]
// contiguous (channels_last) for the tensor-core body. dtype: 0 = float32,
// 1 = bfloat16. body: 0 = the SIMT body, 1 = the tensor-core body
// (bfloat16, C % 8 == 0, w, a and s 16-byte aligned; `work`, f32 scratch of
// forge_gn_silu_conv3x3_wgmma_splits(...) · B·O·H·W values where that is
// above 1, else unused). Returns a cudaError_t value (0 on success).
extern "C" int forge_gn_silu_conv3x3(const void* x, const void* a, const void* s,
                                     const void* w, const void* bias, void* y, void* work, int B,
                                     int C, int H, int W, int O, int dtype, int body,
                                     void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || O <= 0 || B > 65535 ||
      (O + BO - 1) / BO > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(a) |
                           reinterpret_cast<uintptr_t>(s);
    if (dtype != 1 || C % 8 != 0 || (ptrs & 15) != 0) return (int)cudaErrorInvalidValue;
    return (int)dispatch_wgmma(x, a, s, w, bias, y, work, B, C, H, W, O, st);
  }
  if (body != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch<float>(x, a, s, w, bias, y, B, C, H, W, O, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, a, s, w, bias, y, B, C, H, W, O, st);
  return (int)cudaErrorInvalidValue;
}

// The parts the tensor-core body cuts the channel walk of this call into (1:
// no scratch needed), or -1 if the card cannot be asked.
extern "C" int forge_gn_silu_conv3x3_wgmma_splits(int B, int C, int H, int W, int O) {
  int sms = 0;
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || O <= 0 || sm_count(&sms) != cudaSuccess) return -1;
  return wgmma_plan(B, C, H, W, O, sms).splits;
}

// Dynamic shared memory of the tensor-core body at BN output channels a
// block, in bytes; -1 where no instance has that BN.
extern "C" int forge_gn_silu_conv3x3_wgmma_smem(int bn) {
  switch (bn) {
    case 256: return TcShape<256>::SMEM;
    case 160: return TcShape<160>::SMEM;
    case 128: return TcShape<128>::SMEM;
    case 64: return TcShape<64>::SMEM;
  }
  return -1;
}

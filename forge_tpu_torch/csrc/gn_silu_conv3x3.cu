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
// What bounds it on the H100: this first version is an implicit GEMM on the
// f32 CUDA cores (67 TFLOP/s peak), not the tensor cores, so it is bound by
// FMA issue and shared-memory bandwidth. Its design: each block owns a tile of
// TH×TW output pixels × BO output channels; per chunk of CC input channels it
// stages the (TH+2)×(TW+2) activated halo and the CC·9 × BO weight slab in
// shared memory as f32, and each thread accumulates a 4 pixel × 4 channel
// register tile over the 9 taps, so each shared-memory load feeds four FMAs.
// Bias is added in the f32 epilogue. For bf16 inputs the activation is
// rounded to bf16 before the product, as the reference stores it.
// Tensor cores (wgmma), TMA and a pipelined channel loop are later work.
// Blocks allocate nothing, use no atomics, and run on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace

// x [B,C,H,W], w [O,C,3,3] (dtype), a/s [B,C] f32, bias [O] f32 → y [B,O,H,W] (dtype).
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t value (0 on success).
extern "C" int forge_gn_silu_conv3x3(const void* x, const void* a, const void* s,
                                     const void* w, const void* bias, void* y, int B, int C,
                                     int H, int W, int O, int dtype, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || O <= 0 || B > 65535 ||
      (O + BO - 1) / BO > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, a, s, w, bias, y, B, C, H, W, O, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, a, s, w, bias, y, B, C, H, W, O, st);
  return (int)cudaErrorInvalidValue;
}

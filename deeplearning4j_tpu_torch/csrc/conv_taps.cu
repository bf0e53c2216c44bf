// Single-input-channel convolution as tap accumulation, for Hopper
// (sm_90a): K3, LeNet's conv1.
//
// Replaces the Pallas TPU kernel scripts/lenet_breakdown.py:pal_kernel
// (called through pallas_fwd), which computes LeNet's conv1 forward
// (1 -> 20 channels, 5x5, stride 1) as 25 scalar-times-plane
// accumulations in f32. Same function here, in the JAX conv layer's
// public layout (NCHW) instead of the script's batch-on-lanes one:
//
//   out[b, o, i, j] = sum_{dy, dx} w[o, dy, dx] * xp[b, i + dy, j + dx]
//
// where xp is x[b, 0] zero-padded by (ph, pw) on each side. The sum is
// taken in f32 in dy-major, dx-minor order (fused multiply-adds, so a
// bf16 output may differ from the plain version's separate multiply
// and add by one bf16 ulp); out is stored in x's dtype (f32 or bf16).
// w is f32 [O, kh, kw] (the wrapper upcasts a bf16 W, as pallas_fwd
// does); kh, kw <= 7; no bias (the layer adds it).
//
// Design (simple and right first): one thread block per image. The
// block stages the zero-padded image [Hp, Wp] and all weights
// [O, kh, kw] in shared memory as f32, then each thread owns one output
// pixel at a time: it loads its kh*kw taps into registers once and runs
// O accumulators over them, reading each weight as a shared-memory
// broadcast. For a fixed channel o neighbouring threads hold
// neighbouring pixels, so each channel's store is coalesced. LeNet's
// 5x5 is compiled with its tap count fixed (taps live in registers with
// no guards); other sizes up to 7x7 take a guarded path, whose loops are
// unrolled to 7x7 under the run-time kh, kw. At LeNet's shape the
// guarded path takes 2.7x the fixed one's time on an H100 SXM
// (chip_smoke.py times both), so the specialisation stays.
//
// Shared memory: the caller passes the dynamic size, the sum of the two
// f32 regions above; ``conv_taps_smem_bytes`` in
// nn/layers/convolution.py is its one formula, which the wrapper also
// checks against the card's limit before launching.
//
// What bounds it on the card: at LeNet's training shape (B = 2048,
// bf16, O = 20, 28x28 -> 24x24) it moves 3.21 MB of x and 47.19 MB of
// out, 15.0 us at 3.35 TB/s, and does 2 * 2048 * 20 * 25 * 576 =
// 1.18 GFLOP on bf16 x and bf16-valued weights, 1.2 us at the bf16
// tensor-core rate. So the bound is the bytes, 15.0 us. This kernel
// does the work as f32 FMAs on the CUDA cores instead, 17.6 us at
// 67 TFLOP/s: the gap to the bound is its design, not the work. The
// output is 15x the input, so the stores dominate the bytes; vectorised
// bf16 stores, several pixels a thread and a tensor-core im2col are
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>

namespace {

constexpr int kMaxTaps = 7;
constexpr int kMaxThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// KH = KW = 0: kh and kw at run time (<= kMaxTaps), guarded taps.
template <typename T, int KH, int KW>
__global__ void conv_taps_kernel(const T* __restrict__ x,
                                 const float* __restrict__ w,
                                 T* __restrict__ out, int O, int H, int W,
                                 int kh_rt, int kw_rt, int ph, int pw) {
  constexpr int MH = KH ? KH : kMaxTaps;
  constexpr int MW = KW ? KW : kMaxTaps;
  const int kh = KH ? KH : kh_rt;
  const int kw = KW ? KW : kw_rt;
  const int hp = H + 2 * ph;
  const int wp = W + 2 * pw;
  const int ho = hp - kh + 1;
  const int wo = wp - kw + 1;
  const int taps = kh * kw;

  extern __shared__ float smem[];
  float* img = smem;              // [hp, wp], zero-padded
  float* ws = img + hp * wp;      // [O, kh, kw]

  const int b = blockIdx.x;
  const T* xb = x + (size_t)b * H * W;
  for (int idx = threadIdx.x; idx < hp * wp; idx += blockDim.x) {
    const int r = idx / wp - ph;
    const int c = idx % wp - pw;
    img[idx] = (r >= 0 && r < H && c >= 0 && c < W)
                   ? to_f32(xb[r * W + c]) : 0.f;
  }
  for (int idx = threadIdx.x; idx < O * taps; idx += blockDim.x)
    ws[idx] = w[idx];
  __syncthreads();

  T* ob = out + (size_t)b * O * ho * wo;
  const int npix = ho * wo;
  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    const int i = p / wo;
    const int j = p - i * wo;
    float tap[MH * MW];
#pragma unroll
    for (int dy = 0; dy < MH; ++dy)
#pragma unroll
      for (int dx = 0; dx < MW; ++dx)
        tap[dy * MW + dx] =
            (dy < kh && dx < kw) ? img[(i + dy) * wp + j + dx] : 0.f;
    for (int o = 0; o < O; ++o) {
      const float* wrow = ws + o * taps;
      float acc = 0.f;
#pragma unroll
      for (int dy = 0; dy < MH; ++dy)
#pragma unroll
        for (int dx = 0; dx < MW; ++dx)
          if (dy < kh && dx < kw)
            acc = fmaf(wrow[dy * kw + dx], tap[dy * MW + dx], acc);
      store(ob + (size_t)o * npix + p, acc);
    }
  }
}

// Threads per block: as few rounds over the output pixels as 256
// threads allow, each round as full as a whole number of warps makes it.
int block_threads(int npix) {
  const int rounds = (npix + kMaxThreads - 1) / kMaxThreads;
  const int per_round = (npix + rounds - 1) / rounds;
  return ((per_round + 31) / 32) * 32;
}

template <typename T, int KH, int KW>
cudaError_t launch(const void* x, const float* w, void* out, int B, int O,
                   int H, int W, int kh, int kw, int ph, int pw,
                   size_t smem, cudaStream_t stream) {
  auto kern = conv_taps_kernel<T, KH, KW>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int npix = (H + 2 * ph - kh + 1) * (W + 2 * pw - kw + 1);
  kern<<<B, block_threads(npix), smem, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(out), O, H, W, kh, kw,
      ph, pw);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_taps(const void* x, const float* w, void* out, int B,
                        int O, int H, int W, int kh, int kw, int ph,
                        int pw, size_t smem, int guarded, cudaStream_t s) {
  if (kh == 5 && kw == 5 && !guarded)
    return launch<T, 5, 5>(x, w, out, B, O, H, W, kh, kw, ph, pw, smem, s);
  return launch<T, 0, 0>(x, w, out, B, O, H, W, kh, kw, ph, pw, smem, s);
}

}  // namespace

extern "C" {

// x [B, 1, H, W] (dtype code 0 = float32, 1 = bfloat16), w f32
// [O, kh, kw], out [B, O, Ho, Wo] in x's dtype; smem is the dynamic
// shared memory the caller sized (see the note above); guarded != 0
// takes the guarded path even for 5x5. Launches on ``stream`` and does
// not synchronise; returns the launch's error.
cudaError_t dl4j_conv_taps(const void* x, const void* w, void* out, int B,
                           int O, int H, int W, int kh, int kw, int ph,
                           int pw, int x_dtype, size_t smem, int guarded,
                           void* stream) {
  if (B < 1 || O < 1 || H < 1 || W < 1 || kh < 1 || kw < 1 ||
      kh > kMaxTaps || kw > kMaxTaps || ph < 0 || pw < 0 ||
      H + 2 * ph < kh || W + 2 * pw < kw)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto wf = static_cast<const float*>(w);
  if (x_dtype == 0)
    return launch_taps<float>(x, wf, out, B, O, H, W, kh, kw, ph, pw, smem,
                              guarded, s);
  if (x_dtype == 1)
    return launch_taps<__nv_bfloat16>(x, wf, out, B, O, H, W, kh, kw, ph,
                                      pw, smem, guarded, s);
  return cudaErrorInvalidValue;
}

const char* dl4j_conv_taps_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

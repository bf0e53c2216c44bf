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
// where xp is x[b, 0] zero-padded by (ph, pw) on each side, summed in
// f32 and stored in x's dtype; kh, kw <= 7; no bias (the layer adds it).
// Two kernels, chosen by the wrapper (nn/layers/convolution.py) from the
// operands' dtypes and the shape before any launch:
//
// 1. conv_taps_mma_kernel: bf16 x and bf16 W (the LeNet path: the net
//    casts W to its compute dtype), on the tensor cores.
// 2. conv_taps_kernel: everything else (f32 x, f32 W, bf16 x with a
//    genuinely f32 W), on the CUDA cores; W reaches it as f32.
//
// What bounds K3 on the card: at LeNet's training shape (B = 2048, bf16,
// O = 20, 28x28 -> 24x24) it moves 3.21 MB of x and 47.19 MB of out,
// 15.0 us at 3.35 TB/s, and does 2 * 2048 * 20 * 25 * 576 = 1.18 GFLOP,
// 1.2 us at the bf16 tensor-core rate (17.6 us as f32 FMAs on the CUDA
// cores). So the bound is the bytes, and the output is 15x the input.
// In f32 (the zoo's default lenet5()) the bytes double: 6.42 MB of x and
// 94.37 MB of out, 30.1 us, against the same 17.6 us of FMAs.
//
// The tensor-core kernel (bf16 x, bf16 W)
// ---------------------------------------
// Products: mma.sync m16n8k16 bf16 with f32 accumulators over an
// implicit im2col, transposed so that the output comes out the way it is
// stored: A = W as [channels x taps] (32 channels a pass, taps zero-
// padded to a multiple of 16: 25 -> 32), held in registers for the
// kernel's life when O <= 32; B = the image as [taps x pixels], each
// element one 16-bit shared load through a per-lane tap -> dy*Wp + dx
// offset table. A padded tap's offset is the start of a zero region as
// large as the image, so it reads zero whatever the pixel, never a
// neighbouring pixel: an inf elsewhere in the image cannot turn into a
// NaN through 0 * inf. Where a lane's 8 pixels lie in one output row (at
// LeNet's 24x24 always) the loads take their pixel step as an immediate.
// wgmma buys nothing here: the products are 1.2 us of work at the full
// rate, and its 64-row tiles would need the im2col laid out in shared
// memory first.
//
// Pixel order: a warp owns 64 pixels at a time as 8 n-tiles, column n
// of n-tile j being pixel 8n + j. So a lane's accumulators (columns 2t,
// 2t+1 of every n-tile) are 16 consecutive pixels of each of its
// channels: two 16-byte shared stores per channel, with no shuffles.
// Lanes of odd and even rows store their two halves in opposite order,
// so the eight lanes of each store phase hit eight different 16-byte
// bank groups (when a channel row is 1152 bytes, as at LeNet's 24x24,
// all channels start on the same bank).
//
// Input: persistent blocks (up to 4 per SM, as registers and shared
// memory allow) walk over the images. Each image lands by one
// cp.async.bulk (x's images are laid out 16-byte aligned; the wrapper
// pads x's image stride to a multiple of 8 elements where it is not)
// into a 2-stage ring completed on mbarriers, so image n+1 arrives while
// image n computes. For padding > 0 the landed image is copied into the
// interior of a zero-padded buffer whose halo and zero region are
// written once and never overwritten.
//
// Output: each image's [O, Ho*Wo] is staged as bf16 in shared memory
// (23,040 contiguous bytes at LeNet's shape) and written by one bulk
// async copy from shared to global memory, its group waited on before
// that buffer is reused (two buffers). Where O*Ho*Wo is not a multiple
// of 8 (the copy needs 16-byte sizes and addresses) the block writes it
// with 16-byte vector stores instead, scalar only at its two ends.
//
// Rounding: the plain version (conv_taps_reference) sums the taps one
// after another in f32; the tensor cores sum them in another order.
// Where the sum cancels, that moves the bf16 result by many ulps: the
// two f32 sums differ by a few 2^-24 of s = sum |w x|, while a bf16 ulp
// is about 2^-8 of the result (without what follows, 8 ulps and more at
// LeNet's shape: scripts/torch_conv_taps_variants.py reads it). So
// beside each product the kernel takes s with one more mma, on the
// operands' magnitudes, and flags each output with |out| < kFixRel * s;
// after the image its threads recompute the flagged outputs in the
// plain version's order (multiply, then add, both rounded), W's bf16
// bits staged in shared memory. kFixRel is 2^-10: with 25 taps, 24
// roundings in the plain version's sum and (assumed) at most 17 in the
// tensor cores', each under 2^-24 s, a second ulp needs |out| < 41 *
// 2^-24 s / 2^-8 = 2^-10.6 s; on the card the outputs that miss one ulp
// without the fix-up sit far lower (the same script prints their largest
// |out| / s). Flagged outputs reach a list in shared memory with one
// atomic a warp; up to kFixCap an image, past which the block recomputes
// the whole image so. Building with -DDL4J_CONV_TAPS_FIX_REL=0 leaves the
// fix-up out: the script's reading, not the product's.
//
// Shared memory: the caller passes the dynamic size;
// ``conv_taps_mma_smem_bytes`` in nn/layers/convolution.py is its one
// formula (MmaLayout below is the same layout), which the wrapper
// checks against the card's limit before launching.
//
// The CUDA-core kernel (f32 x, or bf16 x with an f32 W)
// -----------------------------------------------------
// At LeNet's shape in f32 it is bytes-bound (30.1 us, 94% of it the
// output) as long as its 590 M fused multiply-adds issue at close to one
// a lane a clock: 17.6 us at 67 TFLOP/s. A warp issues one instruction a
// clock and an SM's four schedulers four FFMAs, so every other
// instruction costs an FFMA's slot; one shared load per FFMA, as in a
// thread-per-pixel layout, halves the rate at best and leaves the
// kernel bound by the shared-memory pipe. So:
//
// Register blocking. A thread owns a strip of kStrip = 8 consecutive
// output pixels of one row and a group of channels. It loads the strip's
// input window (kh rows of 8 + kw - 1 floats) into registers once; for
// each of its channels it reads the weights from shared memory as
// 16-byte broadcasts of 4 taps (each channel's taps zero-padded to whole
// float4s) and each weight serves the 8 pixels: at 5x5, 7 LDS.128 per 200
// FFMA. Weights in the constant bank (an FFMA operand c[..], no load at
// all) were weighed and not taken: W changes every training step and lives
// on the card, so each launch would first copy it device to device into a
// __constant__ symbol, one more operation on the stream, and two calls on
// different streams would race for the one symbol (a kernel parameter
// would need W on the host). The broadcasts cost about 4% of the issue
// slots and share nothing between launches.
//
// Sums: each output is one fmaf chain over the taps from 0, dy-major and
// dx-minor, as the thread-per-pixel kernel this one replaced summed. The
// plain version (conv_taps_reference) multiplies, then adds, rounding
// twice, so at f32 the two agree to within a few roundings of the sum,
// not bit for bit (chip_smoke.py holds them to CONV_TOL_F32, relative to
// the largest output); at bf16 x the f32 sum is rounded once to bf16,
// within CONV_TOL_ULPS of the plain version's.
//
// Input: persistent blocks (kFfmaBlocksPerSM an SM) walk over the images,
// each landing by one cp.async.bulk into an mbarrier ring of up to
// kFfmaStages images (the tensor-core kernel's helpers): images are small
// (3,136 bytes in f32), and under the output's write traffic a 2-deep
// ring left the blocks waiting on their next image. f32 x without padding
// is read where it lands; bf16 x, or padding > 0, is first copied as f32
// into the interior of a zero-padded image whose halo is written once.
// Every image buffer is followed by kSlack floats, so a strip that runs
// past its row's end reads inside the buffer (its outputs past Wo are
// never stored).
//
// Output: the block stages its output in shared memory in x's dtype, by
// pieces of whole channel-rows [c, i, :], which lie one after another in
// out: the whole image [O, Ho*Wo] at LeNet's shape (46,080 bytes a buffer
// in f32), fewer channel-rows (at least one) where the image and the ring
// leave less room. A thread stages its strip with 16-byte stores (the two
// halves of an f32 strip in the order that puts the eight lanes of a store
// phase on eight bank groups). Each piece goes out by one bulk async copy
// from shared to global memory, two buffers, its group waited on before
// the buffer is reused; where a piece's size or address is not a multiple
// of 16 bytes, the block writes it with 16-byte vector stores instead, one
// element at a time only at its two ends.
//
// The plan: the ring's depth (stages) and a piece's channel-rows
// (piece_rows) are the launch's arguments, chosen by the wrapper
// (conv_taps_plan in nn/layers/convolution.py) for the image at hand: the
// deepest ring up to kFfmaStages, then the most rows up to 96 KB of both
// buffers, that fit a block. An image too large for even one ring stage
// and one row of each buffer (at 20 channels, 5x5: f32 from 239 x 239,
// bf16 x from 196 x 196, f32 padded by 2 from 168 x 168) runs with
// stages = 0, on the guarded path, in no more shared memory than the
// zero-padded f32 image and W take: the block reads each image from
// global memory itself into the padded image (no ring), W's rows are not
// padded, a strip's window reads nothing past its row, and the strips
// store to global memory from registers (no staging). So the kernel takes
// every image whose padded f32 copy and W fit a block.
//
// LeNet's 5x5 is compiled with its tap count fixed; other sizes up to 7x7
// take a guarded path in the same kernel (strips of kGuardedStrip = 4
// pixels, the taps under the run-time kh, kw, one scalar weight load per
// tap). Shared memory: ``conv_taps_smem_bytes`` in
// nn/layers/convolution.py is its one formula (FfmaLayout below is the
// same layout); the launch refuses less than the layout takes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxTaps = 7;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------------
// The tensor-core kernel
// ---------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kStages = 2;          // images in flight a block
constexpr int kOutBuffers = 2;      // output buffers a block
constexpr int kMaxWarps = 4;        // warps a block
#ifndef DL4J_CONV_TAPS_FIX_REL
#define DL4J_CONV_TAPS_FIX_REL 0x1p-10f
#endif
constexpr int kMaxBlocksPerSM = 4;
constexpr int kChunk = 64;          // pixels a warp owns at a time
constexpr int kFixCap = 512;        // outputs an image fixed up by list
// outputs with |out| < kFixRel * sum |w x| are recomputed in order
constexpr float kFixRel = DL4J_CONV_TAPS_FIX_REL;
constexpr bool kFixUp = kFixRel > 0.f;

__host__ __device__ constexpr int round8(int n) { return (n + 7) & ~7; }

// The shared-memory layout, in bytes from the (16-byte aligned) base; the
// same as conv_taps_mma_smem_bytes in nn/layers/convolution.py.
// An image buffer is followed by a zero region as large as the padded
// image, so that a padded tap's offset (the region's start) added to any
// pixel's offset still reads zero.
struct MmaLayout {
  int land_elems;   // one ring stage: the image's stride + zero region
  int pimg_elems;   // the zero-padded image + zero region (padding only)
  int out_elems;    // one output buffer [O, npix]
  int list_off, w_off, land_off, pimg_off, out_off, bytes;
  __host__ __device__ MmaLayout(int O, int H, int W, int kh, int kw,
                                int ph, int pw, int npix, int x_stride) {
    const int zeros = round8((H + 2 * ph) * (W + 2 * pw));
    land_elems = x_stride + ((ph || pw) ? 0 : zeros);
    pimg_elems = (ph || pw) ? 2 * zeros : 0;
    out_elems = round8(O * npix);
    list_off = 32;    // two mbarriers, two fix-up counters
    w_off = list_off + 4 * kFixCap;                  // W's bf16 bits
    land_off = w_off + 2 * round8(O * kh * kw);
    pimg_off = land_off + 2 * kStages * land_elems;
    out_off = pimg_off + 2 * pimg_elems;
    bytes = out_off + 2 * kOutBuffers * out_elems;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also announces `bytes` of bulk-copy traffic
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// wait for the phase of parity `parity`; a wait that outlasts any
// image's load by far (2^28 polls, seconds) is a lost arrival: it traps
// (an error at the next synchronisation) rather than hang the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}
// order this thread's generic-proxy shared accesses before its later
// bulk copies (which read or write shared memory through the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the bulk stores this thread committed, all but the newest N, have
// finished reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bits_to_f32(unsigned short v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// out[ch, p] in the plain version's order: sum over dy, then dx, of the
// rounded product, each add rounded (as conv_taps_reference computes it)
__device__ float ordered_sum(const unsigned short* img,
                             const unsigned short* wrow, int poff, int kh,
                             int kw, int wp) {
  float acc = 0.f;
  for (int dy = 0; dy < kh; ++dy)
#pragma unroll
    for (int dx = 0; dx < kMaxTaps; ++dx)
      if (dx < kw)
        acc = __fadd_rn(
            acc, __fmul_rn(bits_to_f32(wrow[dy * kw + dx]),
                           bits_to_f32(img[poff + dy * wp + dx])));
  return acc;
}

// A fragments (W, and |W|) of channels [32 * grp, 32 * grp + 32): for
// m-tile mt, k-step ks, register r, lane (g, t) holds rows
// g + 8 * (r & 1) and columns 2t + 8 * (r >> 1) + {0, 1}
template <int KS>
__device__ __forceinline__ void load_weights(uint32_t (*a)[KS][4],
                                             uint32_t (*aa)[KS][4],
                                             const unsigned short* w,
                                             int grp, int O, int taps,
                                             int g, int t) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 32 * grp + 16 * mt + g + 8 * (r & 1);
        const int col = 16 * ks + 2 * t + 8 * (r >> 1);
        uint32_t v = 0;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (row < O && col + h < taps)
            v |= static_cast<uint32_t>(w[row * taps + col + h]) << (16 * h);
        a[mt][ks][r] = v;
        aa[mt][ks][r] = v & 0x7fff7fffu;
      }
}

template <int KS>
__global__ void __launch_bounds__(kMaxWarps * 32)
    conv_taps_mma_kernel(const bf16* __restrict__ x,
                         const bf16* __restrict__ w, bf16* __restrict__ out,
                         int B, int O, int H, int W, int kh, int kw, int ph,
                         int pw, int x_stride) {
  const int hp = H + 2 * ph, wp = W + 2 * pw;
  const int ho = hp - kh + 1, wo = wp - kw + 1;
  const int npix = ho * wo, taps = kh * kw;
  const bool padded = ph || pw;
  const int n_out = O * npix;
  const int groups = (O + 31) / 32;
  const int chunks = (npix + kChunk - 1) / kChunk;
  const MmaLayout L(O, H, W, kh, kw, ph, pw, npix, x_stride);

  extern __shared__ __align__(16) uint8_t mma_smem[];
  uint8_t* smem = mma_smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  int* fix_count = reinterpret_cast<int*>(smem + 16);   // [2]
  int* fix_list = reinterpret_cast<int*>(smem + L.list_off);
  unsigned short* wsm = reinterpret_cast<unsigned short*>(smem + L.w_off);
  unsigned short* land =
      reinterpret_cast<unsigned short*>(smem + L.land_off);
  unsigned short* pimg =
      reinterpret_cast<unsigned short*>(smem + L.pimg_off);
  unsigned short* ostage =
      reinterpret_cast<unsigned short*>(smem + L.out_off);
  const unsigned short* wbits = reinterpret_cast<const unsigned short*>(w);

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, nwarps = nthreads >> 5;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  // the zero region: after the landed image's stride, or after the
  // padded image; no copy ever writes it
  const int zeros = padded ? L.pimg_elems / 2 : x_stride;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + s, 1);
    fix_count[0] = fix_count[1] = 0;
    mbar_init_fence();
  }
  const int land_zeros = L.land_elems - x_stride;
  for (int i = tid; i < kStages * land_zeros; i += nthreads)
    land[(i / land_zeros) * L.land_elems + x_stride + i % land_zeros] = 0;
  for (int i = tid; i < L.pimg_elems; i += nthreads) pimg[i] = 0;
  for (int i = tid; i < O * taps; i += nthreads) wsm[i] = wbits[i];
  __syncthreads();

  const int first = blockIdx.x, step = gridDim.x;
  const uint32_t img_bytes = 2u * x_stride;
  auto issue = [&](int n) {   // image n of this block into its stage
    const int img = first + n * step;
    if (img >= B) return;
    uint64_t* bar = full + n % kStages;
    mbar_expect_tx(bar, img_bytes);
    bulk_load(land + (n % kStages) * L.land_elems,
              x + (size_t)img * x_stride, img_bytes, bar);
  };
  if (tid == 0)
    for (int n = 0; n < kStages; ++n) issue(n);

  // this lane's B rows: taps 16 ks + 2t + (e & 1) + 8 (e >> 1); a padded
  // tap's offset is the zero region's start, which any pixel's offset
  // keeps inside the region
  int toff[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 16 * ks + 2 * t + (e & 1) + 8 * (e >> 1);
      toff[ks][e] = k < taps ? (k / kw) * wp + k % kw : zeros;
    }
  uint32_t a[2][KS][4], aa[2][KS][4];
  load_weights<KS>(a, aa, wbits, 0, O, taps, g, t);
  // the store phases: lanes of even and odd rows take the two 16-byte
  // halves of their 16 pixels in opposite order (see the header)
  const int swap = (g & 1) & ~((npix >> 3) & 1);

  for (int n = 0, img = first; img < B; ++n, img += step) {
    const int s = n % kStages;
    unsigned short* ob = ostage + (n % kOutBuffers) * L.out_elems;
    // the store that last read ob (image n - kOutBuffers's) is done
    if (tid == 0) bulk_wait_read<kOutBuffers - 1>();
    mbar_wait(full + s, (n / kStages) & 1);
    const unsigned short* src = land + s * L.land_elems;
    if (padded) {
      for (int i = tid; i < H * W; i += nthreads)
        pimg[(i / W + ph) * wp + i % W + pw] = src[i];
      src = pimg;
    }
    __syncthreads();                      // (A) image ready, ob free
    if (padded && tid == 0) issue(n + kStages);
    int* count = fix_count + (n & 1);

    for (int grp = 0; grp < groups; ++grp) {
      if (groups > 1) load_weights<KS>(a, aa, wbits, grp, O, taps, g, t);
      const bool two = O - 32 * grp > 16;   // m-tile 1 has channels
      const bool three = O - 32 * grp > 24;  // its rows g + 8 too
      for (int c = warp; c < chunks; c += nwarps) {
        const int p0 = c * kChunk;
        float acc[2][8][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
        // B column g of n-tile j is pixel p0 + 8g + j
        const int pb = p0 + 8 * g;
        const int pr = pb / wo, pc0 = pb - pr * wo;
        // bit 4 j + e of flags[mt]: acc[mt][j][e] cancels (see the
        // header): the sign of |acc| - kFixRel * s
        uint32_t flags[2] = {0u, 0u};
        // n-tile j on the image at pixel offset `off`
        auto tile = [&](const int j, const int off) {
          uint32_t b[KS][2], bb[KS][2];
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t lo = src[off + toff[ks][2 * h]];
              const uint32_t hi = src[off + toff[ks][2 * h + 1]];
              b[ks][h] = lo | (hi << 16);
              bb[ks][h] = b[ks][h] & 0x7fff7fffu;
            }
          float sabs[2][4] = {};
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (mt == 1 && !two) break;
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
              mma_bf16(acc[mt][j], a[mt][ks], b[ks]);
              if constexpr (kFixUp) mma_bf16(sabs[mt], aa[mt][ks], bb[ks]);
            }
          }
          if constexpr (kFixUp) {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (mt == 0 || e < 2 || three)
                  flags[mt] |= (__float_as_uint(fmaf(-kFixRel, sabs[mt][e],
                                                     fabsf(acc[mt][j][e]))) >>
                                31) << (4 * j + e);
          }
        };
        // mma.sync is warp-wide: the whole warp takes one of the paths
        if (__all_sync(0xffffffffu, pc0 + 8 <= wo && pb + 8 <= npix)) {
          // each lane's 8 pixels lie in one output row: offsets by
          // immediates
          const int poff = pr * wp + pc0;
#pragma unroll
          for (int j = 0; j < 8; ++j) tile(j, poff + j);
        } else {
          int poff = pr * wp + pc0, pc = pc0;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            tile(j, pb + j < npix ? poff : 0);   // past the end: any
            ++poff;
            if (++pc == wo) {
              pc = 0;
              poff += wp - wo;
            }
          }
        }
        // outputs whose sum cancels: listed for the ordered sum, one
        // atomic a warp (an entry past the image or O is -1)
        const int mine = __popc(flags[0]) + __popc(flags[1]);
        int slot = mine;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, slot, d);
          if (lane >= d) slot += v;
        }
        const int total = __shfl_sync(0xffffffffu, slot, 31);
        if (kFixUp && total) {
          int base = 0;
          if (lane == 31) base = atomicAdd(count, total);
          slot += __shfl_sync(0xffffffffu, base, 31) - mine;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            for (uint32_t f = flags[mt]; f; f &= f - 1, ++slot) {
              const int bit = __ffs(f) - 1;
              const int ch = 32 * grp + 16 * mt + g + 8 * ((bit >> 1) & 1);
              const int p = p0 + 16 * t + 8 * (bit & 1) + (bit >> 2);
              if (slot < kFixCap)
                fix_list[slot] = ch < O && p < npix ? ch * npix + p : -1;
            }
        }
        // stage: lane (g, t) holds pixels p0 + 16t + [0, 16) of channels
        // 32 grp + 16 mt + g + 8 h
        const int q0 = p0 + 16 * t;
        const bool vec = (npix & 7) == 0 && q0 + 16 <= npix;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ch = 32 * grp + 16 * mt + g + 8 * h;
            if (ch >= O) continue;
            unsigned short* row = ob + ch * npix;
            if (vec) {
              uint4 half[2];
              half[0] = make_uint4(
                  pack_bf16(acc[mt][0][2 * h], acc[mt][1][2 * h]),
                  pack_bf16(acc[mt][2][2 * h], acc[mt][3][2 * h]),
                  pack_bf16(acc[mt][4][2 * h], acc[mt][5][2 * h]),
                  pack_bf16(acc[mt][6][2 * h], acc[mt][7][2 * h]));
              half[1] = make_uint4(
                  pack_bf16(acc[mt][0][2 * h + 1], acc[mt][1][2 * h + 1]),
                  pack_bf16(acc[mt][2][2 * h + 1], acc[mt][3][2 * h + 1]),
                  pack_bf16(acc[mt][4][2 * h + 1], acc[mt][5][2 * h + 1]),
                  pack_bf16(acc[mt][6][2 * h + 1], acc[mt][7][2 * h + 1]));
              const uint4 first_half = swap ? half[1] : half[0];
              const uint4 second_half = swap ? half[0] : half[1];
              *reinterpret_cast<uint4*>(row + q0 + 8 * swap) = first_half;
              *reinterpret_cast<uint4*>(row + q0 + 8 * (1 - swap)) =
                  second_half;
            } else {
#pragma unroll
              for (int q = 0; q < 16; ++q)
                if (q0 + q < npix) {
                  const float v = q < 8 ? acc[mt][q][2 * h]
                                        : acc[mt][q - 8][2 * h + 1];
                  const bf16 r = __float2bfloat16_rn(v);
                  row[q0 + q] = *reinterpret_cast<const unsigned short*>(&r);
                }
            }
          }
      }
    }
    fence_proxy_async();                  // ob's writes, for the store
    __syncthreads();                      // (B) ob staged, list complete
    const int nfix = *count;
    if (tid == 0) fix_count[(n + 1) & 1] = 0;
    if (nfix > 0) {
      const bool all = nfix > kFixCap;   // the list overflowed
      const int m = all ? n_out : nfix;
      for (int i = tid; i < m; i += nthreads) {
        const int e = all ? i : fix_list[i];
        if (e < 0) continue;
        const int ch = e / npix, p = e - ch * npix;
        const int i0 = p / wo;
        const float v = ordered_sum(src, wsm + ch * taps,
                                    i0 * wp + p - i0 * wo, kh, kw, wp);
        const bf16 r = __float2bfloat16_rn(v);
        ob[e] = *reinterpret_cast<const unsigned short*>(&r);
      }
      fence_proxy_async();
      __syncthreads();                    // (C) fix-ups staged
    }
    unsigned short* dst =
        reinterpret_cast<unsigned short*>(out) + (size_t)img * n_out;
    if ((n_out & 7) == 0) {
      if (tid == 0) {
        bulk_store(dst, ob, 2u * n_out);
        if (!padded) issue(n + kStages);
      }
    } else {
      // 16-byte stores where the destination is 16-byte aligned
      if (!padded && tid == 0) issue(n + kStages);
      const int head = min(n_out, (int)((8 - ((size_t)img * n_out) % 8) % 8));
      const int body = (n_out - head) / 8;
      for (int v = tid; v < body; v += nthreads) {
        const unsigned short* sp = ob + head + 8 * v;
        uint4 u;
        u.x = sp[0] | (static_cast<uint32_t>(sp[1]) << 16);
        u.y = sp[2] | (static_cast<uint32_t>(sp[3]) << 16);
        u.z = sp[4] | (static_cast<uint32_t>(sp[5]) << 16);
        u.w = sp[6] | (static_cast<uint32_t>(sp[7]) << 16);
        *reinterpret_cast<uint4*>(dst + head + 8 * v) = u;
      }
      for (int i = tid; i < n_out; i += nthreads)
        if (i < head || i >= head + 8 * body) dst[i] = ob[i];
    }
  }
  if (tid == 0) bulk_wait_all();
}

// A persistent kernel's grid: as many blocks an SM as registers and
// shared memory allow, up to max_per_sm, on every SM, and no more than B.
// The configuration is kept from the last launch of the same kernel,
// device, block and shared memory (the queries cost more than the launch
// on a host-bound training step).
struct LaunchConfig {
  int dev = -1, threads = 0, sms = 0, per_sm = 0;
  size_t smem = 0;
};

template <typename Kernel>
cudaError_t persistent_grid(Kernel kern, LaunchConfig& cfg, int threads,
                            size_t smem, int max_per_sm, int B, int* grid) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (cfg.dev != dev || cfg.threads != threads || cfg.smem != smem) {
    LaunchConfig c;
    c.dev = dev, c.threads = threads, c.smem = smem;
    if ((e = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)smem)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &c.per_sm, kern, threads, smem)) != cudaSuccess)
      return e;
    c.per_sm = c.per_sm < max_per_sm ? c.per_sm : max_per_sm;
    if (c.per_sm < 1) return cudaErrorInvalidConfiguration;
    cfg = c;
  }
  const long long g = (long long)cfg.sms * cfg.per_sm;
  *grid = (int)(g < B ? g : B);
  return cudaSuccess;
}

template <int KS>
cudaError_t launch_mma(const void* x, const void* w, void* out, int B,
                       int O, int H, int W, int kh, int kw, int ph, int pw,
                       int x_stride, size_t smem, cudaStream_t stream) {
  auto kern = conv_taps_mma_kernel<KS>;
  static LaunchConfig cfg;
  const int npix = (H + 2 * ph - kh + 1) * (W + 2 * pw - kw + 1);
  // warps: as few rounds over the 64-pixel chunks as kMaxWarps allow,
  // each round as full as a whole number of warps makes it
  const int chunks = (npix + kChunk - 1) / kChunk;
  const int rounds = (chunks + kMaxWarps - 1) / kMaxWarps;
  const int threads = 32 * ((chunks + rounds - 1) / rounds);
  int grid = 0;
  const cudaError_t e =
      persistent_grid(kern, cfg, threads, smem, kMaxBlocksPerSM, B, &grid);
  if (e != cudaSuccess) return e;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(out), B, O, H, W, kh, kw, ph, pw, x_stride);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// The CUDA-core kernel
// ---------------------------------------------------------------------

constexpr int kFfmaStages = 4;       // images in flight a block, at most
constexpr int kStrip = 8;            // pixels a strip (fixed 5x5)
constexpr int kGuardedStrip = 4;     // pixels a strip (guarded)
constexpr int kFfmaThreads = 288;    // threads a block, at most
constexpr int kFfmaBlocksPerSM = 2;  // blocks an SM, at most
constexpr int kSlack = 16;           // floats read past an image buffer

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

// The shared-memory layout, in bytes from the (16-byte aligned) base, for
// a ring of `stages` images and output buffers of `piece_rows`
// channel-rows; the same as conv_taps_smem_bytes in
// nn/layers/convolution.py. stages = 0: the zero-padded f32 image and W
// alone (see the header).
struct FfmaLayout {
  bool direct;      // f32 x, no padding: strips read the landed image
  int wrow;         // a channel's weights, zero-padded to whole float4s
  int land_bytes;   // one ring stage: x's image stride (+ slack if direct)
  int pimg_elems;   // the zero-padded f32 image + slack (unless direct)
  int piece_rows;   // channel-rows [c, i, :] an output buffer holds
  int out_bytes;    // one output buffer
  int w_off, land_off, pimg_off, out_off, bytes;
  __host__ __device__ FfmaLayout(int O, int H, int W, int kh, int kw,
                                 int ph, int pw, int x_stride, int x_bytes,
                                 int stages, int piece_rows_)
      : piece_rows(piece_rows_) {
    const int hp = H + 2 * ph, wp = W + 2 * pw;
    const int wo = wp - kw + 1;
    if (stages == 0) {
      direct = false;
      wrow = kh * kw;
      land_bytes = out_bytes = 0;
      pimg_elems = hp * wp;
      pimg_off = 0;
      w_off = 4 * pimg_elems;
      land_off = out_off = bytes = w_off + 4 * O * wrow;
      return;
    }
    direct = x_bytes == 4 && !(ph || pw);
    wrow = round4(kh * kw);
    land_bytes = x_bytes * x_stride + (direct ? 4 * kSlack : 0);
    pimg_elems = direct ? 0 : round4(hp * wp) + kSlack;
    out_bytes = round16(piece_rows * wo * x_bytes);
    w_off = round16(8 * stages);    // an mbarrier a ring stage
    land_off = w_off + 4 * O * wrow;
    pimg_off = land_off + stages * land_bytes;
    out_off = pimg_off + 4 * pimg_elems;
    bytes = out_off + kOutBuffers * out_bytes;
  }
};

template <typename T> struct Bits;
template <> struct Bits<float> { using type = uint32_t; };
template <> struct Bits<bf16> { using type = unsigned short; };

// n elements from shared src to global dst: 16-byte stores where dst is
// 16-byte aligned, one element at a time at the two ends
template <typename U>
__device__ void store_vectors(U* dst, const U* src, int n, int tid,
                              int nthreads) {
  constexpr int V = 16 / sizeof(U);
  const int lead = (int)(((16 - reinterpret_cast<uintptr_t>(dst) % 16) % 16) /
                         sizeof(U));
  const int head = lead < n ? lead : n;
  const int body = (n - head) / V;
  for (int v = tid; v < body; v += nthreads) {
    union {
      uint4 u;
      U e[V];
    } pack;
#pragma unroll
    for (int k = 0; k < V; ++k) pack.e[k] = src[head + V * v + k];
    *reinterpret_cast<uint4*>(dst + head + V * v) = pack.u;
  }
  for (int i = tid; i < n; i += nthreads)
    if (i < head || i >= head + V * body) dst[i] = src[i];
}

// A strip's S outputs into its staged row at dst: 16-byte stores where
// the strip is whole and its row allows them (vec), else up to n of them
// one at a time. An f32 strip of 8 is two halves, stored in the order
// `swap` gives (see the header).
template <int S>
__device__ __forceinline__ void stage_strip(float* dst, const float* acc,
                                            int n, bool vec, int swap) {
  if constexpr (S == 8) {
    if (vec && n == S) {
      const float4 lo = make_float4(acc[0], acc[1], acc[2], acc[3]);
      const float4 hi = make_float4(acc[4], acc[5], acc[6], acc[7]);
      float4* d = reinterpret_cast<float4*>(dst);
      d[swap] = swap ? hi : lo;
      d[1 - swap] = swap ? lo : hi;
      return;
    }
  }
#pragma unroll
  for (int p = 0; p < S; ++p)
    if (p < n) dst[p] = acc[p];
}

template <int S>
__device__ __forceinline__ void stage_strip(bf16* dst, const float* acc,
                                            int n, bool vec, int) {
  if constexpr (S == 8) {
    if (vec && n == S) {
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(pack_bf16(acc[0], acc[1]), pack_bf16(acc[2], acc[3]),
                     pack_bf16(acc[4], acc[5]), pack_bf16(acc[6], acc[7]));
      return;
    }
  }
#pragma unroll
  for (int p = 0; p < S; ++p)
    if (p < n) dst[p] = __float2bfloat16(acc[p]);
}

// KH = KW = 0: kh and kw at run time (<= kMaxTaps), guarded taps.
template <typename T, int KH, int KW>
__global__ void __launch_bounds__(kFfmaThreads, kFfmaBlocksPerSM)
    conv_taps_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     T* __restrict__ out, int B, int O, int H, int W,
                     int kh_rt, int kw_rt, int ph, int pw, int x_stride,
                     int stages, int piece_rows) {
  constexpr bool kFixed = KH > 0;
  constexpr int S = kFixed ? kStrip : kGuardedStrip;
  constexpr int MH = kFixed ? KH : kMaxTaps;
  constexpr int MW = kFixed ? KW : kMaxTaps;
  constexpr int NC = S + MW - 1;          // a window row's floats
  const int kh = kFixed ? KH : kh_rt;
  const int kw = kFixed ? KW : kw_rt;
  const int hp = H + 2 * ph, wp = W + 2 * pw;
  const int ho = hp - kh + 1, wo = wp - kw + 1;
  const int spr = (wo + S - 1) / S;       // strips a row
  const int strips = ho * spr;
  const int rows = O * ho;                // channel-rows [c, i, :]
  const size_t n_out = (size_t)rows * wo;
  const int taps = kh * kw;
  const FfmaLayout L(O, H, W, kh, kw, ph, pw, x_stride, sizeof(T), stages,
                     piece_rows);
  // no ring and no staging (see the header); the launch takes the guarded
  // path for it
  const bool tight = !kFixed && stages == 0;

  extern __shared__ __align__(16) uint8_t ffma_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ffma_smem);
  float* ws = reinterpret_cast<float*>(ffma_smem + L.w_off);
  uint8_t* land = ffma_smem + L.land_off;
  float* pimg = reinterpret_cast<float*>(ffma_smem + L.pimg_off);
  T* ostage = reinterpret_cast<T*>(ffma_smem + L.out_off);
  const int out_elems = L.out_bytes / (int)sizeof(T);

  const int tid = threadIdx.x, nthreads = blockDim.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(full + s, 1);
    mbar_init_fence();
  }
  for (int i = tid; i < O * L.wrow; i += nthreads) {
    const int o = i / L.wrow, t = i - o * L.wrow;
    ws[i] = t < taps ? w[o * taps + t] : 0.f;
  }
  // zeros that no copy overwrites: the slack after each landed image
  // (direct), or the padded image's halo and slack
  if (L.direct) {
    for (int i = tid; i < stages * kSlack; i += nthreads)
      reinterpret_cast<float*>(land + (i / kSlack) * L.land_bytes)
          [x_stride + i % kSlack] = 0.f;
  } else {
    for (int i = tid; i < L.pimg_elems; i += nthreads) pimg[i] = 0.f;
  }
  __syncthreads();

  const int first = blockIdx.x, step = gridDim.x;
  const uint32_t img_bytes = sizeof(T) * x_stride;
  // image n of this block into ring stage s (n % stages, which the
  // caller keeps, so that no image pays a division by the run-time depth)
  auto issue = [&](int n, int s) {
    const int img = first + n * step;
    if (img >= B) return;
    mbar_expect_tx(full + s, img_bytes);
    bulk_load(land + s * L.land_bytes, x + (size_t)img * x_stride,
              img_bytes, full + s);
  };
  if (tid == 0)
    for (int n = 0; n < stages; ++n) issue(n, n);

  const int swap = (tid >> 2) & 1;
  const bool vec_win = (wp & 3) == 0;   // window rows start on 16 bytes
  const bool vec_out = wo % (16 / (int)sizeof(T)) == 0;
  int piece = 0;                        // pieces this block has staged
  int s = 0;                            // image n's ring stage
  uint32_t phase = 0;                   // and that stage's phase
  for (int n = 0, img = first; img < B; ++n, img += step) {
    const float* src = pimg;
    if (tight) {
      // the block reads the image itself, once every strip of the last
      // one is done with the padded image
      __syncthreads();
      const T* xi = x + (size_t)img * x_stride;
      for (int i = tid; i < H * W; i += nthreads)
        pimg[(i / W + ph) * wp + i % W + pw] = to_f32(xi[i]);
    } else {
      mbar_wait(full + s, phase);
      if (L.direct) {
        src = reinterpret_cast<const float*>(land + s * L.land_bytes);
      } else {
        const T* lp = reinterpret_cast<const T*>(land + s * L.land_bytes);
        for (int i = tid; i < H * W; i += nthreads)
          pimg[(i / W + ph) * wp + i % W + pw] = to_f32(lp[i]);
      }
    }
    for (int q0 = 0; q0 < rows; q0 += L.piece_rows, ++piece) {
      const int q1 = min(rows, q0 + L.piece_rows);
      // tight: the strips store to out itself (one piece, the image)
      T* ob = tight ? out + (size_t)img * n_out
                    : ostage + (piece % kOutBuffers) * out_elems;
      // the store that last read ob (kOutBuffers pieces ago) is done
      if (!tight && tid == 0) bulk_wait_read<kOutBuffers - 1>();
      __syncthreads();                  // (A) image ready, ob free
      if (q0 == 0 && !L.direct && !tight && tid == 0) issue(n + stages, s);
      // items: (channel group, strip); the piece's channels in groups
      const int c_lo = q0 / ho, c_hi = (q1 - 1) / ho + 1;
      const int groups = max(1, min(c_hi - c_lo, nthreads / strips));
      const int per_group = (c_hi - c_lo + groups - 1) / groups;
      for (int item = tid; item < groups * strips; item += nthreads) {
        const int g = item / strips, r = item - g * strips;
        const int i = r / spr, j0 = (r - i * spr) * S;
        // the group's channels whose row i lies in the piece: q = c Ho + i
        // in [q0, q1), a run of channels
        const int c_first = q0 > i ? (q0 - i + ho - 1) / ho : 0;
        const int c_end = q1 > i ? (q1 - i + ho - 1) / ho : 0;
        const int cb = max(c_lo + g * per_group, c_first);
        const int ce = min(min(c_hi, c_lo + (g + 1) * per_group), c_end);
        if (cb >= ce) continue;
        // the strip's input window: rows i .. i + kh - 1, columns
        // j0 .. j0 + NC - 1 (past the row's end: never stored outputs)
        float win[MH][NC];
        const float* wsrc = src + i * wp + j0;
#pragma unroll
        for (int dy = 0; dy < MH; ++dy) {
          if (!kFixed && dy >= kh) {
#pragma unroll
            for (int k = 0; k < NC; ++k) win[dy][k] = 0.f;
            continue;
          }
          if constexpr (NC % 4 == 0) {
            if (vec_win) {
#pragma unroll
              for (int k = 0; k < NC / 4; ++k) {
                const float4 v =
                    reinterpret_cast<const float4*>(wsrc + dy * wp)[k];
                win[dy][4 * k] = v.x;
                win[dy][4 * k + 1] = v.y;
                win[dy][4 * k + 2] = v.z;
                win[dy][4 * k + 3] = v.w;
              }
              continue;
            }
          }
#pragma unroll
          for (int k = 0; k < NC; ++k)   // tight: nothing past the row
            win[dy][k] = !tight || j0 + k < wp ? wsrc[dy * wp + k] : 0.f;
        }
        float acc[S];
        if constexpr (kFixed) {
          // weights as float4s of 4 taps, loaded two float4s ahead of
          // their use, across channels too: a load's latency overlaps the
          // FFMAs of the two before it
          constexpr int T4 = round4(KH * KW) / 4;
          static_assert(T4 >= 2, "the prefetch takes two float4s");
          const float4* w4 = reinterpret_cast<const float4*>(ws);
          const int row4 = L.wrow / 4;
          float4 wq[T4];
          wq[0] = w4[cb * row4];
          wq[1] = w4[cb * row4 + 1];
#pragma unroll 1
          for (int c = cb; c < ce; ++c) {
            const float4* wr = w4 + c * row4;
            const float4* wn = w4 + min(c + 1, ce - 1) * row4;
#pragma unroll
            for (int p = 0; p < S; ++p) acc[p] = 0.f;
            // one fmaf chain an output, taps dy-major, dx-minor
#pragma unroll
            for (int t4 = 0; t4 < T4; ++t4) {
              if (t4 + 2 < T4)
                wq[t4 + 2] = wr[t4 + 2];
              else
                wq[t4 + 2 - T4] = wn[t4 + 2 - T4];
              const float4 v = wq[t4];
              const float wt[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int t = 4 * t4 + e;
                if (t < KH * KW) {
#pragma unroll
                  for (int p = 0; p < S; ++p)
                    acc[p] = fmaf(wt[e], win[t / KW][p + t % KW], acc[p]);
                }
              }
            }
            stage_strip<S>(ob + (size_t)(c * ho + i - q0) * wo + j0, acc,
                           min(S, wo - j0), vec_out, swap);
          }
        } else {
#pragma unroll 1
          for (int c = cb; c < ce; ++c) {
            const float* wrow = ws + c * L.wrow;
#pragma unroll
            for (int p = 0; p < S; ++p) acc[p] = 0.f;
#pragma unroll
            for (int dy = 0; dy < MH; ++dy)
#pragma unroll
              for (int dx = 0; dx < MW; ++dx)
                if (dy < kh && dx < kw) {
                  const float wt = wrow[dy * kw + dx];
#pragma unroll
                  for (int p = 0; p < S; ++p)
                    acc[p] = fmaf(wt, win[dy][p + dx], acc[p]);
                }
            stage_strip<S>(ob + (size_t)(c * ho + i - q0) * wo + j0, acc,
                           min(S, wo - j0), vec_out, swap);
          }
        }
      }
      if (tight) continue;
      fence_proxy_async();              // ob's writes, for the store
      __syncthreads();                  // (B) piece staged
      T* dst = out + (size_t)img * n_out + (size_t)q0 * wo;
      const int n_piece = (q1 - q0) * wo;
      const uint32_t bytes = sizeof(T) * n_piece;
      if (bytes % 16 == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
        if (tid == 0) bulk_store(dst, ob, bytes);
      } else {
        using U = typename Bits<T>::type;
        store_vectors(reinterpret_cast<U*>(dst),
                      reinterpret_cast<const U*>(ob), n_piece, tid,
                      nthreads);
      }
    }
    // the ring stage is free once every strip of the image is computed
    if (L.direct && tid == 0) issue(n + stages, s);
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
  if (tid == 0) bulk_wait_all();
}

template <typename T, int KH, int KW>
cudaError_t launch_ffma(const void* x, const float* w, void* out, int B,
                        int O, int H, int W, int kh, int kw, int ph, int pw,
                        int x_stride, int stages, int piece_rows,
                        size_t smem, cudaStream_t stream) {
  auto kern = conv_taps_kernel<T, KH, KW>;
  static LaunchConfig cfg;
  constexpr int S = KH ? kStrip : kGuardedStrip;
  const int ho = H + 2 * ph - kh + 1, wo = W + 2 * pw - kw + 1;
  const int strips = ho * ((wo + S - 1) / S);
  // channel groups: as many as fill a block of kFfmaThreads with strips
  int groups = kFfmaThreads / strips;
  groups = groups < 1 ? 1 : groups > O ? O : groups;
  const long long items = (long long)strips * groups;
  const int threads =
      items >= kFfmaThreads ? kFfmaThreads : (int)((items + 31) / 32 * 32);
  int grid = 0;
  const cudaError_t e =
      persistent_grid(kern, cfg, threads, smem, kFfmaBlocksPerSM, B, &grid);
  if (e != cudaSuccess) return e;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(out), B, O, H, W, kh, kw,
      ph, pw, x_stride, stages, piece_rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_taps(const void* x, const float* w, void* out, int B,
                        int O, int H, int W, int kh, int kw, int ph, int pw,
                        int x_stride, int stages, int piece_rows,
                        size_t smem, int guarded, cudaStream_t s) {
  if (kh == 5 && kw == 5 && !guarded && stages > 0)
    return launch_ffma<T, 5, 5>(x, w, out, B, O, H, W, kh, kw, ph, pw,
                                x_stride, stages, piece_rows, smem, s);
  return launch_ffma<T, 0, 0>(x, w, out, B, O, H, W, kh, kw, ph, pw,
                              x_stride, stages, piece_rows, smem, s);
}

}  // namespace

extern "C" {

// The CUDA-core route: x [B, 1, H, W] (dtype code 0 = float32, 1 =
// bfloat16), its images x_stride elements apart (x_stride >= H * W, a
// whole number of 16 bytes; x 16-byte aligned), w f32 [O, kh, kw], out
// [B, O, Ho, Wo] in x's dtype (16-byte aligned); a ring of `stages`
// images (0..kFfmaStages; 0: none, and piece_rows = O * Ho) and output
// pieces of `piece_rows` channel-rows (1..O * Ho), as conv_taps_plan
// chooses them; smem as conv_taps_smem_bytes sizes it (at least
// FfmaLayout's bytes); guarded != 0 takes the guarded path even for 5x5.
// Launches on ``stream`` and does not synchronise; returns the launch's
// error.
cudaError_t dl4j_conv_taps(const void* x, const void* w, void* out, int B,
                           int O, int H, int W, int kh, int kw, int ph,
                           int pw, int x_dtype, int x_stride, int stages,
                           int piece_rows, size_t smem, int guarded,
                           void* stream) {
  if (B < 1 || O < 1 || H < 1 || W < 1 || kh < 1 || kw < 1 ||
      kh > kMaxTaps || kw > kMaxTaps || ph < 0 || pw < 0 ||
      H + 2 * ph < kh || W + 2 * pw < kw || (x_dtype != 0 && x_dtype != 1))
    return cudaErrorInvalidValue;
  const int x_bytes = x_dtype == 0 ? 4 : 2;
  const int rows = O * (H + 2 * ph - kh + 1);
  if (x_stride < H * W || (x_stride * x_bytes) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 || stages < 0 ||
      stages > kFfmaStages || piece_rows < 1 || piece_rows > rows ||
      (stages == 0 && piece_rows != rows))
    return cudaErrorInvalidValue;
  if (smem < (size_t)FfmaLayout(O, H, W, kh, kw, ph, pw, x_stride, x_bytes,
                                stages, piece_rows)
                 .bytes)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto wf = static_cast<const float*>(w);
  if (x_dtype == 0)
    return launch_taps<float>(x, wf, out, B, O, H, W, kh, kw, ph, pw,
                              x_stride, stages, piece_rows, smem, guarded, s);
  return launch_taps<bf16>(x, wf, out, B, O, H, W, kh, kw, ph, pw, x_stride,
                           stages, piece_rows, smem, guarded, s);
}

// The tensor-core route: x bf16, its images x_stride elements apart
// (x_stride >= H * W, a multiple of 8; x 16-byte aligned), w bf16
// [O, kh, kw], out bf16 [B, O, Ho, Wo] (16-byte aligned); smem as
// conv_taps_mma_smem_bytes sizes it (at least MmaLayout's bytes). As many
// blocks per SM as fit, up to kMaxBlocksPerSM. Launches on ``stream`` and
// does not synchronise; returns the launch's error.
cudaError_t dl4j_conv_taps_mma(const void* x, const void* w, void* out,
                               int B, int O, int H, int W, int kh, int kw,
                               int ph, int pw, int x_stride, size_t smem,
                               void* stream) {
  if (B < 1 || O < 1 || H < 1 || W < 1 || kh < 1 || kw < 1 ||
      kh > kMaxTaps || kw > kMaxTaps || ph < 0 || pw < 0 ||
      H + 2 * ph < kh || W + 2 * pw < kw || x_stride < H * W ||
      x_stride % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorInvalidValue;
  const int npix = (H + 2 * ph - kh + 1) * (W + 2 * pw - kw + 1);
  if (smem <
      (size_t)MmaLayout(O, H, W, kh, kw, ph, pw, npix, x_stride).bytes)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch ((kh * kw + 15) / 16) {
    case 1:
      return launch_mma<1>(x, w, out, B, O, H, W, kh, kw, ph, pw, x_stride,
                           smem, s);
    case 2:
      return launch_mma<2>(x, w, out, B, O, H, W, kh, kw, ph, pw, x_stride,
                           smem, s);
    case 3:
      return launch_mma<3>(x, w, out, B, O, H, W, kh, kw, ph, pw, x_stride,
                           smem, s);
    default:
      return launch_mma<4>(x, w, out, B, O, H, W, kh, kw, ph, pw, x_stride,
                           smem, s);
  }
}

const char* dl4j_conv_taps_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

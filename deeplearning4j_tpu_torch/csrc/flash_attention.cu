// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel behind
// deeplearning4j_tpu/nn/layers/attention.py:_flash_attention (the stock
// jax.experimental.pallas.ops.tpu.flash_attention: a forward kernel, a
// dK/dV kernel and a dQ kernel) with the same function:
//
//   O = softmax(Q K^T * dh^-1/2) V   over q/k/v [B, H, T, dh],
//
// causal or full, with no key mask, without materializing the [T, T]
// scores. The forward also writes the row log-sum-exp LSE [B, H, T]
// (f32) that the backward uses to recompute P without a second softmax.
//
// Three kernels, each in a bfloat16 variant (wgmma bf16) and a float32
// variant (wgmma tf32 in split TF32, below), all on the tensor cores:
//   * Forward: one block per query tile of one (b, h), walking key tiles
//     with an online softmax (running max m and sum l in f32); under
//     causal, key tiles wholly above the diagonal are never visited. It
//     writes O and LSE.
//   * Backward dK/dV: one block per key tile, walking query tiles (from
//     the diagonal on under causal). It recomputes
//     P^T = exp(K Q^T * scale - LSE) and dP^T = V dO^T, then
//     dS = P (dP - Di) with Di = rowsum(dO o O) (computed by the
//     wrapper, as the stock Pallas backward computes it outside its
//     kernels); dV += P^T dO, dK += dS^T Q * scale.
//   * Backward dQ: one block per query tile, walking key tiles:
//     dQ += dS K * scale. No atomics: each output has one owner and sums
//     in a fixed order, so a rerun (activation checkpointing) gives the
//     same bits.
//   * Masks are selects, never products: a key past T or above the
//     diagonal gets probability exactly 0 whatever the tile holds, and
//     rows and keys past a ragged T read as zeros. Any T >= 1 works (no
//     T % 128 rule).
//
// bfloat16, the training path (B=2, H=8, dh=128, T=2048 and 32768,
// causal). What bounds it on the card: operations. Causal attention at
// T = 32768 does ~T/2 * 4 * dh flops per query for ~4 * dh * 2 bytes of
// q/k/v/o per query, thousands of flops per byte, far above the H100's
// ridge (989 TFLOP/s bf16 dense over 3.35 TB/s). So the design feeds the
// tensor cores at Hopper's rate:
//   1. Every product is a wgmma (m64nNk16, f32 accumulators): S = Q K^T
//      and dP = dO V^T read both operands from shared memory; P V, P^T dO,
//      dS^T Q and dS K take P or dS from registers (the accumulator's
//      layout is the A fragment's, rounded to bf16). No mma.sync, no
//      fragment built from scalar shared loads.
//   2. Loads overlap the math: one producer warp issues TMA loads of
//      whole tiles into a 2-stage ring with full/empty mbarriers, while
//      two consumer warpgroups compute on the stage that has landed.
//   3. No transposed copy: an operand read along the rows (V, dO, Q, K)
//      is read as TMA laid it down, through the wgmma transpose bit.
//   4. Larger tiles: the forward and dQ own 128 queries a block (K/V
//      re-read half as often as with 64), the forward streams 128-key
//      tiles, dK/dV owns 128 keys and streams 64-query tiles.
//   5. Under causal the heaviest tiles launch first (the forward and dQ
//      reverse their query tiles; dK/dV's first key tiles are already
//      the heaviest, and its dK blocks, with three products a tile, go
//      before its dV blocks, with two), with (b, h) on the grid's fast
//      axis.
// Tiles are read through 3-D tensor maps over [B*H, T, dh] (boxes of
// [rows, 64], 128-byte swizzle), so a ragged T reads zeros past its end.
// The backward does 8 products where the flop bound counts 5 (dK/dV
// blocks each recompute S^T, so that no thread holds two 64-register
// accumulators; see the dK/dV kernel).
//
// ptxas (-Xptxas -v, CUDA 12.9, sm_90a; scripts/torch_kernel_sass.py),
// 288 threads a block: registers a thread, forward 168 at dh=128 (128
// at dh=64), dK/dV 166 (168), dQ 166 (134); no spills, no stack frame,
// no serialised wgmma; 1 barrier. Shared memory (dynamic, with 1 KB for
// 1024-byte alignment): forward 164,920 bytes at dh=128 (83,000 at
// dh=64), dK/dV 133,160 (67,624), dQ 132,136 (66,600): one block an SM.

#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>
#include <utility>

namespace {

constexpr float kNeg = -1e30f;

// ------------------------------------------------- bf16 kernels for Hopper
// The same three kernels for bfloat16 inputs, built from Hopper's parts:
// TMA tile loads into a shared-memory ring guarded by mbarriers, and
// wgmma products with f32 accumulators in registers. A block has two
// consumer warpgroups (64 rows each) and one producer warp that issues
// the TMA loads (kTmaThreads = 288 threads).
//
// Tiles. A tile of `rows` rows of one head is DH / 64 TMA boxes of
// [rows, 64] bf16 (128-byte rows, 128-byte swizzle), one after another,
// each 1024-byte aligned. A wgmma operand that runs along dh (K-major)
// is addressed through a descriptor with SBO = 1024 (the next 8 rows),
// advanced by 32 bytes per 16-wide k step and by one box past column
// 63. An operand that runs along the rows (MN-major: V in P V, dO and Q
// in dV and dK, K in dQ) is read as it lies, with the instruction's
// transpose bit: LBO = one box (the next 64 columns), SBO = 1024 (the
// next 8 rows), advanced by 16 rows (2048 bytes) per k step. No copy is
// transposed.
//
// Registers. A m64nN accumulator holds, in thread (warp w, lane = 4 g +
// t) of a warpgroup, d[j] at row 16 w + g + 8 ((j >> 1) & 1), column
// 8 (j >> 2) + 2 t + (j & 1). Eight consecutive d of a score tile are
// one k16 A fragment, so P and dS go from one product into the next in
// registers, rounded to bf16 as FA2 does.

typedef __nv_bfloat16 bf16;

constexpr int kWg = 128;                       // threads per warpgroup
constexpr int kConsumers = 2;                  // consumer warpgroups
constexpr int kTmaThreads = kConsumers * kWg + 32;  // + the producer warp
constexpr int kStages = 2;                     // depth of each TMA ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// ---- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also announces `bytes` of TMA traffic
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// wait for the completion of the phase of parity `parity`; a wait that
// outlasts any tile's load or product by far (2^28 polls, seconds) is a
// lost arrival: it traps (an error at the next synchronisation) rather
// than hang the card
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

// ---- TMA: box (c0 = column, c1 = row, c2 = head) of a [BH, T, DH] map
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}
// rows [r0, r0 + ROWS) of head bh: DH / 64 boxes; rows past T read as 0
template <int DH, int ROWS>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map,
                                         uint64_t* bar, int r0, int bh) {
#pragma unroll
  for (int h = 0; h < DH / 64; ++h)
    tma_load(dst + h * ROWS * 64, map, bar, h * 64, r0, bh);
}

// ---- wgmma
// shared-memory operand descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of these registers
// across a wgmma fence or wait
template <int N>
__device__ __forceinline__ void reg_fence(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (*a)[4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

#define DL4J_F8(d, i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define DL4J_F32(d) \
  DL4J_F8(d, 0), DL4J_F8(d, 8), DL4J_F8(d, 16), DL4J_F8(d, 24)
#define DL4J_D32                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "           \
  "%8, %9, %10, %11, %12, %13, %14, %15, "      \
  "%16, %17, %18, %19, %20, %21, %22, %23, "    \
  "%24, %25, %26, %27, %28, %29, %30, %31}"
#define DL4J_D64                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "           \
  "%8, %9, %10, %11, %12, %13, %14, %15, "      \
  "%16, %17, %18, %19, %20, %21, %22, %23, "    \
  "%24, %25, %26, %27, %28, %29, %30, %31, "    \
  "%32, %33, %34, %35, %36, %37, %38, %39, "    \
  "%40, %41, %42, %43, %44, %45, %46, %47, "    \
  "%48, %49, %50, %51, %52, %53, %54, %55, "    \
  "%56, %57, %58, %59, %60, %61, %62, %63}"

// d (+)= A B over k16: A and B from shared memory (both K-major), N
// columns, at OA / OB 16-byte units past the descriptors da / db (added
// inside the instruction's asm, so the compiler cannot hoist one
// descriptor per k step out of the tile loop and spill them); `acc` 0
// overwrites d
template <int N, int OA, int OB>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int acc) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N is 64 or 128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 sa, sb;\n"
        "add.s64 sa, %32, %35;\nadd.s64 sb, %33, %36;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DL4J_D32
        ", sa, sb, p, 1, 1, 0, 0;\n}\n"
        : DL4J_F32(d)
        : "l"(da), "l"(db), "r"(acc), "n"(OA), "n"(OB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 sa, sb;\n"
        "add.s64 sa, %64, %67;\nadd.s64 sb, %65, %68;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " DL4J_D64
        ", sa, sb, p, 1, 1, 0, 0;\n}\n"
        : DL4J_F32(d), DL4J_F32((d + 32))
        : "l"(da), "l"(db), "r"(acc), "n"(OA), "n"(OB));
  }
}
// d += A B over k16: A (a k16 fragment) from registers, B from shared
// memory MN-major (the transpose bit) at OB 16-byte units past db, N
// columns
template <int N, int OB>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N is 64 or 128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 sb;\n"
        "add.s64 sb, %36, %38;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DL4J_D32
        ", {%32, %33, %34, %35}, sb, p, 1, 1, 1;\n}\n"
        : DL4J_F32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
          "n"(OB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 sb;\n"
        "add.s64 sb, %68, %70;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " DL4J_D64
        ", {%64, %65, %66, %67}, sb, p, 1, 1, 1;\n}\n"
        : DL4J_F32(d), DL4J_F32((d + 32))
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
          "n"(OB));
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// an accumulator's columns as bf16 A fragments, one per 16 columns
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (*a)[4], const float* d) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = pack_bf16(d[8 * kk + 2 * e], d[8 * kk + 2 * e + 1]);
}
__device__ __forceinline__ float group4_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float group4_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = A Bᵀ for one warpgroup's 64 rows: A rows and B rows are tiles of
// ROWS_A / ROWS_B rows (the operand's whole tile, so its boxes' stride),
// both run along dh. k step KK reads 32 bytes further along each row,
// and box KK / 4 (ROWS * 128 bytes further) past column 63.
template <int N, int ROWS_A, int ROWS_B, int... KK>
__device__ __forceinline__ void gemm_rows_k(float* d, uint64_t da,
                                            uint64_t db,
                                            std::integer_sequence<int, KK...>) {
  (wgmma_ss<N, (KK / 4) * ROWS_A * 8 + (KK % 4) * 2,
            (KK / 4) * ROWS_B * 8 + (KK % 4) * 2>(d, da, db, KK > 0),
   ...);
}
template <int DH, int N, int ROWS_A, int ROWS_B>
__device__ __forceinline__ void gemm_rows(float* d, const bf16* a,
                                          const bf16* b) {
  gemm_rows_k<N, ROWS_A, ROWS_B>(d, gmma_desc(a, 16, 1024),
                                 gmma_desc(b, 16, 1024),
                                 std::make_integer_sequence<int, DH / 16>{});
}
// d += A B where A is K16 fragments in registers over the K rows of the
// tile b ([K, DH] as it lies in shared memory, ROWS rows): k step KK
// reads 16 rows (2048 bytes) further
template <int DH, int... KK>
__device__ __forceinline__ void gemm_reg_k(float* d, const uint32_t (*a)[4],
                                           uint64_t db,
                                           std::integer_sequence<int, KK...>) {
  (wgmma_rs<DH, KK * 128>(d, a[KK], db), ...);
}
template <int DH, int K, int ROWS>
__device__ __forceinline__ void gemm_reg(float* d, const uint32_t (*a)[4],
                                         const bf16* b) {
  gemm_reg_k<DH>(d, a, gmma_desc(b, ROWS * 128, 1024),
                 std::make_integer_sequence<int, K / 16>{});
}

// Forward. A block owns 128 queries of one (b, h); warpgroup w owns 64
// of them. Q lands once; K and V tiles of 128 keys stream through a
// kStages ring (separate full barriers, so S = Q Kᵀ starts before V has
// landed; one empty barrier per stage, released by the 8 consumer warps
// after P V). Under causal the heaviest query tiles launch first.
constexpr int kFwdRows = 128, kFwdKeys = 128;

template <int DH>
struct FwdSmem {
  static constexpr uint32_t q_bytes = kFwdRows * DH * 2;
  static constexpr uint32_t kv_bytes = kFwdKeys * DH * 2;
  static constexpr uint32_t k = q_bytes;
  static constexpr uint32_t v = k + kStages * kv_bytes;
  static constexpr uint32_t bars = v + kStages * kv_bytes;
  static constexpr uint32_t bytes = bars + 8 * (1 + 3 * kStages) + 1024;
};

template <int DH>
__global__ void __launch_bounds__(kTmaThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       bf16* __restrict__ o, float* __restrict__ lse,
                       int t_len, int causal, float scale_log2) {
  using L = FwdSmem<DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(base);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + L::bars);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;
  auto ks = [&](int s) {
    return reinterpret_cast<bf16*>(base + L::k + s * L::kv_bytes);
  };
  auto vs = [&](int s) {
    return reinterpret_cast<bf16*>(base + L::v + s * L::kv_bytes);
  };

  const int bh = blockIdx.x;
  const int n_qt = (t_len + kFwdRows - 1) / kFwdRows;
  const int q0 = (causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y) *
                 kFwdRows;
  const int k_end = causal ? min(t_len, q0 + kFwdRows) : t_len;
  const int n_tiles = (k_end + kFwdKeys - 1) / kFwdKeys;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, kConsumers * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == kConsumers) {   // the producer warp: one thread issues TMA
    if (threadIdx.x != kConsumers * kWg) return;
    mbar_expect_tx(q_full, L::q_bytes);
    tma_tile<DH, kFwdRows>(qs, &tq, q_full, q0, bh);
    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % kStages;
      if (n >= kStages) mbar_wait(empty + s, ((n / kStages) & 1) ^ 1);
      mbar_expect_tx(k_full + s, L::kv_bytes);
      tma_tile<DH, kFwdKeys>(ks(s), &tk, k_full + s, n * kFwdKeys, bh);
      mbar_expect_tx(v_full + s, L::kv_bytes);
      tma_tile<DH, kFwdKeys>(vs(s), &tv, v_full + s, n * kFwdKeys, bh);
    }
    return;
  }

  const int warp = (threadIdx.x % kWg) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int first = q0 + wg * 64;            // the warpgroup's first row
  const int row0 = first + warp * 16 + g;    // this thread's rows: +0, +8
  const bf16* qw = qs + wg * 64 * 64;

  float acc[DH / 2];
#pragma unroll
  for (int j = 0; j < DH / 2; ++j) acc[j] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};   // l: this thread's part

  mbar_wait(q_full, 0);
  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % kStages;
    const uint32_t par = (n / kStages) & 1;
    const int k0 = n * kFwdKeys;
    float sc[kFwdKeys / 2];
    mbar_wait(k_full + s, par);
    wg_fence();
    gemm_rows<DH, kFwdKeys, kFwdRows, kFwdKeys>(sc, qw, ks(s));
    wg_commit();
    wg_wait();
    reg_fence<kFwdKeys / 2>(sc);

    // masks are selects; a tile needs them where it runs past T or
    // holds a key after the warpgroup's first row
    const bool masked =
        k0 + kFwdKeys > t_len || (causal && k0 + kFwdKeys - 1 > first);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kFwdKeys / 2; ++j) {
      float x = sc[j] * scale_log2;
      if (masked) {
        const int key = k0 + 8 * (j >> 2) + 2 * t + (j & 1);
        const int row = row0 + 8 * ((j >> 1) & 1);
        x = (key < t_len && (!causal || key <= row)) ? x : kNeg;
      }
      sc[j] = x;
      mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], x);
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = group4_max(mx[h]);   // every row sees a key in every tile
      alpha[h] = fast_exp2(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < kFwdKeys / 2; ++j) {
      const int h = (j >> 1) & 1;
      sc[j] = fast_exp2(sc[j] - m[h]);   // a masked key gives exactly 0
      l[h] += sc[j];
    }
#pragma unroll
    for (int j = 0; j < DH / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];
    uint32_t pa[kFwdKeys / 16][4];
    acc_to_a<kFwdKeys>(pa, sc);

    mbar_wait(v_full + s, par);
    reg_fence<DH / 2>(acc);
    reg_fence<kFwdKeys / 16>(pa);
    wg_fence();
    gemm_reg<DH, kFwdKeys, kFwdKeys>(acc, pa, vs(s));
    wg_commit();
    wg_wait();
    reg_fence<DH / 2>(acc);
    if (lane == 0) mbar_arrive(empty + s);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const float lsum = group4_sum(l[h]);   // l >= 1: the row's max key
    if (row >= t_len) continue;
    const float inv = 1.f / lsum;
    bf16* orow = o + ((size_t)bh * t_len + row) * DH;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c + 2 * t) =
          __floats2bfloat162_rn(acc[4 * c + 2 * h] * inv,
                                acc[4 * c + 2 * h + 1] * inv);
    if (t == 0) lse[(size_t)bh * t_len + row] = (m[h] + log2f(lsum)) * kLn2;
  }
}

// Backward dK/dV. A block owns 128 keys of one (b, h) and one of their
// two outputs (blockIdx.z: 0 dK, 1 dV); warpgroup w owns 64 of the keys
// and keeps their output in registers. K and V land once; tiles of 64
// queries (Q, dO, and their LSE and Di, which the producer warp's 32
// lanes copy in beside the TMA loads) stream through the ring, from the
// block's first key on under causal. Per tile:
//   Sᵀ = K Qᵀ (Q K-major), Pᵀ = exp(Sᵀ scale - LSE);
//   dV block: dV += Pᵀ dO (Pᵀ bf16 in registers, dO MN-major);
//   dK block: dPᵀ = V dOᵀ, dSᵀ = Pᵀ (dPᵀ - Di), dK += dSᵀ Q (Q MN-major).
// One block with both outputs held 128 accumulator registers a thread
// beside Sᵀ and dPᵀ, and ptxas serialised its wgmmas for want of
// registers (C7512); split, each block holds 64, at the price of Sᵀ
// computed twice (5 products a tile instead of 4).
constexpr int kBwdKeys = 128, kBwdQs = 64;

template <int DH>
struct DkdvSmem {
  static constexpr uint32_t kv_bytes = kBwdKeys * DH * 2;
  static constexpr uint32_t q_bytes = kBwdQs * DH * 2;
  static constexpr uint32_t v = kv_bytes;
  static constexpr uint32_t q = 2 * kv_bytes;               // + s * q_bytes
  static constexpr uint32_t dout = q + kStages * q_bytes;   // + s * q_bytes
  static constexpr uint32_t rows = dout + kStages * q_bytes;  // lse2, di
  static constexpr uint32_t bars = rows + kStages * 2 * kBwdQs * 4;
  static constexpr uint32_t bytes = bars + 8 * (1 + 2 * kStages) + 1024;
};

template <int DH>
__global__ void __launch_bounds__(kTmaThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse,
                            const float* __restrict__ di,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            int t_len, int causal, float scale,
                            float scale_log2) {
  using L = DkdvSmem<DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  bf16* ks = reinterpret_cast<bf16*>(base);
  bf16* vs = reinterpret_cast<bf16*>(base + L::v);
  float* rows = reinterpret_cast<float*>(base + L::rows);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(base + L::bars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  auto qs = [&](int s) {
    return reinterpret_cast<bf16*>(base + L::q + s * L::q_bytes);
  };
  auto dos = [&](int s) {
    return reinterpret_cast<bf16*>(base + L::dout + s * L::q_bytes);
  };

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBwdKeys;   // ascending: heaviest first
  const int q_begin = causal ? k0 : 0;
  const int n_steps = (t_len - q_begin + kBwdQs - 1) / kBwdQs;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, kConsumers * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  const int lane = threadIdx.x % 32;
  if (wg == kConsumers) {   // the producer warp
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * L::kv_bytes);
      tma_tile<DH, kBwdKeys>(ks, &tk, kv_full, k0, bh);
      tma_tile<DH, kBwdKeys>(vs, &tv, kv_full, k0, bh);
    }
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % kStages;
      const int q0 = q_begin + i * kBwdQs;
      if (i >= kStages) mbar_wait(empty + s, ((i / kStages) & 1) ^ 1);
      float* lse_s = rows + s * 2 * kBwdQs;
#pragma unroll
      for (int e = lane; e < kBwdQs; e += 32) {
        const int qi = q0 + e;
        const bool in = qi < t_len;
        lse_s[e] = in ? lse[(size_t)bh * t_len + qi] * kLog2e : 0.f;
        lse_s[kBwdQs + e] = in ? di[(size_t)bh * t_len + qi] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(full + s, 2 * L::q_bytes);
        tma_tile<DH, kBwdQs>(qs(s), &tq, full + s, q0, bh);
        tma_tile<DH, kBwdQs>(dos(s), &tdo, full + s, q0, bh);
      } else {
        mbar_arrive(full + s);
      }
    }
    return;
  }

  const int warp = (threadIdx.x % kWg) / 32;
  const int g = lane / 4, t = lane % 4;
  const int first = k0 + wg * 64;              // the warpgroup's first key
  const int key0 = first + warp * 16 + g;      // this thread's keys: +0, +8
  const bf16* kw = ks + wg * 64 * 64;
  const bf16* vw = vs + wg * 64 * 64;

  const bool dk_part = blockIdx.z == 0;   // the heavier blocks first
  float acc[DH / 2];
#pragma unroll
  for (int j = 0; j < DH / 2; ++j) acc[j] = 0.f;

  mbar_wait(kv_full, 0);
  for (int i = 0; i < n_steps; ++i) {
    const int s = i % kStages;
    const int q0 = q_begin + i * kBwdQs;
    mbar_wait(full + s, (i / kStages) & 1);
    // under causal a tile wholly before the warpgroup's first key
    // leaves its dK and dV alone
    if (causal && q0 + kBwdQs - 1 < first) {
      if (lane == 0) mbar_arrive(empty + s);
      continue;
    }
    const float* lse_s = rows + s * 2 * kBwdQs;
    const bool masked =
        q0 + kBwdQs > t_len || (causal && q0 < first + 63);
    float st[kBwdQs / 2], dpt[kBwdQs / 2];
    wg_fence();
    gemm_rows<DH, kBwdQs, kBwdKeys, kBwdQs>(st, kw, qs(s));
    if (dk_part) gemm_rows<DH, kBwdQs, kBwdKeys, kBwdQs>(dpt, vw, dos(s));
    wg_commit();
    wg_wait();
    reg_fence<kBwdQs / 2>(st);
    if (dk_part) reg_fence<kBwdQs / 2>(dpt);
#pragma unroll
    for (int j = 0; j < kBwdQs / 2; ++j) {
      const int col = 8 * (j >> 2) + 2 * t + (j & 1);
      float p = fast_exp2(st[j] * scale_log2 - lse_s[col]);
      if (masked) {
        const int key = key0 + 8 * ((j >> 1) & 1);
        const int qi = q0 + col;
        p = (qi < t_len && (!causal || key <= qi)) ? p : 0.f;
      }
      st[j] = dk_part ? p * (dpt[j] - lse_s[kBwdQs + col]) : p;
    }
    uint32_t a[kBwdQs / 16][4];   // Pᵀ or dSᵀ
    acc_to_a<kBwdQs>(a, st);
    reg_fence<DH / 2>(acc);
    reg_fence<kBwdQs / 16>(a);
    wg_fence();
    gemm_reg<DH, kBwdQs, kBwdQs>(acc, a, dk_part ? qs(s) : dos(s));
    wg_commit();
    wg_wait();
    reg_fence<DH / 2>(acc);
    if (lane == 0) mbar_arrive(empty + s);
  }

  bf16* out = dk_part ? dk : dv;
  const float mult = dk_part ? scale : 1.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    if (key >= t_len) continue;
    bf16* row = out + ((size_t)bh * t_len + key) * DH;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * c + 2 * t) =
          __floats2bfloat162_rn(acc[4 * c + 2 * h] * mult,
                                acc[4 * c + 2 * h + 1] * mult);
  }
}

// Backward dQ. A block owns 128 queries of one (b, h) (warpgroup w: 64);
// Q and dO land once, K and V tiles of 64 keys stream through the ring.
// Per tile: S = Q Kᵀ, dP = dO Vᵀ (K and V K-major), dS = P (dP - Di) in
// bf16 registers, dQ += dS K (K MN-major, the same tile). Under causal
// the heaviest query tiles launch first.
constexpr int kDqRows = 128, kDqKeys = 64;

template <int DH>
struct DqSmem {
  static constexpr uint32_t q_bytes = kDqRows * DH * 2;
  static constexpr uint32_t kv_bytes = kDqKeys * DH * 2;
  static constexpr uint32_t dout = q_bytes;
  static constexpr uint32_t k = 2 * q_bytes;                // + s * kv_bytes
  static constexpr uint32_t v = k + kStages * kv_bytes;     // + s * kv_bytes
  static constexpr uint32_t bars = v + kStages * kv_bytes;
  static constexpr uint32_t bytes = bars + 8 * (1 + 2 * kStages) + 1024;
};

template <int DH>
__global__ void __launch_bounds__(kTmaThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ di,
                          bf16* __restrict__ dq, int t_len, int causal,
                          float scale, float scale_log2) {
  using L = DqSmem<DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(base);
  bf16* dos = reinterpret_cast<bf16*>(base + L::dout);
  uint64_t* qo_full = reinterpret_cast<uint64_t*>(base + L::bars);
  uint64_t* full = qo_full + 1;
  uint64_t* empty = full + kStages;
  auto ks = [&](int s) {
    return reinterpret_cast<bf16*>(base + L::k + s * L::kv_bytes);
  };
  auto vs = [&](int s) {
    return reinterpret_cast<bf16*>(base + L::v + s * L::kv_bytes);
  };

  const int bh = blockIdx.x;
  const int n_qt = (t_len + kDqRows - 1) / kDqRows;
  const int q0 = (causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y) *
                 kDqRows;
  const int k_end = causal ? min(t_len, q0 + kDqRows) : t_len;
  const int n_tiles = (k_end + kDqKeys - 1) / kDqKeys;

  if (threadIdx.x == 0) {
    mbar_init(qo_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == kConsumers) {   // the producer warp: one thread issues TMA
    if (threadIdx.x != kConsumers * kWg) return;
    mbar_expect_tx(qo_full, 2 * L::q_bytes);
    tma_tile<DH, kDqRows>(qs, &tq, qo_full, q0, bh);
    tma_tile<DH, kDqRows>(dos, &tdo, qo_full, q0, bh);
    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % kStages;
      if (n >= kStages) mbar_wait(empty + s, ((n / kStages) & 1) ^ 1);
      mbar_expect_tx(full + s, 2 * L::kv_bytes);
      tma_tile<DH, kDqKeys>(ks(s), &tk, full + s, n * kDqKeys, bh);
      tma_tile<DH, kDqKeys>(vs(s), &tv, full + s, n * kDqKeys, bh);
    }
    return;
  }

  const int warp = (threadIdx.x % kWg) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int first = q0 + wg * 64;
  const int row0 = first + warp * 16 + g;
  const bf16* qw = qs + wg * 64 * 64;
  const bf16* dow = dos + wg * 64 * 64;
  float lse2[2], dir[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const bool in = row < t_len;
    lse2[h] = in ? lse[(size_t)bh * t_len + row] * kLog2e : 0.f;
    dir[h] = in ? di[(size_t)bh * t_len + row] : 0.f;
  }
  float acc[DH / 2];
#pragma unroll
  for (int j = 0; j < DH / 2; ++j) acc[j] = 0.f;

  mbar_wait(qo_full, 0);
  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % kStages;
    const int k0 = n * kDqKeys;
    mbar_wait(full + s, (n / kStages) & 1);
    // under causal a key tile wholly after the warpgroup's last row
    if (causal && k0 > first + 63) {
      if (lane == 0) mbar_arrive(empty + s);
      continue;
    }
    float sc[kDqKeys / 2], dp[kDqKeys / 2];
    wg_fence();
    gemm_rows<DH, kDqKeys, kDqRows, kDqKeys>(sc, qw, ks(s));
    gemm_rows<DH, kDqKeys, kDqRows, kDqKeys>(dp, dow, vs(s));
    wg_commit();
    wg_wait();
    reg_fence<kDqKeys / 2>(sc);
    reg_fence<kDqKeys / 2>(dp);

    const bool masked =
        k0 + kDqKeys > t_len || (causal && k0 + kDqKeys - 1 > first);
#pragma unroll
    for (int j = 0; j < kDqKeys / 2; ++j) {
      const int h = (j >> 1) & 1;
      float p = fast_exp2(sc[j] * scale_log2 - lse2[h]);
      if (masked) {
        const int key = k0 + 8 * (j >> 2) + 2 * t + (j & 1);
        p = (key < t_len && (!causal || key <= row0 + 8 * h)) ? p : 0.f;
      }
      sc[j] = p * (dp[j] - dir[h]);
    }
    uint32_t da[kDqKeys / 16][4];
    acc_to_a<kDqKeys>(da, sc);
    reg_fence<DH / 2>(acc);
    reg_fence<kDqKeys / 16>(da);
    wg_fence();
    gemm_reg<DH, kDqKeys, kDqKeys>(acc, da, ks(s));
    wg_commit();
    wg_wait();
    reg_fence<DH / 2>(acc);
    if (lane == 0) mbar_arrive(empty + s);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= t_len) continue;
    bf16* out = dq + ((size_t)bh * t_len + row) * DH;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * c + 2 * t) =
          __floats2bfloat162_rn(acc[4 * c + 2 * h] * scale,
                                acc[4 * c + 2 * h + 1] * scale);
  }
}

// ---------------------------------------------- float32 kernels for Hopper
// The same three kernels for float32 inputs, on the tensor cores in split
// TF32 ("3xTF32"). Each operand x is held as big = tf32(x) and small =
// tf32(x - big), tf32 being round to nearest (ties away) to 10 mantissa
// bits (cvt.rna.tf32.f32); each product A B is As Bb + Ab Bs + Ab Bb into
// f32 accumulators, the two small products over every k8 step first and
// the big one last (see 5). The error is near 2^-22
// of |A||B|, like an f32 sum's; one tf32 product (2^-11) would miss the
// f32 limits. A CPU model (tests/test_torch_port_flash_attention.py)
// decided it: round-to-nearest big, three products, no small Ab Bs term
// beyond them, passes every f32 measure with a wide margin; a single
// TF32 product fails the norm measure.
//
// What bounds it on the card: operations, three tensor-core products for
// each f32 one (495 TFLOP/s tf32 / 3 = 165 effective, against 67 on the
// CUDA cores). The design:
//   1. Every product is a wgmma m64nNk8 .tf32: S = Q Kᵀ and its kin read
//      both operands from shared memory; P V, Pᵀ dO, dSᵀ Q and dS K take
//      P or dS from registers, split there.
//   2. wgmma .tf32 reads shared-memory operands K-major only (the
//      transpose bit is for 16-bit types), so the operands that run along
//      the rows (V, dO and Q in dV and dK, K in dQ) are read from a
//      transposed copy. The split of every shared-memory operand and those
//      copies are made once per call by flash_split_kernel, one pass
//      over O(T dh) bytes for all of a call's operands (the wrapper
//      allocates them): big and small planes
//      [2, B*H, T, dh] and transposed planes [2, B*H, dh, Tp], Tp = T
//      rounded up to 8.
//   3. The f32 accumulator is not the tf32 A fragment's layout: thread
//      (g, t) holds columns 2t and 2t + 1 of each 8, the fragment wants
//      k = t and t + 4. So k = t is read from column 2t and k = t + 4 from
//      column 2t + 1, and the transposed planes hold the keys (or queries)
//      of each 8 in the order 0 2 4 6 1 3 5 7: the sum is the same, and no
//      shuffle is needed.
//   4. Loads overlap the math: a producer warp issues TMA loads (boxes of
//      [rows, 32 floats], 128-byte swizzle: a k8 step is 32 bytes, as a
//      bf16 k16 step) into buffers with full/empty mbarriers, one pair per
//      operand, so one operand's next tile loads while another's product
//      runs; a consumer warpgroup computes.
//   5. The tensor cores' f32 accumulation rounds toward zero, so a sum
//      carried through hundreds of wgmmas drifts toward zero (dK and dV
//      missed the f32 norm limit from T = 1000 on, more with T).
//      So each step's product goes into a fresh accumulator (the first
//      wgmma of its chain overwrites) and is added to the running O, dK,
//      dV or dQ in registers, rounded to nearest. Within a chain the
//      small products come first, while the accumulator is still small,
//      so only the big product's k8 steps (4 to 16) truncate at the
//      full scale.
//   6. Under causal the heaviest tiles launch first, as in bf16.
// Shared memory at dh = 128 (227 KB a block): a [64, 128] f32 tile is 32
// KB a plane, 64 KB split. Forward: Q (64 rows) + K (64 keys) + Vᵀ (64
// keys), 192 KB; the backward holds its 64 rows' two operands (K and V,
// or Q and dO) split, 128 KB, and steps of 32 over three more (Q, dO, Qᵀ
// or K, V, Kᵀ), 96 KB: 224 KB. So one warpgroup a block and one block an
// SM at dh = 128 (two at dh = 64); a 2-stage ring of these tiles does not
// fit. dK and dV are separate blocks, as in bf16.
//
// ptxas (-Xptxas -v, sm_90a; scripts/torch_kernel_sass.py), 160 threads
// a block: registers a thread, forward 210 at dh=128 (161 at dh=64),
// dK/dV 191 (127), dQ 181 (117); no spills, no stack frame, no
// serialised wgmma. Shared memory (dynamic, with 1 KB for 1024-byte
// alignment): forward 197,672 bytes at dh=128 (99,368 at dh=64), dK/dV
// 230,952 (116,264), dQ 230,440 (115,752). flash_split_kernel: 30
// registers, 4,224 bytes.

constexpr int kF32Threads = kWg + 32;  // a consumer warpgroup + producer warp
constexpr int kF32Rows = 64;           // queries or keys a block owns
constexpr int kF32FwdKeys = 64;        // keys per forward step
constexpr int kF32Step = 32;           // queries (dK/dV) or keys (dQ) a step

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

#define DL4J_D16                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "      \
  "%8, %9, %10, %11, %12, %13, %14, %15}"

// d (+)= A B over one k8 step of tf32: A and B from shared memory (both
// K-major) at OA / OB 16-byte units past da / db, N columns; `acc` 0
// overwrites d
template <int N, int OA, int OB>
__device__ __forceinline__ void wgmma_tf32_ss(float* d, uint64_t da,
                                              uint64_t db, int acc) {
  static_assert(N == 32 || N == 64, "wgmma_tf32_ss: N is 32 or 64");
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 sa, sb;\n"
        "add.s64 sa, %16, %19;\nadd.s64 sb, %17, %20;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " DL4J_D16
        ", sa, sb, p, 1, 1;\n}\n"
        : DL4J_F8(d, 0), DL4J_F8(d, 8)
        : "l"(da), "l"(db), "r"(acc), "n"(OA), "n"(OB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 sa, sb;\n"
        "add.s64 sa, %32, %35;\nadd.s64 sb, %33, %36;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " DL4J_D32
        ", sa, sb, p, 1, 1;\n}\n"
        : DL4J_F32(d)
        : "l"(da), "l"(db), "r"(acc), "n"(OA), "n"(OB));
  }
}
// d (+)= A B over one k8 step of tf32: A (a k8 fragment) from registers,
// B from shared memory (K-major) at OB 16-byte units past db, N columns;
// `acc` 0 overwrites d
template <int N, int OB>
__device__ __forceinline__ void wgmma_tf32_rs(float* d, const uint32_t* a,
                                              uint64_t db, int acc) {
  static_assert(N == 64 || N == 128, "wgmma_tf32_rs: N is 64 or 128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 sb;\n"
        "add.s64 sb, %36, %38;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " DL4J_D32
        ", {%32, %33, %34, %35}, sb, p, 1, 1;\n}\n"
        : DL4J_F32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),
          "n"(OB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 sb;\n"
        "add.s64 sb, %68, %70;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " DL4J_D64
        ", {%64, %65, %66, %67}, sb, p, 1, 1;\n}\n"
        : DL4J_F32(d), DL4J_F32((d + 32))
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),
          "n"(OB));
  }
}

// 16-byte units past a tile's descriptor of k8 step kk, in a tile of
// `rows` rows stored as boxes of [rows, 32 floats]: 32 bytes a step, a
// box (rows * 128 bytes) every 4 steps
__host__ __device__ constexpr int k8_offset(int kk, int rows) {
  return (kk / 4) * rows * 8 + (kk % 4) * 2;
}

// S = A Bᵀ in split TF32 for one warpgroup's 64 rows of A: A is a tile of
// ROWS_A rows and B one of N rows, both along dh, each in big and small
// planes
template <int N, int ROWS_A, int... KK>
__device__ __forceinline__ void gemm3_rows_k(float* d, uint64_t ab,
                                             uint64_t as, uint64_t bb,
                                             uint64_t bs,
                                             std::integer_sequence<int, KK...>) {
  (wgmma_tf32_ss<N, k8_offset(KK, ROWS_A), k8_offset(KK, N)>(d, as, bb,
                                                             KK > 0),
   ...);
  (wgmma_tf32_ss<N, k8_offset(KK, ROWS_A), k8_offset(KK, N)>(d, ab, bs, 1),
   ...);
  (wgmma_tf32_ss<N, k8_offset(KK, ROWS_A), k8_offset(KK, N)>(d, ab, bb, 1),
   ...);
}
template <int DH, int N, int ROWS_A>
__device__ __forceinline__ void gemm3_rows(float* d, const float* ab,
                                           const float* as, const float* bb,
                                           const float* bs) {
  gemm3_rows_k<N, ROWS_A>(d, gmma_desc(ab, 16, 1024), gmma_desc(as, 16, 1024),
                          gmma_desc(bb, 16, 1024), gmma_desc(bs, 16, 1024),
                          std::make_integer_sequence<int, DH / 8>{});
}
// d = A B in split TF32: A is K / 8 split k8 fragments in registers, B a
// transposed tile [N = DH rows, K] in big and small planes (boxes of
// [DH, 32] along K)
template <int N, int... KK>
__device__ __forceinline__ void gemm3_reg_k(float* d, const uint32_t (*ab)[4],
                                            const uint32_t (*as)[4],
                                            uint64_t bb, uint64_t bs,
                                            std::integer_sequence<int, KK...>) {
  (wgmma_tf32_rs<N, k8_offset(KK, N)>(d, as[KK], bb, KK > 0), ...);
  (wgmma_tf32_rs<N, k8_offset(KK, N)>(d, ab[KK], bs, 1), ...);
  (wgmma_tf32_rs<N, k8_offset(KK, N)>(d, ab[KK], bb, 1), ...);
}
template <int DH, int K>
__device__ __forceinline__ void gemm3_reg(float* d, const uint32_t (*ab)[4],
                                          const uint32_t (*as)[4],
                                          const float* bb, const float* bs) {
  gemm3_reg_k<DH>(d, ab, as, gmma_desc(bb, 16, 1024), gmma_desc(bs, 16, 1024),
                  std::make_integer_sequence<int, K / 8>{});
}

// An accumulator's first K columns as split tf32 A fragments, one per 8
// columns: k = t from column 2t, k = t + 4 from column 2t + 1 (so the B
// tile's k rows hold columns 0 2 4 6 1 3 5 7 of each 8)
template <int K>
__device__ __forceinline__ void acc_to_a_tf32(uint32_t (*ab)[4],
                                              uint32_t (*as)[4],
                                              const float* d) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    const float x[4] = {d[4 * kk], d[4 * kk + 2], d[4 * kk + 1],
                        d[4 * kk + 3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ab[kk][e] = tf32_rna(x[e]);
      as[kk][e] = tf32_rna(x[e] - __uint_as_float(ab[kk][e]));
    }
  }
}

// rows [r0, r0 + ROWS) of head bh, both planes of a [2 BH, T, DH] map:
// DH / 32 boxes [ROWS, 32] a plane; rows past T read as 0
template <int DH, int ROWS>
__device__ __forceinline__ void tma_rows(float* big, float* small,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int r0, int bh,
                                         int n_bh) {
#pragma unroll
  for (int h = 0; h < DH / 32; ++h) {
    tma_load(big + h * ROWS * 32, map, bar, h * 32, r0, bh);
    tma_load(small + h * ROWS * 32, map, bar, h * 32, r0, n_bh + bh);
  }
}
// columns [c0, c0 + COLS) of head bh, both planes of a transposed
// [2 BH, DH, Tp] map: COLS / 32 boxes [DH, 32] a plane; past Tp, 0
template <int DH, int COLS>
__device__ __forceinline__ void tma_cols(float* big, float* small,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int c0, int bh,
                                         int n_bh) {
#pragma unroll
  for (int h = 0; h < COLS / 32; ++h) {
    tma_load(big + h * DH * 32, map, bar, c0 + h * 32, 0, bh);
    tma_load(small + h * DH * 32, map, bar, c0 + h * 32, 0, n_bh + bh);
  }
}

// Forward. A block owns 64 queries of one (b, h). Q lands once; K tiles
// and Vᵀ tiles of 64 keys land in one buffer each, the next K while this
// tile's P V runs, the next V while the next S runs. Online softmax as in
// bf16.
template <int DH>
struct F32FwdSmem {
  static constexpr uint32_t plane = kF32Rows * DH * 4;  // also 64 keys
  static constexpr uint32_t q = 0, k = 2 * plane, v = 4 * plane;
  static constexpr uint32_t bars = 6 * plane;
  static constexpr uint32_t bytes = bars + 8 * 5 + 1024;
};

template <int DH>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tvt,
                      float* __restrict__ o, float* __restrict__ lse,
                      int t_len, int n_bh, int causal, float scale_log2) {
  using L = F32FwdSmem<DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  float* qb = reinterpret_cast<float*>(base + L::q);
  float* qs = qb + L::plane / 4;
  float* kb = reinterpret_cast<float*>(base + L::k);
  float* ks = kb + L::plane / 4;
  float* vb = reinterpret_cast<float*>(base + L::v);
  float* vs = vb + L::plane / 4;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + L::bars);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = q_full + 2;
  uint64_t* v_full = q_full + 3;
  uint64_t* v_empty = q_full + 4;

  const int bh = blockIdx.x;
  const int n_qt = (t_len + kF32Rows - 1) / kF32Rows;
  const int q0 = (causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y) *
                 kF32Rows;
  const int k_end = causal ? min(t_len, q0 + kF32Rows) : t_len;
  const int n_tiles = (k_end + kF32FwdKeys - 1) / kF32FwdKeys;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    mbar_init(k_empty, 4);
    mbar_init(v_empty, 4);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kWg) {   // the producer warp: one thread issues TMA
    if (threadIdx.x != kWg) return;
    mbar_expect_tx(q_full, 2 * L::plane);
    tma_rows<DH, kF32Rows>(qb, qs, &tq, q_full, q0, bh, n_bh);
    for (int n = 0; n < n_tiles; ++n) {
      if (n > 0) mbar_wait(k_empty, (n - 1) & 1);
      mbar_expect_tx(k_full, 2 * L::plane);
      tma_rows<DH, kF32FwdKeys>(kb, ks, &tk, k_full, n * kF32FwdKeys, bh,
                                n_bh);
      if (n > 0) mbar_wait(v_empty, (n - 1) & 1);
      mbar_expect_tx(v_full, 2 * L::plane);
      tma_cols<DH, kF32FwdKeys>(vb, vs, &tvt, v_full, n * kF32FwdKeys, bh,
                                n_bh);
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + warp * 16 + g;       // this thread's rows: +0, +8

  float acc[DH / 2];
#pragma unroll
  for (int j = 0; j < DH / 2; ++j) acc[j] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};   // l: this thread's part

  mbar_wait(q_full, 0);
  for (int n = 0; n < n_tiles; ++n) {
    const uint32_t par = n & 1;
    const int k0 = n * kF32FwdKeys;
    float sc[kF32FwdKeys / 2];
    mbar_wait(k_full, par);
    wg_fence();
    gemm3_rows<DH, kF32FwdKeys, kF32Rows>(sc, qb, qs, kb, ks);
    wg_commit();
    wg_wait();
    reg_fence<kF32FwdKeys / 2>(sc);
    if (lane == 0) mbar_arrive(k_empty);

    // masks are selects; a tile needs them where it runs past T or
    // holds a key after the block's first row
    const bool masked =
        k0 + kF32FwdKeys > t_len || (causal && k0 + kF32FwdKeys - 1 > q0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kF32FwdKeys / 2; ++j) {
      float x = sc[j] * scale_log2;
      if (masked) {
        const int key = k0 + 8 * (j >> 2) + 2 * t + (j & 1);
        const int row = row0 + 8 * ((j >> 1) & 1);
        x = (key < t_len && (!causal || key <= row)) ? x : kNeg;
      }
      sc[j] = x;
      mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], x);
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = group4_max(mx[h]);   // every row sees a key in every tile
      alpha[h] = fast_exp2(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < kF32FwdKeys / 2; ++j) {
      const int h = (j >> 1) & 1;
      sc[j] = fast_exp2(sc[j] - m[h]);   // a masked key gives exactly 0
      l[h] += sc[j];
    }
    uint32_t pb[kF32FwdKeys / 8][4], ps[kF32FwdKeys / 8][4];
    acc_to_a_tf32<kF32FwdKeys>(pb, ps, sc);

    float pv[DH / 2];   // this tile's P V, folded in below
    mbar_wait(v_full, par);
    reg_fence<kF32FwdKeys / 8>(pb);
    reg_fence<kF32FwdKeys / 8>(ps);
    wg_fence();
    gemm3_reg<DH, kF32FwdKeys>(pv, pb, ps, vb, vs);
    wg_commit();
    wg_wait();
    reg_fence<DH / 2>(pv);
    if (lane == 0) mbar_arrive(v_empty);
#pragma unroll
    for (int j = 0; j < DH / 2; ++j)
      acc[j] = fmaf(acc[j], alpha[(j >> 1) & 1], pv[j]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const float lsum = group4_sum(l[h]);   // l >= 1: the row's max key
    if (row >= t_len) continue;
    const float inv = 1.f / lsum;
    float* orow = o + ((size_t)bh * t_len + row) * DH;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c)
      *reinterpret_cast<float2*>(orow + 8 * c + 2 * t) = make_float2(
          acc[4 * c + 2 * h] * inv, acc[4 * c + 2 * h + 1] * inv);
    if (t == 0)
      lse[(size_t)bh * t_len + row] = fmaf(m[h], kLn2, logf(lsum));
  }
}

// Backward dK/dV. A block owns 64 keys of one (b, h) and one of their two
// outputs (blockIdx.z: 0 dK, 1 dV). K (and, for dK, V) land once; steps of
// 32 queries, from the block's first key on under causal, bring Q (with
// its LSE and Di, which the producer warp's lanes copy in beside the TMA
// loads; two buffers, by step parity), dO (dK) and the transposed Qᵀ (dK)
// or dOᵀ (dV). Per step:
//   Sᵀ = K Qᵀ, Pᵀ = exp(Sᵀ scale - LSE);
//   dV block: dV += Pᵀ dO (dOᵀ tile);
//   dK block: dPᵀ = V dOᵀ, dSᵀ = Pᵀ (dPᵀ - Di), dK += dSᵀ Q (Qᵀ tile).
template <int DH>
struct F32DkdvSmem {
  static constexpr uint32_t kv_plane = kF32Rows * DH * 4;
  static constexpr uint32_t step_plane = kF32Step * DH * 4;
  static constexpr uint32_t k = 0, v = 2 * kv_plane, q = 4 * kv_plane;
  static constexpr uint32_t dout = q + 2 * step_plane;
  static constexpr uint32_t tr = dout + 2 * step_plane;   // Qᵀ or dOᵀ
  static constexpr uint32_t rows = tr + 2 * step_plane;   // 2 x (lse2, di)
  static constexpr uint32_t bars = rows + 2 * 2 * kF32Step * 4;
  static constexpr uint32_t bytes = bars + 8 * 5 + 1024;
};

template <int DH>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_bwd_dkdv_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tqt,
                           const __grid_constant__ CUtensorMap tdot,
                           const float* __restrict__ lse,
                           const float* __restrict__ di,
                           float* __restrict__ dk, float* __restrict__ dv,
                           int t_len, int n_bh, int causal, float scale,
                           float scale_log2) {
  using L = F32DkdvSmem<DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  auto pl = [&](uint32_t off) { return reinterpret_cast<float*>(base + off); };
  float *kb = pl(L::k), *ks = pl(L::k + L::kv_plane);
  float *vb = pl(L::v), *vs = pl(L::v + L::kv_plane);
  float *qb = pl(L::q), *qs = pl(L::q + L::step_plane);
  float *ob = pl(L::dout), *os = pl(L::dout + L::step_plane);
  float *tb = pl(L::tr), *ts = pl(L::tr + L::step_plane);
  float* rows = pl(L::rows);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(base + L::bars);
  uint64_t* full = kv_full + 1;    // Q, dO, the rows
  uint64_t* empty = kv_full + 2;
  uint64_t* t_full = kv_full + 3;  // Qᵀ or dOᵀ
  uint64_t* t_empty = kv_full + 4;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kF32Rows;   // ascending: heaviest first
  const bool dk_part = blockIdx.z == 0;   // the heavier blocks first
  const int q_begin = causal ? k0 : 0;
  const int n_steps = (t_len - q_begin + kF32Step - 1) / kF32Step;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(full, 32);
    mbar_init(empty, 4);
    mbar_init(t_full, 1);
    mbar_init(t_empty, 4);
    mbar_init_fence();
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= kWg) {   // the producer warp
    if (lane == 0) {
      mbar_expect_tx(kv_full, (dk_part ? 4 : 2) * L::kv_plane);
      tma_rows<DH, kF32Rows>(kb, ks, &tk, kv_full, k0, bh, n_bh);
      if (dk_part) tma_rows<DH, kF32Rows>(vb, vs, &tv, kv_full, k0, bh, n_bh);
    }
    for (int i = 0; i < n_steps; ++i) {
      const int q0 = q_begin + i * kF32Step;
      if (i > 0) mbar_wait(empty, (i - 1) & 1);
      float* rs = rows + (i & 1) * 2 * kF32Step;
      const int qi = q0 + lane;
      const bool in = qi < t_len;
      rs[lane] = in ? lse[(size_t)bh * t_len + qi] * kLog2e : 0.f;
      rs[kF32Step + lane] = in ? di[(size_t)bh * t_len + qi] : 0.f;
      if (lane == 0) {
        mbar_expect_tx(full, (dk_part ? 4 : 2) * L::step_plane);
        tma_rows<DH, kF32Step>(qb, qs, &tq, full, q0, bh, n_bh);
        if (dk_part) tma_rows<DH, kF32Step>(ob, os, &tdo, full, q0, bh, n_bh);
        if (i > 0) mbar_wait(t_empty, (i - 1) & 1);
        mbar_expect_tx(t_full, 2 * L::step_plane);
        tma_cols<DH, kF32Step>(tb, ts, dk_part ? &tqt : &tdot, t_full, q0, bh,
                               n_bh);
      } else {
        mbar_arrive(full);
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int key0 = k0 + warp * 16 + g;   // this thread's keys: +0, +8
  float acc[DH / 2];
#pragma unroll
  for (int j = 0; j < DH / 2; ++j) acc[j] = 0.f;

  mbar_wait(kv_full, 0);
  for (int i = 0; i < n_steps; ++i) {
    const int q0 = q_begin + i * kF32Step;
    const uint32_t par = i & 1;
    const float* rs = rows + (i & 1) * 2 * kF32Step;
    float st[kF32Step / 2], dpt[kF32Step / 2];
    mbar_wait(full, par);
    wg_fence();
    gemm3_rows<DH, kF32Step, kF32Rows>(st, kb, ks, qb, qs);
    if (dk_part) gemm3_rows<DH, kF32Step, kF32Rows>(dpt, vb, vs, ob, os);
    wg_commit();
    wg_wait();
    reg_fence<kF32Step / 2>(st);
    if (dk_part) reg_fence<kF32Step / 2>(dpt);
    // the rows buffer stays: the producer refills the other one next
    if (lane == 0) mbar_arrive(empty);

    const bool masked =
        q0 + kF32Step > t_len || (causal && q0 < k0 + kF32Rows - 1);
#pragma unroll
    for (int j = 0; j < kF32Step / 2; ++j) {
      const int col = 8 * (j >> 2) + 2 * t + (j & 1);
      float p = fast_exp2(fmaf(st[j], scale_log2, -rs[col]));
      if (masked) {
        const int key = key0 + 8 * ((j >> 1) & 1);
        const int qi = q0 + col;
        p = (qi < t_len && (!causal || key <= qi)) ? p : 0.f;
      }
      st[j] = dk_part ? p * (dpt[j] - rs[kF32Step + col]) : p;
    }
    uint32_t ab[kF32Step / 8][4], as[kF32Step / 8][4];   // Pᵀ or dSᵀ
    acc_to_a_tf32<kF32Step>(ab, as, st);
    float part[DH / 2];   // this step's product, folded in below
    mbar_wait(t_full, par);
    reg_fence<kF32Step / 8>(ab);
    reg_fence<kF32Step / 8>(as);
    wg_fence();
    gemm3_reg<DH, kF32Step>(part, ab, as, tb, ts);
    wg_commit();
    wg_wait();
    reg_fence<DH / 2>(part);
    if (lane == 0) mbar_arrive(t_empty);
#pragma unroll
    for (int j = 0; j < DH / 2; ++j) acc[j] += part[j];
  }

  float* out = dk_part ? dk : dv;
  const float mult = dk_part ? scale : 1.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    if (key >= t_len) continue;
    float* row = out + ((size_t)bh * t_len + key) * DH;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c)
      *reinterpret_cast<float2*>(row + 8 * c + 2 * t) = make_float2(
          acc[4 * c + 2 * h] * mult, acc[4 * c + 2 * h + 1] * mult);
  }
}

// Backward dQ. A block owns 64 queries of one (b, h); Q and dO land once,
// steps of 32 keys bring K and V (one buffer, one barrier pair) and Kᵀ
// (another). Per step: S = Q Kᵀ, dP = dO Vᵀ, dS = P (dP - Di) split in
// registers, dQ += dS K (Kᵀ tile). Under causal the heaviest query tiles
// launch first.
template <int DH>
struct F32DqSmem {
  static constexpr uint32_t q_plane = kF32Rows * DH * 4;
  static constexpr uint32_t step_plane = kF32Step * DH * 4;
  static constexpr uint32_t q = 0, dout = 2 * q_plane, k = 4 * q_plane;
  static constexpr uint32_t v = k + 2 * step_plane;
  static constexpr uint32_t tr = v + 2 * step_plane;   // Kᵀ
  static constexpr uint32_t bars = tr + 2 * step_plane;
  static constexpr uint32_t bytes = bars + 8 * 5 + 1024;
};

template <int DH>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_bwd_dq_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tkt,
                         const float* __restrict__ lse,
                         const float* __restrict__ di,
                         float* __restrict__ dq, int t_len, int n_bh,
                         int causal, float scale, float scale_log2) {
  using L = F32DqSmem<DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  auto pl = [&](uint32_t off) { return reinterpret_cast<float*>(base + off); };
  float *qb = pl(L::q), *qs = pl(L::q + L::q_plane);
  float *ob = pl(L::dout), *os = pl(L::dout + L::q_plane);
  float *kb = pl(L::k), *ks = pl(L::k + L::step_plane);
  float *vb = pl(L::v), *vs = pl(L::v + L::step_plane);
  float *tb = pl(L::tr), *ts = pl(L::tr + L::step_plane);
  uint64_t* qo_full = reinterpret_cast<uint64_t*>(base + L::bars);
  uint64_t* full = qo_full + 1;     // K and V
  uint64_t* empty = qo_full + 2;
  uint64_t* t_full = qo_full + 3;   // Kᵀ
  uint64_t* t_empty = qo_full + 4;

  const int bh = blockIdx.x;
  const int n_qt = (t_len + kF32Rows - 1) / kF32Rows;
  const int q0 = (causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y) *
                 kF32Rows;
  const int k_end = causal ? min(t_len, q0 + kF32Rows) : t_len;
  const int n_tiles = (k_end + kF32Step - 1) / kF32Step;

  if (threadIdx.x == 0) {
    mbar_init(qo_full, 1);
    mbar_init(full, 1);
    mbar_init(empty, 4);
    mbar_init(t_full, 1);
    mbar_init(t_empty, 4);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kWg) {   // the producer warp: one thread issues TMA
    if (threadIdx.x != kWg) return;
    mbar_expect_tx(qo_full, 4 * L::q_plane);
    tma_rows<DH, kF32Rows>(qb, qs, &tq, qo_full, q0, bh, n_bh);
    tma_rows<DH, kF32Rows>(ob, os, &tdo, qo_full, q0, bh, n_bh);
    for (int n = 0; n < n_tiles; ++n) {
      const int k0 = n * kF32Step;
      if (n > 0) mbar_wait(empty, (n - 1) & 1);
      mbar_expect_tx(full, 4 * L::step_plane);
      tma_rows<DH, kF32Step>(kb, ks, &tk, full, k0, bh, n_bh);
      tma_rows<DH, kF32Step>(vb, vs, &tv, full, k0, bh, n_bh);
      if (n > 0) mbar_wait(t_empty, (n - 1) & 1);
      mbar_expect_tx(t_full, 2 * L::step_plane);
      tma_cols<DH, kF32Step>(tb, ts, &tkt, t_full, k0, bh, n_bh);
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + warp * 16 + g;
  float lse2[2], dir[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const bool in = row < t_len;
    lse2[h] = in ? lse[(size_t)bh * t_len + row] * kLog2e : 0.f;
    dir[h] = in ? di[(size_t)bh * t_len + row] : 0.f;
  }
  float acc[DH / 2];
#pragma unroll
  for (int j = 0; j < DH / 2; ++j) acc[j] = 0.f;

  mbar_wait(qo_full, 0);
  for (int n = 0; n < n_tiles; ++n) {
    const int k0 = n * kF32Step;
    const uint32_t par = n & 1;
    float sc[kF32Step / 2], dp[kF32Step / 2];
    mbar_wait(full, par);
    wg_fence();
    gemm3_rows<DH, kF32Step, kF32Rows>(sc, qb, qs, kb, ks);
    gemm3_rows<DH, kF32Step, kF32Rows>(dp, ob, os, vb, vs);
    wg_commit();
    wg_wait();
    reg_fence<kF32Step / 2>(sc);
    reg_fence<kF32Step / 2>(dp);
    if (lane == 0) mbar_arrive(empty);

    const bool masked =
        k0 + kF32Step > t_len || (causal && k0 + kF32Step - 1 > q0);
#pragma unroll
    for (int j = 0; j < kF32Step / 2; ++j) {
      const int h = (j >> 1) & 1;
      float p = fast_exp2(fmaf(sc[j], scale_log2, -lse2[h]));
      if (masked) {
        const int key = k0 + 8 * (j >> 2) + 2 * t + (j & 1);
        p = (key < t_len && (!causal || key <= row0 + 8 * h)) ? p : 0.f;
      }
      sc[j] = p * (dp[j] - dir[h]);
    }
    uint32_t ab[kF32Step / 8][4], as[kF32Step / 8][4];
    acc_to_a_tf32<kF32Step>(ab, as, sc);
    float part[DH / 2];   // this step's product, folded in below
    mbar_wait(t_full, par);
    reg_fence<kF32Step / 8>(ab);
    reg_fence<kF32Step / 8>(as);
    wg_fence();
    gemm3_reg<DH, kF32Step>(part, ab, as, tb, ts);
    wg_commit();
    wg_wait();
    reg_fence<DH / 2>(part);
    if (lane == 0) mbar_arrive(t_empty);
#pragma unroll
    for (int j = 0; j < DH / 2; ++j) acc[j] += part[j];
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= t_len) continue;
    float* out = dq + ((size_t)bh * t_len + row) * DH;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c)
      *reinterpret_cast<float2*>(out + 8 * c + 2 * t) = make_float2(
          acc[4 * c + 2 * h] * scale, acc[4 * c + 2 * h + 1] * scale);
  }
}

// The f32 kernels' operands from up to kSplitMax tensors x [BH, T, dh]
// of one shape, in one launch: rows[i] (when not null) gets x[i]'s big
// and small planes [2][BH][T][dh], cols[i] (when not null) those of its
// transpose, [2][BH][dh][Tp], Tp = T rounded up to 8, position p of each
// 8 holding row kKeyOrder[p] of those 8, zeros past T. A block takes 32
// rows by 32 columns of one head of one tensor (blockIdx.x: the tensor
// and the columns) through a shared tile.
constexpr int kSplitMax = 4;
__constant__ int kKeyOrder[8] = {0, 2, 4, 6, 1, 3, 5, 7};

struct SplitArgs {
  const float* x[kSplitMax];
  float* rows[kSplitMax];
  float* cols[kSplitMax];
};

// p[i] by selects over constant indices: a run-time index into a kernel
// parameter's array would copy the array to local memory in every thread
template <typename T>
__device__ __forceinline__ T pick(const T (&p)[kSplitMax], int i) {
  T r = p[0];
#pragma unroll
  for (int j = 1; j < kSplitMax; ++j) r = i == j ? p[j] : r;
  return r;
}

__global__ void __launch_bounds__(256)
flash_split_kernel(const SplitArgs a, int t_len, int tp, int dh,
                   size_t rows_plane, size_t cols_plane) {
  __shared__ float tile[32][33];
  const int op = blockIdx.x / (dh / 32);
  const int c0 = (blockIdx.x % (dh / 32)) * 32, r0 = blockIdx.y * 32;
  const size_t bh = blockIdx.z;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const float* x = pick(a.x, op);
  float* rows = pick(a.rows, op);
  float* cols = pick(a.cols, op);
  // every load before any store: the pointers come from a struct, so the
  // compiler cannot tell that the stores leave x alone
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 8 * i;
    v[i] = r < t_len ? __ldg(x + (bh * t_len + r) * dh + c0 + tx) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 8 * i;
    tile[ty + 8 * i][tx] = v[i];
    if (rows != nullptr && r < t_len) {
      const size_t at = (bh * t_len + r) * dh + c0 + tx;
      const uint32_t b = tf32_rna(v[i]);
      rows[at] = __uint_as_float(b);
      rows[rows_plane + at] =
          __uint_as_float(tf32_rna(v[i] - __uint_as_float(b)));
    }
  }
  if (cols == nullptr) return;
  __syncthreads();
  const int pos = r0 + tx;
  if (pos >= tp) return;
  const int src = (tx & ~7) + kKeyOrder[tx & 7];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = ty + 8 * i;
    const float w = tile[src][c];
    const uint32_t b = tf32_rna(w);
    const size_t at = (bh * dh + c0 + c) * tp + pos;
    cols[at] = __uint_as_float(b);
    cols[cols_plane + at] = __uint_as_float(tf32_rna(w - __uint_as_float(b)));
  }
}

// ------------------------------------------------------------------ launch
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// cuTensorMapEncodeTiled, a libcuda entry point, reached through the
// runtime so that the library needs no -lcuda; the entry point (not a
// tensor map) is resolved once.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

cudaError_t encode_tiled(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiledFn>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A tensor map over a contiguous bf16 [B*H, T, dh] tensor, built for each
// call (never cached: the caching allocator reuses addresses): boxes of
// [rows, 64], 128-byte swizzle; rows past T read as zeros, never as the
// next head's.
cudaError_t head_map(CUtensorMap* map, const void* ptr, int bh, int t,
                     int dh, int rows) {
  EncodeTiledFn enc;
  cudaError_t e = encode_tiled(&enc);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)dh * 2,
                                 (cuuint64_t)t * dh * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
      dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DH>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v,
                          void* o, void* lse, int bh, int t, int causal,
                          float scale, cudaStream_t s) {
  auto kern = flash_fwd_wgmma_kernel<DH>;
  const size_t smem = FwdSmem<DH>::bytes;
  CUtensorMap mq, mk, mv;
  cudaError_t e = allow_smem(kern, smem);
  if (e == cudaSuccess) e = head_map(&mq, q, bh, t, DH, kFwdRows);
  if (e == cudaSuccess) e = head_map(&mk, k, bh, t, DH, kFwdKeys);
  if (e == cudaSuccess) e = head_map(&mv, v, bh, t, DH, kFwdKeys);
  if (e != cudaSuccess) return e;
  dim3 grid(bh, (t + kFwdRows - 1) / kFwdRows);
  kern<<<grid, kTmaThreads, smem, s>>>(mq, mk, mv, static_cast<bf16*>(o),
                                       static_cast<float*>(lse), t, causal,
                                       scale * kLog2e);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bwd_tc(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse, const void* di,
                          void* dq, void* dk, void* dv, int bh, int t,
                          int causal, float scale, cudaStream_t s) {
  auto kdkdv = flash_bwd_dkdv_wgmma_kernel<DH>;
  auto kdq = flash_bwd_dq_wgmma_kernel<DH>;
  const size_t smem1 = DkdvSmem<DH>::bytes, smem2 = DqSmem<DH>::bytes;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t e = allow_smem(kdkdv, smem1);
  if (e == cudaSuccess) e = allow_smem(kdq, smem2);
  if (e == cudaSuccess) e = head_map(&mq, q, bh, t, DH, kBwdQs);
  if (e == cudaSuccess) e = head_map(&mdo, dout, bh, t, DH, kBwdQs);
  if (e == cudaSuccess) e = head_map(&mk, k, bh, t, DH, kBwdKeys);
  if (e == cudaSuccess) e = head_map(&mv, v, bh, t, DH, kBwdKeys);
  if (e != cudaSuccess) return e;
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(di);
  dim3 g1(bh, (t + kBwdKeys - 1) / kBwdKeys, 2);
  kdkdv<<<g1, kTmaThreads, smem1, s>>>(
      mq, mk, mv, mdo, lp, dp, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), t, causal, scale, scale * kLog2e);
  e = cudaGetLastError();
  if (e == cudaSuccess) e = head_map(&mq, q, bh, t, DH, kDqRows);
  if (e == cudaSuccess) e = head_map(&mdo, dout, bh, t, DH, kDqRows);
  if (e == cudaSuccess) e = head_map(&mk, k, bh, t, DH, kDqKeys);
  if (e == cudaSuccess) e = head_map(&mv, v, bh, t, DH, kDqKeys);
  if (e != cudaSuccess) return e;
  dim3 g2(bh, (t + kDqRows - 1) / kDqRows);
  kdq<<<g2, kTmaThreads, smem2, s>>>(mq, mk, mv, mdo, lp, dp,
                                     static_cast<bf16*>(dq), t, causal,
                                     scale, scale * kLog2e);
  return cudaGetLastError();
}

// A tensor map over f32 planes [planes * BH, rows, cols] (cols
// contiguous), built for each call: boxes of [box_rows, 32], 128-byte
// swizzle; past rows or cols, zeros.
cudaError_t plane_map(CUtensorMap* map, const void* ptr, int planes_bh,
                      int rows, int cols, int box_rows) {
  EncodeTiledFn enc;
  cudaError_t e = encode_tiled(&enc);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)planes_bh};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 4,
                                 (cuuint64_t)rows * cols * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// T rounded up to 8: the row length of the transposed planes
int padded_t(int t) { return (t + 7) / 8 * 8; }

// maps over an operand's big and small planes: rows [2 BH, T, DH] with
// boxes of `box_rows` rows, or transposed [2 BH, DH, Tp]
template <int DH>
cudaError_t rows_map(CUtensorMap* map, const void* p, int bh, int t,
                     int box_rows) {
  return plane_map(map, p, 2 * bh, t, DH, box_rows);
}
template <int DH>
cudaError_t cols_map(CUtensorMap* map, const void* p, int bh, int t) {
  return plane_map(map, p, 2 * bh, DH, padded_t(t), DH);
}

template <int DH>
cudaError_t launch_fwd_f32(const void* q, const void* k, const void* v,
                           void* o, void* lse, int bh, int t, int causal,
                           float scale, cudaStream_t s) {
  auto kern = flash_fwd_tf32_kernel<DH>;
  const size_t smem = F32FwdSmem<DH>::bytes;
  CUtensorMap mq, mk, mv;
  cudaError_t e = allow_smem(kern, smem);
  if (e == cudaSuccess) e = rows_map<DH>(&mq, q, bh, t, kF32Rows);
  if (e == cudaSuccess) e = rows_map<DH>(&mk, k, bh, t, kF32FwdKeys);
  if (e == cudaSuccess) e = cols_map<DH>(&mv, v, bh, t);
  if (e != cudaSuccess) return e;
  dim3 grid(bh, (t + kF32Rows - 1) / kF32Rows);
  kern<<<grid, kF32Threads, smem, s>>>(mq, mk, mv, static_cast<float*>(o),
                                       static_cast<float*>(lse), t, bh,
                                       causal, scale * kLog2e);
  return cudaGetLastError();
}

// q, k and dout hold their rows planes and then their transposed planes,
// v its rows planes
template <int DH>
cudaError_t launch_bwd_f32(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, const void* di,
                           void* dq, void* dk, void* dv, int bh, int t,
                           int causal, float scale, cudaStream_t s) {
  auto kdkdv = flash_bwd_dkdv_tf32_kernel<DH>;
  auto kdq = flash_bwd_dq_tf32_kernel<DH>;
  const size_t smem1 = F32DkdvSmem<DH>::bytes, smem2 = F32DqSmem<DH>::bytes;
  const size_t rows_floats = 2 * (size_t)bh * t * DH;
  const float* qt = static_cast<const float*>(q) + rows_floats;
  const float* kt = static_cast<const float*>(k) + rows_floats;
  const float* dot = static_cast<const float*>(dout) + rows_floats;
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(di);
  CUtensorMap mq, mk, mv, mdo, mqt, mdot;
  cudaError_t e = allow_smem(kdkdv, smem1);
  if (e == cudaSuccess) e = allow_smem(kdq, smem2);
  if (e == cudaSuccess) e = rows_map<DH>(&mq, q, bh, t, kF32Step);
  if (e == cudaSuccess) e = rows_map<DH>(&mk, k, bh, t, kF32Rows);
  if (e == cudaSuccess) e = rows_map<DH>(&mv, v, bh, t, kF32Rows);
  if (e == cudaSuccess) e = rows_map<DH>(&mdo, dout, bh, t, kF32Step);
  if (e == cudaSuccess) e = cols_map<DH>(&mqt, qt, bh, t);
  if (e == cudaSuccess) e = cols_map<DH>(&mdot, dot, bh, t);
  if (e != cudaSuccess) return e;
  dim3 g1(bh, (t + kF32Rows - 1) / kF32Rows, 2);
  kdkdv<<<g1, kF32Threads, smem1, s>>>(
      mq, mk, mv, mdo, mqt, mdot, lp, dp, static_cast<float*>(dk),
      static_cast<float*>(dv), t, bh, causal, scale, scale * kLog2e);
  e = cudaGetLastError();
  if (e == cudaSuccess) e = rows_map<DH>(&mq, q, bh, t, kF32Rows);
  if (e == cudaSuccess) e = rows_map<DH>(&mk, k, bh, t, kF32Step);
  if (e == cudaSuccess) e = rows_map<DH>(&mv, v, bh, t, kF32Step);
  if (e == cudaSuccess) e = rows_map<DH>(&mdo, dout, bh, t, kF32Rows);
  if (e == cudaSuccess) e = cols_map<DH>(&mqt, kt, bh, t);   // Kᵀ
  if (e != cudaSuccess) return e;
  dim3 g2(bh, (t + kF32Rows - 1) / kF32Rows);
  kdq<<<g2, kF32Threads, smem2, s>>>(mq, mk, mv, mdo, mqt, lp, dp,
                                     static_cast<float*>(dq), t, bh, causal,
                                     scale, scale * kLog2e);
  return cudaGetLastError();
}

bool shape_ok(int B, int H, int T, int dh) {
  return B >= 1 && H >= 1 && T >= 1 && (dh == 64 || dh == 128) &&
         (long long)B * H <= 65535;
}

}  // namespace

extern "C" {

// The float32 kernels' operands from the n (1 to 4) tensors x[i], each
// contiguous f32 [B, H, T, dh], in one launch: into rows[i] (may be null)
// x[i]'s big and small planes [2][B*H][T][dh], big = tf32(x) rounded to
// nearest, small = tf32(x - big); into cols[i] (may be null) the same of
// its transpose, [2][B*H][dh][Tp], Tp = T rounded up to 8, each 8 rows of
// x in the order 0 2 4 6 1 3 5 7, zeros past T. x, rows and cols are
// host arrays of n device pointers. Launches on ``stream``; returns the
// launch's error.
cudaError_t dl4j_flash_attention_split(const void* const* x,
                                       void* const* rows, void* const* cols,
                                       int n, int B, int H, int T, int dh,
                                       void* stream) {
  if (!shape_ok(B, H, T, dh) || n < 1 || n > kSplitMax)
    return cudaErrorInvalidValue;
  SplitArgs a = {};
  for (int i = 0; i < n; ++i) {
    if (x[i] == nullptr || (rows[i] == nullptr && cols[i] == nullptr))
      return cudaErrorInvalidValue;
    a.x[i] = static_cast<const float*>(x[i]);
    a.rows[i] = static_cast<float*>(rows[i]);
    a.cols[i] = static_cast<float*>(cols[i]);
  }
  const int bh = B * H, tp = padded_t(T);
  dim3 grid(n * (dh / 32), (tp + 31) / 32, bh);
  flash_split_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      a, T, tp, dh, (size_t)bh * T * dh, (size_t)bh * dh * tp);
  return cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16; q/k/v/o share it. o is
// contiguous [B, H, T, dh]; so are q, k, v at bfloat16, while at float32
// they are the operands dl4j_flash_attention_split made of them: q and k
// its rows planes, v its transposed planes. lse is f32 [B, H, T].
// Launches on ``stream`` and does not synchronise; returns the launch's
// error.
cudaError_t dl4j_flash_attention_fwd(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int B, int H, int T, int dh,
                                     int causal, float scale, int dtype,
                                     void* stream) {
  if (!shape_ok(B, H, T, dh)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int bh = B * H;
  if (dtype == 0 && dh == 64)
    return launch_fwd_f32<64>(q, k, v, o, lse, bh, T, causal, scale, s);
  if (dtype == 0 && dh == 128)
    return launch_fwd_f32<128>(q, k, v, o, lse, bh, T, causal, scale, s);
  if (dtype == 1 && dh == 64)
    return launch_fwd_tc<64>(q, k, v, o, lse, bh, T, causal, scale, s);
  if (dtype == 1 && dh == 128)
    return launch_fwd_tc<128>(q, k, v, o, lse, bh, T, causal, scale, s);
  return cudaErrorInvalidValue;
}

// The backward's two kernels (dK/dV, then dQ) on ``stream``. dout, dq,
// dk, dv share q's dtype; dq, dk, dv are [B, H, T, dh], and so are q, k,
// v, dout at bfloat16, while at float32 they are the operands
// dl4j_flash_attention_split made of them: q, k and dout its rows planes
// followed by its transposed planes, v its rows planes. di =
// rowsum(dout * o) is f32 [B, H, T]. Returns the first launch error.
cudaError_t dl4j_flash_attention_bwd(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* di,
                                     void* dq, void* dk, void* dv, int B,
                                     int H, int T, int dh, int causal,
                                     float scale, int dtype, void* stream) {
  if (!shape_ok(B, H, T, dh)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int bh = B * H;
  if (dtype == 0 && dh == 64)
    return launch_bwd_f32<64>(q, k, v, dout, lse, di, dq, dk, dv, bh, T,
                              causal, scale, s);
  if (dtype == 0 && dh == 128)
    return launch_bwd_f32<128>(q, k, v, dout, lse, di, dq, dk, dv, bh, T,
                               causal, scale, s);
  if (dtype == 1 && dh == 64)
    return launch_bwd_tc<64>(q, k, v, dout, lse, di, dq, dk, dv, bh, T,
                             causal, scale, s);
  if (dtype == 1 && dh == 128)
    return launch_bwd_tc<128>(q, k, v, dout, lse, di, dq, dk, dv, bh, T,
                              causal, scale, s);
  return cudaErrorInvalidValue;
}

const char* dl4j_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

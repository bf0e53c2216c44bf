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
// Three kernels, each in a float32 variant on the CUDA cores (FFMA) and
// a bfloat16 variant on the tensor cores:
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
//   * float32 (FA2-style, 64-row tiles, 128 threads): tiles are staged
//     in shared memory as f32 (Q^T and K^T transposed, so a thread's 4x8
//     score micro-tile reads float4s); P and dS go through shared memory
//     to the next product. Bound by the CUDA cores (67 TFLOP/s).
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

constexpr int kThreads = 128;
constexpr float kNeg = -1e30f;

// forward: queries per block, keys per step
constexpr int kFwdQ = 64;
constexpr int kFwdK = 64;
// dK/dV: keys per block, queries per step
constexpr int kBwdK = 64;
constexpr int kBwdQ = 32;
// dQ: queries per block, keys per step
constexpr int kDqQ = 64;
constexpr int kDqK = 32;

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void unpack(const float4 v, float* o) {
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
// max / sum over the 8 consecutive lanes that share a row group
__device__ __forceinline__ float group8_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  return v;
}
__device__ __forceinline__ float group8_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v;
}

// Stage rows [r0, r0 + ROWS) of one head [T, DH] in shared memory
// transposed, dst[d * ROWS + r], zero past T. Consecutive threads take
// consecutive rows, so the transposed stores hit consecutive banks.
template <int DH, int ROWS>
__device__ __forceinline__ void stage_t(const float* src, int r0, int t_len,
                                        float* dst) {
  for (int i = threadIdx.x; i < ROWS * (DH / 4); i += kThreads) {
    const int r = i % ROWS;
    const int d = (i / ROWS) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < t_len) load4(src + (size_t)(r0 + r) * DH + d, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[(d + e) * ROWS + r] = v[e];
  }
}

// Stage the same rows row-major, dst[r * DH + d], zero past T.
template <int DH, int ROWS>
__device__ __forceinline__ void stage(const float* src, int r0, int t_len,
                                      float* dst) {
  for (int i = threadIdx.x; i < ROWS * (DH / 4); i += kThreads) {
    const int r = i / (DH / 4);
    const int d = (i % (DH / 4)) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < t_len) load4(src + (size_t)(r0 + r) * DH + d, v);
    *reinterpret_cast<float4*>(dst + r * DH + d) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ bool allowed(int key, int qi, int t_len,
                                        bool causal) {
  return key < t_len && qi < t_len && (!causal || key <= qi);
}

// ---------------------------------------------------------------- forward
// Thread layout: rg = tid / 8 owns rows rg*4 .. rg*4+3 of the 64-query
// tile; cg = tid % 8 owns score columns cg*4+{0..3} and 32+cg*4+{0..3}
// and output columns c*32 + cg*4 + {0..3}.
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int t_len, int causal,
                 float scale) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [DH][kFwdQ]
  float* kt = qt + DH * kFwdQ;                  // [DH][kFwdK]
  float* vs = kt + DH * kFwdK;                  // [kFwdK][DH]
  float* ps = vs + kFwdK * DH;                  // [kFwdK][kFwdQ]
  constexpr int NC = DH / 32;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;
  const int cg = tid & 7;
  const int q0 = blockIdx.x * kFwdQ;
  const size_t bh = blockIdx.y;
  const size_t head = bh * (size_t)t_len * DH;

  stage_t<DH, kFwdQ>(q + head, q0, t_len, qt);

  float acc[4][4 * NC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? min(t_len, q0 + kFwdQ) : t_len;
  for (int k0 = 0; k0 < k_end; k0 += kFwdK) {
    __syncthreads();  // the previous tile's kt / vs / ps are consumed
    stage_t<DH, kFwdK>(k + head, k0, t_len, kt);
    stage<DH, kFwdK>(v + head, k0, t_len, vs);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float a[4], b[8];
      unpack(lds4(qt + d * kFwdQ + rg * 4), a);
      unpack(lds4(kt + d * kFwdK + cg * 4), b);
      unpack(lds4(kt + d * kFwdK + 32 + cg * 4), b + 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + rg * 4 + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + (j < 4 ? cg * 4 + j : 32 + cg * 4 + j - 4);
        // rows past T are never written: let them see every key < T
        const bool ok = key < t_len && (!causal || key <= qi);
        s[i][j] = ok ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = group8_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + (j < 4 ? cg * 4 + j : 32 + cg * 4 + j - 4);
        const bool ok = key < t_len && (!causal || key <= qi);
        const float p = ok ? expf(s[i][j] - m_new) : 0.f;
        s[i][j] = p;
        sum += p;
      }
      sum = group8_sum(sum);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = j < 4 ? cg * 4 + j : 32 + cg * 4 + j - 4;
        ps[col * kFwdQ + rg * 4 + i] = s[i][j];
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kFwdK; ++kk) {
      float p[4];
      unpack(lds4(ps + kk * kFwdQ + rg * 4), p);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float vv[4];
        unpack(lds4(vs + kk * DH + c * 32 + cg * 4), vv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][c * 4 + e] = fmaf(p[i], vv[e], acc[i][c * 4 + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    if (qi >= t_len) continue;
    const float inv = 1.f / l[i];  // l >= 1: the row's max key counts
    float* orow = o + head + (size_t)qi * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        orow[c * 32 + cg * 4 + e] = acc[i][c * 4 + e] * inv;
    if (cg == 0) lse[bh * t_len + qi] = m[i] + logf(l[i]);
  }
}

// ----------------------------------------------------------- backward dK/dV
// Thread layout: kg = tid / 8 owns keys kg*4 .. kg*4+3 of the 64-key
// tile; qg = tid % 8 owns queries qg*4 .. qg*4+3 of each 32-query step
// and output columns c*32 + qg*4 + {0..3}.
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ di, float* __restrict__ dk,
                      float* __restrict__ dv, int t_len, int causal,
                      float scale) {
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);  // [DH][kBwdK]
  float* vt = kt + DH * kBwdK;                  // [DH][kBwdK]
  float* qt = vt + DH * kBwdK;                  // [DH][kBwdQ]
  float* dot = qt + DH * kBwdQ;                 // [DH][kBwdQ]
  float* qs = dot + DH * kBwdQ;                 // [kBwdQ][DH]
  float* dos = qs + kBwdQ * DH;                 // [kBwdQ][DH]
  float* pt = dos + kBwdQ * DH;                 // [kBwdQ][kBwdK]
  float* dst = pt + kBwdQ * kBwdK;              // [kBwdQ][kBwdK]
  float* ls = dst + kBwdQ * kBwdK;              // [kBwdQ]
  float* dis = ls + kBwdQ;                      // [kBwdQ]
  constexpr int NC = DH / 32;

  const int tid = threadIdx.x;
  const int kg = tid >> 3;
  const int qg = tid & 7;
  const int k0 = blockIdx.x * kBwdK;
  const size_t bh = blockIdx.y;
  const size_t head = bh * (size_t)t_len * DH;

  stage_t<DH, kBwdK>(k + head, k0, t_len, kt);
  stage_t<DH, kBwdK>(v + head, k0, t_len, vt);

  float dk_acc[4][4 * NC], dv_acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) {
      dk_acc[i][c] = 0.f;
      dv_acc[i][c] = 0.f;
    }

  // under causal only queries at or after the tile's first key attend it
  const int q_begin = causal ? k0 : 0;
  for (int q0 = q_begin; q0 < t_len; q0 += kBwdQ) {
    __syncthreads();
    stage_t<DH, kBwdQ>(q + head, q0, t_len, qt);
    stage<DH, kBwdQ>(q + head, q0, t_len, qs);
    stage_t<DH, kBwdQ>(dout + head, q0, t_len, dot);
    stage<DH, kBwdQ>(dout + head, q0, t_len, dos);
    for (int i = tid; i < kBwdQ; i += kThreads) {
      const int qi = q0 + i;
      ls[i] = qi < t_len ? lse[bh * t_len + qi] : 0.f;
      dis[i] = qi < t_len ? di[bh * t_len + qi] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float ka[4], va[4], qb[4], ob[4];
      unpack(lds4(kt + d * kBwdK + kg * 4), ka);
      unpack(lds4(vt + d * kBwdK + kg * 4), va);
      unpack(lds4(qt + d * kBwdQ + qg * 4), qb);
      unpack(lds4(dot + d * kBwdQ + qg * 4), ob);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(ka[i], qb[j], s[i][j]);
          dp[i][j] = fmaf(va[i], ob[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + kg * 4 + i;
        const int ql = qg * 4 + j;
        const bool ok = allowed(key, q0 + ql, t_len, causal);
        const float p = ok ? expf(s[i][j] * scale - ls[ql]) : 0.f;
        const float ds = ok ? p * (dp[i][j] - dis[ql]) : 0.f;
        pt[ql * kBwdK + kg * 4 + i] = p;
        dst[ql * kBwdK + kg * 4 + i] = ds;
      }
    __syncthreads();

#pragma unroll 2
    for (int qq = 0; qq < kBwdQ; ++qq) {
      float p[4], ds[4];
      unpack(lds4(pt + qq * kBwdK + kg * 4), p);
      unpack(lds4(dst + qq * kBwdK + kg * 4), ds);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float ob[4], qb[4];
        unpack(lds4(dos + qq * DH + c * 32 + qg * 4), ob);
        unpack(lds4(qs + qq * DH + c * 32 + qg * 4), qb);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dv_acc[i][c * 4 + e] = fmaf(p[i], ob[e], dv_acc[i][c * 4 + e]);
            dk_acc[i][c * 4 + e] = fmaf(ds[i], qb[e], dk_acc[i][c * 4 + e]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + kg * 4 + i;
    if (key >= t_len) continue;
    float* dkrow = dk + head + (size_t)key * DH;
    float* dvrow = dv + head + (size_t)key * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dkrow[c * 32 + qg * 4 + e] = dk_acc[i][c * 4 + e] * scale;
        dvrow[c * 32 + qg * 4 + e] = dv_acc[i][c * 4 + e];
      }
  }
}

// -------------------------------------------------------------- backward dQ
// Thread layout: rg = tid / 8 owns queries rg*4 .. rg*4+3 of the
// 64-query tile; cg = tid % 8 owns keys cg*4 .. cg*4+3 of each 32-key
// step and output columns c*32 + cg*4 + {0..3}.
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, float* __restrict__ dq,
                    int t_len, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [DH][kDqQ]
  float* dot = qt + DH * kDqQ;                  // [DH][kDqQ]
  float* kt = dot + DH * kDqQ;                  // [DH][kDqK]
  float* vt = kt + DH * kDqK;                   // [DH][kDqK]
  float* ks = vt + DH * kDqK;                   // [kDqK][DH]
  float* dss = ks + kDqK * DH;                  // [kDqK][kDqQ]
  constexpr int NC = DH / 32;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;
  const int cg = tid & 7;
  const int q0 = blockIdx.x * kDqQ;
  const size_t bh = blockIdx.y;
  const size_t head = bh * (size_t)t_len * DH;

  stage_t<DH, kDqQ>(q + head, q0, t_len, qt);
  stage_t<DH, kDqQ>(dout + head, q0, t_len, dot);

  float lse_r[4], di_r[4];
  float acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    lse_r[i] = qi < t_len ? lse[bh * t_len + qi] : 0.f;
    di_r[i] = qi < t_len ? di[bh * t_len + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? min(t_len, q0 + kDqQ) : t_len;
  for (int k0 = 0; k0 < k_end; k0 += kDqK) {
    __syncthreads();
    stage_t<DH, kDqK>(k + head, k0, t_len, kt);
    stage_t<DH, kDqK>(v + head, k0, t_len, vt);
    stage<DH, kDqK>(k + head, k0, t_len, ks);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qa[4], oa[4], kb[4], vb[4];
      unpack(lds4(qt + d * kDqQ + rg * 4), qa);
      unpack(lds4(dot + d * kDqQ + rg * 4), oa);
      unpack(lds4(kt + d * kDqK + cg * 4), kb);
      unpack(lds4(vt + d * kDqK + cg * 4), vb);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = q0 + rg * 4 + i;
        const int key = k0 + cg * 4 + j;
        const bool ok = allowed(key, qi, t_len, causal);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        dss[(cg * 4 + j) * kDqQ + rg * 4 + i] =
            ok ? p * (dp[i][j] - di_r[i]) : 0.f;
      }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kDqK; ++kk) {
      float ds[4];
      unpack(lds4(dss + kk * kDqQ + rg * 4), ds);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float kb[4];
        unpack(lds4(ks + kk * DH + c * 32 + cg * 4), kb);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][c * 4 + e] = fmaf(ds[i], kb[e], acc[i][c * 4 + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    if (qi >= t_len) continue;
    float* row = dq + head + (size_t)qi * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        row[c * 32 + cg * 4 + e] = acc[i][c * 4 + e] * scale;
  }
}

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
__device__ __forceinline__ uint64_t gmma_desc(const bf16* p, uint32_t lbo,
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

// ------------------------------------------------------------------ launch
constexpr size_t fwd_smem(int dh) {
  return sizeof(float) * ((size_t)dh * kFwdQ + (size_t)dh * kFwdK +
                          (size_t)kFwdK * dh + (size_t)kFwdK * kFwdQ);
}
constexpr size_t dkdv_smem(int dh) {
  return sizeof(float) *
         ((size_t)2 * dh * kBwdK + (size_t)4 * dh * kBwdQ +
          (size_t)2 * kBwdQ * kBwdK + (size_t)2 * kBwdQ);
}
constexpr size_t dq_smem(int dh) {
  return sizeof(float) * ((size_t)2 * dh * kDqQ + (size_t)3 * dh * kDqK +
                          (size_t)kDqK * kDqQ);
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int DH>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int t, int causal, float scale,
                       cudaStream_t s) {
  auto kern = flash_fwd_kernel<DH>;
  const size_t smem = fwd_smem(DH);
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((t + kFwdQ - 1) / kFwdQ, bh);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), t, causal, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* di,
                       void* dq, void* dk, void* dv, int bh, int t,
                       int causal, float scale, cudaStream_t s) {
  auto kdkdv = flash_bwd_dkdv_kernel<DH>;
  auto kdq = flash_bwd_dq_kernel<DH>;
  cudaError_t e = allow_smem(kdkdv, dkdv_smem(DH));
  if (e != cudaSuccess) return e;
  e = allow_smem(kdq, dq_smem(DH));
  if (e != cudaSuccess) return e;
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(di);
  dim3 g1((t + kBwdK - 1) / kBwdK, bh);
  kdkdv<<<g1, kThreads, dkdv_smem(DH), s>>>(
      qp, kp, vp, dop, lp, dp, static_cast<float*>(dk), static_cast<float*>(dv), t,
      causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dim3 g2((t + kDqQ - 1) / kDqQ, bh);
  kdq<<<g2, kThreads, dq_smem(DH), s>>>(qp, kp, vp, dop, lp, dp,
                                        static_cast<float*>(dq), t, causal,
                                        scale);
  return cudaGetLastError();
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

bool shape_ok(int B, int H, int T, int dh) {
  return B >= 1 && H >= 1 && T >= 1 && (dh == 64 || dh == 128) &&
         (long long)B * H <= 65535;
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16; q/k/v/o share it. q, k, v, o
// are contiguous [B, H, T, dh]; lse is f32 [B, H, T]. Launches on
// ``stream`` and does not synchronise; returns the launch's error.
cudaError_t dl4j_flash_attention_fwd(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int B, int H, int T, int dh,
                                     int causal, float scale, int dtype,
                                     void* stream) {
  if (!shape_ok(B, H, T, dh)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int bh = B * H;
  if (dtype == 0 && dh == 64)
    return launch_fwd<64>(q, k, v, o, lse, bh, T, causal, scale, s);
  if (dtype == 0 && dh == 128)
    return launch_fwd<128>(q, k, v, o, lse, bh, T, causal, scale, s);
  if (dtype == 1 && dh == 64)
    return launch_fwd_tc<64>(q, k, v, o, lse, bh, T, causal, scale, s);
  if (dtype == 1 && dh == 128)
    return launch_fwd_tc<128>(q, k, v, o, lse, bh, T, causal, scale, s);
  return cudaErrorInvalidValue;
}

// The backward's two kernels (dK/dV, then dQ) on ``stream``. dout, dq,
// dk, dv share q's dtype and shape; di = rowsum(dout * o) is f32
// [B, H, T]. Returns the first launch error.
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
    return launch_bwd<64>(q, k, v, dout, lse, di, dq, dk, dv, bh, T,
                                 causal, scale, s);
  if (dtype == 0 && dh == 128)
    return launch_bwd<128>(q, k, v, dout, lse, di, dq, dk, dv, bh,
                                  T, causal, scale, s);
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

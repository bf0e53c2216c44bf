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
// Design (simple and right first; FA2-style). Three kernels, each in a
// float32 variant on the CUDA cores (FFMA) and a bfloat16 variant on the
// tensor cores (mma.sync m16n8k16, f32 accumulators):
//   * Forward: one thread block per (b*h, 64-query tile). It walks
//     64-key tiles with an online softmax (running max m and sum l in
//     f32); under causal, key tiles wholly above the diagonal are never
//     visited. It writes O and LSE.
//   * Backward dK/dV: one block per (b*h, 64-key tile), walking 32-query
//     tiles (from the diagonal on under causal). It recomputes
//     P^T = exp(K Q^T * scale - LSE) and dP^T = V dO^T, then
//     dS = P (dP - Di) with Di = rowsum(dO o O) (computed by the
//     wrapper, as the stock Pallas backward computes it outside its
//     kernels); dV += P^T dO, dK += dS^T Q * scale.
//   * Backward dQ: one block per (b*h, 64-query tile), walking key tiles
//     (32 keys in f32, 64 in bf16): dQ += dS K * scale. No atomics: each
//     output has one owner, so a rerun (activation checkpointing) gives
//     the same bits.
//   * Masks are selects, never products: a key past T or above the
//     diagonal gets probability exactly 0 whatever the tile holds, and
//     rows and keys past a ragged T are zero-filled in shared memory.
//     Any T >= 1 works (no T % 128 rule).
//   * float32: tiles are staged in shared memory as f32 (Q^T and K^T
//     transposed, so a thread's 4x8 score micro-tile reads float4s); P
//     and dS go through shared memory to the next product.
//   * bfloat16: tiles are staged as bf16 with padded rows; each warp owns
//     16 rows and keeps P and dS in registers from one mma to the next
//     (rounded to bf16, as FA2 does). Softmax statistics stay f32.
//
// What bounds it on the card: operations. Causal attention at T = 2048,
// dh = 128 does ~T/2 * 4 * dh flops per query for ~4 * dh * 2 bytes of
// bf16 q/k/v/o per query, hundreds of flops per byte, above the H100's
// ridge (989 TFLOP/s bf16 dense). The bf16 variant issues mma.sync from
// shared memory with no load/compute overlap; wgmma, TMA and a
// multi-stage cp.async pipeline are later work. The f32 variant is bound
// by the CUDA cores (67 TFLOP/s).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>

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

// ------------------------------------------------- bf16 tensor-core kernels
// The same three kernels for bfloat16 inputs on the tensor cores:
// mma.sync m16n8k16 (bf16 inputs, f32 accumulators), one 16-row slab
// per warp. Fragment layout (g = lane / 4, t = lane % 4):
//   A 16x16 row-major: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 8+2t..),
//     a3 (g+8, 8+2t..);
//   B 16x8 given as [n][k]: b0 (n=g, k=2t..2t+1), b1 (n=g, k=8+2t..);
//   C 16x8 f32: c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1).
// A C tile pair (two adjacent n=8 tiles) is exactly an A fragment of
// k=16, so P and dS go from one product into the next in registers,
// rounded to bf16 (as FA2 does). Tiles sit in shared memory as bf16 with
// rows padded by 8 elements, so the 32-bit fragment loads of a warp hit
// 32 distinct banks; tiles read along the other axis (V in the forward,
// Q and dO in dK/dV, K in dQ) are staged transposed.

constexpr int kTcRows = 64;   // rows per block (16 per warp)
constexpr int kTcBwdQ = 32;   // dK/dV: queries per step

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// A fragment of rows [r0, r0+16), cols [c0, c0+16) of a row-major tile
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* x, int ld,
                                       int r0, int c0, int g, int t) {
  a[0] = ld32(x + (r0 + g) * ld + c0 + 2 * t);
  a[1] = ld32(x + (r0 + g + 8) * ld + c0 + 2 * t);
  a[2] = ld32(x + (r0 + g) * ld + c0 + 8 + 2 * t);
  a[3] = ld32(x + (r0 + g + 8) * ld + c0 + 8 + 2 * t);
}
// B fragment of n rows [n0, n0+8), k cols [k0, k0+16) of a [n][k] tile
__device__ __forceinline__ void frag_b(uint32_t* b, const bf16* y, int ld,
                                       int n0, int k0, int g, int t) {
  b[0] = ld32(y + (n0 + g) * ld + k0 + 2 * t);
  b[1] = ld32(y + (n0 + g) * ld + k0 + 8 + 2 * t);
}
// P (or dS) as the A fragment for k columns [16 kk, 16 kk + 16)
__device__ __forceinline__ void c_to_a(uint32_t* a, const float (*c)[4],
                                       int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}
__device__ __forceinline__ float group4_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float group4_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// rows [r0, r0 + ROWS) of a [T, DH] head into dst[r * (DH + 8) + d],
// 16-byte vectors, zero past T
template <int DH, int ROWS>
__device__ __forceinline__ void tc_stage(const bf16* src, int r0, int t_len,
                                         bf16* dst) {
  constexpr int V = DH / 8;
  for (int i = threadIdx.x; i < ROWS * V; i += kThreads) {
    const int r = i / V;
    const int c = (i % V) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < t_len)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * DH + c);
    *reinterpret_cast<uint4*>(dst + r * (DH + 8) + c) = val;
  }
}
// the same rows transposed, dst[d * (ROWS + 8) + r]
template <int DH, int ROWS>
__device__ __forceinline__ void tc_stage_t(const bf16* src, int r0,
                                           int t_len, bf16* dst) {
  constexpr int V = DH / 8;
  for (int i = threadIdx.x; i < ROWS * V; i += kThreads) {
    const int r = i % ROWS;
    const int c = (i / ROWS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < t_len)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * DH + c);
    const bf16* h = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[(c + e) * (ROWS + 8) + r] = h[e];
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int t_len, int causal,
                    float scale) {
  constexpr int SR = DH + 8;        // row stride of row-major tiles
  constexpr int ST = kTcRows + 8;   // row stride of V^T
  constexpr int KS = DH / 16;       // k steps over dh
  constexpr int NO = DH / 8;        // output n tiles
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);   // [64][SR]
  bf16* ks = qs + kTcRows * SR;                // [64][SR]
  bf16* vt = ks + kTcRows * SR;                // [DH][ST]

  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTcRows;
  const size_t bh = blockIdx.y;
  const size_t head = bh * (size_t)t_len * DH;
  const int qa = q0 + r0 + g, qb = qa + 8;

  tc_stage<DH, kTcRows>(q + head, q0, t_len, qs);
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) frag_a(qf[kk], qs, SR, r0, kk * 16, g, t);

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  const int k_end = causal ? min(t_len, q0 + kTcRows) : t_len;
  for (int k0 = 0; k0 < k_end; k0 += kTcRows) {
    __syncthreads();
    tc_stage<DH, kTcRows>(k + head, k0, t_len, ks);
    tc_stage_t<DH, kTcRows>(v + head, k0, t_len, vt);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t b[2];
        frag_b(b, ks, SR, j * 8, kk * 16, g, t);
        mma_bf16(s[j], qf[kk], b);
      }
    }
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const int row = (e >> 1) ? qb : qa;
        const bool ok = key < t_len && (!causal || key <= row);
        s[j][e] = ok ? s[j][e] * scale : kNeg;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], group4_max(mx[h]));
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const int row = (e >> 1) ? qb : qa;
        const bool ok = key < t_len && (!causal || key <= row);
        const float p = ok ? expf(s[j][e] - m[e >> 1]) : 0.f;
        s[j][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + group4_sum(sum[h]);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kTcRows / 16; ++kk) {
      uint32_t pa[4];
      c_to_a(pa, s, kk);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t b[2];
        frag_b(b, vt, ST, n * 8, kk * 16, g, t);
        mma_bf16(acc[n], pa, b);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? qb : qa;
    if (row >= t_len) continue;
    const float inv = 1.f / l[h];  // l >= 1: the row's max key counts
    bf16* orow = o + head + (size_t)row * DH;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * h] * inv,
                                acc[n][2 * h + 1] * inv);
    if (t == 0) lse[bh * t_len + row] = m[h] + logf(l[h]);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_tc_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ di,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         int t_len, int causal, float scale) {
  constexpr int SR = DH + 8;
  constexpr int ST = kTcBwdQ + 8;
  constexpr int KS = DH / 16;
  constexpr int NO = DH / 8;
  constexpr int NQ = kTcBwdQ / 8;     // score n tiles (queries)
  extern __shared__ float4 smem4[];
  bf16* ks = reinterpret_cast<bf16*>(smem4);   // [64][SR]
  bf16* vs = ks + kTcRows * SR;                // [64][SR]
  bf16* qs = vs + kTcRows * SR;                // [32][SR]
  bf16* dos = qs + kTcBwdQ * SR;               // [32][SR]
  bf16* qt = dos + kTcBwdQ * SR;               // [DH][ST]
  bf16* dot = qt + DH * ST;                    // [DH][ST]
  float* ls = reinterpret_cast<float*>(dot + DH * ST);  // [32]
  float* dis = ls + kTcBwdQ;                            // [32]

  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kTcRows;
  const size_t bh = blockIdx.y;
  const size_t head = bh * (size_t)t_len * DH;

  tc_stage<DH, kTcRows>(k + head, k0, t_len, ks);
  tc_stage<DH, kTcRows>(v + head, k0, t_len, vs);

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[n][e] = 0.f;
      dv_acc[n][e] = 0.f;
    }

  const int q_begin = causal ? k0 : 0;
  for (int q0 = q_begin; q0 < t_len; q0 += kTcBwdQ) {
    __syncthreads();
    tc_stage<DH, kTcBwdQ>(q + head, q0, t_len, qs);
    tc_stage<DH, kTcBwdQ>(dout + head, q0, t_len, dos);
    tc_stage_t<DH, kTcBwdQ>(q + head, q0, t_len, qt);
    tc_stage_t<DH, kTcBwdQ>(dout + head, q0, t_len, dot);
    for (int i = threadIdx.x; i < kTcBwdQ; i += kThreads) {
      const int qi = q0 + i;
      ls[i] = qi < t_len ? lse[bh * t_len + qi] : 0.f;
      dis[i] = qi < t_len ? di[bh * t_len + qi] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: rows are this warp's 16 keys
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.f;
        dp[j][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ak[4], av[4];
      frag_a(ak, ks, SR, r0, kk * 16, g, t);
      frag_a(av, vs, SR, r0, kk * 16, g, t);
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        uint32_t b[2];
        frag_b(b, qs, SR, j * 8, kk * 16, g, t);
        mma_bf16(s[j], ak, b);
        frag_b(b, dos, SR, j * 8, kk * 16, g, t);
        mma_bf16(dp[j], av, b);
      }
    }
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + r0 + g + (e >> 1) * 8;
        const int ql = j * 8 + 2 * t + (e & 1);
        const bool ok = allowed(key, q0 + ql, t_len, causal);
        const float p = ok ? expf(s[j][e] * scale - ls[ql]) : 0.f;
        dp[j][e] = ok ? p * (dp[j][e] - dis[ql]) : 0.f;
        s[j][e] = p;
      }
    // dV += P^T dO, dK += dS^T Q over this step's queries
#pragma unroll
    for (int kk = 0; kk < kTcBwdQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      c_to_a(pa, s, kk);
      c_to_a(da, dp, kk);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t b[2];
        frag_b(b, dot, ST, n * 8, kk * 16, g, t);
        mma_bf16(dv_acc[n], pa, b);
        frag_b(b, qt, ST, n * 8, kk * 16, g, t);
        mma_bf16(dk_acc[n], da, b);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + r0 + g + h * 8;
    if (key >= t_len) continue;
    bf16* dkrow = dk + head + (size_t)key * DH;
    bf16* dvrow = dv + head + (size_t)key * DH;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dkrow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dk_acc[n][2 * h] * scale,
                                dk_acc[n][2 * h + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvrow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q,
                       const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ di,
                       bf16* __restrict__ dq, int t_len, int causal,
                       float scale) {
  constexpr int SR = DH + 8;
  constexpr int ST = kTcRows + 8;
  constexpr int KS = DH / 16;
  constexpr int NO = DH / 8;
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);   // [64][SR]
  bf16* dos = qs + kTcRows * SR;               // [64][SR]
  bf16* ks = dos + kTcRows * SR;               // [64][SR]
  bf16* vs = ks + kTcRows * SR;                // [64][SR]
  bf16* kt = vs + kTcRows * SR;                // [DH][ST]

  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTcRows;
  const size_t bh = blockIdx.y;
  const size_t head = bh * (size_t)t_len * DH;
  const int qa = q0 + r0 + g, qb = qa + 8;

  tc_stage<DH, kTcRows>(q + head, q0, t_len, qs);
  tc_stage<DH, kTcRows>(dout + head, q0, t_len, dos);
  const float lse_r[2] = {qa < t_len ? lse[bh * t_len + qa] : 0.f,
                          qb < t_len ? lse[bh * t_len + qb] : 0.f};
  const float di_r[2] = {qa < t_len ? di[bh * t_len + qa] : 0.f,
                         qb < t_len ? di[bh * t_len + qb] : 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int k_end = causal ? min(t_len, q0 + kTcRows) : t_len;
  for (int k0 = 0; k0 < k_end; k0 += kTcRows) {
    __syncthreads();
    tc_stage<DH, kTcRows>(k + head, k0, t_len, ks);
    tc_stage<DH, kTcRows>(v + head, k0, t_len, vs);
    tc_stage_t<DH, kTcRows>(k + head, k0, t_len, kt);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.f;
        dp[j][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t aq[4], ao[4];
      frag_a(aq, qs, SR, r0, kk * 16, g, t);
      frag_a(ao, dos, SR, r0, kk * 16, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b[2];
        frag_b(b, ks, SR, j * 8, kk * 16, g, t);
        mma_bf16(s[j], aq, b);
        frag_b(b, vs, SR, j * 8, kk * 16, g, t);
        mma_bf16(dp[j], ao, b);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const int h = e >> 1;
        const bool ok = allowed(key, h ? qb : qa, t_len, causal);
        const float p = ok ? expf(s[j][e] * scale - lse_r[h]) : 0.f;
        s[j][e] = ok ? p * (dp[j][e] - di_r[h]) : 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < kTcRows / 16; ++kk) {
      uint32_t da[4];
      c_to_a(da, s, kk);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t b[2];
        frag_b(b, kt, ST, n * 8, kk * 16, g, t);
        mma_bf16(acc[n], da, b);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? qb : qa;
    if (row >= t_len) continue;
    bf16* out = dq + head + (size_t)row * DH;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * h] * scale,
                                acc[n][2 * h + 1] * scale);
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

constexpr size_t tc_fwd_smem(int dh) {
  return sizeof(bf16) * ((size_t)2 * kTcRows * (dh + 8) +
                         (size_t)dh * (kTcRows + 8));
}
constexpr size_t tc_dkdv_smem(int dh) {
  return sizeof(bf16) * ((size_t)2 * kTcRows * (dh + 8) +
                         (size_t)2 * kTcBwdQ * (dh + 8) +
                         (size_t)2 * dh * (kTcBwdQ + 8)) +
         sizeof(float) * 2 * kTcBwdQ;
}
constexpr size_t tc_dq_smem(int dh) {
  return sizeof(bf16) * ((size_t)4 * kTcRows * (dh + 8) +
                         (size_t)dh * (kTcRows + 8));
}

template <int DH>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v,
                          void* o, void* lse, int bh, int t, int causal,
                          float scale, cudaStream_t s) {
  auto kern = flash_fwd_tc_kernel<DH>;
  const size_t smem = tc_fwd_smem(DH);
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((t + kTcRows - 1) / kTcRows, bh);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), t, causal, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bwd_tc(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse, const void* di,
                          void* dq, void* dk, void* dv, int bh, int t,
                          int causal, float scale, cudaStream_t s) {
  auto kdkdv = flash_bwd_dkdv_tc_kernel<DH>;
  auto kdq = flash_bwd_dq_tc_kernel<DH>;
  cudaError_t e = allow_smem(kdkdv, tc_dkdv_smem(DH));
  if (e != cudaSuccess) return e;
  e = allow_smem(kdq, tc_dq_smem(DH));
  if (e != cudaSuccess) return e;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(di);
  dim3 grid((t + kTcRows - 1) / kTcRows, bh);
  kdkdv<<<grid, kThreads, tc_dkdv_smem(DH), s>>>(
      qp, kp, vp, dop, lp, dp, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), t, causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  kdq<<<grid, kThreads, tc_dq_smem(DH), s>>>(
      qp, kp, vp, dop, lp, dp, static_cast<bf16*>(dq), t, causal, scale);
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

// Paged attention over the shared KV block pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// deeplearning4j_tpu/nn/layers/attention.py:_paged_flash_attention with
// the same function: for each (row b, head h), a walk over logical
// blocks lo_blk[b] + j mapped through bid[b, j] into the pool
// pk/pv [nb, bt, H, dh], with an online softmax for t queries.
//
//   * A key counts if its block is mapped (bval), it is causal
//     (kpos <= qpos), inside the window (kpos > qpos - tm) and at or
//     above floor[b].
//   * V lanes outside [floor, filled + len) are zeroed BEFORE P.V:
//     a recycled block may hold NaN, and a zero softmax weight does not
//     kill a NaN (0 * NaN = NaN). Masks are selects, never products.
//   * A row with no valid key writes 0 (acc / (l == 0 ? 1 : l)).
//   * Scale is the exact dh^-1/2 multiplier the wrapper passes.
//
// What bounds it on the card: bytes. Decode attention does about
// 4 * dh flops per key for 2 * dh * 4 bytes of f32 K/V, about 0.5 flop
// per byte, far below the H100's ridge; the least time is the live K/V
// bytes over 3.35 TB/s. The pool stays in the master dtype (f32), as in
// the JAX package, so tensor cores have no part here (TF32 would change
// the numbers); the lever is keeping enough loads in flight.
//
// Design: split-K ("flash-decoding") in two passes.
//
//   Pass 1, paged_attention_partial_kernel, grid (split x query tile,
//   h, b), one block of 4 warps each. The block works out its row's live entry
//   range (entries whose keys reach floor[b] and that start at or
//   before the last query position filled[b] + t - 1) and takes split
//   s's equal share of it, so a short history still spreads over every
//   split and the split count, not the table width, sets the grid. The
//   number of splits S is a pure function of (B, H, t, ntab) and the
//   card's SM count that the wrapper computes; the plan is arithmetic on
//   the inputs, so the same inputs on the same card give the same bits.
//   The walk streams each entry's K and V tile [bt, dh] through a
//   3-stage ring in shared memory with 16-byte cp.async copies: two
//   entries are in flight while one is computed, with one __syncthreads
//   per entry. An entry that is unmapped, wholly below the floor or
//   starts past the block's last query issues no load and is skipped.
//   Each warp owns keys r = warp, warp + 4, ... of a tile and keeps, per
//   query, its own running max m, sum l and a dh-wide accumulator in f32
//   registers (dh / 32 columns a lane, beside the lane's dh / 32
//   elements of q). It takes its keys 4 at a time: 4 dot products of
//   dh / 32 lane products each, their 4 butterfly sums side by side
//   (independent shuffles in flight), then one online-softmax rescale
//   of m, l and the accumulator. At the end the 4 warps merge in shared
//   memory in a fixed warp order and write the split's partial (m, l,
//   unnormalised acc) to the workspace. t = 1 (decode) instantiates one
//   query a block; t > 1 (verify, chunks) kQueryTile queries a block,
//   more tiles on grid x.
//
//   Pass 2, paged_attention_combine_kernel, one block per (b, h,
//   query): folds the splits in a fixed order: M = max m_s,
//   L = sum e^(m_s - M) l_s, O = sum e^(m_s - M) acc_s / (L == 0 ? 1 : L),
//   cast to q's dtype. A split with no live key holds m = -1e30, l = 0,
//   acc = 0 and so adds exactly nothing; a row with none at all comes
//   out exactly 0.
//
// The kernels allocate nothing, synchronise nothing and use no atomics
// (so a CUDA graph can capture them); the wrapper allocates the
// workspace (acc [B, H, S, t, dh], then m and l [B, H, S, t], f32) with
// torch.empty.
//
// What that does about the single-walk kernel it replaces (one block
// per (b, h), 64 blocks at the serving shape, four __syncthreads and a
// synchronous load per entry, state in shared memory): S = 5 splits
// give 320 blocks at B=8 and 33 give 264 at B=1 on a 132-SM card; the
// ring keeps two entries' K/V in flight per block; m, l and the
// accumulator live in registers. On an H100 (700 W) at B=8, H=8,
// dh=128, 16-token blocks, window 2048, q bf16, f32 pool, the two
// passes take 0.0425 ms of device time back to back in a CUDA graph,
// 73% of the 0.0311 ms byte bound (chip_smoke.py; PERF.md, K2).
//
// ptxas -v (sm_90a; scripts/torch_kernel_sass.py paged_attention):
// pass 1 uses 63-72 registers at t = 1 and 80-126 at t > 1, pass 2 32;
// no stack and no spills in any of the 20 kernels. Dynamic shared
// memory of a pass-1 block at the serving shape: 51,232 bytes (a
// 49,152-byte ring and 2,080 bytes of merge rows).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;
// queries one pass-1 block takes when t > 1 (PAGED_QUERY_TILE in
// nn/layers/attention.py)
constexpr int kQueryTile = 4;
// keys of a tile one warp scores together
constexpr int kKeys = 4;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// V consecutive elements at p (aligned to their size) as f32
template <typename T, int V>
__device__ __forceinline__ void load_f32(const T* p, float (&o)[V]);

template <>
__device__ __forceinline__ void load_f32<float, 4>(const float* p,
                                                   float (&o)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}
template <>
__device__ __forceinline__ void load_f32<float, 2>(const float* p,
                                                   float (&o)[2]) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  o[0] = x.x;
  o[1] = x.y;
}
template <>
__device__ __forceinline__ void load_f32<__nv_bfloat16, 4>(
    const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}
template <>
__device__ __forceinline__ void load_f32<__nv_bfloat16, 2>(
    const __nv_bfloat16* p, float (&o)[2]) {
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  o[0] = a.x;
  o[1] = a.y;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory of one pass-1 block: the K/V ring and the warps' merge
// rows.
__host__ __device__ inline size_t ring_bytes(int bt, int dh, int kv_size) {
  return (size_t)kStages * 2 * bt * dh * kv_size;
}
__host__ __device__ inline size_t merge_floats(int tq, int dh) {
  return (size_t)kWarps * tq * (dh + 2);
}

template <typename QT, typename KVT, int DH, int TQ>
__global__ void __launch_bounds__(kThreads)
paged_attention_partial_kernel(const QT* __restrict__ q,
                     const KVT* __restrict__ pk,
                     const KVT* __restrict__ pv,
                     const int* __restrict__ bid,
                     const int* __restrict__ bval,
                     const int* __restrict__ lo_blk,
                     const int* __restrict__ floor_,
                     const int* __restrict__ filled,
                     const int* __restrict__ lengths,
                     float* __restrict__ ws_acc,
                     float* __restrict__ ws_m,
                     float* __restrict__ ws_l,
                     int H, int t, int bt, int ntab, int tm, int splits,
                     float scale) {
  constexpr int V = DH / 32;                 // columns a lane
  constexpr int CH = 16 / sizeof(KVT);       // elements a 16-byte copy
  constexpr int ROW_CH = DH / CH;            // copies a K or V row
  constexpr int MROW = DH + 2;               // merge row: acc, m, l
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tile = bt * DH;
  KVT* ring = reinterpret_cast<KVT*>(smem_raw);   // [kStages][K, V][bt][DH]
  float* merge = reinterpret_cast<float*>(
      smem_raw + ring_bytes(bt, DH, sizeof(KVT)));  // [kWarps][TQ][MROW]

  const int split = blockIdx.x % splits;
  const int q0 = (blockIdx.x / splits) * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * H + h;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int lo = lo_blk[b];
  const int fl = floor_[b];
  const int fi = filled[b];
  const int vhi = fi + lengths[b];       // end of the written span
  const int nq = min(TQ, t - q0);        // this block's queries
  const int qlast = fi + q0 + nq - 1;    // its last query position

  // -- split plan: split's equal share of the row's live range --------
  const int jlo = max(0, fl / bt - lo);
  const int jhi = min(ntab, (fi + t - 1) / bt - lo + 1);
  const int len = max(0, jhi - jlo);
  const int j0 = jlo + (int)((long long)split * len / splits);
  const int j1 = jlo + (int)((long long)(split + 1) * len / splits);

  // an entry holds a key some query of this block may attend only if it
  // is mapped, reaches the floor and starts at or before the block's
  // last query; any other entry issues no load and is not computed
  // (uniform across the block: every thread reads the same entry)
  auto live = [&](int j) {
    const int kbase = (lo + j) * bt;
    return bval[b * ntab + j] > 0 && kbase + bt > fl && kbase <= qlast;
  };
  const int n = j1 - j0;

  // -- per-lane state: q, and per query m, l and the accumulator -------
  float qv[TQ][V];
  float acc[TQ][V];
  float m[TQ];
  float l[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < V; ++c) {
      acc[i][c] = 0.f;
      qv[i][c] = 0.f;
    }
    if (i < nq)
      load_f32<QT, V>(q + ((size_t)bh * t + q0 + i) * DH + lane * V, qv[i]);
  }

  // entry j0 + e goes to ring stage e % kStages
  auto issue = [&](int e) {
    if (!live(j0 + e)) return;
    KVT* ks = ring + (size_t)(e % kStages) * 2 * tile;
    KVT* vs = ks + tile;
    const size_t blk = (size_t)bid[b * ntab + j0 + e];
    for (int c = tid; c < bt * ROW_CH; c += kThreads) {
      const int r = c / ROW_CH;
      const int x = (c - r * ROW_CH) * CH;
      const size_t off = ((blk * bt + r) * H + h) * DH + x;
      cp_async16(ks + r * DH + x, pk + off);
      cp_async16(vs + r * DH + x, pv + off);
    }
  };

  // -- the walk: kStages - 1 entries in flight ahead of the one computed
#pragma unroll
  for (int e = 0; e < kStages - 1; ++e) {
    if (e < n) issue(e);
    cp_async_commit();
  }
  for (int e = 0; e < n; ++e) {
    cp_async_wait<kStages - 2>();   // entry e's copies (this thread's)
    __syncthreads();                // ... and every thread's; stage of
                                    // entry e - 1 is free again
    if (e + kStages - 1 < n) issue(e + kStages - 1);
    cp_async_commit();
    if (!live(j0 + e)) continue;
    const KVT* ks = ring + (size_t)(e % kStages) * 2 * tile;
    const KVT* vs = ks + tile;
    const int kbase = (lo + j0 + e) * bt;
    // keys r = warp + kWarps * j of the tile, kKeys a warp at a time:
    // their kKeys score reductions run side by side, then one
    // online-softmax rescale per query for the group
    for (int j = 0; j * kWarps < bt; j += kKeys) {
      float kf[kKeys][V];
      float vf[kKeys][V];
      int kpos[kKeys];
      bool has[kKeys];
#pragma unroll
      for (int k = 0; k < kKeys; ++k) {
        const int r = warp + kWarps * (j + k);
        has[k] = r < bt;
        kpos[k] = kbase + r;
        const int row = has[k] ? r : 0;     // a row inside the tile
        load_f32<KVT, V>(ks + row * DH + lane * V, kf[k]);
        load_f32<KVT, V>(vs + row * DH + lane * V, vf[k]);
        const bool vlive = has[k] && kpos[k] < vhi && kpos[k] >= fl;
#pragma unroll
        for (int c = 0; c < V; ++c) vf[k][c] = vlive ? vf[k][c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        if (i < nq) {
          const int qpos = fi + q0 + i;
          float sc[kKeys];
#pragma unroll
          for (int k = 0; k < kKeys; ++k) {
            float d = 0.f;
#pragma unroll
            for (int c = 0; c < V; ++c) d = fmaf(qv[i][c], kf[k][c], d);
            sc[k] = d;
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
            for (int k = 0; k < kKeys; ++k)
              sc[k] += __shfl_xor_sync(0xffffffffu, sc[k], o);
          }
          bool ok[kKeys];
          float mx = m[i];
#pragma unroll
          for (int k = 0; k < kKeys; ++k) {
            ok[k] = has[k] && kpos[k] <= qpos && kpos[k] > qpos - tm &&
                    kpos[k] >= fl;
            sc[k] = ok[k] ? sc[k] * scale : kNeg;
            mx = fmaxf(mx, sc[k]);
          }
          const float corr = expf(m[i] - mx);
          float p[kKeys];
          float psum = 0.f;
#pragma unroll
          for (int k = 0; k < kKeys; ++k) {
            p[k] = ok[k] ? expf(sc[k] - mx) : 0.f;
            psum += p[k];
          }
          l[i] = l[i] * corr + psum;
#pragma unroll
          for (int c = 0; c < V; ++c) {
            float a = acc[i][c] * corr;
#pragma unroll
            for (int k = 0; k < kKeys; ++k) a = fmaf(p[k], vf[k][c], a);
            acc[i][c] = a;
          }
          m[i] = mx;
        }
      }
    }
  }
  cp_async_wait<0>();

  // -- merge the 4 warps in a fixed order; write the split's partial ---
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    if (i < nq) {
      float* row = merge + (warp * TQ + i) * MROW;
#pragma unroll
      for (int c = 0; c < V; ++c) row[lane * V + c] = acc[i][c];
      if (lane == 0) {
        row[DH] = m[i];
        row[DH + 1] = l[i];
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nq * DH; idx += kThreads) {
    const int i = idx / DH;
    const int c = idx - i * DH;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, merge[(w * TQ + i) * MROW + DH]);
    float sum = 0.f;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* row = merge + (w * TQ + i) * MROW;
      const float f = expf(row[DH] - mx);
      sum += f * row[DH + 1];
      a += f * row[c];
    }
    const size_t out_row = ((size_t)bh * splits + split) * t + q0 + i;
    ws_acc[out_row * DH + c] = a;
    if (c == 0) {
      ws_m[out_row] = mx;
      ws_l[out_row] = sum;
    }
  }
}

// One block of DH threads per output row (b, h, query): warp 0 folds
// the split maxima and sums into weights e^(m_s - M) and L in a fixed
// lane order, then each thread sums its column over the splits in order.
template <typename QT, int DH>
__global__ void __launch_bounds__(DH)
paged_attention_combine_kernel(const float* __restrict__ ws_acc,
                     const float* __restrict__ ws_m,
                     const float* __restrict__ ws_l, QT* __restrict__ out,
                     int t, int splits) {
  extern __shared__ float fold[];   // [splits] weights, then L
  const int row = blockIdx.x;       // (b * H + h) * t + query
  const int bh = row / t;
  const size_t first = (size_t)bh * splits * t + (row - bh * t);
  const int tid = threadIdx.x;
  if (tid < 32) {
    float mx = kNeg;
    for (int s = tid; s < splits; s += 32)
      mx = fmaxf(mx, ws_m[first + (size_t)s * t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int s = tid; s < splits; s += 32) {
      const size_t r = first + (size_t)s * t;
      const float f = expf(ws_m[r] - mx);
      fold[s] = f;
      sum += f * ws_l[r];
    }
    sum = warp_sum(sum);
    if (tid == 0) fold[splits] = sum;
  }
  __syncthreads();
  const float* acc = ws_acc + first * DH + tid;
  const size_t step = (size_t)t * DH;
  float a = 0.f;
#pragma unroll 4
  for (int s = 0; s < splits; ++s) a += fold[s] * acc[s * step];
  const float sum = fold[splits];
  store(out + (size_t)row * DH + tid, a / (sum == 0.f ? 1.f : sum));
}

struct Args {
  const void* q;
  const void* pk;
  const void* pv;
  const int* bid;
  const int* bval;
  const int* lo_blk;
  const int* floor_;
  const int* filled;
  const int* lengths;
  void* out;
  float* ws;
  int B, H, t, dh, bt, ntab, tm, splits;
  float scale;
  size_t smem;
  cudaStream_t stream;
};

template <typename QT, typename KVT, int DH, int TQ>
cudaError_t launch(const Args& a) {
  auto kern = paged_attention_partial_kernel<QT, KVT, DH, TQ>;
  if (a.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
    if (e != cudaSuccess) return e;
  }
  const size_t rows = (size_t)a.B * a.H * a.splits * a.t;
  float* ws_acc = a.ws;
  float* ws_m = ws_acc + rows * DH;
  float* ws_l = ws_m + rows;
  const dim3 grid(a.splits * ((a.t + TQ - 1) / TQ), a.H, a.B);
  kern<<<grid, kThreads, a.smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KVT*>(a.pk),
      static_cast<const KVT*>(a.pv), a.bid, a.bval, a.lo_blk, a.floor_,
      a.filled, a.lengths, ws_acc, ws_m, ws_l, a.H, a.t, a.bt, a.ntab,
      a.tm, a.splits, a.scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  paged_attention_combine_kernel<QT, DH>
      <<<a.B * a.H * a.t, DH, sizeof(float) * (a.splits + 1), a.stream>>>(
          ws_acc, ws_m, ws_l, static_cast<QT*>(a.out), a.t, a.splits);
  return cudaGetLastError();
}

template <typename QT, typename KVT>
cudaError_t launch_shape(const Args& a) {
  if (a.dh == 64)
    return a.t == 1 ? launch<QT, KVT, 64, 1>(a)
                    : launch<QT, KVT, 64, kQueryTile>(a);
  if (a.dh == 128)
    return a.t == 1 ? launch<QT, KVT, 128, 1>(a)
                    : launch<QT, KVT, 128, kQueryTile>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory one pass-1 block needs; the wrapper checks it
// against the card's per-block limit before launching.
size_t dl4j_paged_attention_smem_bytes(int t, int dh, int bt,
                                       int kv_dtype) {
  const int kv_size = kv_dtype == 1 ? 2 : 4;
  const int tq = t == 1 ? 1 : kQueryTile;
  return ring_bytes(bt, dh, kv_size) + sizeof(float) * merge_floats(tq, dh);
}

// dtype codes: 0 = float32, 1 = bfloat16. q/out share q_dtype; pk/pv
// share kv_dtype. All index operands are int32 on the device; pointers
// to q, pk, pv and the workspace are 16-byte aligned. The workspace is
// f32: acc [B, H, splits, t, dh], then m and l [B, H, splits, t]. Launches
// both passes on ``stream`` and does not synchronise; returns the first
// launch error.
cudaError_t dl4j_paged_attention(const void* q, const void* pk,
                                 const void* pv, const void* bid,
                                 const void* bval, const void* lo_blk,
                                 const void* floor_, const void* filled,
                                 const void* lengths, void* out,
                                 void* workspace, int B, int H, int t,
                                 int dh, int bt, int ntab, int tm,
                                 int splits, float scale, int q_dtype,
                                 int kv_dtype, void* stream) {
  if (B < 1 || H < 1 || B > 65535 || H > 65535 || t < 1 || bt < 1 ||
      bt > 64 || (bt & (bt - 1)) || ntab < 1 || splits < 1 ||
      splits > ntab || splits >= 48 * 1024 / (int)sizeof(float))
    return cudaErrorInvalidValue;
  Args a{q, pk, pv,
         static_cast<const int*>(bid), static_cast<const int*>(bval),
         static_cast<const int*>(lo_blk), static_cast<const int*>(floor_),
         static_cast<const int*>(filled), static_cast<const int*>(lengths),
         out, static_cast<float*>(workspace),
         B, H, t, dh, bt, ntab, tm, splits, scale,
         dl4j_paged_attention_smem_bytes(t, dh, bt, kv_dtype),
         static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0 && kv_dtype == 0) return launch_shape<float, float>(a);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch_shape<__nv_bfloat16, float>(a);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_shape<float, __nv_bfloat16>(a);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_shape<__nv_bfloat16, __nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

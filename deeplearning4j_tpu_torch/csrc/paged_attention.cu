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
//
// Design (simple and right first): one thread block per (b, h); the
// block reads its own indices from global memory (a GPU has no scalar
// prefetch) and loops over j < ntab. Each live pool block's K and V
// tile [bt, dh] is converted to f32 in shared memory; scores, the
// running max / sum (m, l) and the output accumulator live in shared
// memory in f32. Scale is dh^-1/2, as in the TPU kernel.
//
// Skipping: a table entry that is unmapped, lies wholly below floor,
// or starts past the last query position holds no key any query may
// attend, so its probabilities are all exactly 0 and it contributes
// exactly nothing; the kernel skips its loads. (The TPU kernel DMAs
// block 0 for such entries instead.) Blocks past filled + len but
// inside the causal reach are still visited, because the pad queries
// of a masked chunk may attend them.
//
// What bounds it on the card: bytes. Decode attention does about
// 4 * dh flops per key for 2 * dh * 4 bytes of f32 K/V, about
// 0.5 flop per byte, far below the H100's ridge (~295 bf16 flops per
// byte); the least time is the live K/V bytes over 3.35 TB/s. This
// version walks the blocks one after another with no overlap of loads
// and compute and only B * H thread blocks in flight; split-K over
// blocks, cp.async / TMA double buffering and wgmma are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
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

template <typename QT, typename KVT, int DH>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const QT* __restrict__ q,
                       const KVT* __restrict__ pk,
                       const KVT* __restrict__ pv,
                       const int* __restrict__ bid,
                       const int* __restrict__ bval,
                       const int* __restrict__ lo_blk,
                       const int* __restrict__ floor_,
                       const int* __restrict__ filled,
                       const int* __restrict__ lengths,
                       QT* __restrict__ out,
                       int H, int t, int bt, int ntab, int tm,
                       float scale) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  float* qs = smem;              // [t, DH]
  float* acc = qs + t * DH;      // [t, DH]
  float* ks = acc + t * DH;      // [bt, DH]
  float* vs = ks + bt * DH;      // [bt, DH]
  float* sc = vs + bt * DH;      // [t, bt] scores, then probabilities
  float* m = sc + t * bt;        // [t] running max
  float* l = m + t;              // [t] running sum
  float* alpha = l + t;          // [t] this block's rescale factor

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;

  const QT* qp = q + (size_t)bh * t * DH;
  for (int i = tid; i < t * DH; i += kThreads) {
    qs[i] = to_f32(qp[i]);
    acc[i] = 0.f;
  }
  for (int i = tid; i < t; i += kThreads) {
    m[i] = kNeg;
    l[i] = 0.f;
  }
  const int lo = lo_blk[b];
  const int fl = floor_[b];
  const int fi = filled[b];
  const int vhi = fi + lengths[b];   // end of the written span
  const int qlast = fi + t - 1;      // last query position
  __syncthreads();

  for (int j = 0; j < ntab; ++j) {
    const int kbase = (lo + j) * bt;
    // uniform across the thread block: no divergence around the syncs
    if (bval[b * ntab + j] <= 0 || kbase + bt <= fl || kbase > qlast)
      continue;
    const size_t blk = (size_t)bid[b * ntab + j];
    for (int idx = tid; idx < bt * DH; idx += kThreads) {
      const int r = idx / DH;
      const int d = idx - r * DH;
      const size_t off = ((blk * bt + r) * H + h) * DH + d;
      const int kpos = kbase + r;
      const bool vlive = kpos < vhi && kpos >= fl;
      ks[idx] = to_f32(pk[off]);
      vs[idx] = vlive ? to_f32(pv[off]) : 0.f;
    }
    __syncthreads();
    // scores: one warp per (query, key) pair, lanes across dh
    for (int p = warp; p < t * bt; p += kWarps) {
      const int i = p / bt;
      const int r = p - i * bt;
      float s = 0.f;
#pragma unroll
      for (int d = lane; d < DH; d += 32) s += qs[i * DH + d] * ks[r * DH + d];
      s = warp_sum(s);
      if (lane == 0) {
        const int kpos = kbase + r;
        const int qpos = fi + i;
        const bool ok = kpos <= qpos && kpos > qpos - tm && kpos >= fl;
        sc[p] = ok ? s * scale : kNeg;
      }
    }
    __syncthreads();
    // online-softmax update: one warp per query
    for (int i = warp; i < t; i += kWarps) {
      float mx = kNeg;
      for (int r = lane; r < bt; r += 32) mx = fmaxf(mx, sc[i * bt + r]);
      mx = warp_max(mx);
      const float m_prev = m[i];
      const float m_next = fmaxf(m_prev, mx);
      const int qpos = fi + i;
      float sum = 0.f;
      for (int r = lane; r < bt; r += 32) {
        const int kpos = kbase + r;
        const bool ok = kpos <= qpos && kpos > qpos - tm && kpos >= fl;
        const float pr = ok ? expf(sc[i * bt + r] - m_next) : 0.f;
        sc[i * bt + r] = pr;
        sum += pr;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_prev - m_next);
        alpha[i] = a;
        l[i] = a * l[i] + sum;
        m[i] = m_next;
      }
    }
    __syncthreads();
    // acc = alpha * acc + P . V
    for (int idx = tid; idx < t * DH; idx += kThreads) {
      const int i = idx / DH;
      const int d = idx - i * DH;
      float v = 0.f;
      for (int r = 0; r < bt; ++r) v += sc[i * bt + r] * vs[r * DH + d];
      acc[idx] = alpha[i] * acc[idx] + v;
    }
    __syncthreads();
  }

  QT* op = out + (size_t)bh * t * DH;
  for (int idx = tid; idx < t * DH; idx += kThreads) {
    const float li = l[idx / DH];
    store(op + idx, acc[idx] / (li == 0.f ? 1.f : li));
  }
}

template <typename QT, typename KVT, int DH>
cudaError_t launch(const void* q, const void* pk, const void* pv,
                   const int* bid, const int* bval, const int* lo_blk,
                   const int* floor_, const int* filled,
                   const int* lengths, void* out, int B, int H, int t,
                   int bt, int ntab, int tm, float scale,
                   size_t smem_bytes, cudaStream_t stream) {
  auto kern = paged_attention_kernel<QT, KVT, DH>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes);
    if (e != cudaSuccess) return e;
  }
  kern<<<B * H, kThreads, smem_bytes, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(pk),
      static_cast<const KVT*>(pv), bid, bval, lo_blk, floor_, filled,
      lengths, static_cast<QT*>(out), H, t, bt, ntab, tm, scale);
  return cudaGetLastError();
}

template <typename QT, typename KVT>
cudaError_t launch_dh(int dh, const void* q, const void* pk,
                      const void* pv, const int* bid, const int* bval,
                      const int* lo_blk, const int* floor_,
                      const int* filled, const int* lengths, void* out,
                      int B, int H, int t, int bt, int ntab, int tm,
                      float scale, size_t smem, cudaStream_t s) {
  if (dh == 64)
    return launch<QT, KVT, 64>(q, pk, pv, bid, bval, lo_blk, floor_,
                               filled, lengths, out, B, H, t, bt, ntab,
                               tm, scale, smem, s);
  if (dh == 128)
    return launch<QT, KVT, 128>(q, pk, pv, bid, bval, lo_blk, floor_,
                                filled, lengths, out, B, H, t, bt, ntab,
                                tm, scale, smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs; the wrapper checks it against
// the card's per-block limit before launching.
size_t dl4j_paged_attention_smem_bytes(int t, int dh, int bt) {
  return sizeof(float) *
         ((size_t)2 * t * dh + (size_t)2 * bt * dh + (size_t)t * bt +
          (size_t)3 * t);
}

// dtype codes: 0 = float32, 1 = bfloat16. q/out share q_dtype; pk/pv
// share kv_dtype. All index operands are int32 on the device. Launches
// on ``stream`` and does not synchronise; returns the launch's error.
cudaError_t dl4j_paged_attention(const void* q, const void* pk,
                                 const void* pv, const void* bid,
                                 const void* bval, const void* lo_blk,
                                 const void* floor_, const void* filled,
                                 const void* lengths, void* out, int B,
                                 int H, int t, int dh, int bt, int ntab,
                                 int tm, float scale, int q_dtype,
                                 int kv_dtype, void* stream) {
  if (B < 1 || H < 1 || t < 1 || bt < 1 || bt > 64 || (bt & (bt - 1)) ||
      ntab < 1)
    return cudaErrorInvalidValue;
  const size_t smem = dl4j_paged_attention_smem_bytes(t, dh, bt);
  auto s = static_cast<cudaStream_t>(stream);
  auto ib = static_cast<const int*>(bid);
  auto iv = static_cast<const int*>(bval);
  auto il = static_cast<const int*>(lo_blk);
  auto ifl = static_cast<const int*>(floor_);
  auto ifi = static_cast<const int*>(filled);
  auto ilen = static_cast<const int*>(lengths);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_dh<float, float>(dh, q, pk, pv, ib, iv, il, ifl, ifi,
                                   ilen, out, B, H, t, bt, ntab, tm,
                                   scale, smem, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch_dh<__nv_bfloat16, float>(dh, q, pk, pv, ib, iv, il,
                                           ifl, ifi, ilen, out, B, H, t,
                                           bt, ntab, tm, scale, smem, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_dh<float, __nv_bfloat16>(dh, q, pk, pv, ib, iv, il,
                                           ifl, ifi, ilen, out, B, H, t,
                                           bt, ntab, tm, scale, smem, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_dh<__nv_bfloat16, __nv_bfloat16>(
        dh, q, pk, pv, ib, iv, il, ifl, ifi, ilen, out, B, H, t, bt, ntab,
        tm, scale, smem, s);
  return cudaErrorInvalidValue;
}

const char* dl4j_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

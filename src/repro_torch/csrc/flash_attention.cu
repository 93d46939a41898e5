// Flash attention forward (online softmax over KV tiles) for Hopper.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention/flash_attention.py (body `_kernel`;
// ops.py's `flash_attention_bh` vmaps it over batch and heads), and
// computes, for every batch row b and query head h,
//
//   out[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, h / G]) v[b, j, h / G]
//
// in float32, with G = Hq / Hkv query heads sharing one KV head (GQA).
// Causal: key j is visible to query i when j <= q_start[b] + i, absolute
// positions from 0 on the key axis (not right-aligned); hidden logits are
// -1e30, as in the TPU kernel, and l is floored at 1e-30.  q_start is 0
// for a prompt and the cache index for a decode step.  Keys j >= Skv do
// not exist (no padding is read).
//
// What bounds it on the card: memory, for decode (one query row per head
// against the cache: K and V are read once, 2 * Skv * Hkv * D floats per
// batch row) and for the serving prefill too (2 * Sq * Skv * Hq * D
// multiply-adds per batch row, a few MFLOP, against 0.4 MB of cache per
// layer).  The logits never leave the chip: the (32 x BK) tile lives in
// shared memory and the running (m, l, acc) in registers.
//
// What the design does about it: one block of 128 threads per (32 query
// rows, query head, batch row), 4 threads per query row.  A loop over KV
// tiles of BK rows stages K and V (widened to float) in shared memory,
// with the next tile's loads in flight in registers meanwhile so that
// their latency hides behind the arithmetic; it computes the tile's
// logits, updates the row's max and sum with warp shuffles among its 4
// threads, and adds P V into 16 (D = 64) register accumulators per
// thread.  Tiles that lie wholly beyond the causal limit
// of the block's last query are not visited: every one of their logits
// would be -1e30 below a finite row max, so they add exactly 0.  The
// inputs are read through their strides in the model's (B, S, H, D)
// layout, so no transposing copy is made.  IEEE float32, expf; no
// --use_fast_math.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kBQ = 32;
constexpr int kLanes = 4;                     // threads per query row
constexpr int kThreads = kBQ * kLanes;        // 128
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Strides {
  long long b, s, h;  // element strides of the batch, sequence, head axes
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, float* __restrict__ out,
                       const int* __restrict__ q_start, int Sq, int Skv,
                       int Hq, int Hkv, Strides qs_, Strides ks_,
                       Strides vs_, Strides os_, float scale, int causal) {
  constexpr int BK = (D <= 64) ? 32 : 16;     // KV rows per tile
  constexpr int PER_K = BK / kLanes;           // logits per thread per tile
  constexpr int PER_D = D / kLanes;            // output columns per thread
  __shared__ float qs[kBQ][D + 1];             // +1: rows on distinct banks
  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D];
  __shared__ float ps[kBQ][BK + 1];

  const int tid = threadIdx.x;
  const int row = tid / kLanes, lane = tid % kLanes;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const long long start = causal ? (long long)q_start[b] : 0;

  const T* qb = q + b * qs_.b + h * qs_.h;
  const T* kb = k + b * ks_.b + hk * ks_.h;
  const T* vb = v + b * vs_.b + hk * vs_.h;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int i = e / D, d = e % D;
    qs[i][d] = (q0 + i < Sq) ? widen(qb[(long long)(q0 + i) * qs_.s + d])
                             : 0.0f;
  }

  const long long qpos = start + q0 + row;
  long long kv_end = Skv;
  if (causal) {
    const int last_row = min(q0 + kBQ, Sq) - 1;
    kv_end = min(kv_end, start + last_row + 1);  // keys past it are hidden
  }

  float m_run = -INFINITY, l_run = 0.0f;
  float acc[PER_D];
#pragma unroll
  for (int c = 0; c < PER_D; ++c) acc[c] = 0.0f;

  // The next KV tile waits in registers while the current one is used:
  // its loads are all issued at once and their latency hides behind the
  // arithmetic.
  constexpr int PER_T = BK * D / kThreads;  // K (and V) values per thread
  T kr[PER_T], vr[PER_T];
  auto fetch = [&](long long kv0) {
#pragma unroll
    for (int r = 0; r < PER_T; ++r) {
      const int e = tid + r * kThreads;
      const long long kj = kv0 + e / D;
      if (kj < Skv) {                          // masked again when stored
        kr[r] = kb[kj * ks_.s + e % D];
        vr[r] = vb[kj * vs_.s + e % D];
      }
    }
  };
  if (kv_end > 0) fetch(0);

  for (long long kv0 = 0; kv0 < kv_end; kv0 += BK) {
    __syncthreads();  // the previous tile is read (and the q tile stored)
#pragma unroll
    for (int r = 0; r < PER_T; ++r) {
      const int e = tid + r * kThreads;
      const int j = e / D, d = e % D;
      const bool in = kv0 + j < Skv;
      ks[j][d] = in ? widen(kr[r]) : 0.0f;
      vs[j][d] = in ? widen(vr[r]) : 0.0f;
    }
    __syncthreads();
    if (kv0 + BK < kv_end) fetch(kv0 + BK);

    float s[PER_K];
    float tile_max = -INFINITY;
#pragma unroll
    for (int u = 0; u < PER_K; ++u) {
      const int j = lane + kLanes * u;
      float dot = 0.0f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(qs[row][d], ks[j][d], dot);
      float logit = dot * scale;
      const long long kpos = kv0 + j;
      if (kpos >= Skv) logit = -INFINITY;           // no such key
      else if (causal && kpos > qpos) logit = kMasked;
      s[u] = logit;
      tile_max = fmaxf(tile_max, logit);
    }
    // the 4 threads of a row are neighbouring lanes of one warp
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    // key kv0 always exists, so m_new is finite
    const float m_new = fmaxf(m_run, tile_max);
    const float alpha = expf(m_run - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int u = 0; u < PER_K; ++u) {
      const float p = expf(s[u] - m_new);
      ps[row][lane + kLanes * u] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_run = l_run * alpha + psum;
    m_run = m_new;
    __syncwarp();  // the row's p values, written by its 4 lanes

#pragma unroll
    for (int c = 0; c < PER_D; ++c) acc[c] *= alpha;
#pragma unroll 8
    for (int j = 0; j < BK; ++j) {
      const float p = ps[row][j];
#pragma unroll
      for (int c = 0; c < PER_D; ++c)
        acc[c] = fmaf(p, vs[j][lane + kLanes * c], acc[c]);
    }
  }

  if (q0 + row < Sq) {
    const float l = fmaxf(l_run, 1e-30f);
    float* ob = out + b * os_.b + (long long)(q0 + row) * os_.s + h * os_.h;
#pragma unroll
    for (int c = 0; c < PER_D; ++c) ob[lane + kLanes * c] = acc[c] / l;
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* out,
            const int* q_start, int B, int Sq, int Skv, int Hq, int Hkv,
            Strides qs, Strides ks, Strides vs, Strides os, float scale,
            int causal, cudaStream_t stream) {
  const dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)Hq,
                  (unsigned)B);
  flash_attention_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(out), q_start, Sq, Skv,
      Hq, Hkv, qs, ks, vs, os, scale, causal);
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* out,
             const int* q_start, int B, int Sq, int Skv, int Hq, int Hkv,
             Strides qs, Strides ks, Strides vs, Strides os, float scale,
             int causal, cudaStream_t s) {
  switch (D) {
    case 16: launch<T, 16>(q, k, v, out, q_start, B, Sq, Skv, Hq, Hkv, qs, ks,
                           vs, os, scale, causal, s); break;
    case 32: launch<T, 32>(q, k, v, out, q_start, B, Sq, Skv, Hq, Hkv, qs, ks,
                           vs, os, scale, causal, s); break;
    case 64: launch<T, 64>(q, k, v, out, q_start, B, Sq, Skv, Hq, Hkv, qs, ks,
                           vs, os, scale, causal, s); break;
    case 128: launch<T, 128>(q, k, v, out, q_start, B, Sq, Skv, Hq, Hkv, qs,
                             ks, vs, os, scale, causal, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// q: (B, Sq, Hq, D), k, v: (B, Skv, Hkv, D), out: (B, Sq, Hq, D) float32,
// each given by its (batch, sequence, head) element strides with the D axis
// contiguous; q_start: (B,) int32 on the card.  bf16: 0 = float32 inputs,
// 1 = bfloat16.  D is 16, 32, 64 or 128.  Returns cudaGetLastError() after
// the launch: 0 when it was accepted.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out,
    const void* q_start, int bf16, int B, int Sq, int Skv, int Hq, int Hkv,
    int D, const long long* q_strides, const long long* k_strides,
    const long long* v_strides, const long long* o_strides, float scale,
    int causal, void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0) return 0;
  if (Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  const Strides qs{q_strides[0], q_strides[1], q_strides[2]};
  const Strides ks{k_strides[0], k_strides[1], k_strides[2]};
  const Strides vs{v_strides[0], v_strides[1], v_strides[2]};
  const Strides os{o_strides[0], o_strides[1], o_strides[2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qst = static_cast<const int*>(q_start);
  const int rc = bf16
      ? launch_d<__nv_bfloat16>(D, q, k, v, out, qst, B, Sq, Skv, Hq, Hkv, qs,
                                ks, vs, os, scale, causal, s)
      : launch_d<float>(D, q, k, v, out, qst, B, Sq, Skv, Hq, Hkv, qs, ks, vs,
                        os, scale, causal, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

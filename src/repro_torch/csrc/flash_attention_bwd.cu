// Flash attention backward for Hopper, with grouped KV heads.
//
// The gradient of the forward in flash_attention.cu, which replaces the
// Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention/flash_attention.py (body `_kernel`).
// The Pallas kernel has no backward: the JAX package differentiates the
// model's attention (repro/models/transformer.py, `_attention_dynwin`)
// with XLA's autodiff.  This kernel computes that same gradient, dq, dk
// and dv of
//
//   out[b, i, h] = sum_j P_ij V_j,   P_ij = softmax_j(scale * q_i . k_j)
//
// for q, k, v of one type (float32 or bfloat16), dout float32, with the
// type rules of the plain version's autograd
// (repro_torch/kernels/flash_attention/ref.py, `ref_attention_gqa`):
// with `round_p` and a bfloat16 V, the forward rounds P to bfloat16
// before P V, so dV sums the rounded P and dP = dout . v is rounded to
// bfloat16 before the softmax backward; then
//
//   D_i  = sum_j P_ij dP_ij               (P unrounded, dP as used)
//   dS_ij = P_ij (dP_ij - D_i) scale
//   dq_i = sum_j dS_ij k_j,  dk_j = sum_(i, g) dS_ij q_i,
//   dv_j = sum_(i, g) P_ij dout_i    (the sums over (i, g) take every query
//                                     head g of KV head j's group)
//
// (D is rowsum(dout * out) only when P is not rounded).  Each gradient is
// written in its input's type.  Causal: key j is visible to query i of
// batch row b when j <= q_start[b] + i, as in the forward.
//
// Two kernels behind one entry point, no floating-point atomics: every
// output element is summed by one thread in a fixed order, so two calls
// give the same bits.
//
// 1. rows: a block serves 4 warps x RW rows r = i * G + g (query i, head g
//    of one KV head's group; RW = 4 at head_dim 64, 2 at 128).  It walks
//    the visible keys three times in chunks of 32, one key a lane, K (and
//    V) widened to float32 in shared memory: (a) each lane's online max
//    and sum of exponentials, merged across the warp in a fixed tree;
//    (b) D_i; (c) dS_ij into shared memory, then one column a lane sums
//    dq_i over the chunk's keys in key order.  It writes dq and the row
//    statistics (M, L, D) for (2).
// 2. keys: a block serves 4 warps x KW keys of one KV head (KW = RW); it
//    walks the rows that can see its keys in chunks of 32, one row a
//    lane, recomputes P and dS from (M, L, D), and sums dk and dv over
//    the rows in row order (all G heads of the group within the block).
//
// What bounds it on the card: at SmolLM-135M's training shape (B 16,
// S 256, 9/3 heads, head_dim 64; float32 q, k, v, as the QAT model gives
// them) a layer's gradient reads q, k, v, dout and writes dq, dk, dv,
// ~41 MB (12 us at 3.35 TB/s), and needs 5 products over the visible
// (query head, key) pairs (q.k and dout.v again, then dq, dk, dv): ~3.0
// GFLOP, 45 us at the CUDA cores' 67 TFLOP/s, so it is bound by
// operations.  This first version runs on the CUDA cores with float4
// shared-memory reads and recomputes q.k three times in the rows kernel;
// tensor cores (three bf16 parts, as the forward), fewer passes, wgmma
// and TMA are later work.  Nothing is allocated; the wrapper passes the
// statistics' scratch.  The launches run on the caller's stream.  IEEE
// float32, expf and division; no --use_fast_math.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;     // keys (rows kernel) or rows (keys kernel): a lane each

struct Args {
  const void* q; const void* k; const void* v; const float* dout;
  const int* q_start;
  void* dq; void* dk; void* dv;
  float* stat_m; float* stat_l; float* stat_d;   // (B, Sq, Hq) each
  int Sq, Skv, Hq, Hkv, G;
  float scale;
  int causal, round_dp;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T narrow(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// scale * q.k, rounded before the max is subtracted (no fma contraction),
// in every pass and both kernels: the row's max logit then gives
// exp(0) = 1 exactly, as in the plain version.
__device__ __forceinline__ float logit(float s, float scale) {
  return __fmul_rn(s, scale);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Element offset of (b, s, h, 0) in a contiguous (B, S, H, D) tensor.
__device__ __forceinline__ long long at(int b, int s, int h, int S, int H,
                                        int D) {
  return (((long long)b * S + s) * H + h) * D;
}

// The warp's sum of x, in a fixed tree (lane 0's order), given to every lane.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return __shfl_sync(0xffffffffu, x, 0);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_down_sync(0xffffffffu, x, o));
  return __shfl_sync(0xffffffffu, x, 0);
}

// s[u] = a[u] . b over D columns, a[u] row `row0 + u` of a (R, D) array in
// shared memory (the same address in every lane: a broadcast), b a row of
// this lane; both 16-byte aligned.  Columns in order, one fma each.
template <int N, int D, int LD>
__device__ __forceinline__ void dots(const float (*a)[LD], int row0,
                                     const float* b, float (&s)[N]) {
#pragma unroll
  for (int u = 0; u < N; ++u) s[u] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 y = *reinterpret_cast<const float4*>(b + d);
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const float4 x = *reinterpret_cast<const float4*>(&a[row0 + u][d]);
      s[u] = fmaf(x.x, y.x, s[u]);
      s[u] = fmaf(x.y, y.y, s[u]);
      s[u] = fmaf(x.z, y.z, s[u]);
      s[u] = fmaf(x.w, y.w, s[u]);
    }
  }
}

// Rows [n0, n0 + n) of a contiguous (B, S, H, D) tensor at (b, ., h),
// widened into dst[0 .. n) (rows past `end` are zero).
template <typename T, int D, int LD>
__device__ __forceinline__ void load_rows(float (*dst)[LD], const T* src,
                                          int b, int n0, int n, int end,
                                          int h, int S, int H) {
  for (int e = threadIdx.x; e < n * D; e += kThreads) {
    const int rl = e / D, d = e % D, s = n0 + rl;
    dst[rl][d] = s < end ? widen(src[at(b, s, h, S, H, D) + d]) : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// 1. rows: statistics, D and dq
// ---------------------------------------------------------------------------

// Block (tile, hk, b) of the grid (ceil(G * Sq / RB), Hkv, B): rows
// [tile * RB, +RB) of KV head hk of batch row b; warp w takes rows
// tile * RB + w * RW + u, u < RW.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) rows_kernel(const Args a) {
  constexpr int RW = 256 / D;          // rows a warp
  constexpr int RB = kWarps * RW;      // rows a block
  constexpr int KP = D + 4;            // a key's padded row: float4 reads, no bank conflicts
  constexpr int DL = D / 32;           // columns a lane in the dq sums
  __shared__ __align__(16) float Qs[RB][D];
  __shared__ __align__(16) float Os[RB][D];
  __shared__ __align__(16) float Ks[kChunk][KP];
  __shared__ __align__(16) float Vs[kChunk][KP];
  __shared__ float Ss[kWarps][RW][kChunk];

  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z, hk = blockIdx.y, G = a.G;
  const int total = G * a.Sq, r0 = blockIdx.x * RB;
  const int start = a.causal ? a.q_start[b] : 0;
  const int last = min(total, r0 + RB) - 1;
  const int kv_end = a.causal ? min(a.Skv, start + last / G + 1) : a.Skv;

  for (int e = tid; e < RB * D; e += kThreads) {
    const int rl = e / D, d = e % D, r = r0 + rl;
    float x = 0.0f, o = 0.0f;
    if (r < total) {
      const long long off = at(b, r / G, hk * G + r % G, a.Sq, a.Hq, D) + d;
      x = widen(q[off]);
      o = a.dout[off];
    }
    Qs[rl][d] = x;
    Os[rl][d] = o;
  }
  int lim[RW];                          // each row's keys: [0, lim)
#pragma unroll
  for (int u = 0; u < RW; ++u) {
    const int r = r0 + warp * RW + u;
    lim[u] = r >= total ? 0
             : a.causal ? min(a.Skv, start + r / G + 1) : a.Skv;
  }
  const int row0 = warp * RW;

  // (a) max and sum of exponentials: one online softmax a lane, merged
  float m[RW], l[RW];
#pragma unroll
  for (int u = 0; u < RW; ++u) { m[u] = -INFINITY; l[u] = 0.0f; }
  for (int c0 = 0; c0 < kv_end; c0 += kChunk) {
    __syncthreads();
    load_rows<T, D, KP>(Ks, k, b, c0, kChunk, kv_end, hk, a.Skv, a.Hkv);
    __syncthreads();
    float s[RW];
    dots<RW, D, D>(Qs, row0, Ks[lane], s);
    const int j = c0 + lane;
#pragma unroll
    for (int u = 0; u < RW; ++u) {
      if (j >= lim[u]) continue;
      const float x = logit(s[u], a.scale);
      if (x > m[u]) {
        l[u] = (m[u] == -INFINITY ? 0.0f : l[u] * expf(m[u] - x)) + 1.0f;
        m[u] = x;
      } else {
        l[u] += expf(x - m[u]);
      }
    }
  }
  float M[RW], L[RW];
#pragma unroll
  for (int u = 0; u < RW; ++u) {
    M[u] = warp_max(m[u]);
    L[u] = warp_sum(m[u] == -INFINITY ? 0.0f : l[u] * expf(m[u] - M[u]));
  }

  // (b) D = sum_j P dP
  float dsum[RW];
#pragma unroll
  for (int u = 0; u < RW; ++u) dsum[u] = 0.0f;
  for (int c0 = 0; c0 < kv_end; c0 += kChunk) {
    __syncthreads();
    load_rows<T, D, KP>(Ks, k, b, c0, kChunk, kv_end, hk, a.Skv, a.Hkv);
    load_rows<T, D, KP>(Vs, v, b, c0, kChunk, kv_end, hk, a.Skv, a.Hkv);
    __syncthreads();
    float s[RW], o[RW];
    dots<RW, D, D>(Qs, row0, Ks[lane], s);
    dots<RW, D, D>(Os, row0, Vs[lane], o);
    const int j = c0 + lane;
#pragma unroll
    for (int u = 0; u < RW; ++u) {
      if (j >= lim[u]) continue;
      const float p = expf(logit(s[u], a.scale) - M[u]) / L[u];
      const float dp = a.round_dp ? round_bf16(o[u]) : o[u];
      dsum[u] += p * dp;
    }
  }
  float Dr[RW];
#pragma unroll
  for (int u = 0; u < RW; ++u) Dr[u] = warp_sum(dsum[u]);

  // (c) dq_i = sum_j dS_ij k_j, one column a lane, keys in order
  float acc[RW][DL];
#pragma unroll
  for (int u = 0; u < RW; ++u)
#pragma unroll
    for (int t = 0; t < DL; ++t) acc[u][t] = 0.0f;
  for (int c0 = 0; c0 < kv_end; c0 += kChunk) {
    __syncthreads();
    load_rows<T, D, KP>(Ks, k, b, c0, kChunk, kv_end, hk, a.Skv, a.Hkv);
    load_rows<T, D, KP>(Vs, v, b, c0, kChunk, kv_end, hk, a.Skv, a.Hkv);
    __syncthreads();
    float s[RW], o[RW];
    dots<RW, D, D>(Qs, row0, Ks[lane], s);
    dots<RW, D, D>(Os, row0, Vs[lane], o);
    const int j = c0 + lane;
#pragma unroll
    for (int u = 0; u < RW; ++u) {
      float ds = 0.0f;
      if (j < lim[u]) {
        const float p = expf(logit(s[u], a.scale) - M[u]) / L[u];
        const float dp = a.round_dp ? round_bf16(o[u]) : o[u];
        ds = p * (dp - Dr[u]) * a.scale;
      }
      Ss[warp][u][lane] = ds;
    }
    __syncwarp();
    const int n = min(kChunk, kv_end - c0);
    for (int jj = 0; jj < n; ++jj) {
#pragma unroll
      for (int u = 0; u < RW; ++u) {
        const float w = Ss[warp][u][jj];
#pragma unroll
        for (int t = 0; t < DL; ++t)
          acc[u][t] = fmaf(w, Ks[jj][lane + 32 * t], acc[u][t]);
      }
    }
    __syncwarp();
  }

  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int u = 0; u < RW; ++u) {
    const int r = r0 + row0 + u;
    if (r >= total) continue;
    const int i = r / G, h = hk * G + r % G;
    const long long off = at(b, i, h, a.Sq, a.Hq, D);
#pragma unroll
    for (int t = 0; t < DL; ++t)
      dq[off + lane + 32 * t] = narrow<T>(acc[u][t]);
    if (lane == 0) {
      const long long si = ((long long)b * a.Sq + i) * a.Hq + h;
      a.stat_m[si] = M[u];
      a.stat_l[si] = L[u];
      a.stat_d[si] = Dr[u];
    }
  }
}

// ---------------------------------------------------------------------------
// 2. keys: dk and dv
// ---------------------------------------------------------------------------

// Block (tile, hk, b) of the grid (ceil(Skv / KB), Hkv, B): keys [tile *
// KB, +KB) of KV head hk of batch row b; warp w takes keys tile * KB + w
// * KW + u, u < KW.  The rows r = i * G + g that can see the block's first
// key come in chunks of 32 (r from (j0 - q_start) * G when causal).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) keys_kernel(const Args a) {
  constexpr int KW = 256 / D;          // keys a warp
  constexpr int KB = kWarps * KW;      // keys a block
  constexpr int QP = D + 4;            // a row's padded copy
  constexpr int DL = D / 32;
  __shared__ __align__(16) float Kk[KB][D];
  __shared__ __align__(16) float Vk[KB][D];
  __shared__ __align__(16) float Qs[kChunk][QP];
  __shared__ __align__(16) float Os[kChunk][QP];
  __shared__ float Ms[kChunk], Ls[kChunk], Ds[kChunk];
  __shared__ int Lim[kChunk];
  __shared__ float Ps[kWarps][KW][kChunk];
  __shared__ float Ss[kWarps][KW][kChunk];

  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z, hk = blockIdx.y, G = a.G;
  const int total = G * a.Sq, j0 = blockIdx.x * KB;
  const int start = a.causal ? a.q_start[b] : 0;

  load_rows<T, D, D>(Kk, k, b, j0, KB, a.Skv, hk, a.Skv, a.Hkv);
  load_rows<T, D, D>(Vk, v, b, j0, KB, a.Skv, hk, a.Skv, a.Hkv);
  const long long first = a.causal ? max(0LL, (long long)j0 - start) * G : 0;
  const int key0 = warp * KW;

  float dk[KW][DL], dv[KW][DL];
#pragma unroll
  for (int u = 0; u < KW; ++u)
#pragma unroll
    for (int t = 0; t < DL; ++t) { dk[u][t] = 0.0f; dv[u][t] = 0.0f; }

  for (long long c = first; c < total; c += kChunk) {
    const int c0 = (int)c;
    __syncthreads();
    for (int e = tid; e < kChunk * D; e += kThreads) {
      const int rl = e / D, d = e % D, r = c0 + rl;
      float x = 0.0f, o = 0.0f;
      if (r < total) {
        const long long off = at(b, r / G, hk * G + r % G, a.Sq, a.Hq, D) + d;
        x = widen(q[off]);
        o = a.dout[off];
      }
      Qs[rl][d] = x;
      Os[rl][d] = o;
    }
    if (tid < kChunk) {
      const int r = c0 + tid;
      float mm = 0.0f, ll = 1.0f, dd = 0.0f;
      int lim = 0;
      if (r < total) {
        const int i = r / G;
        const long long si = ((long long)b * a.Sq + i) * a.Hq + hk * G + r % G;
        mm = a.stat_m[si];
        ll = a.stat_l[si];
        dd = a.stat_d[si];
        lim = a.causal ? min(a.Skv, start + i + 1) : a.Skv;
      }
      Ms[tid] = mm; Ls[tid] = ll; Ds[tid] = dd; Lim[tid] = lim;
    }
    __syncthreads();
    // one row a lane: P and dS of this lane's row against the warp's keys
    float s[KW], o[KW];
    {
      // dots of the lane's row with each key: the key rows are the
      // broadcast operand, the lane's row the per-lane one
#pragma unroll
      for (int u = 0; u < KW; ++u) { s[u] = 0.0f; o[u] = 0.0f; }
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float4 x = *reinterpret_cast<const float4*>(&Qs[lane][d]);
        const float4 y = *reinterpret_cast<const float4*>(&Os[lane][d]);
#pragma unroll
        for (int u = 0; u < KW; ++u) {
          const float4 kk = *reinterpret_cast<const float4*>(&Kk[key0 + u][d]);
          const float4 vv = *reinterpret_cast<const float4*>(&Vk[key0 + u][d]);
          s[u] = fmaf(x.x, kk.x, s[u]);
          s[u] = fmaf(x.y, kk.y, s[u]);
          s[u] = fmaf(x.z, kk.z, s[u]);
          s[u] = fmaf(x.w, kk.w, s[u]);
          o[u] = fmaf(y.x, vv.x, o[u]);
          o[u] = fmaf(y.y, vv.y, o[u]);
          o[u] = fmaf(y.z, vv.z, o[u]);
          o[u] = fmaf(y.w, vv.w, o[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < KW; ++u) {
      const int j = j0 + key0 + u;
      float p = 0.0f, ds = 0.0f;
      if (j < Lim[lane]) {
        p = expf(logit(s[u], a.scale) - Ms[lane]) / Ls[lane];
        const float dp = a.round_dp ? round_bf16(o[u]) : o[u];
        ds = p * (dp - Ds[lane]) * a.scale;
        if (a.round_dp) p = round_bf16(p);    // the P that P V used
      }
      Ps[warp][u][lane] = p;
      Ss[warp][u][lane] = ds;
    }
    __syncwarp();
    const int n = min((long long)kChunk, total - c);
    for (int rr = 0; rr < n; ++rr) {
#pragma unroll
      for (int u = 0; u < KW; ++u) {
        const float pw = Ps[warp][u][rr], sw = Ss[warp][u][rr];
#pragma unroll
        for (int t = 0; t < DL; ++t) {
          dv[u][t] = fmaf(pw, Os[rr][lane + 32 * t], dv[u][t]);
          dk[u][t] = fmaf(sw, Qs[rr][lane + 32 * t], dk[u][t]);
        }
      }
    }
    __syncwarp();
  }

  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int u = 0; u < KW; ++u) {
    const int j = j0 + key0 + u;
    if (j >= a.Skv) continue;
    const long long off = at(b, j, hk, a.Skv, a.Hkv, D);
#pragma unroll
    for (int t = 0; t < DL; ++t) {
      dkp[off + lane + 32 * t] = narrow<T>(dk[u][t]);
      dvp[off + lane + 32 * t] = narrow<T>(dv[u][t]);
    }
  }
}

template <typename T, int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int RB = kWarps * (256 / D), KB = RB;
  const dim3 rows_grid((a.G * a.Sq + RB - 1) / RB, a.Hkv, B);
  rows_kernel<T, D><<<rows_grid, kThreads, 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 keys_grid((a.Skv + KB - 1) / KB, a.Hkv, B);
  keys_kernel<T, D><<<keys_grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const Args& a, int B, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: contiguous (B, Sq, Hq, D), (B, Skv, Hkv, D) of one type
// (bf16 = 1: bfloat16, else float32); dout: contiguous float32 like q;
// dq, dk, dv: like q, k, v; stats: 3 * B * Sq * Hq floats of scratch.
// Returns 0 or the CUDA error of a refused launch.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* q_start, void* dq, void* dk, void* dv, void* stats,
    int bf16, int B, int Sq, int Skv, int Hq, int Hkv, int D, float scale,
    int causal, int round_p, void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0) return 0;
  if (Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.dout = static_cast<const float*>(dout);
  a.q_start = static_cast<const int*>(q_start);
  a.dq = dq; a.dk = dk; a.dv = dv;
  const long long n = (long long)B * Sq * Hq;
  a.stat_m = static_cast<float*>(stats);
  a.stat_l = a.stat_m + n;
  a.stat_d = a.stat_l + n;
  a.Sq = Sq; a.Skv = Skv; a.Hq = Hq; a.Hkv = Hkv; a.G = Hq / Hkv;
  a.scale = scale;
  a.causal = causal;
  a.round_dp = round_p && bf16;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_d<__nv_bfloat16>(D, a, B, s)
              : dispatch_d<float>(D, a, B, s);
}

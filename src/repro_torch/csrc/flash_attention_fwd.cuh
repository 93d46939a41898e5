// Flash attention forward for Hopper, with grouped KV heads.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention/flash_attention.py (body `_kernel`;
// ops.py's `flash_attention_bh` vmaps it over batch and heads), and
// computes, for every batch row b and query head h,
//
//   out[b, i, h] = sum_j p_ij v[b, j, h / G],
//   p_ij = softmax_j(scale * q[b, i, h] . k[b, j, h / G])
//
// in float32, with G = Hq / Hkv query heads sharing one KV head (GQA), and
// the reference model's type rules (repro/models/transformer.py,
// `_attention_dynwin`): K is rounded to q's type before the product (the
// products are then exact in float32), and with `round_p` the
// probabilities are rounded to V's type before P V.  Causal: key j is
// visible to query i when j <= p = q_start[b] + i, absolute positions
// from 0 on the key axis, and with a sliding window (`window` > 0, the
// local layers of Gemma 2 and 3) also when j > p - window; hidden keys add
// exactly 0 (the reference's -1e30 logits), so they are skipped.  Keys j
// >= Skv do not exist.  With `softcap` > 0 (Gemma 2) the scaled logit s
// becomes softcap * tanhf(s / softcap) before the mask, as the reference
// computes it (IEEE division; tanhf within 2 ulp).
//
// A block serves rows r = i * G + g (query i, head g of one KV head's
// group), so every K/V row it reads serves all G query heads at once.
// Two kernels; the wrapper picks one and its launch plan
// (repro_torch/kernels/flash_attention/flash_attention.py, `plan`), and
// the entry: flash_attention.cu's builds them without the window and the
// soft-cap, flash_attention_masked.cu's with (MASK):
//
// 1. split (decode: at most 8 rows a KV head): 4 or 8 rows a block on the
//    CUDA cores.  What bounds a decode step on the card is the cache rows
//    up to the index (0.84 MB a layer for SmolLM-135M's 4 slots: 0.25 us
//    at 3.35 TB/s), so a launch is bound by latency: the launch, one
//    memory round trip, the merge.  The visible keys [kv_begin, kv_end)
//    (kv_begin: the first key the block's first row sees; 0 without a
//    window) are split evenly across the blocks of a thread-block cluster
//    (at most 8).  In a block, D/4 lanes share a key (4 columns each, one
//    16-byte load of K and one of V, all of a thread's loads issued at
//    once; at head_dim 256, 32 lanes of 8 columns, so that a key stays in
//    one warp; at head_dim 112, 32 lanes of which 28 hold 4 columns and 4
//    stay idle, so that a key's lanes are a power of two), so a warp
//    reads whole rows; each key group keeps its own online softmax (m, l,
//    acc) over its keys, with no barrier in the loop.  The groups'
//    partials meet in shared memory in group order, the blocks' through
//    distributed shared memory in rank order: two calls give the same bits.
//
// 2. mma (prefill): 64 rows a block, keys in chunks of 64 copied with
//    cp.async (the next chunk in flight while one is multiplied), 8 warps:
//    4 row groups of 16 x 2 halves of each chunk's keys.  Q K^T runs on the
//    bf16 tensor cores (mma.sync m16n8k16, float32 accumulators): a
//    bfloat16 q and K rounded to bf16 are exact, a float32 q and K are
//    three bf16 parts each (hi + mid + lo == x exactly, so each of the 9
//    products is exact); each 16-deep step sums into zeroed fragments that
//    are added to an IEEE float32 total.  The probabilities stay in
//    registers as the A operand of P V (the accumulator layout of m16n8 is
//    the A layout of m16n8k16); P V multiplies bf16 parts too: P and a
//    float32 V as three parts each, a bfloat16 V as itself, and P rounded
//    to bf16 (round_p with a bfloat16 V) as itself: 9, 3 or 1 passes.  The
//    halves meet in shared memory; when the plan splits the keys across a
//    cluster (while each block has an SM of its own), the ranks meet as in
//    (1).  What bounds it: the bytes and the float32 P V on the card's
//    peak rates are ~1 us for SmolLM-135M's prefill; a launch is bound by
//    its chain of latencies with few warps an SM.  Up to head_dim 128 (a
//    64-row block's accumulators at 256 would not fit the registers), a
//    float32 q up to 64; the other prefill shapes take the wgmma kernel
//    of flash_attention_wgmma.cu.
//
// The window and the soft-cap are the template parameter MASK of both
// kernels: a launch without either runs kernels without their branches.
//
// K and V may also be float8_e4m3fn (an fp8 K/V cache; q stays float32
// or bfloat16), built by flash_attention_fp8.cu.  Every e4m3 value (3
// mantissa bits, exponents 2^-9 .. 448) is exact in bf16 and in float32,
// so K and V are converted in registers and enter the products as one
// exact bf16 part (the mma kernel) or as floats (the split kernel): P V
// is still summed in float32 (no fp8 tensor-core product, whose
// accumulator keeps fewer bits).
//
// One rank's slice of the keys (the sequence-sharded cache): `mode` 1
// (stats) and 2 (pass 2) take K and V as the rank's rows and a q_start
// shifted by the slice's first row, so that q_start may be negative and a
// row may see no key of the slice.  Such a row has M = -inf, L = 0 and
// adds exactly 0.  Mode 1 writes each row's (M, L) over the slice to
// `stats` (M at [row], L at [stat_plane + row], row = (b * Sq + i) * Hq +
// h) and, unless round_p needs two passes, the slice's output normalized
// by its own L (0 for an empty row); with two passes it runs the first
// pass alone.  Mode 2 reads the group's (M, L) from `stats` and runs the
// second pass over the slice: p = exp(s - M) / L (rounded with round_p),
// out = the slice's P V.  The ranks' outputs then sum to the group's.
//
// Both kernels run one online-softmax pass, except with round_p and a
// bfloat16 or e4m3 V: the rounding needs the final max M and sum L
// before any P V, so a first pass computes (M, L) (merged as above) and a
// second forms p = exp(s - M) / L, rounds it to V's type and accumulates
// P V; the logits of the two passes are the same bits.  Chunks and tiles past the causal
// limit of a block's last query, or below the window of its first, are
// never visited.  The inputs are read
// through their strides in the model's (B, S, H, D) layout: no copy.
// Vector loads of K and V (and the mma kernel's 16-byte cp.async copies)
// need rows on a 16-byte boundary; the wrapper tests it and passes `vec`
// = 0 otherwise, for element loads of the same kernels.  Nothing is
// allocated; the launch runs on the caller's stream.  IEEE float32, expf
// and division; no --use_fast_math.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

using fp8 = __nv_fp8_e4m3;

constexpr int kThreads = 128;
constexpr int kMaxSplits = 8;    // a portable cluster size
constexpr int kMmaRows = 64;     // 4 row groups x 16 rows
constexpr int kMmaWarps = 8;     // 4 row groups x 2 key halves
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaKeys = 64;     // keys of a chunk
constexpr long long kAll = 1LL << 62;
enum Mode { kWhole = 0, kStats = 1, kPass2 = 2 };   // Args::mode

struct Strides {
  long long b, s, h;  // element strides of the batch, sequence, head axes
};

struct Args {
  const void* q; const void* k; const void* v; float* out;
  const int* q_start;
  int Sq, Skv, Hkv, G;
  Strides qs, ks, vs, os;
  float scale, softcap;   // softcap 0: off
  int window;             // 0: global
  int causal, round_p, two_pass, vec;
  int splits;   // the cluster's blocks along the keys
  int mode;     // kWhole, kStats or kPass2 (the header)
  float* stats;              // modes 1 and 2: M then L, stat_plane each
  long long stat_plane;      // B * Sq * Hq
};

// The index of row r (query r / G, head hk * G + r % G) of batch row b in
// a (B, Sq, Hq) plane of `stats`.
__device__ __forceinline__ long long stat_at(const Args& a, int b, int hk,
                                             int r) {
  const int i = r / a.G, h = hk * a.G + r % a.G;
  return ((long long)b * a.Sq + i) * ((long long)a.Hkv * a.G) + h;
}
__device__ __forceinline__ void put_stats(const Args& a, int b, int hk, int r,
                                          float m, float l) {
  const long long at = stat_at(a, b, hk, r);
  a.stats[at] = m;
  a.stats[a.stat_plane + at] = l;
}
// acc / l, or 0 for a row that saw no key of the slice (l = 0).
__device__ __forceinline__ float normalized(float acc, float l) {
  return l > 0.0f ? acc / l : 0.0f;
}

// An e4m3 code as a float (exact: through the f16 conversion).
__device__ __forceinline__ float e4m3_float(__nv_fp8_storage_t x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x, __NV_E4M3)));
}
// Two e4m3 codes (low byte first) as floats.
__device__ __forceinline__ float2 e4m3x2_float2(uint16_t x) {
  return __half22float2(
      __half2(__nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)x, __NV_E4M3)));
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(fp8 v) { return e4m3_float(v.__x); }

// x rounded to T, as a float (to e4m3: to nearest even; the probabilities
// it takes lie in [0, 1], far from the saturation at 448).
template <typename T>
__device__ __forceinline__ float round_to(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <>
__device__ __forceinline__ float round_to<fp8>(float x) {
  return e4m3_float(__nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3));
}

template <typename T>
__device__ __forceinline__ T zero_of() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}
template <>
__device__ __forceinline__ fp8 zero_of<fp8>() {
  fp8 z;
  z.__x = 0;
  return z;
}

__device__ __forceinline__ uint32_t bits2(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// Four consecutive elements of a row, as floats: one vector load when
// `vec` (the row is on a 4-element boundary), else four.
__device__ __forceinline__ void load4(const float* p, bool vec,
                                      float (&o)[4]) {
  if (vec) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    o[0] = f.x; o[1] = f.y; o[2] = f.z; o[3] = f.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c] = p[c];
  }
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, bool vec,
                                      float (&o)[4]) {
  if (vec) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = unpack2(u.x), b = unpack2(u.y);
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c] = __bfloat162float(p[c]);
  }
}

__device__ __forceinline__ void load4(const fp8* p, bool vec,
                                      float (&o)[4]) {
  if (vec) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    const float2 a = e4m3x2_float2((uint16_t)(u & 0xffffu));
    const float2 b = e4m3x2_float2((uint16_t)(u >> 16));
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c] = widen(p[c]);
  }
}

// C consecutive elements of a row (C a multiple of 4), as floats.
template <typename T, int C>
__device__ __forceinline__ void loadc(const T* p, bool vec, float (&o)[C]) {
#pragma unroll
  for (int c = 0; c < C; c += 4) {
    float t[4];
    load4(p + c, vec, t);
#pragma unroll
    for (int e = 0; e < 4; ++e) o[c + e] = t[e];
  }
}

// MASK (a template parameter of both kernels) is true when the launch
// has a window or a soft-cap: without either the kernels compile without
// their branches on every logit and row.

// The logit of a dot product: scaled, then soft-capped when softcap > 0,
// in the reference's order (s = dot * scale; c * tanh(s / c)).
template <bool MASK>
__device__ __forceinline__ float logit(float dot, const Args& a) {
  const float s = dot * a.scale;
  if (MASK && a.softcap > 0.0f) return a.softcap * tanhf(s / a.softcap);
  return s;
}

// The first key the row at position p sees: p - window + 1, or 0.
template <bool MASK>
__device__ __forceinline__ long long first_key(long long p, const Args& a) {
  if constexpr (!MASK) return 0;
  return a.window > 0 ? p - a.window + 1 : 0;
}

// The factor that carries a partial softmax at max m_old to max m_new
// (>= m_old); 0 for an empty partial (m_old = -inf, l = 0, acc = 0).
__device__ __forceinline__ float rescale(float m_old, float m_new) {
  return m_old == -INFINITY ? 0.0f : expf(m_old - m_new);
}

// Every thread of the cluster arrives and waits; the shared-memory writes
// before it are seen by every block after it.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The same, ordering nothing: no block leaves while others still read its
// shared memory.
__device__ __forceinline__ void cluster_barrier_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n"
               "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// 1. split: CUDA cores, split-KV across a cluster
// ---------------------------------------------------------------------------

// The least power of two >= x.
__host__ __device__ constexpr int pow2_ceil(int x) {
  return x <= 1 ? 1 : 2 * pow2_ceil((x + 1) / 2);
}

// Block (rank, tile, b * Hkv + hk) of the grid (S, ceil(G * Sq / RB),
// B * Hkv): rows [tile * RB, +RB) of KV head hk of batch row b, keys
// [kv_begin + rank * span, +span) of [kv_begin, kv_end), span =
// ceil((kv_end - kv_begin) / S).  Thread t: key group t / LPK, columns
// (t % LPK) * CPL .. +CPL-1; chunk c holds keys k0 + c * CH + u * NK +
// group, u < U.  Where D / CPL is not a power of two (head_dim 112: 28
// lanes of 4 columns), a key takes the next power of two of lanes (32)
// and the lanes past D hold zeros and load nothing, so that a key's
// lanes still fill one warp's shuffles.  The wrapper's `block_rows`,
// `block_keys`, `lane_columns` and `key_lanes` use the same formulas.
template <typename TQ, typename TKV, int D, int RB, bool MASK>
__global__ void __launch_bounds__(kThreads)
split_kernel(const Args a) {
  constexpr int CPL = D > 128 ? D / 32 : 4;   // columns of a lane
  constexpr int LPK = pow2_ceil(D / CPL);   // lanes of a key, one warp at most
  constexpr bool kIdle = LPK * CPL != D;    // lanes past D (head_dim 112)
  constexpr int NK = kThreads / LPK;      // key groups of a block
  constexpr int U = 16 / RB;              // keys a group holds at once
  constexpr int CH = NK * U;              // keys of a chunk
  __shared__ float red[NK * RB * D];      // the groups' acc
  __shared__ float red_m[NK * RB], red_l[NK * RB], fac[NK * RB];
  __shared__ float part[RB * D];          // the block's acc (read remotely)
  __shared__ float part_m[RB], part_l[RB], stat_m[RB], stat_l[RB];
  __shared__ float fin_f[kMaxSplits * RB], fin_m[RB], fin_l[RB];

  const TQ* __restrict__ q = static_cast<const TQ*>(a.q);
  const TKV* __restrict__ k = static_cast<const TKV*>(a.k);
  const TKV* __restrict__ v = static_cast<const TKV*>(a.v);
  const int tid = threadIdx.x, kg = tid / LPK, li = tid % LPK;
  const bool cols = !kIdle || li * CPL < D;   // the lane holds columns
  const int S = gridDim.x;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (S > 1) ? (int)cluster.block_rank() : 0;
  const int rows = a.G * a.Sq;
  const int r0 = blockIdx.y * RB;
  const int b = blockIdx.z / a.Hkv, hk = blockIdx.z % a.Hkv;
  const long long start = a.causal ? (long long)a.q_start[b] : 0;

  float qv[RB][CPL];
  long long lim[RB];   // the row's last visible key; -1 for no row
  long long lo[RB];    // the row's first visible key
#pragma unroll
  for (int rr = 0; rr < RB; ++rr) {
    const int r = r0 + rr;
    const bool valid = r < rows;
    const int i = r / a.G, h = hk * a.G + r % a.G;
    lim[rr] = !valid ? -1 : (a.causal ? start + i : kAll);
    lo[rr] = valid ? first_key<MASK>(start + i, a) : 0;
    const TQ* qr = q + b * a.qs.b + (long long)i * a.qs.s
                   + (long long)h * a.qs.h + li * CPL;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      qv[rr][c] = (valid && cols) ? widen(qr[c]) : 0.0f;
  }
  const int last = min(rows, r0 + RB) - 1;
  const long long kv_end =
      a.causal ? max(0LL, min((long long)a.Skv, start + last / a.G + 1))
               : (long long)a.Skv;
  const long long kv_begin =
      min(kv_end, max(0LL, first_key<MASK>(start + r0 / a.G, a)));
  const long long span = (kv_end - kv_begin + S - 1) / S;
  const long long k0 = min(kv_end, kv_begin + rank * span);
  const long long k1 = min(kv_end, k0 + span);
  const int nchunks = (int)((k1 - k0 + CH - 1) / CH);
  const TKV* kb = k + b * a.ks.b + (long long)hk * a.ks.h + li * CPL;
  const TKV* vb = v + b * a.vs.b + (long long)hk * a.vs.h + li * CPL;
  const bool vec = a.vec;

  float kr[U][CPL], vr[U][CPL], s[U][RB];
  auto load = [&](int c) {   // all of the chunk's loads issued together
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long j = k0 + (long long)c * CH + u * NK + kg;
#pragma unroll
      for (int e = 0; e < CPL; ++e) kr[u][e] = vr[u][e] = 0.0f;
      if (j < k1 && cols) {
        loadc(kb + j * a.ks.s, vec, kr[u]);
        loadc(vb + j * a.vs.s, vec, vr[u]);
      }
    }
  };
  auto scores = [&](int c) {   // every lane of a group gets the same bits
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long j = k0 + (long long)c * CH + u * NK + kg;
      float kq[CPL];
#pragma unroll
      for (int e = 0; e < CPL; ++e) kq[e] = round_to<TQ>(kr[u][e]);
#pragma unroll
      for (int rr = 0; rr < RB; ++rr) {
        float dot = 0.0f;
#pragma unroll
        for (int e = 0; e < CPL; ++e) dot = fmaf(qv[rr][e], kq[e], dot);
#pragma unroll
        for (int o = 1; o < LPK; o <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[u][rr] = (j < k1 && j <= lim[rr] && (!MASK || j >= lo[rr]))
                       ? logit<MASK>(dot, a) : -INFINITY;
      }
    }
  };

  float m[RB], l[RB], acc[RB][CPL];
#pragma unroll
  for (int rr = 0; rr < RB; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.0f;
#pragma unroll
    for (int e = 0; e < CPL; ++e) acc[rr][e] = 0.0f;
  }
  // One online-softmax step over the chunk's keys; with `pv` the chunk's
  // p v is added too.
  auto online = [&](bool pv) {
#pragma unroll
    for (int rr = 0; rr < RB; ++rr) {
      float mc = -INFINITY;
#pragma unroll
      for (int u = 0; u < U; ++u) mc = fmaxf(mc, s[u][rr]);
      const float mn = fmaxf(m[rr], mc);
      const float f = rescale(m[rr], mn);
      l[rr] *= f;
      if (pv) {
#pragma unroll
        for (int e = 0; e < CPL; ++e) acc[rr][e] *= f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = (s[u][rr] == -INFINITY) ? 0.0f : expf(s[u][rr] - mn);
        l[rr] += p;
        if (pv) {
#pragma unroll
          for (int e = 0; e < CPL; ++e)
            acc[rr][e] = fmaf(p, vr[u][e], acc[rr][e]);
        }
      }
      m[rr] = mn;
    }
  };

  auto remote = [&](float* p, int r) {
    return (S > 1) ? cluster.map_shared_rank(p, r) : p;
  };
  // The block's (m, l) (and acc) into pm, pl (and part): the key groups'
  // partials added in group order.
  auto block_merge = [&](bool with_acc, float* pm, float* pl) {
    if (li == 0) {
#pragma unroll
      for (int rr = 0; rr < RB; ++rr) {
        red_m[kg * RB + rr] = m[rr];
        red_l[kg * RB + rr] = l[rr];
      }
    }
    if (with_acc && cols) {
#pragma unroll
      for (int rr = 0; rr < RB; ++rr)
#pragma unroll
        for (int e = 0; e < CPL; ++e)
          red[(kg * RB + rr) * D + li * CPL + e] = acc[rr][e];
    }
    __syncthreads();
    if (tid < RB) {
      float mx = -INFINITY;
      for (int gi = 0; gi < NK; ++gi) mx = fmaxf(mx, red_m[gi * RB + tid]);
      pm[tid] = mx;
    }
    __syncthreads();
    for (int e = tid; e < NK * RB; e += kThreads)
      fac[e] = rescale(red_m[e], pm[e % RB]);
    __syncthreads();
    if (tid < RB) {
      float sum = 0.0f;
      for (int gi = 0; gi < NK; ++gi)
        sum += red_l[gi * RB + tid] * fac[gi * RB + tid];
      pl[tid] = sum;
    }
    if (with_acc) {
      for (int e = tid; e < RB * D; e += kThreads) {
        const int rr = e / D;
        float sum = 0.0f;
        for (int gi = 0; gi < NK; ++gi)
          sum += red[gi * RB * D + e] * fac[gi * RB + rr];
        part[e] = sum;
      }
    }
    if (S > 1) cluster_barrier(); else __syncthreads();
  };
  // The cluster's (M, L) from every rank's (pm, pl) in rank order, the
  // same bits in every block; fin_f[r] carries rank r's partial to M.
  auto cluster_merge = [&](float* pm, float* pl) {
    if (tid < RB) {
      float mr[kMaxSplits];
      float mx = -INFINITY;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {
        mr[r] = (r < S) ? remote(pm, r)[tid] : -INFINITY;
        mx = fmaxf(mx, mr[r]);
      }
      float sum = 0.0f;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {
        if (r < S) {
          const float f = rescale(mr[r], mx);
          fin_f[r * RB + tid] = f;
          sum += remote(pl, r)[tid] * f;
        }
      }
      fin_m[tid] = mx;
      fin_l[tid] = sum;
    }
    __syncthreads();
  };

  const int mode = a.mode;
  const bool two = a.two_pass || mode == kPass2;
  if (mode == kPass2) {   // the group's (M, L) of each row
#pragma unroll
    for (int rr = 0; rr < RB; ++rr) {
      const bool valid = r0 + rr < rows;
      const long long at = valid ? stat_at(a, b, hk, r0 + rr) : 0;
      m[rr] = valid ? a.stats[at] : 0.0f;
      l[rr] = valid ? a.stats[a.stat_plane + at] : 1.0f;
    }
  } else if (two) {   // pass 1: the cluster's (M, L) before any p is formed
    for (int c = 0; c < nchunks; ++c) {
      load(c);
      scores(c);
      online(false);
    }
    block_merge(false, stat_m, stat_l);
    cluster_merge(stat_m, stat_l);
    if (mode == kStats) {   // the slice's (M, L) alone
      if (rank == 0 && tid < RB && r0 + tid < rows)
        put_stats(a, b, hk, r0 + tid, fin_m[tid], fin_l[tid]);
      if (S > 1) cluster_barrier_relaxed();   // no block leaves while read
      return;
    }
#pragma unroll
    for (int rr = 0; rr < RB; ++rr) {
      m[rr] = fin_m[rr];
      l[rr] = fin_l[rr];
    }
  }
  for (int c = 0; c < nchunks; ++c) {
    // one chunk stays in registers from pass 1
    if (!two || nchunks > 1 || mode == kPass2) {
      load(c);
      scores(c);
    }
    if (!two) {
      online(true);
      continue;
    }
#pragma unroll
    for (int rr = 0; rr < RB; ++rr)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float p = (s[u][rr] == -INFINITY) ? 0.0f
                                          : expf(s[u][rr] - m[rr]) / l[rr];
        if (a.round_p) p = round_to<TKV>(p);
#pragma unroll
        for (int e = 0; e < CPL; ++e)
          acc[rr][e] = fmaf(p, vr[u][e], acc[rr][e]);
      }
  }
  if (two) {   // acc holds normalized sums: carried with factor 1
#pragma unroll
    for (int rr = 0; rr < RB; ++rr) {
      m[rr] = 0.0f;
      l[rr] = 0.0f;
    }
  }
  block_merge(true, part_m, part_l);
  cluster_merge(part_m, part_l);
  if (mode == kStats && rank == 0 && tid < RB && r0 + tid < rows)
    put_stats(a, b, hk, r0 + tid, fin_m[tid], fin_l[tid]);

  // rank q of S writes elements q * kThreads + tid, ... of the tile
  for (int e = rank * kThreads + tid; e < RB * D; e += S * kThreads) {
    const int rr = e / D, d = e % D, r = r0 + rr;
    if (r >= rows) continue;
    float sum = 0.0f;
#pragma unroll
    for (int q2 = 0; q2 < kMaxSplits; ++q2)
      if (q2 < S) sum += remote(part, q2)[e] * fin_f[q2 * RB + rr];
    const int i = r / a.G, h = hk * a.G + r % a.G;
    a.out[b * a.os.b + (long long)i * a.os.s + (long long)h * a.os.h + d] =
        two ? sum : normalized(sum, fin_l[rr]);
  }
  if (S > 1) cluster_barrier_relaxed();   // no block leaves while read
}

// ---------------------------------------------------------------------------
// 2. mma: bf16 tensor cores, bfloat16 q
// ---------------------------------------------------------------------------

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Two float32 values as three pairs of bf16 parts, exactly:
// v = hi + mid + lo (each cvt rounds a pair to nearest).
__device__ __forceinline__ void split3(float2 v, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __float22bfloat162_rn(v);
  const float2 hf = __bfloat1622float2(h);
  const float2 r = make_float2(v.x - hf.x, v.y - hf.y);
  const __nv_bfloat162 m = __float22bfloat162_rn(r);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l =
      __float22bfloat162_rn(make_float2(r.x - mf.x, r.y - mf.y));
  hi = bits2(h);
  mid = bits2(m);
  lo = bits2(l);
}

// Shared memory of the mma kernel (dynamic: it passes 48 KB): the K chunk
// as KP bf16 parts of its rows, then V's VP parts as 32-bit words holding
// the bf16 pair (key 2p, key 2p + 1) of one column, then the raw K and V
// rows of the next chunk as they arrive (cp.async).  After the last chunk
// the two key halves' acc (2 x 64 rows x D) and the block's merged acc
// (64 x D) take their place.
template <typename TQ, typename TKV, int D>
struct MmaSmem {
  static constexpr bool QF = sizeof(TQ) == 4;
  static constexpr int QP = QF ? 3 : 1;                        // q parts
  static constexpr int KP = (QF && sizeof(TKV) == 4) ? 3 : 1;  // K parts
  static constexpr int VP = (sizeof(TKV) == 4) ? 3 : 1;        // V parts
  static constexpr int KLD = D + 8;   // bf16 elements a key row
  static constexpr int VLD = D + 8;   // words a key-pair row
  static constexpr int kbytes = KP * kMmaKeys * KLD * 2;
  static constexpr int vbytes = VP * (kMmaKeys / 2) * VLD * 4;
  static constexpr int RAW = kMmaKeys * D * (int)sizeof(TKV);  // a chunk
  static constexpr int raw_off = kbytes + vbytes;
  static constexpr int chunk_bytes = raw_off + 2 * RAW;        // K and V
  static constexpr int acc_bytes = 3 * kMmaRows * D * 4;
  static constexpr int bytes =
      chunk_bytes > acc_bytes ? chunk_bytes : acc_bytes;
  static_assert(raw_off % 16 == 0, "16-byte copies");
};

// Block (tile * S + rank, hk, b) of the grid (ceil(G * Sq / 64) * S, Hkv,
// B), S = the cluster's blocks: rows [tile * 64, +64) of KV head hk of
// batch row b; the tile's keys [kv_begin, kv_end) in chunks of 64 (chunk
// c0 = kv_begin / 64 on), chunks [c0 + rank * span, +span) of them, span
// = ceil(chunks / S).  8
// warps: warp w takes rows (w % 4) * 16 .. +15 against keys (w / 4) * 32
// .. +31 of every chunk (its key half), with its own online softmax; the
// halves meet in shared memory, the ranks through distributed shared
// memory, both in a fixed order.  A float32 q and a float32 K are three
// bf16 parts each (9 exact products a pair); K is rounded to bf16 for a
// bfloat16 q.
template <typename TQ, typename TKV, int D, bool MASK>
__global__ void __launch_bounds__(kMmaThreads)
mma_kernel(const Args a) {
  using SM = MmaSmem<TQ, TKV, D>;
  constexpr int QP = SM::QP, KP = SM::KP;
  constexpr int HK = kMmaKeys / 2;    // keys of a warp's half chunk
  constexpr int NT = HK / 8;          // key tiles of a half chunk
  constexpr int DT = D / 8;           // column tiles of the output
  constexpr int KW = SM::KLD / 2;     // words a K row
  constexpr int T = kMmaThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_m[2 * kMmaRows], red_l[2 * kMmaRows];
  __shared__ float half_f[2 * kMmaRows];
  __shared__ float part_m[kMmaRows], part_l[kMmaRows];
  __shared__ float stat_m[kMmaRows], stat_l[kMmaRows];
  __shared__ float fin_f[kMaxSplits * kMmaRows], fin_m[kMmaRows],
      fin_l[kMmaRows];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  uint32_t* vw = reinterpret_cast<uint32_t*>(smem + SM::kbytes);
  float* red = reinterpret_cast<float*>(smem);    // after the last chunk
  float* part = red + 2 * kMmaRows * D;

  const TQ* __restrict__ q = static_cast<const TQ*>(a.q);
  const TKV* __restrict__ k = static_cast<const TKV*>(a.k);
  const TKV* __restrict__ v = static_cast<const TKV*>(a.v);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rg = warp & 3, kh = warp >> 2;   // row group, key half
  const int row0 = rg * 16 + g;              // the thread's rows: +0, +8
  const int S = a.splits;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (S > 1) ? (int)cluster.block_rank() : 0;
  const int rows = a.G * a.Sq;
  const int r0 = (blockIdx.x / S) * kMmaRows;
  const int hk = blockIdx.y, b = blockIdx.z;
  const long long start = a.causal ? (long long)a.q_start[b] : 0;
  const int mode = a.mode;
  const bool vec = a.vec, two = a.two_pass || mode == kPass2;

  // The thread's rows and their q as A fragments (QP bf16 parts).
  long long lim[2], lo[2];
  uint32_t qa[QP][D / 16][4];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = r0 + row0 + 8 * h2;
    const bool valid = r < rows;
    const int i = r / a.G, h = hk * a.G + r % a.G;
    lim[h2] = !valid ? -1 : (a.causal ? start + i : kAll);
    lo[h2] = valid ? first_key<MASK>(start + i, a) : 0;
    const TQ* qr = q + b * a.qs.b + (long long)i * a.qs.s
                   + (long long)h * a.qs.h;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c0 = kk * 16 + 8 * half + 2 * t4;
        const float2 x = valid ? make_float2(widen(qr[c0]), widen(qr[c0 + 1]))
                               : make_float2(0.0f, 0.0f);
        if constexpr (QP == 1) {
          qa[0][kk][2 * half + h2] = bits2(__float22bfloat162_rn(x));  // exact
        } else {
          split3(x, qa[0][kk][2 * half + h2], qa[1][kk][2 * half + h2],
                 qa[2][kk][2 * half + h2]);
        }
      }
  }
  const int last = min(rows, r0 + kMmaRows) - 1;
  const long long kv_end =
      a.causal ? max(0LL, min((long long)a.Skv, start + last / a.G + 1))
               : (long long)a.Skv;
  const long long kv_begin =
      min(kv_end, max(0LL, first_key<MASK>(start + r0 / a.G, a)));
  const int c_first = (int)(kv_begin / kMmaKeys);
  const int c_end = (int)((kv_end + kMmaKeys - 1) / kMmaKeys);
  const int span = (c_end - c_first + S - 1) / S;
  const int c_lo = min(c_end, c_first + rank * span);
  const int c_hi = min(c_end, c_lo + span);
  const TKV* kb = k + b * a.ks.b + (long long)hk * a.ks.h;
  const TKV* vb = v + b * a.vs.b + (long long)hk * a.vs.h;
  unsigned char* rk = smem + SM::raw_off;
  unsigned char* rv = rk + SM::RAW;

  // Trip counts are compile-time: a thread's elements are e = tid + it * T
  // for it below a constant.
  // Chunk c's raw K (and V) rows: 16-byte cp.async copies, all in flight
  // at once, zeros past kv_end; element loads when the rows are off 16
  // bytes.
  auto copy = [&](int c, bool with_v) {
    const long long j0 = (long long)c * kMmaKeys;
    if (vec) {
      constexpr int CPR = D * (int)sizeof(TKV) / 16;   // copies a row
      constexpr int NC = kMmaKeys * CPR;
#pragma unroll
      for (int it = 0; it < (NC + T - 1) / T; ++it) {
        const int e = tid + it * T;
        if (NC % T && e >= NC) break;
        const long long j = j0 + e / CPR;
        const int off = (e % CPR) * 16;
        const bool ok = j < kv_end;
        cp_async16(rk + e * 16,
                   ok ? reinterpret_cast<const char*>(kb + j * a.ks.s) + off
                      : reinterpret_cast<const char*>(kb),
                   ok ? 16 : 0);
        if (with_v)
          cp_async16(rv + e * 16,
                     ok ? reinterpret_cast<const char*>(vb + j * a.vs.s) + off
                        : reinterpret_cast<const char*>(vb),
                     ok ? 16 : 0);
      }
    } else {
      TKV* tk = reinterpret_cast<TKV*>(rk);
      TKV* tv = reinterpret_cast<TKV*>(rv);
      constexpr int NE = kMmaKeys * D;
      static_assert(NE % T == 0, "element loads");
#pragma unroll 4
      for (int it = 0; it < NE / T; ++it) {
        const int e = tid + it * T;
        const long long j = j0 + e / D;
        const int d = e % D;
        const bool ok = j < kv_end;
        tk[e] = ok ? kb[j * a.ks.s + d] : zero_of<TKV>();
        if (with_v) tv[e] = ok ? vb[j * a.vs.s + d] : zero_of<TKV>();
      }
    }
    cp_async_commit();
  };
  // The raw rows into the operands of the mmas: K's parts (K rounded to
  // bf16 for a bfloat16 q), V's parts.
  auto convert = [&](bool with_v) {
    const TKV* tk = reinterpret_cast<const TKV*>(rk);
    const TKV* tv = reinterpret_cast<const TKV*>(rv);
    constexpr int KG = kMmaKeys * D / 4;
#pragma unroll
    for (int it = 0; it < (KG + T - 1) / T; ++it) {
      const int e = tid + it * T;
      if (KG % T && e >= KG) break;
      const int key = e / (D / 4), d4 = (e % (D / 4)) * 4;
      float f[4];
      load4(tk + key * D + d4, true, f);
      uint32_t w[KP][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 x = make_float2(f[2 * h], f[2 * h + 1]);
        if constexpr (KP == 1) {
          w[0][h] = bits2(__float22bfloat162_rn(x));   // K in q's type
        } else {
          split3(x, w[0][h], w[1][h], w[2][h]);
        }
      }
#pragma unroll
      for (int p = 0; p < KP; ++p)
        *reinterpret_cast<uint2*>(ks + (p * kMmaKeys + key) * SM::KLD + d4) =
            make_uint2(w[p][0], w[p][1]);
    }
    if (!with_v) return;
    constexpr int VG = kMmaKeys / 2 * D / 4;
#pragma unroll
    for (int it = 0; it < (VG + T - 1) / T; ++it) {
      const int e = tid + it * T;
      if (VG % T && e >= VG) break;
      const int pr = e / (D / 4), d4 = (e % (D / 4)) * 4;
      float f0[4], f1[4];
      load4(tv + (2 * pr) * D + d4, true, f0);
      load4(tv + (2 * pr + 1) * D + d4, true, f1);
      uint32_t w[SM::VP][4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float2 x = make_float2(f0[cc], f1[cc]);
        if constexpr (SM::VP == 1) {
          w[0][cc] = bits2(__float22bfloat162_rn(x));   // exact
        } else {
          split3(x, w[0][cc], w[1][cc], w[2][cc]);
        }
      }
#pragma unroll
      for (int p = 0; p < SM::VP; ++p)
        *reinterpret_cast<uint4*>(
            vw + (p * (kMmaKeys / 2) + pr) * SM::VLD + d4) =
            make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
    }
  };

  // logits, then p, of the warp's key half: sacc[nt] = (row 0, keys 2t4,
  // 2t4 + 1 of key tile kh * 4 + nt), (row 8, ..)
  float sacc[NT][4];
  auto scores = [&](int c) {
    const uint32_t* kw = reinterpret_cast<const uint32_t*>(ks);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) sacc[nt][r] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      float t[NT][4];   // independent accumulators: the mmas pipeline
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) t[nt][r] = 0.0f;
#pragma unroll
      for (int kp = 0; kp < KP; ++kp) {
        uint32_t bf[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint32_t* row =
              kw + (kp * kMmaKeys + kh * HK + nt * 8 + g) * KW;
          bf[nt][0] = row[kk * 8 + t4];
          bf[nt][1] = row[kk * 8 + 4 + t4];
        }
#pragma unroll
        for (int qp = 0; qp < QP; ++qp)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(t[nt], qa[qp][kk], bf[nt]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) sacc[nt][r] += t[nt][r];
    }
    // key x of the half is visible to row h2 when vlo[h2] <= x <= vis[h2]
    // (32-bit)
    const long long base = (long long)c * kMmaKeys + kh * HK;
    int vis[2], vlo[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      vis[h2] = (int)max(-1LL, min((long long)HK,
                                   min(kv_end - 1, lim[h2]) - base));
      vlo[h2] = (int)max(0LL, min((long long)HK, lo[h2] - base));
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int x = nt * 8 + 2 * t4 + (r & 1);
        sacc[nt][r] = (x <= vis[r >> 1] && (!MASK || x >= vlo[r >> 1]))
                          ? logit<MASK>(sacc[nt][r], a) : -INFINITY;
      }
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  if (mode == kPass2) {   // the group's (M, L) of the thread's rows
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = r0 + row0 + 8 * h2;
      const long long at = r < rows ? stat_at(a, b, hk, r) : 0;
      m[h2] = r < rows ? a.stats[at] : 0.0f;
      l[h2] = r < rows ? a.stats[a.stat_plane + at] : 1.0f;
    }
  }
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.0f;

  // One online-softmax step (the row max is shared by the 4 lanes of a
  // row, l stays a per-lane partial); with `pv`, acc is carried and the
  // logits become p = exp(s - m).
  auto online = [&](bool pv) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float mc = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mc = fmaxf(mc, fmaxf(sacc[nt][2 * h2], sacc[nt][2 * h2 + 1]));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      const float mn = fmaxf(m[h2], mc);
      const float f = rescale(m[h2], mn);
      l[h2] *= f;
      if (pv) {
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          acc[j][2 * h2] *= f;
          acc[j][2 * h2 + 1] *= f;
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& s = sacc[nt][2 * h2 + e];
          const float p = (s == -INFINITY) ? 0.0f : expf(s - mn);
          l[h2] += p;
          s = p;
        }
      m[h2] = mn;
    }
  };
  auto quad_sum = [&](float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
  };

  // acc += P V over the warp's key half on the tensor cores, P in PP bf16
  // parts and V in VP.
  auto pv = [&](auto pp_count) {
    constexpr int PP = decltype(pp_count)::value;
#pragma unroll
    for (int kq = 0; kq < HK / 16; ++kq) {
      const float2 x[4] = {
          make_float2(sacc[2 * kq][0], sacc[2 * kq][1]),
          make_float2(sacc[2 * kq][2], sacc[2 * kq][3]),
          make_float2(sacc[2 * kq + 1][0], sacc[2 * kq + 1][1]),
          make_float2(sacc[2 * kq + 1][2], sacc[2 * kq + 1][3])};
      uint32_t pa[PP][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if constexpr (PP == 1) {
          pa[0][r] = bits2(__float22bfloat162_rn(x[r]));   // exact
        } else {
          split3(x[r], pa[0][r], pa[1][r], pa[2][r]);
        }
      }
      float t[DT][4];   // independent accumulators: the mmas pipeline
#pragma unroll
      for (int dn = 0; dn < DT; ++dn)
#pragma unroll
        for (int r = 0; r < 4; ++r) t[dn][r] = 0.0f;
      const int pair0 = kh * (HK / 2) + kq * 8;   // the key pairs' row
#pragma unroll
      for (int vp = 0; vp < SM::VP; ++vp) {
        uint32_t bf[DT][2];
#pragma unroll
        for (int dn = 0; dn < DT; ++dn) {
          const uint32_t* col =
              vw + vp * (kMmaKeys / 2) * SM::VLD + dn * 8 + g;
          bf[dn][0] = col[(pair0 + t4) * SM::VLD];
          bf[dn][1] = col[(pair0 + 4 + t4) * SM::VLD];
        }
#pragma unroll
        for (int p = 0; p < PP; ++p)
#pragma unroll
          for (int dn = 0; dn < DT; ++dn) mma_bf16(t[dn], pa[p], bf[dn]);
      }
#pragma unroll
      for (int dn = 0; dn < DT; ++dn)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[dn][r] += t[dn][r];
    }
  };

  // The two key halves' (m, l) (and acc) of each row into pm, pl (and
  // part), half 0 first.  Ends with the block's threads in step.
  auto halves_merge = [&](bool with_acc, float* pm, float* pl) {
    if (t4 == 0) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        red_m[kh * kMmaRows + row0 + 8 * h2] = m[h2];
        red_l[kh * kMmaRows + row0 + 8 * h2] = l[h2];
      }
    }
    if (with_acc) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int dn = 0; dn < DT; ++dn)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            red[(kh * kMmaRows + row0 + 8 * h2) * D + dn * 8 + 2 * t4 + e] =
                acc[dn][2 * h2 + e];
    }
    __syncthreads();
    if (tid < kMmaRows) {
      const float m0 = red_m[tid], m1 = red_m[kMmaRows + tid];
      const float mx = fmaxf(m0, m1);
      const float f0 = rescale(m0, mx), f1 = rescale(m1, mx);
      half_f[tid] = f0;
      half_f[kMmaRows + tid] = f1;
      pm[tid] = mx;
      pl[tid] = red_l[tid] * f0 + red_l[kMmaRows + tid] * f1;
    }
    __syncthreads();
    if (with_acc) {
      for (int e = tid; e < kMmaRows * D; e += T) {
        const int row = e / D;
        part[e] = red[e] * half_f[row]
                  + red[kMmaRows * D + e] * half_f[kMmaRows + row];
      }
    }
  };
  auto remote = [&](float* p, int r) {
    return (S > 1) ? cluster.map_shared_rank(p, r) : p;
  };
  // The cluster's (M, L) of each row from every rank's (pm, pl) in rank
  // order, the same bits in every block; fin_f[r] carries rank r's
  // partial to M.  Ends with the block's threads in step.
  auto cluster_merge = [&](float* pm, float* pl) {
    if (S > 1) cluster_barrier(); else __syncthreads();
    if (tid < kMmaRows) {
      float mr[kMaxSplits];
      float mx = -INFINITY;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {
        mr[r] = (r < S) ? remote(pm, r)[tid] : -INFINITY;
        mx = fmaxf(mx, mr[r]);
      }
      float sum = 0.0f;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {
        if (r < S) {
          const float f = rescale(mr[r], mx);
          fin_f[r * kMmaRows + tid] = f;
          sum += remote(pl, r)[tid] * f;
        }
      }
      fin_m[tid] = mx;
      fin_l[tid] = sum;
    }
    __syncthreads();
  };

  // Pass 0 (round_p with a bfloat16 V only): (M, L) of every row, over the
  // whole cluster, before any p is formed.  Pass 1: P V.  Chunk c + 1 is
  // copied while chunk c is multiplied.
  for (int pass = (two && mode != kPass2) ? 0 : 1; pass < 2; ++pass) {
    const bool with_v = pass == 1;
    if (c_lo < c_hi) copy(c_lo, with_v);
    for (int c = c_lo; c < c_hi; ++c) {
      cp_async_wait<0>();   // this thread's copies of chunk c landed
      __syncthreads();      // everyone's; the previous operands are read
      convert(with_v);
      __syncthreads();      // the raw rows are free again
      if (c + 1 < c_hi) copy(c + 1, with_v);
      scores(c);
      if (!with_v) {
        online(false);
        continue;
      }
      if (!two) {
        online(true);
        pv(std::integral_constant<int, 3>());
        continue;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float& s = sacc[nt][r];
          const float p =
              (s == -INFINITY) ? 0.0f : expf(s - m[r >> 1]) / l[r >> 1];
          s = a.round_p ? round_to<TKV>(p) : p;
        }
      if (a.round_p && sizeof(TKV) <= 2)   // P exact in one bf16 part
        pv(std::integral_constant<int, 1>());
      else
        pv(std::integral_constant<int, 3>());
    }
    if (pass == 0 || !two) {
      l[0] = quad_sum(l[0]);
      l[1] = quad_sum(l[1]);
    }
    if (pass == 0) {   // the cluster's (M, L) for pass 1
      halves_merge(false, stat_m, stat_l);
      cluster_merge(stat_m, stat_l);
      if (mode == kStats) {   // the slice's (M, L) alone
        if (rank == 0 && tid < kMmaRows && r0 + tid < rows)
          put_stats(a, b, hk, r0 + tid, fin_m[tid], fin_l[tid]);
        if (S > 1) cluster_barrier_relaxed();   // no block leaves while read
        return;
      }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        m[h2] = fin_m[row0 + 8 * h2];
        l[h2] = fin_l[row0 + 8 * h2];
      }
    }
  }

  // With two passes acc is already normalized: factor 1.
  __syncthreads();   // every warp is done with the chunk buffers
  if (two) {
    m[0] = m[1] = 0.0f;
    l[0] = l[1] = 0.0f;
  }
  if (S == 1) {
    // The block holds every key: the warps of key half 1 hand their
    // partials to those of half 0, which merge (half 0 first) and store
    // from registers.
    constexpr int RP = D + 8;   // row pitch: rows g on distinct banks
    if (kh == 1) {
      if (t4 == 0) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          red_m[row0 + 8 * h2] = m[h2];
          red_l[row0 + 8 * h2] = l[h2];
        }
      }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int dn = 0; dn < DT; ++dn)
          *reinterpret_cast<float2*>(
              red + (row0 + 8 * h2) * RP + dn * 8 + 2 * t4) =
              make_float2(acc[dn][2 * h2], acc[dn][2 * h2 + 1]);
    }
    __syncthreads();
    if (kh == 1) return;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int row = row0 + 8 * h2, r = r0 + row;
      if (r >= rows) continue;
      const float m1 = red_m[row];
      const float mx = fmaxf(m[h2], m1);
      const float f0 = rescale(m[h2], mx), f1 = rescale(m1, mx);
      const float sum_l = l[h2] * f0 + red_l[row] * f1;
      if (mode == kStats && t4 == 0) put_stats(a, b, hk, r, mx, sum_l);
      const int i = r / a.G, h = hk * a.G + r % a.G;
      float* ob = a.out + b * a.os.b + (long long)i * a.os.s
                  + (long long)h * a.os.h;
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        const float2 o = *reinterpret_cast<const float2*>(
            red + row * RP + dn * 8 + 2 * t4);
        float x0 = acc[dn][2 * h2] * f0 + o.x * f1;
        float x1 = acc[dn][2 * h2 + 1] * f0 + o.y * f1;
        if (!two) {
          x0 = normalized(x0, sum_l);
          x1 = normalized(x1, sum_l);
        }
        // the wrapper's output: contiguous, so the pair is 8-byte aligned
        *reinterpret_cast<float2*>(ob + dn * 8 + 2 * t4) =
            make_float2(x0, x1);
      }
    }
    return;
  }

  // Split keys: the halves, then the ranks; rank q of S writes rows q,
  // q + S, ..., each the sum over ranks 0..S-1 in order.
  halves_merge(true, part_m, part_l);
  cluster_merge(part_m, part_l);
  if (mode == kStats && rank == 0 && tid < kMmaRows && r0 + tid < rows)
    put_stats(a, b, hk, r0 + tid, fin_m[tid], fin_l[tid]);
  for (int row = rank + S * warp; row < kMmaRows; row += S * kMmaWarps) {
    const int r = r0 + row;
    if (r >= rows) break;
    const int i = r / a.G, h = hk * a.G + r % a.G;
    float* ob = a.out + b * a.os.b + (long long)i * a.os.s
                + (long long)h * a.os.h;
    for (int d = lane; d < D; d += 32) {
      float sum = 0.0f;
#pragma unroll
      for (int q2 = 0; q2 < kMaxSplits; ++q2)
        if (q2 < S)
          sum += cluster.map_shared_rank(part, q2)[row * D + d]
                 * fin_f[q2 * kMmaRows + row];
      ob[d] = two ? sum : normalized(sum, fin_l[row]);
    }
  }
  cluster_barrier_relaxed();   // no block leaves while read
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename... Params, typename... Actual>
int launch_cluster(void (*kern)(Params...), dim3 grid, dim3 block,
                   dim3 cluster, int smem, cudaStream_t stream,
                   Actual... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, args...);
}

struct Launch {
  int B, tiles, splits;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int D, int RB, bool MASK>
int split(const Args& a, const Launch& c) {
  const dim3 grid((unsigned)c.splits, (unsigned)c.tiles,
                  (unsigned)(c.B * a.Hkv));
  return launch_cluster(split_kernel<TQ, TKV, D, RB, MASK>, grid,
                        dim3(kThreads), dim3((unsigned)c.splits, 1, 1), 0,
                        c.stream, a);
}

template <typename TQ, typename TKV, int D, bool MASK>
int mma(const Args& a, const Launch& c) {
  constexpr int smem = MmaSmem<TQ, TKV, D>::bytes;
  static const int attr = (int)cudaFuncSetAttribute(
      mma_kernel<TQ, TKV, D, MASK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);   // once
  if (attr) return attr;
  const dim3 grid((unsigned)(c.tiles * c.splits), (unsigned)a.Hkv,
                  (unsigned)c.B);
  return launch_cluster(mma_kernel<TQ, TKV, D, MASK>, grid,
                        dim3(kMmaThreads),
                        dim3((unsigned)c.splits, 1, 1), smem, c.stream, a);
}

// variant 0: split; 1: mma (a float32 q only up to D = 64: its three
// parts would not fit the registers at 128; a bfloat16 q up to 128).
template <typename TQ, typename TKV, int D, bool MASK>
int dispatch(const Args& a, const Launch& c, int variant, int rows) {
  constexpr bool QF = std::is_same<TQ, float>::value;
  if (variant == 1) {
    if constexpr (D <= 128 && (!QF || D <= 64))
      return mma<TQ, TKV, D, MASK>(a, c);
    return (int)cudaErrorInvalidValue;
  }
  return rows == 4 ? split<TQ, TKV, D, 4, MASK>(a, c)
                   : split<TQ, TKV, D, 8, MASK>(a, c);
}

template <typename TQ, typename TKV, bool MASK>
int dispatch_d(int D, const Args& a, const Launch& c, int variant, int rows) {
  switch (D) {
    case 16: return dispatch<TQ, TKV, 16, MASK>(a, c, variant, rows);
    case 32: return dispatch<TQ, TKV, 32, MASK>(a, c, variant, rows);
    case 64: return dispatch<TQ, TKV, 64, MASK>(a, c, variant, rows);
    case 112: return dispatch<TQ, TKV, 112, MASK>(a, c, variant, rows);
    case 128: return dispatch<TQ, TKV, 128, MASK>(a, c, variant, rows);
    case 256: return dispatch<TQ, TKV, 256, MASK>(a, c, variant, rows);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K and V's types (the entries' `kv_type`): float32, bfloat16, e4m3.
enum KvType { kKvF32 = 0, kKvBf16 = 1, kKvFp8 = 2 };

// The entry points' body for the kernels built with MASK (the window and
// the soft-cap taken) or without (both refused), on float32 / bfloat16 K
// and V or (FP8) on e4m3 K and V.
template <bool MASK, bool FP8>
int launch_impl(
    const void* q, const void* k, const void* v, void* out,
    const void* q_start, int q_bf16, int kv_type, int B, int Sq, int Skv,
    int Hq, int Hkv, int D, const long long* q_strides,
    const long long* k_strides, const long long* v_strides,
    const long long* o_strides, float scale, int causal, int round_p,
    int window, float softcap, int variant, int rows, int splits, int vec,
    int mode, void* stats, void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0) return 0;
  if (mode < kWhole || mode > kPass2 || (mode != kWhole && stats == nullptr))
    return (int)cudaErrorInvalidValue;
  if (Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (window < 0 || !(softcap >= 0.0f) || (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  if (!MASK && (window > 0 || softcap > 0.0f))
    return (int)cudaErrorInvalidValue;
  if (FP8 != (kv_type == kKvFp8) || kv_type < kKvF32 || kv_type > kKvFp8)
    return (int)cudaErrorInvalidValue;
  const bool ok = (variant == 0 && (rows == 4 || rows == 8) && splits >= 1
                   && splits <= kMaxSplits)
                  || (variant == 1 && rows == kMmaRows
                      && splits >= 1 && splits <= kMaxSplits && D <= 128
                      && (q_bf16 || D <= 64));
  if (!ok) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.out = static_cast<float*>(out);
  a.q_start = static_cast<const int*>(q_start);
  a.Sq = Sq; a.Skv = Skv; a.Hkv = Hkv; a.G = Hq / Hkv;
  a.qs = Strides{q_strides[0], q_strides[1], q_strides[2]};
  a.ks = Strides{k_strides[0], k_strides[1], k_strides[2]};
  a.vs = Strides{v_strides[0], v_strides[1], v_strides[2]};
  a.os = Strides{o_strides[0], o_strides[1], o_strides[2]};
  a.scale = scale;
  a.softcap = softcap;
  a.window = window;
  a.causal = causal;
  a.round_p = round_p;
  a.two_pass = round_p && kv_type != kKvF32;
  a.vec = vec;
  a.splits = splits;
  a.mode = mode;
  a.stats = static_cast<float*>(stats);
  a.stat_plane = (long long)B * Sq * Hq;
  const long long total = (long long)a.G * Sq;
  const Launch c{B, (int)((total + rows - 1) / rows), splits,
                 static_cast<cudaStream_t>(stream)};
  int rc;
  const bool kv_bf16 = kv_type == kKvBf16;
  (void)kv_bf16;
  if constexpr (FP8)
    rc = q_bf16 ? dispatch_d<__nv_bfloat16, fp8, MASK>(D, a, c, variant, rows)
                : dispatch_d<float, fp8, MASK>(D, a, c, variant, rows);
  else if (q_bf16)
    rc = kv_bf16 ? dispatch_d<__nv_bfloat16, __nv_bfloat16, MASK>(
                       D, a, c, variant, rows)
                 : dispatch_d<__nv_bfloat16, float, MASK>(D, a, c, variant,
                                                          rows);
  else
    rc = kv_bf16 ? dispatch_d<float, __nv_bfloat16, MASK>(D, a, c, variant,
                                                          rows)
                 : dispatch_d<float, float, MASK>(D, a, c, variant, rows);
  return rc ? rc : (int)cudaGetLastError();
}

}  // namespace

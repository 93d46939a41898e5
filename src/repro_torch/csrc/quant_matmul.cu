// Matrix product with packed low-bit weights (LightPE on the card) for Hopper.
//
// Replaces the Pallas TPU kernel `quant_matmul` in
// src/repro/kernels/quant_matmul/quant_matmul.py (bodies `_mm_kernel_int4`,
// `_mm_kernel_pow2`, `_mm_kernel_int8`, with `_unpack_tile`; the padded
// `quant_matmul_any` of ops.py is the same function), and computes
//
//   y (M, N) float32 = x (M, K) @ dequant(W)
//
// with x float32 or bfloat16 and W in one of three modes:
//   int4: (K/2, N) bytes, two 4-bit two's-complement codes per byte along K
//         (row 2r in the low nibble, 2r+1 in the high), value q * scale[n];
//   pow2: the same packing, code = sign bit 3 + 3-bit index, value
//         +-2^idx * 2^(e_max[n] - 7) (LightPE-1; `scale` holds e_max);
//   int8: (K, N) int8 codes, value q * scale[n].
// The per-column factor is applied once, to the fully reduced float32 sum
// of x * (code value), as the TPU kernel does; never to a partial sum.
//
// Two kernels behind one entry point; the wrapper picks one and its launch
// plan (repro_torch/kernels/quant_matmul/quant_matmul.py, `plan`):
//
// 1. M <= 16 (decode): a split-K GEMV on the CUDA cores, float32 FMAs.  What
//    bounds it is the code bytes (K*N/2 for int4/pow2, K*N for int8), read
//    once: 166 KB for a 576 x 576 projection, 0.05 us at 3.35 TB/s, so a
//    launch is really bound by latency: the launch itself and one memory
//    round trip.  Each thread issues all its code loads at once, as 16-byte
//    vector loads along N (16 columns of one byte row, both nibbles used),
//    1-4 of them, before the block stages its K-slice of x (widened to
//    float) in shared memory behind one barrier; then it multiplies with
//    columns x M float32 accumulators (templated on an M bucket: 16 x 4,
//    8 x 8, 4 x 16).  K is split across the warps of a block and across
//    the blocks of a thread-block cluster (up to 8).  The reduction is in a
//    fixed order: the threads of a column group add in shared memory in
//    thread order, then each rank of the cluster adds its share of the
//    outputs over ranks 0..S-1 through distributed shared memory, applies
//    the factor and stores.  One launch, no workspace, no atomics: two
//    calls give the same bits.
//
// 2. M > 16 (prefill): bf16 tensor cores (mma.sync m16n8k16, float32
//    accumulators) on 64 x 64 output tiles, K in steps of 32 through a
//    4-stage cp.async pipeline that stages the raw x tile and the raw code
//    bytes; each stage's codes are decoded once, to bf16 pairs in shared
//    memory, and read from there as B fragments.  What bounds a prefill
//    step of SmolLM-135M is the bytes (codes, x and the float32 output) and
//    then the bf16 tensor rate; what holds this kernel back on the card is
//    instruction latency with few warps an SM, so K is split across a
//    cluster (reduced in rank order as in (1)) until there are about three
//    blocks an SM.
//    Exactness: every code value is exact in bf16 (int4 -8..7, int8
//    -128..127, pow2 +-2^0..2^7 before the per-column factor), and so is
//    every bfloat16 x.  A float32 x is the exact sum of three bf16 numbers,
//    hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid) (three 8-bit
//    significands make float32's 24), so three mma passes form exactly the
//    products x * code that a float32 FMA would; only the order of the sum
//    differs.  Two limits: |x| within 2^-8 of FLT_MAX makes hi infinite,
//    and lo underflows for |x| < ~2^-110, where bf16 keeps no lo part.
//    Inside one mma the products are exact but their sum is aligned and
//    truncated, not IEEE-rounded; so each 32-deep K step accumulates into
//    a zeroed fragment that is then added to an IEEE float32 running sum.
//
// Ragged M, K and N are masked in the loads and the stores: no padding
// copy.  16-byte loads and cp.async need 16-byte aligned rows; the wrapper
// tests the pointers and row pitches and picks narrower loads of the same
// kernels where they are not (down to single bytes and elements).  Nothing
// is allocated; the launch runs on the caller's stream.  IEEE float32
// throughout; no --use_fast_math.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

enum Mode { kInt4 = 0, kPow2 = 1, kInt8 = 2 };

constexpr int kMaxSplits = 8;  // a portable cluster size

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

// The value of a 4-bit code (0..15) before the per-column factor.
template <int MODE>
__device__ __forceinline__ float nibble_value(uint32_t c) {
  if (MODE == kInt4) return (float)(((int)(c << 28)) >> 28);
  // pow2: +-2^(c & 7), built from its bits
  return __uint_as_float(((c & 8u) << 28) | ((127u + (c & 7u)) << 23));
}

// The bf16 bits of the same value (exact).
template <int MODE>
__device__ __forceinline__ uint32_t nibble_bf16(uint32_t c) {
  if (MODE == kInt4)
    return __bfloat16_as_ushort(__float2bfloat16_rn(nibble_value<kInt4>(c)));
  return ((c & 8u) << 12) | ((127u + (c & 7u)) << 7);
}

__device__ __forceinline__ uint32_t int8_bf16(uint8_t b) {
  return __bfloat16_as_ushort(__float2bfloat16_rn((float)(int8_t)b));
}

template <int MODE>
__device__ __forceinline__ float column_factor(const float* __restrict__ scale,
                                               int n) {
  if (MODE != kPow2) return scale[n];
  const int e = (int)scale[n] - 7;   // 2^e, built from its bits when normal
  return (e >= -126 && e <= 127) ? __int_as_float((e + 127) << 23)
                                 : ldexpf(1.0f, e);
}

// Every thread of the cluster arrives and waits; the shared-memory writes
// before it are seen by every block after it (release / acquire at cluster
// scope, no fence of the whole device).
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

// Sum over the cluster's ranks 0..S-1, in that order, of element e of each
// rank's shared array `part` (the loads are issued together).
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster,
                                            float* part, int e, int S) {
  float v[kMaxSplits];
#pragma unroll
  for (int q = 0; q < kMaxSplits; ++q)
    v[q] = (q < S) ? cluster.map_shared_rank(part, q)[e] : 0.0f;
  float s = 0.0f;
#pragma unroll
  for (int q = 0; q < kMaxSplits; ++q)
    if (q < S) s += v[q];
  return s;
}

// ---------------------------------------------------------------------------
// 1. decode: split-K GEMV
// ---------------------------------------------------------------------------

constexpr int kGemvThreads = 128;
constexpr int kGemvSmem = 8192;   // floats: the x chunk, then the partials
constexpr int kGemvPart = 2048;   // floats: MB * COLS (<= 64) * tn (<= 32)
constexpr int kGemvUnroll = 4;    // code loads a thread keeps in flight
constexpr int kGemvXLoads = 8;    // x loads a thread issues at once

template <int COLS> struct CodeVec;
template <> struct CodeVec<16> { using T = uint4; };
template <> struct CodeVec<8> { using T = uint2; };
template <> struct CodeVec<4> { using T = uint32_t; };
template <> struct CodeVec<1> { using T = uint8_t; };

__device__ __forceinline__ void words(uint4 v, uint32_t (&o)[4]) {
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void words(uint2 v, uint32_t (&o)[2]) {
  o[0] = v.x; o[1] = v.y;
}
__device__ __forceinline__ void words(uint32_t v, uint32_t (&o)[1]) {
  o[0] = v;
}
__device__ __forceinline__ void words(uint8_t v, uint32_t (&o)[1]) {
  o[0] = v;
}

// Block (bx, s) of the grid (ceil(N / (tn * COLS)), S): columns
// [bx * tn * COLS, +tn * COLS) and byte rows [s * span, (s + 1) * span) of
// the R = K / KPB byte rows.  Thread t: column group t % tn (COLS columns),
// byte rows r0 + t / tn + j * (128 / tn).  The plan in the wrapper uses the
// same formulas.
template <typename XT, int MODE, int MB, int COLS>
__global__ void __launch_bounds__(kGemvThreads)
gemv_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ w,
            const float* __restrict__ scale, float* __restrict__ out,
            int M, int K, int N, int tn, int span) {
  using V = typename CodeVec<COLS>::T;
  constexpr int KPB = (MODE == kInt8) ? 1 : 2;   // k values a byte row holds
  constexpr int NW = (COLS + 3) / 4;             // 32-bit words of a load
  constexpr int CR = kGemvSmem / (MB * KPB);     // byte rows an x chunk holds
  static_assert(MB * COLS <= 64, "accumulators");
  __shared__ __align__(16) float sm[kGemvSmem];
  __shared__ float part[kGemvPart];

  const int R = K / KPB;
  const int tid = threadIdx.x;
  const int tk = kGemvThreads / tn;
  const int ti = tid % tn, tr = tid / tn;
  const int bn = tn * COLS;
  const int nb0 = blockIdx.x * bn;
  const int n0 = nb0 + ti * COLS;
  const bool live = n0 < N;   // COLS divides N: a group is all in or out
  const int r0 = blockIdx.y * span;
  const int r1 = min(R, r0 + span);

  float acc[MB][COLS];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[m][c] = 0.0f;

  uint32_t code[kGemvUnroll][NW];
  auto load = [&](int g, int c1) {
#pragma unroll
    for (int j = 0; j < kGemvUnroll; ++j) {
      const int r = g + j * tk;
      V v = V();
      if (live && r < c1)
        v = *reinterpret_cast<const V*>(w + (size_t)r * N + n0);
      words(v, code[j]);
    }
  };

  for (int c0 = r0; c0 < r1; c0 += CR) {
    const int c1 = min(r1, c0 + CR);
    const int first = c0 + tr;
    load(first, c1);   // in flight while x is staged
    // x[m][c0 * KPB .. c1 * KPB), widened, at sm[kk * MB + m]; rows m >= M
    // are zero
    const int nk = (c1 - c0) * KPB;
    const size_t k0 = (size_t)c0 * KPB;
    for (int e0 = 0; e0 < nk * MB; e0 += kGemvXLoads * kGemvThreads) {
      float v[kGemvXLoads];   // all issued before the first store
#pragma unroll
      for (int i = 0; i < kGemvXLoads; ++i) {
        const int e = e0 + i * kGemvThreads + tid;
        const int m = e / nk, kk = e % nk;
        v[i] = (e < nk * MB && m < M) ? widen(x[(size_t)m * K + k0 + kk])
                                      : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kGemvXLoads; ++i) {
        const int e = e0 + i * kGemvThreads + tid;
        if (e < nk * MB) sm[(e % nk) * MB + e / nk] = v[i];
      }
    }
    __syncthreads();
    for (int g = first; g < c1; g += kGemvUnroll * tk) {
      if (g != first) load(g, c1);
#pragma unroll
      for (int j = 0; j < kGemvUnroll; ++j) {
        const int r = g + j * tk;
        if (r >= c1) break;
#pragma unroll
        for (int h = 0; h < KPB; ++h) {
          float xv[MB];
          const float4* xp =
              reinterpret_cast<const float4*>(sm + ((r - c0) * KPB + h) * MB);
#pragma unroll
          for (int q = 0; q < MB / 4; ++q) {
            const float4 f = xp[q];
            xv[4 * q] = f.x; xv[4 * q + 1] = f.y;
            xv[4 * q + 2] = f.z; xv[4 * q + 3] = f.w;
          }
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
            const uint32_t byte = (code[j][c / 4] >> (8 * (c % 4))) & 0xFFu;
            const float v = (MODE == kInt8)
                                ? (float)(int8_t)byte
                                : nibble_value<MODE>(h ? (byte >> 4) : (byte & 0xFu));
#pragma unroll
            for (int m = 0; m < MB; ++m) acc[m][c] = fmaf(xv[m], v, acc[m][c]);
          }
        }
      }
    }
    __syncthreads();
  }

  // The block's sum: the tk threads of a column group add in thread order.
  float* red = sm;   // [tk][MB][bn]
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      red[(tr * MB + m) * bn + ti * COLS + c] = acc[m][c];
  __syncthreads();
  for (int e = tid; e < MB * bn; e += kGemvThreads) {
    float s = 0.0f;
    for (int t0 = 0; t0 < tk; t0 += 8) {
      float v[8];   // loads issued together, added in thread order
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = (t0 + i < tk) ? red[(t0 + i) * MB * bn + e] : 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (t0 + i < tk) s += v[i];
    }
    part[e] = s;
  }

  // The cluster's sum: rank q of S adds outputs q, q + S, ... (in units of
  // the block's threads) over ranks 0..S-1 in order, then scales.
  const int S = gridDim.y;
  cg::cluster_group cluster = cg::this_cluster();
  if (S > 1) cluster_barrier(); else __syncthreads();
  const int rank = (S > 1) ? (int)cluster.block_rank() : 0;
  for (int e = rank * kGemvThreads + tid; e < MB * bn;
       e += S * kGemvThreads) {
    const int m = e / bn, n = nb0 + e % bn;
    const float s = (S > 1) ? cluster_sum(cluster, &part[0], e, S) : part[e];
    if (m < M && n < N) out[(size_t)m * N + n] = s * column_factor<MODE>(scale, n);
  }
  if (S > 1) cluster_barrier_relaxed();   // no block leaves while read
}

// ---------------------------------------------------------------------------
// 2. prefill: bf16 tensor cores
// ---------------------------------------------------------------------------

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kStages = 4;

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

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t bits2(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two float32 values (k, k + 1) as three pairs of bf16 parts, exactly:
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

// Shared memory of the tensor-core kernel (dynamic: four stages of a
// float32 x tile pass the 48 KB of a static array): the stages, which the
// split-K partial tile reuses.
template <typename XT, int MODE>
constexpr int mma_smem_bytes() {
  constexpr int stage = kBM * (kBK + 8) * (int)sizeof(XT)
                        + kBK / ((MODE == kInt8) ? 1 : 2) * (kBN + 16);
  constexpr int red = kBM * (kBN + 4) * 4;
  return kStages * stage > red ? kStages * stage : red;
}

// Block (bx, by, s) of the grid (ceil(N / 64), ceil(M / 64), S): output
// rows [by * 64, +64), columns [bx * 64, +64), K tiles of 32 in
// [s * span, (s + 1) * span).  4 warps, each a 16 x 64 tile (so a float32
// x row is split into its bf16 parts by one warp only).
// ASYNC: 16-byte cp.async copies (rows 16-byte aligned); otherwise the same
// stages are filled element by element.  Once a stage has landed, the
// block decodes its codes through a 256-entry table into 32-bit words
// that each hold the bf16 pair (row 2q, row 2q + 1) of one column: a B
// fragment register is then one shared-memory load.
template <typename XT, int MODE, bool ASYNC>
__global__ void __launch_bounds__(2 * kBN)
mma_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ w,
           const float* __restrict__ scale, float* __restrict__ out,
           int M, int K, int N, int span) {
  constexpr int THREADS = kBN * 2;
  constexpr int KPB = (MODE == kInt8) ? 1 : 2;
  constexpr int KR = kBK / KPB;            // code rows of a K tile
  constexpr int XLD = kBK + 8;             // x row pitch (elements)
  constexpr int WLD = kBN + 16;            // code row pitch (bytes)
  constexpr int XBYTES = kBM * XLD * (int)sizeof(XT);
  constexpr int STAGE = XBYTES + KR * WLD;
  constexpr int RLD = kBN + 4;             // pitch of the split-K partials
  constexpr bool F32 = sizeof(XT) == 4;
  constexpr int PARTS = F32 ? 3 : 1;
  static_assert(XBYTES % 16 == 0 && STAGE % 16 == 0, "16-byte stages");
  constexpr int WBLD = kBN + 8;            // pitch of the decoded words
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ uint32_t lut[256];
  __shared__ __align__(16) uint32_t wb[kBK / 2][WBLD];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int R = K / KPB;
  const int tiles = (K + kBK - 1) / kBK;
  const int kt0 = blockIdx.z * span;
  const int nkt = min(tiles, kt0 + span) - kt0;

  for (int i = tid; i < 256; i += THREADS)   // read after the first barrier
    lut[i] = (MODE == kInt8) ? int8_bf16((uint8_t)i)
                             : nibble_bf16<MODE>(i & 0xF)
                                   | (nibble_bf16<MODE>(i >> 4) << 16);

  auto load_stage = [&](int st, int kt) {
    XT* xs = reinterpret_cast<XT*>(sm + st * STAGE);
    uint8_t* ws = sm + st * STAGE + XBYTES;
    const int k0 = kt * kBK, q0 = kt * KR;
    // Trip counts are compile-time: a thread's copies are c = tid + i *
    // THREADS for i below a constant, with no loop to run at run time.
    if constexpr (ASYNC) {
      constexpr int XV = 16 / (int)sizeof(XT);    // elements a copy
      constexpr int XC = kBM * kBK / XV;
      static_assert(XC % THREADS == 0, "x copies");
#pragma unroll
      for (int i = 0; i < XC / THREADS; ++i) {
        const int c = tid + i * THREADS;
        const int row = c / (kBK / XV), kc = (c % (kBK / XV)) * XV;
        const int m = m0 + row, k = k0 + kc;
        const bool ok = m < M && k < K;
        cp_async16(xs + row * XLD + kc, ok ? x + (size_t)m * K + k : x,
                   ok ? 16 : 0);
      }
      constexpr int WC = KR * kBN / 16;
#pragma unroll
      for (int i = 0; i < (WC + THREADS - 1) / THREADS; ++i) {
        const int c = tid + i * THREADS;
        if (WC % THREADS && c >= WC) break;
        const int row = c / (kBN / 16), nc = (c % (kBN / 16)) * 16;
        const int q = q0 + row, n = n0 + nc;
        const bool ok = q < R && n < N;
        cp_async16(ws + row * WLD + nc, ok ? w + (size_t)q * N + n : w,
                   ok ? 16 : 0);
      }
    } else {
      static_assert(kBM * kBK % THREADS == 0 && KR * kBN % THREADS == 0, "");
#pragma unroll
      for (int i = 0; i < kBM * kBK / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int row = e / kBK, kk = e % kBK;
        const int m = m0 + row, k = k0 + kk;
        xs[row * XLD + kk] = (m < M && k < K) ? x[(size_t)m * K + k]
                                              : zero<XT>();
      }
#pragma unroll
      for (int i = 0; i < KR * kBN / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int row = e / kBN, c = e % kBN;
        const int q = q0 + row, n = n0 + c;
        ws[row * WLD + c] = (q < R && n < N) ? w[(size_t)q * N + n] : 0;
      }
    }
  };

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nkt) load_stage(s, kt0 + s);
    cp_async_commit();
  }
  for (int t = 0; t < nkt; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage t landed; stage t - 1 is free again
    if (t + kStages - 1 < nkt)
      load_stage((t + kStages - 1) % kStages, kt0 + t + kStages - 1);
    cp_async_commit();

    const int st = t % kStages;
    const XT* xs = reinterpret_cast<const XT*>(sm + st * STAGE);
    const uint8_t* ws = sm + st * STAGE + XBYTES;
    // the stage's codes as bf16 pairs (k rows 2q, 2q + 1), once a block
    static_assert(kBK / 2 * kBN / 4 % THREADS == 0, "decode");
#pragma unroll
    for (int i = 0; i < kBK / 2 * kBN / 4 / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int q = e / (kBN / 4), n4 = (e % (kBN / 4)) * 4;
      uint32_t o[4];
      if constexpr (MODE == kInt8) {
        const uint32_t lo = *reinterpret_cast<const uint32_t*>(
            ws + (2 * q) * WLD + n4);
        const uint32_t hi = *reinterpret_cast<const uint32_t*>(
            ws + (2 * q + 1) * WLD + n4);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          o[j] = lut[(lo >> (8 * j)) & 0xFFu]
                 | (lut[(hi >> (8 * j)) & 0xFFu] << 16);
      } else {
        const uint32_t b = *reinterpret_cast<const uint32_t*>(
            ws + q * WLD + n4);
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = lut[(b >> (8 * j)) & 0xFFu];
      }
      *reinterpret_cast<uint4*>(&wb[q][n4]) = make_uint4(o[0], o[1], o[2],
                                                         o[3]);
    }
    __syncthreads();
    float tile[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) tile[j][r] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[PARTS][4];
      const int row = warp * 16 + g;
#pragma unroll
      for (int r = 0; r < 4; ++r) {   // (row, k), (row+8, k), (row, k+8), ..
        const XT* p = xs + (row + 8 * (r & 1)) * XLD + kk + 8 * (r >> 1)
                      + 2 * t4;
        if constexpr (F32) {
          split3(*reinterpret_cast<const float2*>(p), a[0][r],
                 a[PARTS - 2][r], a[PARTS - 1][r]);
        } else {
          a[0][r] = *reinterpret_cast<const uint32_t*>(p);
        }
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = ni * 8 + g;
        uint32_t b[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)   // k rows kk + 8h + 2 t4, +1
          b[h] = wb[kk / 2 + 4 * h + t4][col];
#pragma unroll
        for (int p = 0; p < PARTS; ++p) mma_bf16(tile[ni], a[p], b);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] += tile[j][r];
  }
  cp_async_wait<0>();

  const int S = gridDim.z;
  if (S == 1) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int col = n0 + ni * 8 + 2 * t4;
      float f[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        f[j] = (col + j < N) ? column_factor<MODE>(scale, col + j) : 0.0f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + warp * 16 + g + 8 * (r >> 1);
        const int n = col + (r & 1);
        if (m < M && n < N) out[(size_t)m * N + n] = acc[ni][r] * f[r & 1];
      }
    }
    return;
  }

  // Split K: the partial tiles meet in distributed shared memory; rank q of
  // S adds elements q * THREADS + tid, ... over ranks 0..S-1 in order.
  __syncthreads();   // every warp is done with the stages
  float* red = reinterpret_cast<float*>(sm);
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      red[(warp * 16 + g + 8 * (r >> 1)) * RLD + ni * 8 + 2 * t4
          + (r & 1)] = acc[ni][r];
  cg::cluster_group cluster = cg::this_cluster();
  cluster_barrier();
  const int rank = (int)cluster.block_rank();
  for (int e = rank * THREADS + tid; e < kBM * kBN; e += S * THREADS) {
    const int row = e / kBN, c = e % kBN;
    const int m = m0 + row, n = n0 + c;
    const float s = cluster_sum(cluster, red, row * RLD + c, S);
    if (m < M && n < N) out[(size_t)m * N + n] = s * column_factor<MODE>(scale, n);
  }
  cluster_barrier_relaxed();
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

struct Call {
  const void* x; const void* w; const void* scale; void* out;
  int M, K, N, mode, tile, splits, span;
  cudaStream_t stream;
};

template <typename XT, int MODE, int MB, int COLS>
int gemv(const Call& c) {
  const int bn = c.tile * COLS;
  const dim3 grid((unsigned)((c.N + bn - 1) / bn), (unsigned)c.splits);
  return launch_cluster(
      gemv_kernel<XT, MODE, MB, COLS>, grid, dim3(kGemvThreads),
      dim3(1, (unsigned)c.splits, 1), 0, c.stream, static_cast<const XT*>(c.x),
      static_cast<const uint8_t*>(c.w), static_cast<const float*>(c.scale),
      static_cast<float*>(c.out), c.M, c.K, c.N, c.tile, c.span);
}

// COLS: the bytes of a code load, at most 64 / MB (the accumulators).
template <typename XT, int MODE, int MB>
int gemv_cols(const Call& c, int vec) {
  if constexpr (MB * 16 <= 64) if (vec == 16) return gemv<XT, MODE, MB, 16>(c);
  if constexpr (MB * 8 <= 64) if (vec == 8) return gemv<XT, MODE, MB, 8>(c);
  if (vec == 4) return gemv<XT, MODE, MB, 4>(c);
  if (vec == 1) return gemv<XT, MODE, MB, 1>(c);
  return (int)cudaErrorInvalidValue;
}

template <typename XT, int MODE>
int gemv_m(const Call& c, int vec) {
  if (c.M <= 4) return gemv_cols<XT, MODE, 4>(c, vec);
  if (c.M <= 8) return gemv_cols<XT, MODE, 8>(c, vec);
  return gemv_cols<XT, MODE, 16>(c, vec);
}

template <typename XT, int MODE, bool ASYNC>
int mma(const Call& c) {
  constexpr int smem = mma_smem_bytes<XT, MODE>();
  static const int attr = (int)cudaFuncSetAttribute(
      mma_kernel<XT, MODE, ASYNC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);   // once
  if (attr) return attr;
  const dim3 grid((unsigned)((c.N + kBN - 1) / kBN),
                  (unsigned)((c.M + kBM - 1) / kBM), (unsigned)c.splits);
  return launch_cluster(
      mma_kernel<XT, MODE, ASYNC>, grid, dim3(2 * kBN),
      dim3(1, 1, (unsigned)c.splits), smem, c.stream,
      static_cast<const XT*>(c.x), static_cast<const uint8_t*>(c.w),
      static_cast<const float*>(c.scale), static_cast<float*>(c.out), c.M,
      c.K, c.N, c.span);
}

template <typename XT, int MODE>
int dispatch(const Call& c, int variant, int vec) {
  if (variant == 0) return gemv_m<XT, MODE>(c, vec);
  return vec ? mma<XT, MODE, true>(c) : mma<XT, MODE, false>(c);
}

template <typename XT>
int dispatch_mode(const Call& c, int variant, int vec) {
  if (c.mode == kInt4) return dispatch<XT, kInt4>(c, variant, vec);
  if (c.mode == kPow2) return dispatch<XT, kPow2>(c, variant, vec);
  return dispatch<XT, kInt8>(c, variant, vec);
}

int pow2_in(int v, int lo, int hi) {
  return v >= lo && v <= hi && (v & (v - 1)) == 0;
}

// Refuses a plan that the kernels would not cover [0, M) x [0, K) x [0, N)
// with exactly once.
bool plan_ok(int M, int K, int N, int mode, int variant, int vec, int tile,
             int splits, int span) {
  if (splits < 1 || splits > kMaxSplits || span < 1) return false;
  if (variant == 0) {
    const int mb = M <= 4 ? 4 : M <= 8 ? 8 : 16;
    const int rows = (mode == kInt8) ? K : K / 2;
    return M <= 16 && (vec == 1 || (pow2_in(vec, 4, 16) && mb * vec <= 64))
           && N % vec == 0 && pow2_in(tile, 1, 32)
           && (long long)span * splits >= rows
           && (long long)span * (splits - 1) < rows;
  }
  if (variant == 1) {
    const int tiles = (K + kBK - 1) / kBK;
    return M > 16 && tile == kBN && (vec == 0 || vec == 16)
           && (long long)span * splits >= tiles
           && (long long)span * (splits - 1) < tiles;
  }
  return false;
}

}  // namespace

// x_bf16: 0 = float32 x, 1 = bfloat16 x; mode: 0 int4, 1 pow2, 2 int8.
// The launch plan (the wrapper's `plan`): variant 0 = the GEMV (vec: bytes
// of a code load, 16/8/4/1; tile: threads along N; span: byte rows of a
// split), 1 = the tensor-core product (vec: 16 for cp.async copies, 0 for
// element loads; tile: 64, the tile's columns; span: K tiles of 32 of a
// split);
// splits: the cluster size along K.  Returns the launch's CUDA error: 0
// when it was accepted.
extern "C" int quant_matmul_launch(const void* x, int x_bf16, const void* w,
                                   const void* scale, void* out, int M, int K,
                                   int N, int mode, int variant, int vec,
                                   int tile, int splits, int span,
                                   void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (mode < kInt4 || mode > kInt8 || K <= 0 || (mode != kInt8 && K % 2)
      || !plan_ok(M, K, N, mode, variant, vec, tile, splits, span))
    return (int)cudaErrorInvalidValue;
  const Call c{x, w, scale, out, M, K, N, mode, tile, splits, span,
               static_cast<cudaStream_t>(stream)};
  const int rc = x_bf16 ? dispatch_mode<__nv_bfloat16>(c, variant, vec)
                        : dispatch_mode<float>(c, variant, vec);
  return rc ? rc : (int)cudaGetLastError();
}

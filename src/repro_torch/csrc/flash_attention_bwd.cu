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
// batch row b at position p = q_start[b] + i when j <= p and, with a
// sliding window (`window` > 0, causal only), j > p - window, as in the
// forward.  With a logit soft-cap c (`softcap` > 0) the logit is
// c * t, t = tanhf(scale * q.k / c) in IEEE float32 (the forward's), and
// dS takes the plain version's autograd in its order: P (dP - D), times
// c, times (1 - t * t) (tanh's backward), divided by c, times scale.
// A row that sees no key (a query past the keys by more than the
// window, which no model forms) gets zero gradients.
//
// What bounds it on the card.  At SmolLM-135M's training shape (B 16,
// S 256, 9/3 heads, head_dim 64; float32 q, k, v, as the QAT model gives
// them) a layer's gradient moves ~41 MB (12 us at 3.35 TB/s) and needs 5
// products over the 4.7 M visible (query head, key) pairs (q.k and dout.v
// again, then dq, dk, dv): 3.0 GFLOP, 45 us on the CUDA cores' 67
// TFLOP/s.  So on the CUDA cores it is bound by operations, and this
// design moves every product to the bf16 tensor cores (mma.sync
// m16n8k16, float32 accumulators, as the forward's prefill variant):
//
// - Operands.  A bfloat16 q, k or v is one exact bf16 part; a float32
//   operand (q, k, v, dout, P, dS) is three (hi + mid + lo == x exactly,
//   `split3`).  Of the 9 part products of two float32 operands the kernel
//   issues the 6 whose weight reaches float32 rounding, in the order
//   hi.lo, mid.mid, hi.mid, lo.hi, mid.hi, hi.hi, and drops mid.lo,
//   lo.mid and lo.lo (each below 2^-26 of |a||b|).  P rounded to
//   bfloat16 (round_p with a bfloat16 V) is one part.  Every 16-deep step
//   sums its part products into zeroed fragments, which are then added to
//   an IEEE float32 total, in a fixed order.  At the float32 training
//   shape the gradient's 5 products are 5 x 6 = 30 part products a
//   (pair, column): 18.2 GFLOP, 18 us at the tensor cores' 989 TFLOP/s,
//   the least the card takes, still bound by operations (bytes: 12 us).
//   This design forms 9 x 6 = 54 (q.k and dout.v three times each):
//   32.7 GFLOP, 33 us at that peak; mma.sync runs at about two thirds of
//   it, and the splitting, the softmax and the copies between the
//   products take the rest of the time.
// - Products.  Two kernels behind one entry point, 9 products a backward
//   (the version before this ran 10 on the CUDA cores), 8 warps a block:
//   1. rows (dq and the row statistics): a block serves 64 rows r = i * G
//      + g (query i, head g of one KV head's group); warp w takes 16 rows
//      (w % 4) against one half (w / 4) of every chunk of 64 keys.  It
//      walks the keys of its rows' windows twice.  Pass 1 forms
//      S = q.k and dP = dout.v and keeps, beside the online max m and sum
//      l of exp(s - m), the online d = sum exp(s - m) dP, rescaled with l
//      whenever m grows; the halves merge, half 0 first, and D = d / L.
//      Pass 2 forms S and dP again, P = exp(s - M) / L and dS, and sums
//      dq = dS K with dS in registers as the A operand; the halves' dq
//      meet in shared memory (2 q.k + 2 dout.v + dq).  q's and dout's
//      fragments stay in registers.  It writes dq and (M, L, D) for (2).
//   2. keys (dk, dv): a block holds 64 keys of one KV head and walks the
//      rows that can see them (their positions in [j, j + window - 1]
//      with a window) in tiles of 64.  Warp w forms S^T = K q^T and dP^T
//      = V dout^T for its 16 keys, then P^T and dS^T from (M, L, D) in its
//      accumulators, which are the A operands of dv += P^T dout and dk +=
//      dS^T q: P and dS never touch shared memory (q.k + dout.v + dk +
//      dv).  The two warps of a key group split the tile's rows and meet
//      at the end, half 0 first, and K's fragments stay in registers.
//   This file takes head_dims 16, 32 and 64; 112, 128 and 256 run the
//   warpgroup design of flash_attention_bwd_wgmma.cu.
// - One logit in every pass.  Both kernels issue, for every element of S
//   (or S^T), the same part products in the same order on the same
//   16-deep steps (`mma_parts`, `mma_parts_swapped`: mma.sync gives the
//   same bits with its operands swapped, which a test on the H100
//   confirmed), and round scale * (q.k) before the max is subtracted, so
//   P = 1 exactly for a row's max and a single-key row gives dS = 0.  The
//   forward's log-sum-exp is not taken: its logits come from another
//   order of sums.
// - No floating-point atomics: every output element is summed by one
//   thread in a fixed order, so two calls give the same bits.
// - Memory.  K and V chunks (rows kernel) and q, dout tiles with their
//   statistics (keys kernel) are copied with 16-byte cp.async into a raw
//   buffer while the current chunk is multiplied, then split into parts in
//   shared memory (row pitch D + 8 bf16: the 8 rows an ldmatrix reads
//   start at 8 distinct 16-byte offsets modulo 128 bytes for every head
//   dim taken, so it reads without bank conflicts); each
//   block's first copy is in flight while its fixed operands are loaded
//   and split.  At head_dim 64 in float32 the rows kernel takes 140 KB of
//   shared memory and the keys kernel 140 KB, and both take about 255
//   registers a thread: one block of 8 warps an SM.  The fragments of q
//   and dout (rows) and K (keys) stay in registers.
// - Occupancy at the training shape.  The rows kernel has 48 (b, hk) x 12
//   row tiles, the keys kernel 48 x 4 key tiles of 64 (1.5 waves on 132
//   SMs, causally unbalanced: key tile 0 is seen by all 12 row tiles, tile
//   3 by 3).  The grid is (Hkv, B, tiles) with the heaviest tiles first
//   (the last row tiles, the first key tiles), so the first wave takes the
//   long blocks and the short ones fill in behind them; the busiest SM
//   then holds 12 tiles against a mean of 10.9.  Smaller key tiles would
//   balance better but copy and split every q and dout tile twice as
//   often.  A window caps each row's keys at `window`: a row tile's work
//   grows with its position up to the window and is flat past it, and a
//   key tile's is flat up to the last window before the end and falls
//   after it, so the same order still starts with the heaviest tiles.
//
// Nothing is allocated; the wrapper passes the statistics' scratch.  The
// launches run on the caller's stream.  IEEE float32, expf and division;
// no --use_fast_math.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;   // 8 warps

struct Args {
  const void* q; const void* k; const void* v; const float* dout;
  const int* q_start;
  void* dq; void* dk; void* dv;
  float* stat_m; float* stat_l; float* stat_d;   // (B, Sq, Hq) each
  int Sq, Skv, Hq, Hkv, G;
  float scale, softcap;    // softcap 0: off
  int causal, round_dp;
  int window;              // 0: global
};

// Tiles and shared memory of the two kernels for q, k, v of type T.  KC,
// KP, RK and SPLIT stand in ref.py as BWD_CHUNK, BWD_KEY_PARTS,
// BWD_ROW_TILE and BWD_ROW_SPLIT, for emulate_attention_bwd.
template <typename T, int D>
struct Cfg {
  static_assert(D <= 64, "head_dims 16, 32, 64 (the wider: the wgmma file)");
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int XP = F32 ? 3 : 1;       // parts of q, k, v
  static constexpr int OP = 3;                 // parts of dout, P, dS
  static constexpr int LD = D + 8;             // bf16 pitch of a D row
  static constexpr int TS = (int)sizeof(T);
  // 1. rows: RT rows a block in RG groups of 16, keys in chunks of KC,
  // each in KP parts with their own statistics
  static constexpr int RT = 64;
  static constexpr int KC = 64;
  static constexpr int KP = 2;
  static constexpr int RG = RT / 16;
  static constexpr int rows_smem =
      (XP + OP) * RT * LD * 2 + 2 * XP * KC * LD * 2 + 2 * KC * D * TS;
  // 2. keys: KB keys a block in KG groups of 16, rows in tiles of RK,
  // split in SPLIT parts among the warps of a key group
  static constexpr int KB = 64;
  static constexpr int RK = 64;
  static constexpr int SPLIT = 2;
  static constexpr int KG = KB / 16;
  static constexpr int raw_keys = RK * D * (TS + 4) + 3 * RK * 4;
  static constexpr int keys_smem = 2 * XP * KB * LD * 2
      + (XP + OP) * RK * LD * 2 + raw_keys;
  static_assert(RG * KP == 8 && KG * SPLIT == 8, "8 warps");
  static_assert(rows_smem <= 226 * 1024 && keys_smem <= 226 * 1024,
                "shared memory");
  static_assert((XP + OP) * RT * LD * 2 >= RT * (D + 8) * 4,
                "the rows kernel's dq halves fit over q and dout");
  static_assert(keys_smem >= 2 * KB * (D + 8) * 4,
                "the keys kernel's dk, dv halves fit over the parts");
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Element offset of (b, s, h, 0) in a contiguous (B, S, H, D) tensor.
__device__ __forceinline__ long long at(int b, int s, int h, int S, int H,
                                        int D) {
  return (((long long)b * S + s) * H + h) * D;
}

__device__ __forceinline__ uint32_t bits2(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
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

// A pair of values as P bf16 parts: P = 1 rounds (the value is exact in
// bf16), P = 3 splits.
template <int P>
__device__ __forceinline__ void to_words(float2 x, uint32_t (&w)[3]) {
  if constexpr (P == 1) {
    w[0] = bits2(__float22bfloat162_rn(x));
  } else {
    split3(x, w[0], w[1], w[2]);
  }
}

// Four consecutive elements as floats (zeros for a null row).
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  if (!p) { o[0] = o[1] = o[2] = o[3] = 0.0f; return; }
  const float4 f = *reinterpret_cast<const float4*>(p);
  o[0] = f.x; o[1] = f.y; o[2] = f.z; o[3] = f.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&o)[4]) {
  if (!p) { o[0] = o[1] = o[2] = o[3] = 0.0f; return; }
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

// A thread's share of R rows of D values, 4 columns at a time: loaded
// (load_rows; src(rl) is row rl's first element, or null for a row of
// zeros), all its loads in flight before the first is used, then stored
// as P bf16 parts (store_parts: part p of row rl at dst + (p * R + rl) *
// LD); to_parts does both.  The last round may leave threads idle (R x
// D / 4 need not be a multiple of the block).
template <int R, int D>
struct Rows4 {
  static constexpr int V4 = D / 4, N = R * V4;
  static constexpr int IT = (N + kThreads - 1) / kThreads;
  float f[IT][4];
  __device__ __forceinline__ static bool has(int e) {
    return N % kThreads == 0 || e < N;
  }
};

template <int R, int D, typename T, typename Src>
__device__ __forceinline__ void load_rows(Rows4<R, D>& x, Src src) {
  constexpr int V4 = D / 4;
#pragma unroll
  for (int it = 0; it < Rows4<R, D>::IT; ++it) {
    const int e = threadIdx.x + it * kThreads;
    const T* row = Rows4<R, D>::has(e) ? src(e / V4) : nullptr;
    load4(row ? row + (e % V4) * 4 : static_cast<const T*>(nullptr), x.f[it]);
  }
}

template <int P, int R, int D, int LD>
__device__ __forceinline__ void store_parts(bf16* dst, const Rows4<R, D>& x) {
  constexpr int V4 = D / 4;
#pragma unroll
  for (int it = 0; it < Rows4<R, D>::IT; ++it) {
    const int e = threadIdx.x + it * kThreads;
    if (!Rows4<R, D>::has(e)) continue;
    const int rl = e / V4, c = (e % V4) * 4;
    uint32_t w0[3], w1[3];
    to_words<P>(make_float2(x.f[it][0], x.f[it][1]), w0);
    to_words<P>(make_float2(x.f[it][2], x.f[it][3]), w1);
#pragma unroll
    for (int p = 0; p < P; ++p)
      *reinterpret_cast<uint2*>(dst + (p * R + rl) * LD + c) =
          make_uint2(w0[p], w1[p]);
  }
}

template <int P, int R, int D, int LD, typename T, typename Src>
__device__ __forceinline__ void to_parts(bf16* dst, Src src) {
  Rows4<R, D> x;
  load_rows<R, D, T>(x, src);
  store_parts<P, R, D, LD>(dst, x);
}

// ---------------------------------------------------------------------------
// Tensor-core fragments (mma.sync m16n8k16, bf16 in, float32 accumulators)
// ---------------------------------------------------------------------------

// d += a (16 x 16, row) * b (16 x 8, col).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8 x 8 bf16 matrices; lane l gives the address of a row of matrix
// l / 8 and receives, of matrix m, (row l / 4, columns 2 (l % 4) + 0, 1)
// in r[m] (`trans`: (rows 2 (l % 4) + 0, 1, column l / 4)).
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}

// The A fragment (16 x 16) at rows m0, columns k0 of X stored row-major
// [m][k] with pitch ld.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* x,
                                       int ld, int m0, int k0, int lane) {
  ldsm4(a, x + (m0 + (lane & 15)) * ld + k0 + ((lane >> 4) << 3));
}

// The B fragments of two n-tiles (n0 and n0 + 8; b[0..1] and b[2..3]) at
// k rows k0 .. k0 + 15, from Y stored [n][k] (B = Y^T) or, `trans`, from Y
// stored [k][n] (B = Y).
template <bool TRANS>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* y,
                                       int ld, int n0, int k0, int lane) {
  if constexpr (!TRANS) {
    ldsm4(b, y + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0
                 + (((lane >> 3) & 1) << 3));
  } else {
    ldsm4t(b, y + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + n0
                  + ((lane >> 4) << 3));
  }
}

// t[nt] += sum of the kept part products A_pa B_pb of one 16-deep step:
// A's PA parts as fragments af, B's PB parts in shared memory (part pb at
// b + pb * b_part), n-tiles n0 + 8 nt (in pairs).
// Kept: pa + pb <= 2, issued in the order (0,2) (1,1) (0,1) (2,0) (1,0)
// (0,0) (ref.py's `PAIRS`).
template <int PA, int PB, int NT, bool BT>
__device__ __forceinline__ void mma_parts(float (&t)[NT][4],
                                          const uint32_t (&af)[PA][4],
                                          const bf16* b, int b_ld, int b_part,
                                          int n0, int k0, int lane) {
#pragma unroll
  for (int pb = PB - 1; pb >= 0; --pb) {
    uint32_t bf[NT][2];
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t r[4];
      load_b<BT>(r, b + pb * b_part, b_ld, n0 + 16 * np, k0, lane);
      bf[2 * np][0] = r[0];
      bf[2 * np][1] = r[1];
      bf[2 * np + 1][0] = r[2];
      bf[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int pa = PA - 1; pa >= 0; --pa) {
      if (pa + pb > 2) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(t[nt], af[pa], bf[nt]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&x)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) x[nt][r] = 0.0f;
}

template <int NT>
__device__ __forceinline__ void add(float (&acc)[NT][4],
                                    const float (&t)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] += t[nt][r];
}

// One 16-deep step of warp_mma_regs: acc += the step's part products,
// summed into zeroed fragments first.
template <int PA, int PB, int NT, bool BT>
__device__ __forceinline__ void mma_step(float (&acc)[NT][4],
                                         const uint32_t (&af)[PA][4],
                                         const bf16* b, int b_ld, int b_part,
                                         int n0, int k0, int lane) {
  float t[NT][4];
  zero(t);
  mma_parts<PA, PB, NT, BT>(t, af, b, b_ld, b_part, n0, k0, lane);
  add(acc, t);
}

// A's fragments of every 16-deep step (rows m0 .. m0 + 15, K deep) from
// shared memory into registers.
template <int PA, int K>
__device__ __forceinline__ void load_frags(uint32_t (&af)[K / 16][PA][4],
                                           const bf16* a, int a_ld,
                                           int a_part, int m0, int lane) {
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks)
#pragma unroll
    for (int pa = 0; pa < PA; ++pa)
      load_a(af[ks][pa], a + pa * a_part, a_ld, m0, 16 * ks, lane);
}

// acc (16 x 8 NT) += A (16 x K) B (K x 8 NT): A's PA parts as fragments
// of every 16-deep step in registers, B's PB parts in shared memory (part
// pb at b + pb * b_part), its n-tiles n0 + 8 nt.  Both kernels form S and
// dP with it, so an element's logit has the same bits in both.
template <int PA, int PB, int NT, int K, bool BT>
__device__ __forceinline__ void warp_mma_regs(
    float (&acc)[NT][4], const uint32_t (&af)[K / 16][PA][4], const bf16* b,
    int b_ld, int b_part, int n0, int lane) {
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks)
    mma_step<PA, PB, NT, BT>(acc, af[ks], b, b_ld, b_part, n0, 16 * ks,
                             lane);
}

// ---------------------------------------------------------------------------
// Asynchronous copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// N rows of D elements of T into dst (contiguous), 16 bytes a copy: src(rl)
// is row rl's first element, or null for a row of zeros (read from
// nowhere: `base` stands in).  Where a row's copies split evenly among the
// block's threads, thread t copies row t / TPR (TPR = threads a row) and
// asks src once; otherwise (head_dim 16 in bfloat16) the threads
// take the copies in turn.
template <int N, int D, typename T, typename Src>
__device__ __forceinline__ void copy_rows(unsigned char* dst, const T* base,
                                          Src src) {
  constexpr int CPR = D * (int)sizeof(T) / 16;   // copies a row
  constexpr int TOTAL = N * CPR;
  static_assert(D * (int)sizeof(T) % 16 == 0, "whole copies a row");
  if constexpr (kThreads % N == 0 && CPR % (kThreads / N) == 0) {
    constexpr int TPR = kThreads / N;
    const int rl = threadIdx.x / TPR;
    const T* row = src(rl);
#pragma unroll
    for (int it = 0; it < CPR / TPR; ++it) {
      const int c = threadIdx.x % TPR + TPR * it;
      cp_async16(dst + (rl * CPR + c) * 16,
                 reinterpret_cast<const char*>(row ? row : base)
                     + (row ? c * 16 : 0),
                 row ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int it = 0; it < (TOTAL + kThreads - 1) / kThreads; ++it) {
      const int e = threadIdx.x + it * kThreads;
      if (TOTAL % kThreads != 0 && e >= TOTAL) break;
      const T* row = src(e / CPR);
      cp_async16(dst + e * 16,
                 reinterpret_cast<const char*>(row ? row : base)
                     + (row ? (e % CPR) * 16 : 0),
                 row ? 16 : 0);
    }
  }
}

// ---------------------------------------------------------------------------
// 1. rows: the row statistics, D and dq
// ---------------------------------------------------------------------------

// MASK (a template parameter of both kernels) is true when the launch
// has a window or a soft-cap: without either the kernels compile without
// their branches, as they did before they took them.

// The first key visible to the row at position p: p - window + 1, or 0.
template <bool MASK>
__device__ __forceinline__ long long first_key(long long p, const Args& a) {
  if constexpr (!MASK) return 0LL;
  return a.window > 0 ? max(0LL, p - a.window + 1) : 0LL;
}

// The logit of a scaled dot product x: c * t, t = tanhf(x / c), with a
// soft-cap c (t written to `t`), else x.
template <bool MASK>
__device__ __forceinline__ float capped(float x, const Args& a, float& t) {
  if (MASK && a.softcap > 0.0f) {
    t = tanhf(__fdiv_rn(x, a.softcap));
    return __fmul_rn(a.softcap, t);
  }
  t = 0.0f;
  return x;
}

// dS of one element from its P, dP, the row's D and the capped logit's t,
// in the plain version's autograd order: P (dP - D), then through the
// soft-cap (x c, x (1 - t t), / c), then x scale.
template <bool MASK>
__device__ __forceinline__ float dlogit(float p, float dp, float dr, float t,
                                        const Args& a) {
  float g = __fmul_rn(p, __fsub_rn(dp, dr));
  if (MASK && a.softcap > 0.0f) {
    g = __fmul_rn(g, a.softcap);
    g = __fmul_rn(g, __fsub_rn(1.0f, __fmul_rn(t, t)));
    g = __fdiv_rn(g, a.softcap);
  }
  return __fmul_rn(g, a.scale);
}

// Block (hk, b, z) of the grid (Hkv, B, ceil(G * Sq / RT)): rows [tile *
// RT, +RT) of KV head hk of batch row b, tile = tiles - 1 - z (the rows
// with the most keys first).  Warp w takes rows (w % RG) * 16 .. + 15
// against key part (w / RG) % KP of every chunk (KC / KP keys) and dq's
// columns part w / (RG KP), with its own online statistics and dq; the
// key parts meet in shared memory, part 0 first, after each pass.  The
// chunks start at the one holding the first key the tile's first row
// sees (0 without a window).
template <typename T, int D, bool MASK>
__global__ void __launch_bounds__(kThreads, 1) rows_kernel(const Args a) {
  using C = Cfg<T, D>;
  constexpr int RT = C::RT, KC = C::KC, LD = C::LD, XP = C::XP;
  constexpr int KP = C::KP, RG = C::RG;
  constexpr int KH = KC / KP;         // keys of a warp's part of a chunk
  constexpr int NT = KH / 8;          // key tiles of a warp's S
  constexpr int DT = D / 8;           // column tiles of a warp's dq
  constexpr int RP = D + 8;           // float pitch of a dq half's row
  static_assert(NT % 2 == 0 && DT % 2 == 0, "tiles");
  // q's and dout's fragments stay in registers (96 of them in float32 at
  // head_dim 64)
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float part_m[KP][RT], part_l[KP][RT], part_d[KP][RT];
  bf16* qs = reinterpret_cast<bf16*>(smem);   // XP x RT x LD
  bf16* os = qs + XP * RT * LD;               // 3 x RT x LD
  bf16* ks = os + C::OP * RT * LD;            // XP x KC x LD
  bf16* vs = ks + XP * KC * LD;               // XP x KC x LD
  unsigned char* rawk = reinterpret_cast<unsigned char*>(vs + XP * KC * LD);
  unsigned char* rawv = rawk + KC * D * C::TS;

  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = (warp % RG) * 16;          // the warp's rows
  const int kh = (warp / RG) % KP;            // its key part
  // PROBE start
  const int hk = blockIdx.x, b = blockIdx.y;
  const int G = a.G, total = G * a.Sq;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * RT;
  const long long start = a.causal ? (long long)a.q_start[b] : 0;
  const int last = min(total, r0 + RT) - 1;
  const int kv_end = a.causal
      ? (int)min((long long)a.Skv, start + last / G + 1) : a.Skv;
  const int kv_begin = MASK && a.causal
      ? (int)min((long long)kv_end - 1, first_key<MASK>(start + r0 / G, a))
      : 0;
  const int c0 = kv_begin / KC;               // the first chunk walked

  auto copy_chunk = [&](int c) {
    auto off = [&](int jl) -> long long {
      const int j = c * KC + jl;
      return j < kv_end ? at(b, j, hk, a.Skv, a.Hkv, D) : -1;
    };
    copy_rows<KC, D, T>(rawk, k, [&](int jl) -> const T* {
      const long long o = off(jl);
      return o < 0 ? nullptr : k + o;
    });
    copy_rows<KC, D, T>(rawv, v, [&](int jl) -> const T* {
      const long long o = off(jl);
      return o < 0 ? nullptr : v + o;
    });
    cp_async_commit();
  };
  copy_chunk(c0);             // in flight while q and dout are split

  // q and dout of the tile's rows, as parts
  auto row_off = [&](int rl) -> long long {
    const int r = r0 + rl;
    return r < total ? at(b, r / G, hk * G + r % G, a.Sq, a.Hq, D) : -1;
  };
  {
    Rows4<RT, D> xq, xo;        // every load in flight before the splits
    load_rows<RT, D, T>(xq, [&](int rl) -> const T* {
      const long long o = row_off(rl);
      return o < 0 ? nullptr : q + o;
    });
    load_rows<RT, D, float>(xo, [&](int rl) -> const float* {
      const long long o = row_off(rl);
      return o < 0 ? nullptr : a.dout + o;
    });
    store_parts<XP, RT, D, LD>(qs, xq);
    store_parts<C::OP, RT, D, LD>(os, xo);
  }
  uint32_t qf[D / 16][XP][4], of[D / 16][C::OP][4];
  __syncthreads();
  load_frags<XP, D>(qf, qs, LD, RT * LD, row0, lane);
  load_frags<C::OP, D>(of, os, LD, RT * LD, row0, lane);
  // PROBE 0

  // the thread's rows (+0, +8 of the warp's 16): first and last visible
  // key, or lim -1 for a row that sees none
  int lo[2], lim[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = r0 + row0 + g + 8 * h2;
    const long long p = start + r / G;
    lo[h2] = MASK && a.causal
        ? (int)min((long long)a.Skv, first_key<MASK>(p, a)) : 0;
    lim[h2] = r >= total ? -1
              : a.causal ? (int)min((long long)a.Skv - 1, p) : a.Skv - 1;
    if (MASK && lo[h2] > lim[h2]) lim[h2] = -1;
  }

  auto convert_chunk = [&]() {
    const T* tk = reinterpret_cast<const T*>(rawk);
    const T* tv = reinterpret_cast<const T*>(rawv);
    to_parts<XP, KC, D, LD, T>(ks, [&](int jl) { return tk + jl * D; });
    to_parts<XP, KC, D, LD, T>(vs, [&](int jl) { return tv + jl * D; });
  };
  // S (logits, soft-capped, -inf where hidden; tc: each one's t) and dP
  // (rounded under round_dp) of the warp's rows against its part of
  // chunk c
  float s[NT][4], dp[NT][4], tc[NT][4];
  auto scores = [&](int c) {
    zero(s);
    zero(dp);
    warp_mma_regs<XP, XP, NT, D, false>(s, qf, ks, LD, KC * LD, kh * KH,
                                        lane);
    warp_mma_regs<C::OP, XP, NT, D, false>(dp, of, vs, LD, KC * LD, kh * KH,
                                           lane);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = c * KC + kh * KH + nt * 8 + 2 * t4 + (r & 1);
        const float x =
            capped<MASK>(__fmul_rn(s[nt][r], a.scale), a, tc[nt][r]);
        s[nt][r] = j <= lim[r >> 1] && (!MASK || j >= lo[r >> 1])
            ? x : -INFINITY;
        if (a.round_dp) dp[nt][r] = round_bf16(dp[nt][r]);
      }
  };
  const int chunks = (kv_end + KC - 1) / KC;

  // Pass 1: the online max m, sum l of exp(s - m) and d = sum exp(s - m)
  // dP, a lane's columns each (the row's max is shared by its 4 lanes).
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f},
        d[2] = {0.0f, 0.0f};
  for (int c = c0; c < chunks; ++c) {
    cp_async_wait_all();
    __syncthreads();          // chunk c landed; the last parts are read
    // PROBE 1
    convert_chunk();
    __syncthreads();          // parts ready; the raw buffer is free
    // PROBE 2
    copy_chunk(c + 1 < chunks ? c + 1 : c0);   // pass 2 starts at chunk c0
    scores(c);
    // PROBE 3
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float mc = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mc = fmaxf(mc, fmaxf(s[nt][2 * h2], s[nt][2 * h2 + 1]));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      const float mn = fmaxf(m[h2], mc);
      const float f = m[h2] == -INFINITY ? 0.0f : expf(m[h2] - mn);
      float ls = 0.0f, ds = 0.0f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[nt][2 * h2 + e];
          const float ex = expf(x - mn);   // computed for every element:
          const float p = x == -INFINITY ? 0.0f : ex;   // no branch
          ls += p;
          ds += p * dp[nt][2 * h2 + e];
        }
      l[h2] = l[h2] * f + ls;
      d[h2] = d[h2] * f + ds;
      m[h2] = mn;
    }
    // PROBE 4
  }
  // The key parts' (m, l, d) of each row, part 0 first: M, L and D = d /
  // L
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    float ls = l[h2], ds = d[h2];
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    ds += __shfl_xor_sync(0xffffffffu, ds, 1);
    ds += __shfl_xor_sync(0xffffffffu, ds, 2);
    if (t4 == 0) {
      const int row = row0 + g + 8 * h2;
      part_m[kh][row] = m[h2];
      part_l[kh][row] = ls;
      part_d[kh][row] = ds;
    }
  }
  __syncthreads();
  float M[2], L[2], Dr[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = row0 + g + 8 * h2;
    float mx = part_m[0][row];
#pragma unroll
    for (int kp = 1; kp < KP; ++kp) mx = fmaxf(mx, part_m[kp][row]);
    float f[KP];
#pragma unroll
    for (int kp = 0; kp < KP; ++kp)
      f[kp] = part_m[kp][row] == -INFINITY ? 0.0f
                                           : expf(part_m[kp][row] - mx);
    const float ls = part_l[0][row] * f[0] + part_l[1][row] * f[1];
    const float ds = part_d[0][row] * f[0] + part_d[1][row] * f[1];
    const bool valid = lim[h2] >= 0;
    M[h2] = valid ? mx : 0.0f;
    L[h2] = valid ? ls : 1.0f;
    Dr[h2] = valid ? __fdiv_rn(ds, ls) : 0.0f;
  }
  // PROBE 5

  // Pass 2: dS (dlogit) from P = exp(s - M) / L; dq += dS K with dS as
  // the A operand straight from the accumulators (three parts).
  float dq[DT][4];
  zero(dq);
  for (int c = c0; c < chunks; ++c) {
    cp_async_wait_all();
    __syncthreads();
    convert_chunk();
    __syncthreads();
    // PROBE 6
    if (c + 1 < chunks) copy_chunk(c + 1);
    scores(c);
    // PROBE 7
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = s[nt][r];
        const int h2 = r >> 1;
        // every element computed, the hidden ones then dropped: no branch
        const float p = __fdiv_rn(expf(x - M[h2]), L[h2]);
        const float ds = dlogit<MASK>(p, dp[nt][r], Dr[h2], tc[nt][r], a);
        s[nt][r] = x != -INFINITY ? ds : 0.0f;
      }
#pragma unroll
    for (int kq = 0; kq < KH / 16; ++kq) {
      uint32_t af[3][4];
      split3(make_float2(s[2 * kq][0], s[2 * kq][1]), af[0][0], af[1][0],
             af[2][0]);
      split3(make_float2(s[2 * kq][2], s[2 * kq][3]), af[0][1], af[1][1],
             af[2][1]);
      split3(make_float2(s[2 * kq + 1][0], s[2 * kq + 1][1]), af[0][2],
             af[1][2], af[2][2]);
      split3(make_float2(s[2 * kq + 1][2], s[2 * kq + 1][3]), af[0][3],
             af[1][3], af[2][3]);
      float t[DT][4];
      zero(t);
      mma_parts<3, XP, DT, true>(t, af, ks, LD, KC * LD, 0, kh * KH + kq * 16,
                                 lane);
      add(dq, t);
    }
    // PROBE 8
  }

  // dq = part 0's + part 1's, through shared memory over q and dout
  float* red = reinterpret_cast<float*>(smem);
  __syncthreads();            // every warp is done with the parts
  if (kh == 1) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
      for (int dn = 0; dn < DT; ++dn)
        *reinterpret_cast<float2*>(
            red + (row0 + g + 8 * h2) * RP + dn * 8 + 2 * t4) =
            make_float2(dq[dn][2 * h2], dq[dn][2 * h2 + 1]);
  }
  __syncthreads();
  // PROBE 9
  // PROBE dump g_dbg_rows 10 chunks
  if (kh == 1) return;
  T* dqp = static_cast<T*>(a.dq);
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = r0 + row0 + g + 8 * h2;
    if (r >= total) continue;
    const int i = r / G, h = hk * G + r % G;
    const long long off = at(b, i, h, a.Sq, a.Hq, D);
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      const int col = dn * 8 + 2 * t4;
      const float2 o = *reinterpret_cast<const float2*>(
          red + (row0 + g + 8 * h2) * RP + col);
      const float x0 = dq[dn][2 * h2] + o.x, x1 = dq[dn][2 * h2 + 1] + o.y;
      if constexpr (C::F32) {
        *reinterpret_cast<float2*>(dqp + off + col) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dqp + off + col) =
            __float22bfloat162_rn(make_float2(x0, x1));
      }
    }
    if (t4 == 0) {
      const long long si = ((long long)b * a.Sq + i) * a.Hq + h;
      a.stat_m[si] = M[h2];
      a.stat_l[si] = L[h2];
      a.stat_d[si] = Dr[h2];
    }
  }
}

// ---------------------------------------------------------------------------
// 2. keys: dk and dv
// ---------------------------------------------------------------------------

// t[nt] += the kept part products of one 16-deep step with the operands'
// roles swapped: A holds y's PY parts (fragments yf), B is x's PX parts in
// shared memory (rows n0 + 8 nt of x).  Each element (y row, x row) gets
// the products x.y in the order mma_parts gives them on (A = x, B = y):
// mma.sync is symmetric in its operands, so the sums have the same bits.
template <int PX, int PY, int NT>
__device__ __forceinline__ void mma_parts_swapped(
    float (&t)[NT][4], const uint32_t (&yf)[PY][4], const bf16* x, int x_ld,
    int x_part, int n0, int k0, int lane) {
  uint32_t bf[PX][NT][2];
#pragma unroll
  for (int px = 0; px < PX; ++px)
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t r[4];
      load_b<false>(r, x + px * x_part, x_ld, n0 + 16 * np, k0, lane);
      bf[px][2 * np][0] = r[0];
      bf[px][2 * np][1] = r[1];
      bf[px][2 * np + 1][0] = r[2];
      bf[px][2 * np + 1][1] = r[3];
    }
#pragma unroll
  for (int py = PY - 1; py >= 0; --py)
#pragma unroll
    for (int px = PX - 1; px >= 0; --px) {
      if (px + py > 2) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(t[nt], yf[py], bf[px][nt]);
    }
}

// Block (hk, b, z) of the grid (Hkv, B, ceil(Skv / KB)): keys [z * KB,
// +KB) of KV head hk of batch row b (the keys most rows see first).  The
// rows r = i * G + g that can see the block's keys come in tiles of RK,
// from a multiple of RK (r from (j0 - q_start) * G when causal) to the
// last row whose window reaches its last key (the last row without a
// window).  Warp w takes keys (w % KG) * 16 .. + 15 and forms S^T = K q^T
// and dP^T = V dout^T for them against RS rows of each tile, then P^T and
// dS^T in its accumulators, which are the A operands of dv += P^T dout
// and dk += dS^T q.  The two warps of a key group take the two halves of
// the tile's rows (RS = RK / 2) and meet at the end, half 0 first, and
// K's fragments stay in registers.
template <typename T, int D, bool MASK>
__global__ void __launch_bounds__(kThreads, 1) keys_kernel(const Args a) {
  using C = Cfg<T, D>;
  constexpr int KB = C::KB, RK = C::RK, LD = C::LD;
  constexpr int XP = C::XP, OP = C::OP;
  constexpr int SPLIT = C::SPLIT;     // row parts of a tile
  constexpr int RS = RK / SPLIT;      // rows of a warp's S^T
  constexpr int NT = RS / 8;
  constexpr int DT = D / 8;           // column tiles of dk and dv
  constexpr int RP = D + 8;           // float pitch of a merged row
  static_assert(KB % 16 == 0 && NT % 2 == 0, "key groups of 16");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float sm[RK], sl[RK], sd[RK];
  __shared__ int slo[RK], slim[RK];
  bf16* ks = reinterpret_cast<bf16*>(smem);   // XP x KB x LD
  bf16* vs = ks + XP * KB * LD;               // XP x KB x LD
  bf16* qs = vs + XP * KB * LD;               // XP x RK x LD
  bf16* os = qs + XP * RK * LD;               // 3 x RK x LD
  unsigned char* rawq = reinterpret_cast<unsigned char*>(os + OP * RK * LD);
  unsigned char* rawo = rawq + RK * D * C::TS;
  float* rawst = reinterpret_cast<float*>(rawo + RK * D * 4);   // M, L, D

  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int key0 = (warp % C::KG) * 16, sp = warp / C::KG;
  const int rs0 = sp * RS;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int G = a.G, total = G * a.Sq;
  const int j0 = blockIdx.z * KB;
  // PROBE start
  const long long start = a.causal ? (long long)a.q_start[b] : 0;

  const long long seen =
      a.causal ? max(0LL, (long long)j0 - start) * G : 0LL;
  const int first = (int)min((long long)total, seen / RK * RK);
  // past the last row that can see the block's last key
  const long long j_last = min(j0 + KB, a.Skv) - 1;
  const int end = MASK && a.causal && a.window > 0
      ? (int)min((long long)total,
                 max(0LL, j_last + a.window - start) * G)
      : total;
  const int tiles = end > first ? (end - first + RK - 1) / RK : 0;

  auto copy_tile = [&](int r0) {
    auto stat = [&](int rl) -> long long {   // row rl's statistics' index
      const int r = r0 + rl;
      return r < total ? ((long long)b * a.Sq + r / G) * a.Hq + hk * G + r % G
                       : -1;
    };
    copy_rows<RK, D, T>(rawq, q, [&](int rl) -> const T* {
      const long long si = stat(rl);
      return si < 0 ? nullptr : q + si * D;
    });
    copy_rows<RK, D, float>(rawo, a.dout, [&](int rl) -> const float* {
      const long long si = stat(rl);
      return si < 0 ? nullptr : a.dout + si * D;
    });
    for (int rl = tid; rl < RK; rl += kThreads) {
      const long long si = stat(rl);
      cp_async4(rawst + rl, a.stat_m + max(si, 0LL), si < 0 ? 0 : 4);
      cp_async4(rawst + RK + rl, a.stat_l + max(si, 0LL), si < 0 ? 0 : 4);
      cp_async4(rawst + 2 * RK + rl, a.stat_d + max(si, 0LL), si < 0 ? 0 : 4);
    }
    cp_async_commit();
  };

  // the block's K and V, as parts (zeros past Skv), while the first tile
  // of rows is copied
  if (tiles > 0) copy_tile(first);
  {
    Rows4<KB, D> xk, xv;        // every load in flight before the splits
    load_rows<KB, D, T>(xk, [&](int jl) -> const T* {
      const int j = j0 + jl;
      return j < a.Skv ? k + at(b, j, hk, a.Skv, a.Hkv, D) : nullptr;
    });
    load_rows<KB, D, T>(xv, [&](int jl) -> const T* {
      const int j = j0 + jl;
      return j < a.Skv ? v + at(b, j, hk, a.Skv, a.Hkv, D) : nullptr;
    });
    store_parts<XP, KB, D, LD>(ks, xk);
    store_parts<XP, KB, D, LD>(vs, xv);
  }
  uint32_t kf[D / 16][XP][4];      // K's fragments stay in registers
  __syncthreads();
  load_frags<XP, D>(kf, ks, LD, KB * LD, key0, lane);
  // PROBE 0

  float dk[DT][4], dv[DT][4];
  zero(dk);
  zero(dv);
  for (int t = 0; t < tiles; ++t) {
    const int r0 = first + t * RK;
    cp_async_wait_all();
    __syncthreads();          // tile t landed; the last tile's parts are read
    // PROBE 1
    {
      Rows4<RK, D> xq, xo;
      load_rows<RK, D, T>(xq, [&](int rl) {
        return reinterpret_cast<const T*>(rawq) + rl * D;
      });
      load_rows<RK, D, float>(xo, [&](int rl) {
        return reinterpret_cast<const float*>(rawo) + rl * D;
      });
      store_parts<XP, RK, D, LD>(qs, xq);
      store_parts<OP, RK, D, LD>(os, xo);
    }
    for (int rl = tid; rl < RK; rl += kThreads) {
      const int r = r0 + rl;
      const bool valid = r < total;
      const long long p = start + r / G;
      sm[rl] = valid ? rawst[rl] : 0.0f;
      sl[rl] = valid ? rawst[RK + rl] : 1.0f;
      sd[rl] = valid ? rawst[2 * RK + rl] : 0.0f;
      if constexpr (MASK)
        slo[rl] = a.causal
            ? (int)min((long long)a.Skv, first_key<MASK>(p, a)) : 0;
      slim[rl] = !valid ? -1
                 : a.causal ? (int)min((long long)a.Skv - 1, p) : a.Skv - 1;
    }
    __syncthreads();          // parts ready; the raw buffer is free
    if (t + 1 < tiles) copy_tile(r0 + RK);
    // PROBE 2

    // S^T and dP^T of the warp's 16 keys against its RS rows: each
    // element's products in the rows kernel's order (mma_parts_swapped)
    float s[NT][4], dp[NT][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      float t1[NT][4], t2[NT][4];
      zero(t1);
      zero(t2);
      mma_parts_swapped<XP, XP, NT>(t1, kf[kk], qs, LD, RK * LD, rs0,
                                    16 * kk, lane);
      uint32_t f[XP][4];
#pragma unroll
      for (int p = 0; p < XP; ++p)
        load_a(f[p], vs + p * KB * LD, LD, key0, 16 * kk, lane);
      mma_parts_swapped<OP, XP, NT>(t2, f, os, LD, RK * LD, rs0, 16 * kk,
                                    lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          s[nt][r] += t1[nt][r];
          dp[nt][r] += t2[nt][r];
        }
    }
    // PROBE 3
    // P^T (in s) and dS^T (in dp): key g + 8 (r >> 1), row 2 t4 + (r & 1)
    // of n-tile nt
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = j0 + key0 + g + 8 * (r >> 1);
        const int rl = rs0 + nt * 8 + 2 * t4 + (r & 1);
        // every element computed, the hidden ones then dropped: no branch
        float tt;
        const float x = capped<MASK>(__fmul_rn(s[nt][r], a.scale), a, tt);
        const float dpe = a.round_dp ? round_bf16(dp[nt][r]) : dp[nt][r];
        const float pe = __fdiv_rn(expf(x - sm[rl]), sl[rl]);
        const float de = dlogit<MASK>(pe, dpe, sd[rl], tt, a);
        const bool vis = j <= slim[rl] && (!MASK || j >= slo[rl]);
        s[nt][r] = vis ? (a.round_dp ? round_bf16(pe) : pe) : 0.0f;
        dp[nt][r] = vis ? de : 0.0f;   // (round_dp: the P that P V used)
      }

    // PROBE 4
    // dv += P^T dout and dk += dS^T q over the warp's rows, 16 at a time,
    // P^T and dS^T as A operands from the accumulators (P rounded to bf16
    // is one part)
#pragma unroll
    for (int kq = 0; kq < RS / 16; ++kq) {
      uint32_t fp[3][4], fs[3][4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int nt = 2 * kq + (h >> 1), r = 2 * (h & 1);
        split3(make_float2(s[nt][r], s[nt][r + 1]), fp[0][h], fp[1][h],
               fp[2][h]);
        split3(make_float2(dp[nt][r], dp[nt][r + 1]), fs[0][h], fs[1][h],
               fs[2][h]);
      }
      const int k0 = rs0 + 16 * kq;
      if (C::F32 || !a.round_dp) {
        float t[DT][4];
        zero(t);
        mma_parts<3, OP, DT, true>(t, fp, os, LD, RK * LD, 0, k0, lane);
        add(dv, t);
      } else {
        const uint32_t f1[1][4] = {{fp[0][0], fp[0][1], fp[0][2], fp[0][3]}};
        float t[DT][4];
        zero(t);
        mma_parts<1, OP, DT, true>(t, f1, os, LD, RK * LD, 0, k0, lane);
        add(dv, t);
      }
      float t[DT][4];
      zero(t);
      mma_parts<3, XP, DT, true>(t, fs, qs, LD, RK * LD, 0, k0, lane);
      add(dk, t);
    }
    // PROBE 5
  }

  // the two row halves of each key group: half 0 + half 1, through shared
  // memory over the parts
  {
    float* red = reinterpret_cast<float*>(smem);
    __syncthreads();          // every warp is done with the parts
    if (sp == 1) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int dn = 0; dn < DT; ++dn) {
          const int row = key0 + g + 8 * h2, col = dn * 8 + 2 * t4;
          *reinterpret_cast<float2*>(red + row * RP + col) =
              make_float2(dk[dn][2 * h2], dk[dn][2 * h2 + 1]);
          *reinterpret_cast<float2*>(red + (KB + row) * RP + col) =
              make_float2(dv[dn][2 * h2], dv[dn][2 * h2 + 1]);
        }
    }
    __syncthreads();
    if (sp == 1) return;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        const int row = key0 + g + 8 * h2, col = dn * 8 + 2 * t4;
        const float2 xk = *reinterpret_cast<const float2*>(red + row * RP + col);
        const float2 xv =
            *reinterpret_cast<const float2*>(red + (KB + row) * RP + col);
        dk[dn][2 * h2] += xk.x;
        dk[dn][2 * h2 + 1] += xk.y;
        dv[dn][2 * h2] += xv.x;
        dv[dn][2 * h2 + 1] += xv.y;
      }
  }

  // PROBE dump g_dbg_keys 6 tiles
  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int j = j0 + key0 + g + 8 * h2;
    if (j >= a.Skv) continue;
    const long long off = at(b, j, hk, a.Skv, a.Hkv, D);
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      const int col = dn * 8 + 2 * t4;
      const float2 xk = make_float2(dk[dn][2 * h2], dk[dn][2 * h2 + 1]);
      const float2 xv = make_float2(dv[dn][2 * h2], dv[dn][2 * h2 + 1]);
      if constexpr (C::F32) {
        *reinterpret_cast<float2*>(dkp + off + col) = xk;
        *reinterpret_cast<float2*>(dvp + off + col) = xv;
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dkp + off + col) =
            __float22bfloat162_rn(xk);
        *reinterpret_cast<__nv_bfloat162*>(dvp + off + col) =
            __float22bfloat162_rn(xv);
      }
    }
  }
}

template <typename T, int D, bool MASK>
int launch(const Args& a, int B, cudaStream_t stream) {
  using C = Cfg<T, D>;
  const long long rtiles = ((long long)a.G * a.Sq + C::RT - 1) / C::RT;
  const long long ktiles = ((long long)a.Skv + C::KB - 1) / C::KB;
  if (rtiles > 65535 || ktiles > 65535) return (int)cudaErrorInvalidValue;
  static const int attr_rows = (int)cudaFuncSetAttribute(
      rows_kernel<T, D, MASK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::rows_smem);   // once
  static const int attr_keys = (int)cudaFuncSetAttribute(
      keys_kernel<T, D, MASK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::keys_smem);
  if (attr_rows) return attr_rows;
  if (attr_keys) return attr_keys;
  rows_kernel<T, D, MASK><<<dim3(a.Hkv, B, (unsigned)rtiles), kThreads,
                      C::rows_smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  keys_kernel<T, D, MASK><<<dim3(a.Hkv, B, (unsigned)ktiles), kThreads,
                      C::keys_smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool MASK>
int dispatch_d(int D, const Args& a, int B, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16, MASK>(a, B, stream);
    case 32: return launch<T, 32, MASK>(a, B, stream);
    case 64: return launch<T, 64, MASK>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: contiguous (B, Sq, Hq, D), (B, Skv, Hkv, D) of one type
// (bf16 = 1: bfloat16, else float32), on a 16-byte boundary, D in 16, 32,
// 64; dout: contiguous float32 like q; dq, dk, dv: like q,
// k, v; stats: 3 * B * Sq * Hq floats of scratch.  window: 0 (global) or
// the sliding window's width (causal only); softcap: 0 (off) or the
// logit soft-cap.  Returns 0 or the CUDA error of a refused launch.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* q_start, void* dq, void* dk, void* dv, void* stats,
    int bf16, int B, int Sq, int Skv, int Hq, int Hkv, int D, float scale,
    int causal, int round_p, int window, float softcap, void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0) return 0;
  if (Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (window < 0 || !(softcap >= 0.0f) || (window > 0 && !causal))
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
  a.softcap = softcap;
  a.window = window;
  a.causal = causal;
  a.round_dp = round_p && bf16;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool mask = window > 0 || softcap > 0.0f;
  if (bf16)
    return mask ? dispatch_d<__nv_bfloat16, true>(D, a, B, s)
                : dispatch_d<__nv_bfloat16, false>(D, a, B, s);
  return mask ? dispatch_d<float, true>(D, a, B, s)
              : dispatch_d<float, false>(D, a, B, s);
}

// Flash attention backward for Hopper at head_dims 112, 128 and 256: the
// warpgroup (wgmma) design.
//
// The gradient of the forward in flash_attention.cu, which replaces the
// Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention/flash_attention.py (body `_kernel`);
// the JAX package differentiates the model's attention with XLA's
// autodiff.  It computes what flash_attention_bwd.cu computes (its header
// states the function, the type rules, the masks and the soft-cap's
// derivative) for the wide head dimensions, where that file's mma.sync
// tiles formed every logit four times; flash_attention_bwd.cu keeps
// head_dims 16, 32 and 64.
//
// What bounds it on the card.  Gemma-2-9B's gradient at 4,608 tokens (16
// query heads, 8 KV heads, head_dim 256, a window of 4,096) needs 5
// products over 168 M visible (query head, key) pairs: 0.86 TFLOP, 0.9 ms
// on the bf16 tensor cores' 989 TFLOP/s (float32 operands: 6 part
// products each, 5.2 ms); its bytes take 0.1 ms.  So it is bound by
// operations, and every product runs on wgmma.
//
// Design:
// - Packing.  One launch (`hop::pack_kernel`) lays q, dout, k and v out as
//   packed tiles of 64 rows in bf16 parts (hopper.cuh): q, k, v one part
//   in bfloat16, three in float32; dout always three.  Every operand of a
//   product is then a whole slab of a packed tile, copied by one bulk copy
//   a part.
// - Two kernels, rows (dq and the row statistics) and keys (dk, dv), each
//   block two consumer warpgroups and a producer warp (the first of a
//   third warpgroup, which gives its registers to the consumers:
//   setmaxnreg).  The producer's lane 0 feeds warpgroup 0's ring, lane 1
//   warpgroup 1's (3 stages of 24 KB each, mbarriers), in the order the
//   warpgroup consumes them.
// - One logit once.  Warpgroup 0 forms S = q K^T for a (64-row tile, 64-key
//   chunk) and warpgroup 1 dP = dout V^T for the same pair, each slab of
//   the head dimension (S: 32 columns for float32 operands, 64 for
//   bfloat16; dP: 32) one chain of m64n64k16 wgmmas over the kept part
//   pairs in a fixed order, and the chains' sums added in IEEE float32
//   (the tensor cores' adder does not round to nearest: a chain a 64 x 64
//   tile of the whole sum grew dk's error on the H100 to 2.5e-4 at 1,024
//   keys, 3.0e-5 of its largest value, beyond the plain version's
//   tolerance).  The gradients' products likewise: a chain a 64-deep
//   piece, added in float32.  Warpgroup 1 hands dP over in shared memory;
//   warpgroup 0 alone turns S and dP into P and dS, which it writes as bf16
//   parts (rows in M, keys in K), for both warpgroups to read as the A
//   operand of the gradient's products.  No warp forms a logit another
//   warp forms.  Both kernels form S with the same function on the same
//   tiles (rows in M, keys in N), so the keys kernel's logit has the rows
//   kernel's bits: P = 1 exactly at a row's maximum, and a row that sees
//   one key gets dS = 0.
// - rows: a block holds 64 rows r = i * G + g of one KV head and walks the
//   chunks of 64 keys its rows can see twice: pass 1 keeps the online max
//   m, sum l of exp(s - m) and d = sum exp(s - m) dP; pass 2 forms P =
//   exp(s - M) / L and dS and sums dq = dS K, warpgroup 0 into dq's first
//   columns (64, or 128 at head_dim 256) and warpgroup 1 into the rest,
//   both from K read MN-major.  It writes dq and (M, L, D = d / L).
// - keys: a block holds 64 keys of one KV head and walks the tiles of 64
//   rows that can see them; warpgroup 0 writes P and dS, and sums dv +=
//   P^T dout, warpgroup 1 dk += dS^T q (P and dS read transposed, dout and
//   q MN-major).  Where the key tiles alone leave most SMs idle (Gemma-3's
//   one KV head), a thread-block cluster of up to 8 blocks shares a key
//   tile: rank q takes its row tiles q, q + S, ..., and the ranks' dk and
//   dv meet through distributed shared memory in rank order.
// - No floating-point atomics: every output element is summed by one
//   thread in a fixed order, so two calls give the same bits.
// - Shared memory: the two rings (144 KB), dP (16 KB) and dS's parts (24
//   KB), P's parts (24 KB) in the keys kernel: 184 and 208 KB, one block
//   an SM.  Three stages suffice: five of 16 KB for the bfloat16 slabs
//   measured the same on the H100 (the short wgmma chains, not the
//   copies, set the pace).
//
// Nothing is allocated; the wrapper passes the packed buffers and the
// statistics' scratch.  The launches run on the caller's stream.  IEEE
// float32, expf and division; no --use_fast_math.

#pragma once

#include "hopper.cuh"

#include <cooperative_groups.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

using namespace hop;

constexpr int kWG = 128;                     // threads of a warpgroup
// two consumer warpgroups and a producer warpgroup (of which one warp
// works), which hands most of its registers to the consumers
constexpr int kThreads = 3 * kWG;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(kWG * kProducerRegs + 2 * kWG * kConsumerRegs <= 65536,
              "registers");
constexpr int kStages = 3;                   // of each ring
constexpr int kStageBytes = 24 * 1024;
constexpr int kMaxSplits = 8;                // a portable cluster size
// named barriers (0 is __syncthreads)
constexpr int kDpFull = 1, kXEmpty = 2, kDsFull = 3, kDsEmpty = 4, kWg0 = 5,
              kBoth = 6;

struct Args {
  const bf16* q; const bf16* k; const bf16* v; const bf16* o;   // packed
  const int* q_start;
  void* dq; void* dk; void* dv;
  float* stat_m; float* stat_l; float* stat_d;   // (B, Sq, Hq) each
  int Sq, Skv, Hq, Hkv, G;
  int rtiles, ktiles;      // packed tiles of a (batch row, KV head)
  int splits;              // keys kernel: the cluster's blocks on a key tile
  float scale, softcap;    // softcap 0: off
  int causal, round_dp;
  int window;              // 0: global
};

// Tiles, slabs and shared memory; the wrapper's `bwd_wgmma_plan` states
// the same numbers.
template <int D, bool F32>
struct Cfg {
  static constexpr int XP = F32 ? 3 : 1;       // parts of q, k, v
  static constexpr int OP = 3;                 // parts of dout, P, dS
  static constexpr int SW0 = F32 ? 32 : 64;    // columns of an S slab
  static constexpr int SW1 = 32;               // columns of a dP slab
  static constexpr int NS0 = (D + SW0 - 1) / SW0;
  static constexpr int NS1 = (D + SW1 - 1) / SW1;
  // dP's last NT slabs are one chain of their own (bfloat16: 3 part pairs
  // a slab against S's 1; the rows kernel's warpgroup 0 forms them, so
  // that both warpgroups bring in as many slabs); the other NS1 - NT are
  // a chain each
  static constexpr int NT = F32 ? 0 : (D > 128 ? 2 : 1);
  static constexpr int NP = (D + 63) / 64;     // gradient pieces of 64 cols
  static constexpr int NP0 = D > 128 ? 2 : 1;  // rows: warpgroup 0's dq
  static constexpr int PLANE = 64 * 64 * 2;    // a 64 x 64 bf16 part
  static constexpr int XBUF = 64 * 64 * 4;     // dP, float32
  static constexpr int RING = 2 * kStages * kStageBytes;   // both rings
  static constexpr int rows_smem = RING + XBUF + OP * PLANE;
  static constexpr int keys_smem = RING + XBUF + 2 * OP * PLANE;
  static_assert((XP + XP) * 64 * SW0 * 2 <= kStageBytes
                && (OP + XP) * 64 * SW1 * 2 <= kStageBytes
                && OP * 64 * 64 * 2 <= kStageBytes, "items");
  static_assert(keys_smem <= 232448, "shared memory");
  static_assert(2 * 64 * D * 4 <= RING, "the key split's partial dk, dv");
  static_assert(D % 16 == 0 && (D % 64 == 0 || D % 64 == 48), "pieces");
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// MASK (a template parameter of both kernels) is true when the launch
// has a window or a soft-cap: without either the kernels compile without
// their branches.

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

template <int N>
__device__ __forceinline__ void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// Every thread of the cluster arrives and waits; the shared-memory writes
// before it are seen by every block after it.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The same, ordering nothing: no block leaves while others read its
// shared memory.
__device__ __forceinline__ void cluster_barrier_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n"
               "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Columns of slab s (of sw) and of gradient piece p (of 64).
template <int D>
__device__ __forceinline__ int slab_w(int s, int sw) {
  return min(sw, D - s * sw);
}
template <int D>
__device__ __forceinline__ int piece_w(int p) { return min(64, D - p * 64); }

// Part plane of tile `tile` of a packed tensor (parts planes a tile).
template <int D>
__device__ __forceinline__ const bf16* packed_tile(const bf16* base,
                                                   long long tile, int parts) {
  return base + tile * parts * kTile * D;
}

// Columns [c0, c0 + w) of each of the tile's `parts` planes into dst, one
// part after another (each 64 x w bf16).
template <int D>
__device__ __forceinline__ void copy_cols(unsigned char* dst, const bf16* t,
                                          int parts, int c0, int w,
                                          uint64_t* bar) {
  for (int p = 0; p < parts; ++p)
    bulk_copy(dst + p * kTile * w * 2, t + (long long)p * kTile * D + c0 * 64,
              kTile * w * 2, bar);
}

// A warpgroup's walk over its ring: wait for an item (`next`, its stage's
// shared address), issue its wgmmas, and (`done`) wait for them and free
// the stage for the producer's next item.
struct Walk {
  Ring<kStages>* ring;
  unsigned char* stages;
  int it = 0;

  __device__ __forceinline__ uint32_t next() {
    ring->consume(it);
    wg_fence();
    return smem_u32(stages + (it % kStages) * kStageBytes);
  }
  __device__ __forceinline__ void done(float (&t)[32]) {
    wg_commit();
    wg_wait<0>();
    reg_fence(t);
    ring->release(it++);
  }
};

// acc (64 x N) = A B over 64-deep operands: A the 64 x 64 parts at
// shared address a (K-major, or with TA MN-major: the plane holds A^T), B
// the piece of w columns in stage b (MN-major).
template <int TA>
__device__ __forceinline__ void piece_chain(float (&acc)[32], uint32_t a,
                                            int na, uint32_t b, int nb,
                                            int w) {
  if (w == 64)
    chain<64, TA, 1, false>(acc, a, 64 * 64 * 2, na, b, kTile * 64 * 2, nb,
                            4);
  else
    chain<48, TA, 1, false>(acc, a, 64 * 64 * 2, na, b, kTile * 48 * 2, nb,
                            4);
}

// The chain of slab s (of SW columns) of a (64-row tile, 64-key tile)
// product in the walk's next item (A's pa parts, then B's XP), into cs
// (with `more`, on from cs's sum).
template <int D, int XP, int SW>
__device__ __forceinline__ void slab_chain(float (&cs)[32], Walk& walk,
                                           int pa, int s, int more) {
  const int w = min(SW, D - s * SW);
  const uint32_t st = walk.next();
  chain<64, 0, 0, false>(cs, st, kTile * w * 2, pa, st + pa * kTile * w * 2,
                         kTile * w * 2, XP, w / 16, more);
}

// acc = the chains of slabs [s0, s1) of a (64-row tile, 64-key tile)
// product, each chain's sum added in float32 in slab order.  Warpgroup 0
// forms S (q, K), warpgroup 1 dP (dout, V), with the same functions in
// both kernels, so that S and dP have the same bits in both.
template <int D, int XP, int SW>
__device__ __forceinline__ void form_slabs(float (&acc)[32], float (&cs)[32],
                                           Walk& walk, int pa, int s0,
                                           int s1) {
  zero(acc);
  for (int s = s0; s < s1; ++s) {
    slab_chain<D, XP, SW>(cs, walk, pa, s, 0);
    walk.done(cs);
    add(acc, cs);
  }
}

// cs = one chain over slabs [s0, s1): dP's last NT slabs.
template <int D, int XP, int SW>
__device__ __forceinline__ void tail_chain(float (&cs)[32], Walk& walk,
                                           int pa, int s0, int s1) {
  for (int s = s0; s < s1; ++s) {
    slab_chain<D, XP, SW>(cs, walk, pa, s, s > s0);
    walk.done(cs);
  }
}

// grad's pieces p0 .. p0 + NPC - 1 += A B, a chain a piece (B's items of
// nb parts, MN-major; A's na parts at a_addr, transposed with TA).
template <int D, int NPC, int TA>
__device__ __forceinline__ void pieces(float (*grad)[32], float (&cs)[32],
                                       Walk& walk, uint32_t a_addr, int na,
                                       int nb, int p0) {
#pragma unroll
  for (int p = 0; p < NPC; ++p) {
    const uint32_t st = walk.next();
    piece_chain<TA>(cs, a_addr, na, st, nb, piece_w<D>(p0 + p));
    walk.done(cs);
    add(grad[p], cs);
  }
}

// dS (or P) of the thread's accumulator elements i, i + 1, a pair of keys
// of one row, as its `parts` bf16 parts into the 64 x 64 planes at buf
// (rows in M, keys in K; read transposed for the keys kernel's products).
__device__ __forceinline__ void store_pair(unsigned char* buf, int parts,
                                           int row, int col, float x0,
                                           float x1) {
  uint32_t w[3];
  to_parts(make_float2(x0, x1), parts, w);
  const int off = packed_at(row, col) * 2;
#pragma unroll
  for (int p = 0; p < 3; ++p)
    if (p < parts)
      *reinterpret_cast<uint32_t*>(buf + p * 64 * 64 * 2 + off) = w[p];
}

// The accumulator element i of a thread (lane g = lane / 4, t4 = lane % 4
// of warp wl of the warpgroup): row 16 wl + g + 8 ((i >> 1) & 1), column
// 8 (i >> 2) + 2 t4 + (i & 1).
__device__ __forceinline__ int acc_row(int wl, int g, int i) {
  return 16 * wl + g + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int t4, int i) {
  return 8 * (i >> 2) + 2 * t4 + (i & 1);
}

// Stores a pair of gradient values of type T.
template <bool F32>
__device__ __forceinline__ void store2(void* base, long long off, float x0,
                                       float x1) {
  if constexpr (F32) {
    *reinterpret_cast<float2*>(static_cast<float*>(base) + off) =
        make_float2(x0, x1);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(base) + off) =
        __float22bfloat162_rn(make_float2(x0, x1));
  }
}

// ---------------------------------------------------------------------------
// 1. rows: the row statistics, D and dq
// ---------------------------------------------------------------------------

// Block of the grid (rtiles, Hkv, B), item (z, hk, b) (hop::unit_major:
// unit z of every (hk, b) before unit z + 1): rows [tile * 64, +64),
// tile = rtiles - 1 - z (the rows with the most keys first), of KV head hk
// of batch row b.  The chunks start at the one holding the first key the
// tile's first row sees (0 without a window).
template <int D, bool F32, bool MASK>
__global__ void __launch_bounds__(kThreads, 1) rows_kernel(const Args a) {
  using C = Cfg<D, F32>;
  constexpr int XP = C::XP, OP = C::OP;
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ Ring<kStages> rings[2];
  float* xbuf = reinterpret_cast<float*>(smem + C::RING);
  unsigned char* dsbuf = smem + C::RING + C::XBUF;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Item item = unit_major(1);
  const int hk = item.y, b = item.z;
  const int tile = gridDim.x - 1 - item.unit;
  const int r0 = tile * kTile;
  const int G = a.G, total = G * a.Sq;
  const long long start = a.causal ? (long long)a.q_start[b] : 0;
  const int last = min(total, r0 + kTile) - 1;
  const int kv_end = a.causal
      ? (int)min((long long)a.Skv, start + last / G + 1) : a.Skv;
  const int kv_begin = MASK && a.causal
      ? (int)min((long long)kv_end - 1, first_key<MASK>(start + r0 / G, a))
      : 0;
  const int c0 = kv_begin / kTile, chunks = (kv_end + kTile - 1) / kTile;
  const int nc = chunks - c0;
  const long long bh = (long long)b * a.Hkv + hk;
  // PROBE start

  if (tid == 0) {
    rings[0].init();
    rings[1].init();
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {            // the producer: lane 0 of warp 8 feeds
    regs_down<kProducerRegs>();
    if (warp == 8 && lane < 2) {   // warpgroup 0, lane 1 warpgroup 1
      Ring<kStages>& R = rings[lane];
      unsigned char* st = smem + lane * kStages * kStageBytes;
      const int rp = lane == 0 ? XP : OP;
      const bf16* rt = packed_tile<D>(lane == 0 ? a.q : a.o,
                                      bh * a.rtiles + tile, rp);
      const bf16* keys = lane == 0 ? a.k : a.v;
      const int sw = lane == 0 ? C::SW0 : C::SW1;
      const int ns = lane == 0 ? C::NS0 : C::NS1 - C::NT;
      const bf16* ot = packed_tile<D>(a.o, bh * a.rtiles + tile, OP);
      int it = 0;
      // (rows, keys, parts, slab, column width) into the next stage
      auto slab = [&](const bf16* x, int xp, const bf16* y, int s, int w0) {
        const int w = slab_w<D>(s, w0);
        uint64_t* bar = R.produce(it, (xp + XP) * kTile * w * 2);
        unsigned char* dst = st + (it++ % kStages) * kStageBytes;
        copy_cols<D>(dst, x, xp, s * w0, w, bar);
        copy_cols<D>(dst + xp * kTile * w * 2, y, XP, s * w0, w, bar);
      };
      for (int pass = 0; pass < 2; ++pass)
        for (int c = c0; c < chunks; ++c) {
          const bf16* kt = packed_tile<D>(keys, bh * a.ktiles + c, XP);
          for (int s = 0; s < ns; ++s) slab(rt, rp, kt, s, sw);
          if (lane == 0) {        // dP's last slabs, for warpgroup 0
            const bf16* vt = packed_tile<D>(a.v, bh * a.ktiles + c, XP);
            for (int s = C::NS1 - C::NT; s < C::NS1; ++s)
              slab(ot, OP, vt, s, C::SW1);
          }
          if (pass == 0) continue;
          const bf16* kk = packed_tile<D>(a.k, bh * a.ktiles + c, XP);
          const int p0 = lane == 0 ? 0 : C::NP0, p1 = lane == 0 ? C::NP0
                                                                : C::NP;
          for (int p = p0; p < p1; ++p, ++it) {
            const int w = piece_w<D>(p);
            uint64_t* bar = R.produce(it, XP * kTile * w * 2);
            copy_cols<D>(st + (it % kStages) * kStageBytes, kk, XP, p * 64,
                         w, bar);
          }
        }
    }
    return;
  }

  regs_up<kConsumerRegs>();
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int wt = tid & (kWG - 1);         // thread of the warpgroup
  Walk walk{&rings[wg], smem + wg * kStages * kStageBytes};
  const uint32_t ds_addr = smem_u32(dsbuf);
  float acc[32];                          // S (warpgroup 0) or dP (1)
  float cs[32];                           // a chain's sum
  float dq[2][32];
  zero(dq[0]);
  zero(dq[1]);
  const int npw = wg == 0 ? C::NP0 : C::NP - C::NP0;   // dq pieces
  const int pbase = wg == 0 ? 0 : C::NP0;

  // S (warpgroup 0) or dP's first NS1 - NT slabs (1) of the chunk
  auto form = [&]() {
    if (wg == 0)
      form_slabs<D, XP, C::SW0>(acc, cs, walk, XP, 0, C::NS0);
    else
      form_slabs<D, XP, C::SW1>(acc, cs, walk, OP, 0, C::NS1 - C::NT);
  };
  // dq's pieces += dS K (K read MN-major), a chain a piece
  auto dq_product = [&]() {
    if (wg == 0)
      pieces<D, C::NP0, 0>(dq, cs, walk, ds_addr, OP, XP, 0);
    else
      pieces<D, C::NP - C::NP0, 0>(dq, cs, walk, ds_addr, OP, XP, C::NP0);
  };
  const int nt_all = 2 * nc;     // chunk visits over both passes

  if (wg == 1) {
    int gi = 0;
    for (int pass = 0; pass < 2; ++pass)
      for (int c = c0; c < chunks; ++c, ++gi) {
        form();                 // (warpgroup 0 adds dP's last slabs)
        if (gi >= 1) bar_sync(kXEmpty, 2 * kWG);
#pragma unroll
        for (int i = 0; i < 32; ++i) xbuf[i * kWG + wt] = acc[i];
        __threadfence_block();
        bar_arrive(kDpFull, 2 * kWG);
        if (pass == 0) continue;
        bar_sync(kDsFull, 2 * kWG);
        dq_product();
        if (c + 1 < chunks) bar_arrive(kDsEmpty, 2 * kWG);
      }
  } else {
    // the thread's rows (+0, +8 of the warp's 16): first and last visible
    // key, or lim -1 for a row that sees none
    int lo[2], lim[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = r0 + 16 * wl + g + 8 * h2;
      const long long p = start + r / G;
      lo[h2] = MASK && a.causal
          ? (int)min((long long)a.Skv, first_key<MASK>(p, a)) : 0;
      lim[h2] = r >= total ? -1
                : a.causal ? (int)min((long long)a.Skv - 1, p) : a.Skv - 1;
      if (MASK && lo[h2] > lim[h2]) lim[h2] = -1;
    }
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f},
          d[2] = {0.0f, 0.0f};
    float M[2] = {0.0f, 0.0f}, L[2] = {1.0f, 1.0f}, Dr[2] = {0.0f, 0.0f};
    float tc[32], dp[32];
    int gi = 0;
    // PROBE 0
    for (int pass = 0; pass < 2; ++pass) {
      for (int c = c0; c < chunks; ++c, ++gi) {
        form();
        if constexpr (C::NT > 0)   // dP's last slabs, one chain
          tail_chain<D, XP, C::SW1>(dp, walk, OP, C::NS1 - C::NT, C::NS1);
        // PROBE 1
        // the logits: scaled, soft-capped, -inf where hidden
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int j = c * kTile + acc_col(t4, i), h2 = (i >> 1) & 1;
          const float x = capped<MASK>(__fmul_rn(acc[i], a.scale), a, tc[i]);
          acc[i] = j <= lim[h2] && (!MASK || j >= lo[h2]) ? x : -INFINITY;
        }
        bar_sync(kDpFull, 2 * kWG);
        // dP: warpgroup 1's slabs, then this one's (rounded under
        // round_dp, as the keys kernel's)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float x = C::NT > 0 ? xbuf[i * kWG + wt] + dp[i]
                                    : xbuf[i * kWG + wt];
          dp[i] = a.round_dp ? round_bf16(x) : x;
        }
        if (gi + 1 < nt_all) {    // dP is read
          __threadfence_block();
          bar_arrive(kXEmpty, 2 * kWG);
        }
        // PROBE 2
        if (pass == 0) {
          // the online max m, sum l of exp(s - m) and d = sum exp(s - m)
          // dP, a lane's columns each (the row's max is shared by its 4
          // lanes)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            float mc = -INFINITY;
#pragma unroll
            for (int i = 0; i < 32; ++i)
              if (((i >> 1) & 1) == h2) mc = fmaxf(mc, acc[i]);
            mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
            mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
            const float mn = fmaxf(m[h2], mc);
            const float f = m[h2] == -INFINITY ? 0.0f : expf(m[h2] - mn);
            float ls = 0.0f, ds = 0.0f;
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              if (((i >> 1) & 1) != h2) continue;
              const float ex = expf(acc[i] - mn);   // every element: no
              const float p = acc[i] == -INFINITY ? 0.0f : ex;   // branch
              ls += p;
              ds += p * dp[i];
            }
            l[h2] = l[h2] * f + ls;
            d[h2] = d[h2] * f + ds;
            m[h2] = mn;
          }
          // PROBE 3
          continue;
        }
        // pass 2: dS (dlogit) from P = exp(s - M) / L, as three parts
        // into dsbuf (rows in M, keys in K)
        if (c > c0) bar_sync(kDsEmpty, 2 * kWG);
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          float ds2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = acc[i + e];
            const int h2 = (i >> 1) & 1;
            const float p = __fdiv_rn(expf(x - M[h2]), L[h2]);
            const float ds = dlogit<MASK>(p, dp[i + e], Dr[h2], tc[i + e], a);
            ds2[e] = x != -INFINITY ? ds : 0.0f;
          }
          store_pair(dsbuf, OP, acc_row(wl, g, i), acc_col(t4, i), ds2[0],
                     ds2[1]);
        }
        fence_async();
        bar_sync(kWg0, kWG);
        bar_arrive(kDsFull, 2 * kWG);
        // PROBE 4
        dq_product();
        // PROBE 5
      }
      if (pass == 0) {
        // M, L and D = d / L of each row
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          float ls = l[h2], ds = d[h2];
          ls += __shfl_xor_sync(0xffffffffu, ls, 1);
          ls += __shfl_xor_sync(0xffffffffu, ls, 2);
          ds += __shfl_xor_sync(0xffffffffu, ds, 1);
          ds += __shfl_xor_sync(0xffffffffu, ds, 2);
          const bool valid = lim[h2] >= 0;
          M[h2] = valid ? m[h2] : 0.0f;
          L[h2] = valid ? ls : 1.0f;
          Dr[h2] = valid ? __fdiv_rn(ds, ls) : 0.0f;
        }
      }
    }
    if (t4 == 0) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int r = r0 + 16 * wl + g + 8 * h2;
        if (r >= total) continue;
        const long long si =
            ((long long)b * a.Sq + r / G) * a.Hq + hk * G + r % G;
        a.stat_m[si] = M[h2];
        a.stat_l[si] = L[h2];
        a.stat_d[si] = Dr[h2];
      }
    }
  }

  // dq: each warpgroup its pieces of the columns
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    if (p >= npw) break;
    const int w = piece_w<D>(pbase + p);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int col = acc_col(t4, i);
      if (col >= w) continue;
      const int r = r0 + acc_row(wl, g, i);
      if (r >= total) continue;
      const long long off = (((long long)b * a.Sq + r / G) * a.Hq + hk * G
                             + r % G) * D + (pbase + p) * 64 + col;
      store2<F32>(a.dq, off, dq[p][i], dq[p][i + 1]);
    }
  }
  // PROBE 6
  // PROBE dump g_dbg_rows 7 nt_all
}

// ---------------------------------------------------------------------------
// 2. keys: dk and dv
// ---------------------------------------------------------------------------

// Block of the grid (ktiles * S, Hkv, B), S = the cluster's blocks on a
// key tile, item (kt, hk, b) (hop::unit_major: key tile kt of every (hk,
// b) before kt + 1): keys [kt * 64, +64) (the keys most rows see first),
// of KV head hk of batch row b.  The rows r = i * G + g that
// can see them come in tiles of 64, from a multiple of 64 (r from (j0 -
// q_start) * G when causal) to the last row whose window reaches the
// block's last key (the last row without a window); rank q of the cluster
// takes tiles q, q + S, ... of them, and the ranks' dk and dv meet through
// distributed shared memory in rank order.
template <int D, bool F32, bool MASK>
__global__ void __launch_bounds__(kThreads, 1) keys_kernel(const Args a) {
  using C = Cfg<D, F32>;
  constexpr int XP = C::XP, OP = C::OP, NP = C::NP;
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ Ring<kStages> rings[2];
  float* xbuf = reinterpret_cast<float*>(smem + C::RING);
  unsigned char* pbuf = smem + C::RING + C::XBUF;
  unsigned char* dsbuf = pbuf + OP * C::PLANE;
  float* part = reinterpret_cast<float*>(smem);   // after the last tile

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int S = a.splits;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = S > 1 ? (int)cluster.block_rank() : 0;
  const Item item = unit_major(S);
  const int hk = item.y, b = item.z;
  const int kt = item.unit, j0 = kt * kTile;
  const int G = a.G, total = G * a.Sq;
  const long long start = a.causal ? (long long)a.q_start[b] : 0;
  const long long seen =
      a.causal ? max(0LL, (long long)j0 - start) * G : 0LL;
  const int first = (int)min((long long)total, seen / kTile * kTile);
  const long long j_last = min(j0 + kTile, a.Skv) - 1;
  const int end = MASK && a.causal && a.window > 0
      ? (int)min((long long)total, max(0LL, j_last + a.window - start) * G)
      : total;
  const int tiles = end > first ? (end - first + kTile - 1) / kTile : 0;
  const int t0 = first / kTile;
  const long long bh = (long long)b * a.Hkv + hk;
  // PROBE start

  if (tid == 0) {
    rings[0].init();
    rings[1].init();
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {            // the producer
    regs_down<kProducerRegs>();
    if (warp == 8 && lane < 2) {
      Ring<kStages>& R = rings[lane];
      unsigned char* st = smem + lane * kStages * kStageBytes;
      // lane 0: (q, K) slabs, then dout's pieces; lane 1: (dout, V) slabs,
      // then q's pieces
      const int rp = lane == 0 ? XP : OP, gp = lane == 0 ? OP : XP;
      const int sw = lane == 0 ? C::SW0 : C::SW1;
      const bf16* kb = packed_tile<D>(lane == 0 ? a.k : a.v,
                                      bh * a.ktiles + kt, XP);
      int it = 0;
      for (int t = rank; t < tiles; t += S) {
        const long long rt = bh * a.rtiles + t0 + t;
        const bf16* rows = packed_tile<D>(lane == 0 ? a.q : a.o, rt, rp);
        for (int s = 0; s * sw < D; ++s, ++it) {
          const int w = slab_w<D>(s, sw);
          uint64_t* bar = R.produce(it, (rp + XP) * kTile * w * 2);
          unsigned char* dst = st + (it % kStages) * kStageBytes;
          copy_cols<D>(dst, rows, rp, s * sw, w, bar);
          copy_cols<D>(dst + rp * kTile * w * 2, kb, XP, s * sw, w, bar);
        }
        const bf16* grad = packed_tile<D>(lane == 0 ? a.o : a.q, rt, gp);
        for (int p = 0; p < NP; ++p, ++it) {
          const int w = piece_w<D>(p);
          uint64_t* bar = R.produce(it, gp * kTile * w * 2);
          copy_cols<D>(st + (it % kStages) * kStageBytes, grad, gp, p * 64,
                       w, bar);
        }
      }
    }
    __syncwarp();
    if (S > 1) {              // the merge's two cluster barriers
      cluster_barrier();
      cluster_barrier_relaxed();
    }
    return;
  }

  regs_up<kConsumerRegs>();
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int wt = tid & (kWG - 1);
  Walk walk{&rings[wg], smem + wg * kStages * kStageBytes};
  float acc[32];                          // S (warpgroup 0) or dP (1)
  float cs[32];                           // a chain's sum
  float grad[NP][32];                     // dv (warpgroup 0) or dk (1)
#pragma unroll
  for (int p = 0; p < NP; ++p) zero(grad[p]);
  const int pp = a.round_dp ? 1 : OP;     // parts of P
  // the rank's tiles: t = rank + S * u, u < mine
  const int mine = tiles > rank ? (tiles - rank + S - 1) / S : 0;

  // S (warpgroup 0) or dP (1, its last NT slabs one chain, as the rows
  // kernel sums them) of the tile
  auto form = [&]() {
    if (wg == 0) {
      form_slabs<D, XP, C::SW0>(acc, cs, walk, XP, 0, C::NS0);
    } else {
      form_slabs<D, XP, C::SW1>(acc, cs, walk, OP, 0, C::NS1 - C::NT);
      if constexpr (C::NT > 0) {
        tail_chain<D, XP, C::SW1>(cs, walk, OP, C::NS1 - C::NT, C::NS1);
        add(acc, cs);
      }
    }
  };
  // dv += P^T dout (warpgroup 0) or dk += dS^T q (1): P or dS read
  // transposed from its planes at `a_addr`, a chain a piece
  auto grad_product = [&](uint32_t a_addr, int na) {
    pieces<D, NP, 1>(grad, cs, walk, a_addr, na, wg == 0 ? OP : XP, 0);
  };

  if (wg == 1) {
    for (int u = 0; u < mine; ++u) {
      form();
      if (a.round_dp) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = round_bf16(acc[i]);
      }
      if (u >= 1) bar_sync(kXEmpty, 2 * kWG);
#pragma unroll
      for (int i = 0; i < 32; ++i) xbuf[i * kWG + wt] = acc[i];
      __threadfence_block();
      bar_arrive(kDpFull, 2 * kWG);
      bar_sync(kDsFull, 2 * kWG);
      grad_product(smem_u32(dsbuf), OP);
      if (u + 1 < mine) bar_arrive(kDsEmpty, 2 * kWG);
    }
  } else {
    // PROBE 0
    for (int u = 0; u < mine; ++u) {
      const int r0 = first + (rank + S * u) * kTile;
      form();
      // PROBE 1
      // the thread's rows: statistics and visible keys
      float sm[2], sl[2], sd[2];
      int lo[2], lim[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int r = r0 + 16 * wl + g + 8 * h2;
        const bool valid = r < total;
        const long long p = start + r / G;
        const long long si =
            ((long long)b * a.Sq + r / G) * a.Hq + hk * G + r % G;
        sm[h2] = valid ? a.stat_m[si] : 0.0f;
        sl[h2] = valid ? a.stat_l[si] : 1.0f;
        sd[h2] = valid ? a.stat_d[si] : 0.0f;
        lo[h2] = MASK && a.causal
            ? (int)min((long long)a.Skv, first_key<MASK>(p, a)) : 0;
        lim[h2] = !valid ? -1
                  : a.causal ? (int)min((long long)a.Skv - 1, p) : a.Skv - 1;
      }
      bar_sync(kDpFull, 2 * kWG);
      if (u >= 1) bar_sync(kDsEmpty, 2 * kWG);
      // PROBE 2
      // P (its pp parts into pbuf) and dS (three parts into dsbuf), rows
      // in M and keys in K, as the rows kernel writes dS: the products
      // read them transposed
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int h2 = (i >> 1) & 1;
        float pv[2], dv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + acc_col(t4, i + e);
          float tt;
          const float x = capped<MASK>(__fmul_rn(acc[i + e], a.scale), a,
                                       tt);
          const float pe = __fdiv_rn(expf(x - sm[h2]), sl[h2]);
          const float de =
              dlogit<MASK>(pe, xbuf[(i + e) * kWG + wt], sd[h2], tt, a);
          const bool vis = j <= lim[h2] && (!MASK || j >= lo[h2]);
          pv[e] = vis ? (a.round_dp ? round_bf16(pe) : pe) : 0.0f;
          dv[e] = vis ? de : 0.0f;
        }
        const int row = acc_row(wl, g, i), col = acc_col(t4, i);
        store_pair(pbuf, pp, row, col, pv[0], pv[1]);
        store_pair(dsbuf, OP, row, col, dv[0], dv[1]);
      }
      if (u + 1 < mine) {       // dP is read
        __threadfence_block();
        bar_arrive(kXEmpty, 2 * kWG);
      }
      fence_async();
      bar_sync(kWg0, kWG);
      bar_arrive(kDsFull, 2 * kWG);
      // PROBE 3
      grad_product(smem_u32(pbuf), pp);
      // PROBE 4
    }
  }

  // dv (warpgroup 0) or dk (1): keys in the accumulators' rows
  void* out = wg == 0 ? a.dv : a.dk;
  if (S > 1) {
    // the ranks' partial sums, each into its shared memory over the rings
    // (both warpgroups done with them), then rank q sums rows q * 64 / S ..
    // of both over the ranks in order
    bar_sync(kBoth, 2 * kWG);
    float* mine_part = part + wg * kTile * D;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int w = piece_w<D>(p);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int col = acc_col(t4, i);
        if (col >= w) continue;
        *reinterpret_cast<float2*>(mine_part + acc_row(wl, g, i) * D
                                   + p * 64 + col) =
            make_float2(grad[p][i], grad[p][i + 1]);
      }
    }
    cluster_barrier();
    const int rows = kTile / S;
    for (int e = tid; e < 2 * rows * D; e += 2 * kWG) {
      const int which = e / (rows * D);             // 0: dv, 1: dk
      const int row = rank * rows + (e / D) % rows, col = e % D;
      const int j = j0 + row;
      float sum = 0.0f;
#pragma unroll
      for (int q2 = 0; q2 < kMaxSplits; ++q2)
        if (q2 < S)
          sum += cluster.map_shared_rank(part, q2)[(which * kTile + row) * D
                                                   + col];
      if (j < a.Skv) {
        const long long off = (((long long)b * a.Skv + j) * a.Hkv + hk) * D
                              + col;
        if constexpr (F32)
          static_cast<float*>(which ? a.dk : a.dv)[off] = sum;
        else
          static_cast<bf16*>(which ? a.dk : a.dv)[off] =
              __float2bfloat16_rn(sum);
      }
    }
    cluster_barrier_relaxed();   // no block leaves while read
  } else {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int w = piece_w<D>(p);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int col = acc_col(t4, i);
        if (col >= w) continue;
        const int j = j0 + acc_row(wl, g, i);
        if (j >= a.Skv) continue;
        const long long off = (((long long)b * a.Skv + j) * a.Hkv + hk) * D
                              + p * 64 + col;
        store2<F32>(out, off, grad[p][i], grad[p][i + 1]);
      }
    }
  }
  // PROBE 5
  // PROBE dump g_dbg_keys 6 mine
}

template <int D, bool F32, bool MASK>
int launch(const Args& a, int B, cudaStream_t stream) {
  using C = Cfg<D, F32>;
  static const int attr_rows = (int)cudaFuncSetAttribute(
      rows_kernel<D, F32, MASK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::rows_smem);   // once
  static const int attr_keys = (int)cudaFuncSetAttribute(
      keys_kernel<D, F32, MASK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::keys_smem);
  if (attr_rows) return attr_rows;
  if (attr_keys) return attr_keys;
  rows_kernel<D, F32, MASK><<<dim3((unsigned)a.rtiles, a.Hkv, B), kThreads,
                              C::rows_smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.ktiles * a.splits), (unsigned)a.Hkv,
                     (unsigned)B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)C::keys_smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, keys_kernel<D, F32, MASK>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool F32, bool MASK>
int dispatch_d(int D, const Args& a, int B, cudaStream_t stream) {
  switch (D) {
    case 112: return launch<112, F32, MASK>(a, B, stream);
    case 128: return launch<128, F32, MASK>(a, B, stream);
    case 256: return launch<256, F32, MASK>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int D>
int smem_of(int bf16, int keys) {
  return bf16 ? (keys ? Cfg<D, false>::keys_smem : Cfg<D, false>::rows_smem)
              : (keys ? Cfg<D, true>::keys_smem : Cfg<D, true>::rows_smem);
}

// The entry points' body for the kernels built with MASK (the window and
// the soft-cap taken) or without (both refused).
template <bool MASK>
int launch_impl(
    const void* q, const void* k, const void* v, const void* dout,
    const void* q_start, void* dq, void* dk, void* dv, void* stats,
    void* packed, int bf16, int B, int Sq, int Skv, int Hq, int Hkv, int D,
    float scale, int causal, int round_p, int window, float softcap,
    int splits, void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0) return 0;
  if (Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  if (window < 0 || !(softcap >= 0.0f) || (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  if (!MASK && (window > 0 || softcap > 0.0f))
    return (int)cudaErrorInvalidValue;
  if (D != 112 && D != 128 && D != 256) return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > kMaxSplits) return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv, XP = bf16 ? 1 : 3;
  const long long rtiles = ((long long)G * Sq + kTile - 1) / kTile;
  const long long ktiles = ((long long)Skv + kTile - 1) / kTile;
  if (rtiles > 0x7fffffffLL || ktiles * splits > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // (the parameter bf16 hides the type's name here)
  const long long plane = (long long)B * Hkv * kTile * D;
  __nv_bfloat16* pq = static_cast<__nv_bfloat16*>(packed);
  __nv_bfloat16* po = pq + plane * rtiles * XP;
  __nv_bfloat16* pkk = po + plane * rtiles * 3;
  __nv_bfloat16* pv = pkk + plane * ktiles * XP;
  PackArgs pa;
  pa.B = B; pa.Hkv = Hkv; pa.D = D;
  const long long qs = (long long)Hq * D, ks = (long long)Hkv * D;
  pa.job[0] = PackJob{q, bf16, Sq * qs, qs, D, Sq, G, XP, (int)rtiles, pq};
  pa.job[1] = PackJob{dout, 0, Sq * qs, qs, D, Sq, G, 3, (int)rtiles, po};
  pa.job[2] = PackJob{k, bf16, Skv * ks, ks, D, Skv, 1, XP, (int)ktiles, pkk};
  pa.job[3] = PackJob{v, bf16, Skv * ks, ks, D, Skv, 1, XP, (int)ktiles, pv};
  int rc = pack(pa, 4, s);
  if (rc) return rc;
  Args a;
  a.q = pq; a.o = po; a.k = pkk; a.v = pv;
  a.q_start = static_cast<const int*>(q_start);
  a.dq = dq; a.dk = dk; a.dv = dv;
  const long long n = (long long)B * Sq * Hq;
  a.stat_m = static_cast<float*>(stats);
  a.stat_l = a.stat_m + n;
  a.stat_d = a.stat_l + n;
  a.Sq = Sq; a.Skv = Skv; a.Hq = Hq; a.Hkv = Hkv; a.G = G;
  a.rtiles = (int)rtiles; a.ktiles = (int)ktiles;
  a.splits = splits;
  a.scale = scale;
  a.softcap = softcap;
  a.window = window;
  a.causal = causal;
  a.round_dp = round_p && bf16;
  return bf16 ? dispatch_d<false, MASK>(D, a, B, s)
              : dispatch_d<true, MASK>(D, a, B, s);
}

}  // namespace

// Flash attention forward for Hopper at prefill, head_dims 112 and 128
// with a float32 q and 256 with either: the warpgroup (wgmma) design.
//
// Replaces, with flash_attention.cu, the Pallas TPU kernel
// `flash_attention` in src/repro/kernels/flash_attention/flash_attention.py
// (body `_kernel`), and computes what flash_attention.cu's header states
// (grouped KV heads, the causal mask with a query start per batch row,
// the sliding window, the logit soft-cap, K rounded to q's type,
// `round_p`) for the shapes where that file's kernels fall short: its mma
// kernel keeps a float32 q's three bf16 parts in registers (up to head_dim
// 64) and its accumulators at most 128 columns wide, so these shapes ran
// its split kernel, 8 rows a block on the CUDA cores.
//
// What bounds it on the card.  Gemma-2-9B's prefill (4,608 tokens, 16
// query heads, 8 KV heads, head_dim 256, window 4,096) needs 2 products
// over 168 M visible (head, key) pairs: 0.17 TFLOP of bf16 products, 0.2
// ms at 989 TFLOP/s (a float32 q and K: 9 part products a pair, 1.6 ms);
// it reads 45 MB (13 us).  Bound by operations: every product is a wgmma.
//
// Design:
// - One launch packs q, K (rounded to q's type) and V into tiles of 64 rows
//   in bf16 parts (hopper.cuh: a float32 value is three exact parts, a
//   bfloat16 one, or K rounded to a bfloat16 q, one).
// - A block is one consumer warpgroup and one producer warp.  It serves 64
//   rows r = i * G + g of one KV head: the producer brings the block's q
//   tile (every part, kept in shared memory as wgmma's A operand) and then,
//   through a ring of 3 stages of 24 KB with mbarriers, every chunk of 64
//   keys: K in slabs of 64 columns, then V in pieces of 64 columns.
// - S = q K^T: a chain of m64n64k16 wgmmas a slab of 64 columns (every
//   part pair: the products are exact), each chain's sum added to the
//   64 x 64 float32 S in IEEE arithmetic (hopper.cuh, `chain`); the online
//   softmax runs on it in registers; P goes to shared memory as bf16
//   parts (three, or one when it is rounded to a bfloat16 V) and O += P V
//   reads it as A with V MN-major, a chain a piece of 64 columns added to
//   O in registers (64 x D float32: 128 registers a thread at head_dim
//   256).
// - With round_p and a bfloat16 V a first pass forms the rows' (M, L) and
//   a second P = exp(s - M) / L rounded to bf16, as the other kernels do.
// - Where the plan splits a row tile's chunks across a thread-block
//   cluster, the ranks' partial (m, l, O) meet through distributed shared
//   memory in rank order, as in the mma kernel: two calls give the same
//   bits.
//
// Nothing is allocated; the wrapper passes the packed buffer.  The launches
// run on the caller's stream.  IEEE float32, expf and division; no
// --use_fast_math.

#include "hopper.cuh"

#include <cooperative_groups.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

using namespace hop;

constexpr int kWG = 128;
constexpr int kThreads = kWG + 32;     // a warpgroup and a producer warp
constexpr int kStages = 3;
constexpr int kStageBytes = 24 * 1024;
constexpr int kMaxSplits = 8;
constexpr int kWgBar = 1;              // the warpgroup's named barrier
constexpr long long kAll = 1LL << 62;

struct Strides {
  long long b, s, h;
};

struct Args {
  const bf16* q; const bf16* k; const bf16* v;   // packed
  float* out;
  const int* q_start;
  int Sq, Skv, Hkv, G;
  int rtiles, ktiles;
  Strides os;
  float scale, softcap;    // softcap 0: off
  int window;              // 0: global
  int causal, two_pass;
  int qp, kp, vp;          // parts of q, K, V
  int splits;              // the cluster's blocks along the keys
};

// Shared memory; the wrapper's `plan` states the same number.
template <int D>
struct Cfg {
  static constexpr int NS = (D + 63) / 64;     // slabs / pieces of 64 cols
  static constexpr int QBYTES = 3 * kTile * D * 2;
  static constexpr int PLANE = 64 * 64 * 2;
  static constexpr int smem = QBYTES + kStages * kStageBytes + 3 * PLANE;
  static_assert(3 * kTile * 64 * 2 <= kStageBytes, "stages");
  static_assert(kTile * D * 4 <= smem, "the merge's partial O");
  static_assert(smem <= 232448, "shared memory");
};

template <int D>
__device__ __forceinline__ int piece_w(int p) { return min(64, D - p * 64); }

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

__device__ __forceinline__ float rescale(float m_old, float m_new) {
  return m_old == -INFINITY ? 0.0f : expf(m_old - m_new);
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_barrier_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n"
               "barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ int acc_row(int wl, int g, int i) {
  return 16 * wl + g + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int t4, int i) {
  return 8 * (i >> 2) + 2 * t4 + (i & 1);
}

// Block of the grid (rtiles * S, Hkv, B), S = the cluster's blocks, rank
// `rank` of the cluster with item (z, hk, b) (hop::unit_major: unit z of
// every (hk, b) before unit z + 1): rows [tile * 64, +64), tile = rtiles -
// 1 - z (the rows with the most keys first), of KV head hk of batch row b;
// the tile's keys [kv_begin, kv_end) in chunks of 64 (chunk kv_begin / 64
// on), chunks [c_first + rank * span, +span) of them, span = ceil(chunks /
// S).
// Warp 4 is the producer (lane 0); warps 0-3 the consumer warpgroup.
template <int D, bool MASK>
__global__ void __launch_bounds__(kThreads, 1) fwd_kernel(const Args a) {
  using C = Cfg<D>;
  constexpr int NS = C::NS;
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ Ring<kStages> ring;
  __shared__ uint64_t qbar;
  __shared__ float pm[kTile], pl[kTile];
  __shared__ float fin_f[kMaxSplits * kTile], fin_m[kTile], fin_l[kTile];
  unsigned char* qs = smem;
  unsigned char* stages = smem + C::QBYTES;
  unsigned char* pbuf = stages + kStages * kStageBytes;
  float* part = reinterpret_cast<float*>(smem);   // after the last chunk

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int S = a.splits;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (S > 1) ? (int)cluster.block_rank() : 0;
  const int rows = a.G * a.Sq;
  const Item item = unit_major(S);
  const int tile = a.rtiles - 1 - item.unit, r0 = tile * kTile;
  const int hk = item.y, b = item.z;
  const long long bh = (long long)b * a.Hkv + hk;
  const long long start = a.causal ? (long long)a.q_start[b] : 0;
  const int last = min(rows, r0 + kTile) - 1;
  const long long kv_end =
      a.causal ? min((long long)a.Skv, start + last / a.G + 1)
               : (long long)a.Skv;
  const long long kv_begin =
      min(kv_end, max(0LL, first_key<MASK>(start + r0 / a.G, a)));
  const int c_first = (int)(kv_begin / kTile);
  const int c_end = (int)((kv_end + kTile - 1) / kTile);
  const int span = (c_end - c_first + S - 1) / S;
  const int c_lo = min(c_end, c_first + rank * span);
  const int c_hi = min(c_end, c_lo + span);
  const bool two = a.two_pass;

  if (tid == 0) {
    ring.init();
    mbar_init(&qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  auto remote = [&](float* p, int r) {
    return (S > 1) ? cluster.map_shared_rank(p, r) : p;
  };
  // The cluster's (M, L) of each row from every rank's (pm, pl) in rank
  // order, the same bits in every block; fin_f[r] carries rank r's partial
  // to M.  Every thread of the block takes part.
  auto cluster_merge = [&]() {
    if (S > 1) cluster_barrier(); else __syncthreads();
    if (tid < kTile) {
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
          fin_f[r * kTile + tid] = f;
          sum += remote(pl, r)[tid] * f;
        }
      }
      fin_m[tid] = mx;
      fin_l[tid] = sum;
    }
    __syncthreads();
  };

  const int wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  const bool consumer = warp < 4;
  // the consumer's walk over the ring: wait for an item (its stage's
  // shared address), then (done) wait for its products, free the stage
  int it = 0;
  float cs[32];                 // a chain's sum, added in float32
  auto next = [&]() -> uint32_t {
    ring.consume(it);
    wg_fence();
    return smem_u32(stages + (it % kStages) * kStageBytes);
  };
  auto done = [&]() {
    wg_commit();
    wg_wait<0>();
    reg_fence(cs);
    ring.release(it++);
  };

  // the thread's rows (+0, +8 of its warp's 16): last and first visible key
  long long lim[2], lo[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = r0 + 16 * wl + g + 8 * h2;
    const bool valid = r < rows;
    const long long i = r / a.G;
    lim[h2] = !valid ? -1 : (a.causal ? start + i : kAll);
    lo[h2] = valid ? first_key<MASK>(start + i, a) : 0;
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float s[32], o[NS][32];
#pragma unroll
  for (int p = 0; p < NS; ++p) zero(o[p]);
  const uint32_t q_addr = smem_u32(qs), p_addr = smem_u32(pbuf);
  const int pp = two ? 1 : 3;   // parts of P

  if (consumer) mbar_wait(&qbar, 0);
  for (int pass = two ? 0 : 1; pass < 2; ++pass) {
    if (warp == 4) {              // the producer: this pass's chunks
      if (lane == 0) {
        if (pass == (two ? 0 : 1)) {
          mbar_expect_tx(&qbar, a.qp * kTile * D * 2);
          const bf16* qt = a.q + (bh * a.rtiles + tile) * a.qp * kTile * D;
          for (int p = 0; p < a.qp; ++p)
            bulk_copy(qs + p * kTile * D * 2, qt + (long long)p * kTile * D,
                      kTile * D * 2, &qbar);
        }
        int pit = pass == 1 && two ? (c_hi - c_lo) * NS : 0;
        for (int c = c_lo; c < c_hi; ++c) {
          const bf16* kt = a.k + (bh * a.ktiles + c) * a.kp * kTile * D;
          for (int sl = 0; sl < NS; ++sl, ++pit) {
            const int w = piece_w<D>(sl);
            uint64_t* bar = ring.produce(pit, a.kp * kTile * w * 2);
            unsigned char* dst = stages + (pit % kStages) * kStageBytes;
            for (int p = 0; p < a.kp; ++p)
              bulk_copy(dst + p * kTile * w * 2,
                        kt + (long long)p * kTile * D + sl * 64 * 64,
                        kTile * w * 2, bar);
          }
          if (pass == 0) continue;
          const bf16* vt = a.v + (bh * a.ktiles + c) * a.vp * kTile * D;
          for (int sl = 0; sl < NS; ++sl, ++pit) {
            const int w = piece_w<D>(sl);
            uint64_t* bar = ring.produce(pit, a.vp * kTile * w * 2);
            unsigned char* dst = stages + (pit % kStages) * kStageBytes;
            for (int p = 0; p < a.vp; ++p)
              bulk_copy(dst + p * kTile * w * 2,
                        vt + (long long)p * kTile * D + sl * 64 * 64,
                        kTile * w * 2, bar);
          }
        }
      }
      __syncwarp();
    } else {
      for (int c = c_lo; c < c_hi; ++c) {
        // S = q K^T over the slabs, every part pair
        zero(s);
        for (int sl = 0; sl < NS; ++sl) {
          const int w = piece_w<D>(sl);
          const uint32_t st = next();
          chain<64, 0, 0, true>(cs, q_addr + sl * 64 * 64 * 2, kTile * D * 2,
                             a.qp, st, kTile * w * 2, a.kp, w / 16);
          done();
          add(s, cs);
        }
        // logits: scaled, soft-capped, -inf where hidden
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const long long j = (long long)c * kTile + acc_col(t4, i);
          const int h2 = (i >> 1) & 1;
          s[i] = (j < kv_end && j <= lim[h2] && j >= lo[h2])
                     ? logit<MASK>(s[i], a) : -INFINITY;
        }
        if (pass == 0) {           // (M, L) only
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            float mc = -INFINITY;
#pragma unroll
            for (int i = 0; i < 32; ++i)
              if (((i >> 1) & 1) == h2) mc = fmaxf(mc, s[i]);
            mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
            mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
            const float mn = fmaxf(m[h2], mc);
            l[h2] *= rescale(m[h2], mn);
#pragma unroll
            for (int i = 0; i < 32; ++i)
              if (((i >> 1) & 1) == h2)
                l[h2] += s[i] == -INFINITY ? 0.0f : expf(s[i] - mn);
            m[h2] = mn;
          }
          continue;
        }
        if (!two) {                // online: P = exp(s - m), O carried
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            float mc = -INFINITY;
#pragma unroll
            for (int i = 0; i < 32; ++i)
              if (((i >> 1) & 1) == h2) mc = fmaxf(mc, s[i]);
            mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
            mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
            const float mn = fmaxf(m[h2], mc);
            const float f = rescale(m[h2], mn);
            l[h2] *= f;
#pragma unroll
            for (int p = 0; p < NS; ++p)
#pragma unroll
              for (int i = 0; i < 32; ++i)
                if (((i >> 1) & 1) == h2) o[p][i] *= f;
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              if (((i >> 1) & 1) != h2) continue;
              const float pe = s[i] == -INFINITY ? 0.0f : expf(s[i] - mn);
              l[h2] += pe;
              s[i] = pe;
            }
            m[h2] = mn;
          }
        } else {                   // P = exp(s - M) / L rounded to bf16
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int h2 = (i >> 1) & 1;
            const float pe =
                s[i] == -INFINITY ? 0.0f : expf(s[i] - m[h2]) / l[h2];
            s[i] = __bfloat162float(__float2bfloat16_rn(pe));
          }
        }
        // P's parts into pbuf (rows in M, keys in K), once every warp's
        // products of the last chunk are done
        bar_sync(kWgBar, kWG);
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          uint32_t w3[3];
          to_parts(make_float2(s[i], s[i + 1]), pp, w3);
          const int off = packed_at(acc_row(wl, g, i), acc_col(t4, i)) * 2;
#pragma unroll
          for (int p = 0; p < 3; ++p)
            if (p < pp)
              *reinterpret_cast<uint32_t*>(pbuf + p * C::PLANE + off) = w3[p];
        }
        fence_async();
        bar_sync(kWgBar, kWG);
        // O += P V, V read MN-major in pieces of 64 columns
#pragma unroll
        for (int p = 0; p < NS; ++p) {
          const int w = piece_w<D>(p);
          const uint32_t st = next();
          if (w == 64)
            chain<64, 0, 1, true>(cs, p_addr, C::PLANE, pp, st,
                               kTile * 64 * 2, a.vp, 4);
          else
            chain<48, 0, 1, true>(cs, p_addr, C::PLANE, pp, st,
                               kTile * 48 * 2, a.vp, 4);
          done();
          add(o[p], cs);
        }
      }
    }
    if (pass == 0 || !two) {     // a row's l from its 4 lanes
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 1);
        l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 2);
      }
    }
    if (pass == 0) {             // the cluster's (M, L) for pass 1
      if (consumer && t4 == 0) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          pm[16 * wl + g + 8 * h2] = m[h2];
          pl[16 * wl + g + 8 * h2] = l[h2];
        }
      }
      cluster_merge();
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        m[h2] = fin_m[16 * wl + g + 8 * h2];
        l[h2] = fin_l[16 * wl + g + 8 * h2];
      }
      if (S > 1) cluster_barrier_relaxed();   // pm, pl read everywhere
    }
  }

  // With two passes O is already normalized: factor 1.
  if (two) {
    m[0] = m[1] = 0.0f;
    l[0] = l[1] = 0.0f;
  }
  if (S == 1) {
    if (!consumer) return;
#pragma unroll
    for (int p = 0; p < NS; ++p) {
      const int w = piece_w<D>(p);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int col = acc_col(t4, i);
        if (col >= w) continue;
        const int r = r0 + acc_row(wl, g, i);
        if (r >= rows) continue;
        const int h2 = (i >> 1) & 1;
        float x0 = o[p][i], x1 = o[p][i + 1];
        if (!two) {
          x0 = x0 / l[h2];
          x1 = x1 / l[h2];
        }
        const int qi = r / a.G, h = hk * a.G + r % a.G;
        float* ob = a.out + b * a.os.b + (long long)qi * a.os.s
                    + (long long)h * a.os.h + p * 64 + col;
        *reinterpret_cast<float2*>(ob) = make_float2(x0, x1);
      }
    }
    return;
  }

  // Split keys: the ranks' partials meet in rank order; rank q writes rows
  // q, q + S, ..., each the sum over ranks 0..S-1 in order.
  __syncthreads();               // the operands are read
  if (consumer) {
    if (t4 == 0) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        pm[16 * wl + g + 8 * h2] = m[h2];
        pl[16 * wl + g + 8 * h2] = l[h2];
      }
    }
#pragma unroll
    for (int p = 0; p < NS; ++p) {
      const int w = piece_w<D>(p);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int col = acc_col(t4, i);
        if (col >= w) continue;
        *reinterpret_cast<float2*>(part + acc_row(wl, g, i) * D + p * 64
                                   + col) = make_float2(o[p][i], o[p][i + 1]);
      }
    }
  }
  cluster_merge();
  if (consumer) {
    for (int row = rank + S * warp; row < kTile; row += S * 4) {
      const int r = r0 + row;
      if (r >= rows) break;
      const int qi = r / a.G, h = hk * a.G + r % a.G;
      float* ob = a.out + b * a.os.b + (long long)qi * a.os.s
                  + (long long)h * a.os.h;
      for (int d = lane; d < D; d += 32) {
        float sum = 0.0f;
#pragma unroll
        for (int q2 = 0; q2 < kMaxSplits; ++q2)
          if (q2 < S)
            sum += cluster.map_shared_rank(part, q2)[row * D + d]
                   * fin_f[q2 * kTile + row];
        ob[d] = two ? sum : sum / fin_l[row];
      }
    }
  }
  cluster_barrier_relaxed();   // no block leaves while read
}

template <int D, bool MASK>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int smem = Cfg<D>::smem;
  static const int attr = (int)cudaFuncSetAttribute(
      fwd_kernel<D, MASK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);   // once
  if (attr) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.rtiles * a.splits), (unsigned)a.Hkv,
                     (unsigned)B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr_c[1];
  attr_c[0].id = cudaLaunchAttributeClusterDimension;
  attr_c[0].val.clusterDim.x = (unsigned)a.splits;
  attr_c[0].val.clusterDim.y = 1;
  attr_c[0].val.clusterDim.z = 1;
  cfg.attrs = attr_c;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, fwd_kernel<D, MASK>, a);
}

template <bool MASK>
int dispatch_d(int D, const Args& a, int B, cudaStream_t stream) {
  switch (D) {
    case 112: return launch<112, MASK>(a, B, stream);
    case 128: return launch<128, MASK>(a, B, stream);
    case 256: return launch<256, MASK>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory bytes of the kernel at head_dim D (0 for a head_dim this
// source does not take): the wrapper's plan holds its own number to it.
extern "C" int flash_attention_wgmma_smem(int D) {
  switch (D) {
    case 112: return Cfg<112>::smem;
    case 128: return Cfg<128>::smem;
    case 256: return Cfg<256>::smem;
    default: return 0;
  }
}

// q: (B, Sq, Hq, D), k, v: (B, Skv, Hkv, D), out: (B, Sq, Hq, D) float32,
// each by its (batch, sequence, head) element strides with the D axis
// contiguous (out's rows 8-byte aligned); q_start: (B,) int32 on the
// card; q_bf16, kv_bf16: 0 = float32, 1 = bfloat16; D in 112, 128, 256.
// round_p, window, softcap as in flash_attention_launch; splits: the
// cluster's blocks along the keys (1..8); packed: bf16 scratch of B * Hkv
// * 64 * D * (rtiles * QP + ktiles * (KP + VP)) elements (rtiles =
// ceil(G * Sq / 64), ktiles = ceil(Skv / 64); QP = 3 for a float32 q, else
// 1; KP = 3 when q and K are float32, else 1; VP = 3 for a float32 V, else
// 1), 16-byte aligned.  Returns the first refused launch's CUDA error, or 0.
extern "C" int flash_attention_wgmma_launch(
    const void* q, const void* k, const void* v, void* out,
    const void* q_start, int q_bf16, int kv_bf16, int B, int Sq, int Skv,
    int Hq, int Hkv, int D, const long long* q_strides,
    const long long* k_strides, const long long* v_strides,
    const long long* o_strides, float scale, int causal, int round_p,
    int window, float softcap, int splits, void* packed, void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0) return 0;
  if (Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  if (window < 0 || !(softcap >= 0.0f) || (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > kMaxSplits) return (int)cudaErrorInvalidValue;
  if (D != 112 && D != 128 && D != 256) return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const long long rtiles = ((long long)G * Sq + kTile - 1) / kTile;
  const long long ktiles = ((long long)Skv + kTile - 1) / kTile;
  if (rtiles * splits > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int qp = q_bf16 ? 1 : 3, kp = (!q_bf16 && !kv_bf16) ? 3 : 1,
            vp = kv_bf16 ? 1 : 3;
  const long long plane = (long long)B * Hkv * kTile * D;
  bf16* pq = static_cast<bf16*>(packed);
  bf16* pk = pq + plane * rtiles * qp;
  bf16* pv = pk + plane * ktiles * kp;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  PackArgs pa;
  pa.B = B; pa.Hkv = Hkv; pa.D = D;
  pa.job[0] = PackJob{q, q_bf16, q_strides[0], q_strides[1], q_strides[2],
                      Sq, G, qp, (int)rtiles, pq};
  pa.job[1] = PackJob{k, kv_bf16, k_strides[0], k_strides[1], k_strides[2],
                      Skv, 1, kp, (int)ktiles, pk};
  pa.job[2] = PackJob{v, kv_bf16, v_strides[0], v_strides[1], v_strides[2],
                      Skv, 1, vp, (int)ktiles, pv};
  int rc = pack(pa, 3, s);
  if (rc) return rc;
  Args a;
  a.q = pq; a.k = pk; a.v = pv;
  a.out = static_cast<float*>(out);
  a.q_start = static_cast<const int*>(q_start);
  a.Sq = Sq; a.Skv = Skv; a.Hkv = Hkv; a.G = G;
  a.rtiles = (int)rtiles; a.ktiles = (int)ktiles;
  a.os = Strides{o_strides[0], o_strides[1], o_strides[2]};
  a.scale = scale;
  a.softcap = softcap;
  a.window = window;
  a.causal = causal;
  a.two_pass = round_p && kv_bf16;
  a.qp = qp; a.kp = kp; a.vp = vp;
  a.splits = splits;
  const bool mask = window > 0 || softcap > 0.0f;
  rc = mask ? dispatch_d<true>(D, a, B, s) : dispatch_d<false>(D, a, B, s);
  return rc ? rc : (int)cudaGetLastError();
}

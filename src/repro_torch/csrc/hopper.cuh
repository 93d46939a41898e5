// Building blocks of the port's Hopper attention kernels
// (flash_attention_wgmma.cu, flash_attention_bwd_wgmma.cuh): bulk copies
// into shared memory with mbarriers, warpgroup products (wgmma) on bf16
// operands in shared memory, and the packing kernel that lays q, k, v and
// dout out for them.
//
// Packed tiles.  An operand of the attention (q or dout by rows r = i * G
// + g of one KV head, or K or V by keys) is cut into tiles of 64 rows, and
// each tile is stored as P bf16 parts (a float32 value is three: hi + mid
// + lo == x exactly, `split3`; a bfloat16 value, or K rounded to a
// bfloat16 q, is one), each part a 64 x D plane of 8 x 8 core matrices:
// element (row, col) of a part sits at
//
//   ((col / 8) * 8 + row / 8) * 64 + (row % 8) * 8 + col % 8
//
// so the 8 row blocks of a column block follow each other, and any run of
// whole column blocks (a slab of the head dimension) is one contiguous
// span: one bulk copy.  wgmma reads such a plane without swizzling
// (layout 0) in either role:
// - K-major (the tile's rows are M or N, its columns the depth): 8-row
//   groups 128 bytes apart (SBO), column blocks 1024 bytes apart (LBO), a
//   16-deep step 2048 bytes;
// - MN-major (the tile's rows are the depth, its columns N; B transposed):
//   row blocks 128 bytes apart (LBO), column blocks 1024 (SBO), a 16-deep
//   step 256 bytes.
// Rows past the tensor's end are zeros.  The wrapper allocates the packed
// buffers; `pack_kernel` fills them in one launch for up to four tensors.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace hop {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;                      // rows of a packed tile
constexpr int kCore = 64;                      // elements of a core matrix

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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

// A pair of values as P parts (P = 1: rounded to bf16, exact for a value
// that is bf16 already).
__device__ __forceinline__ void to_parts(float2 x, int parts,
                                         uint32_t (&w)[3]) {
  if (parts == 1) {
    w[0] = bits2(__float22bfloat162_rn(x));
    w[1] = w[2] = 0u;
  } else {
    split3(x, w[0], w[1], w[2]);
  }
}

// Element offset of (row, col) in a packed part plane.
__device__ __forceinline__ int packed_at(int row, int col) {
  return ((col >> 3) * 8 + (row >> 3)) * kCore + (row & 7) * 8 + (col & 7);
}

// ---------------------------------------------------------------------------
// Packing
// ---------------------------------------------------------------------------

struct PackJob {
  const void* src;
  int bf16_src;              // 1: bfloat16 source, else float32
  long long sb, ss, sh;      // element strides of (batch, sequence, head)
  int S;                     // positions of the sequence axis
  int G;                     // rows a position a KV head (G query heads, or 1)
  int parts;                 // 1 or 3
  int tiles;                 // tiles of 64 rows a (batch, KV head)
  bf16* dst;
};

struct PackArgs {
  PackJob job[4];
  int B, Hkv, D;
};

// The work of a block of a grid (units * S, Y, Z) in clusters of S blocks
// along x: (unit, y, z), taken in the order of the clusters' linear index
// with the unit slowest, so that the launch runs unit 0 of every (y, z)
// first, then unit 1, ...  A kernel numbers its units heaviest first (the
// row tiles that see the most keys, the key tiles that the most rows
// see): the light ones then fill the last wave, as a list schedule
// longest-first does, where x fastest would leave each (y, z)'s light
// units before the next one's heavy ones.  Every block of a cluster gets
// the same item.
struct Item {
  int unit, y, z;
};
__device__ __forceinline__ Item unit_major(int S) {
  const unsigned long long units = gridDim.x / S, pairs =
      (unsigned long long)gridDim.y * gridDim.z;
  const unsigned long long lin =
      blockIdx.x / S + units * (blockIdx.y + (unsigned long long)gridDim.y
                                * blockIdx.z);
  const unsigned long long pair = lin % pairs;
  return Item{(int)(lin / pairs), (int)(pair % gridDim.y),
              (int)(pair / gridDim.y)};
}

// blockIdx.y picks the job; every thread writes 16-byte units (8 columns of
// one row) of every part, consecutive threads consecutive rows of a column
// block (consecutive 16-byte units of the plane).  Units are counted in 32
// bits: `pack` refuses more than 2^31 of them.
__global__ void __launch_bounds__(256) pack_kernel(const PackArgs a) {
  const PackJob& j = a.job[blockIdx.y];
  const unsigned cbs = a.D / 8, tiles = j.tiles, hkv = a.Hkv, G = j.G;
  const unsigned units = (unsigned)a.B * hkv * tiles * kTile * cbs;
  for (unsigned e = blockIdx.x * blockDim.x + threadIdx.x; e < units;
       e += gridDim.x * blockDim.x) {
    const unsigned row = e % kTile;
    unsigned t = e / kTile;
    const unsigned cb = t % cbs;
    t /= cbs;
    const unsigned tile = t % tiles, bh = t / tiles;
    const unsigned hk = bh % hkv, b = bh / hkv;
    const unsigned r = tile * kTile + row;
    const int pos = (int)(r / G), h = (int)(hk * G + r % G);
    float x[8];
    if (pos < j.S) {
      const long long off = b * j.sb + pos * j.ss + h * j.sh + cb * 8LL;
      // one or two 16-byte loads where the row's columns are aligned
      if (j.bf16_src) {
        const bf16* p = static_cast<const bf16*>(j.src) + off;
        if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
          const uint4 u = *reinterpret_cast<const uint4*>(p);
          const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float2 f = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&w[c]));
            x[2 * c] = f.x;
            x[2 * c + 1] = f.y;
          }
        } else {
#pragma unroll
          for (int c = 0; c < 8; ++c) x[c] = __bfloat162float(p[c]);
        }
      } else {
        const float* p = static_cast<const float*>(j.src) + off;
        if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
          const float4 u = *reinterpret_cast<const float4*>(p);
          const float4 v = *reinterpret_cast<const float4*>(p + 4);
          x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
          x[4] = v.x; x[5] = v.y; x[6] = v.z; x[7] = v.w;
        } else {
#pragma unroll
          for (int c = 0; c < 8; ++c) x[c] = p[c];
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) x[c] = 0.0f;
    }
    uint32_t w[4][3];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      to_parts(make_float2(x[2 * c], x[2 * c + 1]), j.parts, w[c]);
    bf16* base = j.dst
                 + ((long long)bh * tiles + tile) * j.parts * kTile * a.D
                 + (long long)(cb * kTile + row) * 8;
    for (int p = 0; p < j.parts; ++p)
      *reinterpret_cast<uint4*>(base + (long long)p * kTile * a.D) =
          make_uint4(w[0][p], w[1][p], w[2][p], w[3][p]);
  }
}

// One launch for `n` jobs; returns the launch's CUDA error.
inline int pack(const PackArgs& a, int n, cudaStream_t stream) {
  long long most = 0;
  for (int i = 0; i < n; ++i) {
    const long long u = (long long)a.B * a.Hkv * a.job[i].tiles * kTile
                        * (a.D / 8);
    most = u > most ? u : most;
  }
  if (most >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const long long blocks = (most + 255) / 256;
  pack_kernel<<<dim3((unsigned)(blocks < 1056 ? blocks : 1056), n), 256, 0,
                stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// mbarriers, bulk copies, named barriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ bool mbar_try(uint64_t* bar, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return ok != 0;
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  while (!mbar_try(bar, parity)) {
  }
}

// `bytes` (a multiple of 16) from global to shared memory, both 16-byte
// aligned; completes on `bar`'s transaction count.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Generic-proxy writes to shared memory before this are seen by the async
// proxy (wgmma, bulk copies) after a barrier.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barriers: `sync` waits for `count` threads (arrivals included),
// `arrive` counts the thread in and goes on.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// A ring of NS stages, filled by one producer thread and emptied by one
// warpgroup (128 arrivals).  Item i takes stage i % NS in round i / NS.
template <int NS>
struct Ring {
  uint64_t full[NS], empty[NS];

  __device__ __forceinline__ void init() {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
  }
  // producer: wait for the stage of item i to be free, announce its bytes
  __device__ __forceinline__ uint64_t* produce(int i, uint32_t bytes) {
    const int s = i % NS;
    mbar_wait(&empty[s], ((i / NS) & 1) ^ 1);
    mbar_expect_tx(&full[s], bytes);
    return &full[s];
  }
  // consumer: wait for item i to land
  __device__ __forceinline__ void consume(int i) {
    mbar_wait(&full[i % NS], (i / NS) & 1);
  }
  __device__ __forceinline__ void release(int i) {
    mbar_arrive(&empty[i % NS]);
  }
};

// ---------------------------------------------------------------------------
// wgmma: D (64 x N, float32) += A (64 x 16) B (16 x N), bf16 operands in
// shared memory, each K-major (TA, TB = 0) or MN-major (1)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across a
// wgmma wait.
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// The matrix descriptor of a packed plane at shared address `addr`
// (layout 0: no swizzle).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

template <int TA, int TB>
__device__ __forceinline__ void mma_n64(float (&d)[32], uint64_t da,
                                        uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void mma_n48(float (&d)[32], uint64_t da,
                                        uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, %27, %28;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// acc (64 x N) = the sum over the kept part pairs (pa, pb), each over
// `ksteps` 16-deep steps, of A's part pa (at `a`, parts `a_part` bytes
// apart; K-major, or MN-major with TA) times B's part pb (at `b`;
// K-major, or MN-major with TB).  The pairs go in a fixed order, smallest
// weight first: with ALL every pair (the forward's exact products), else
// the backward's 6 of 9 whose weight reaches float32 rounding (ref.py's
// PAIRS), and only those that exist for na x nb parts.  Issued, not
// waited for.
//
// With `more` the chain goes on from acc's sum (a chain over several
// slabs).
//
// A chain runs on the tensor cores' own adder, which does not round to
// nearest: the kernels keep a chain short (one slab of the depth) and add
// its sum to their float32 totals in IEEE arithmetic, so the error does
// not grow with the number of chains.
template <int N, int TA, int TB, bool ALL>
__device__ __forceinline__ void chain(float (&acc)[32], uint32_t a,
                                      uint32_t a_part, int na, uint32_t b,
                                      uint32_t b_part, int nb, int ksteps,
                                      int more = 0) {
  constexpr int A9[9] = {2, 1, 2, 0, 1, 2, 0, 1, 0};
  constexpr int B9[9] = {2, 2, 1, 2, 1, 0, 1, 0, 0};
  constexpr int A6[6] = {0, 1, 0, 2, 1, 0};
  constexpr int B6[6] = {2, 1, 1, 0, 0, 0};
  constexpr int NP = ALL ? 9 : 6;
  constexpr uint32_t a_step = TA ? 256 : 2048, b_step = TB ? 256 : 2048;
  int keep = more;              // 0: the first product starts the sum
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int pa = ALL ? A9[i] : A6[i], pb = ALL ? B9[i] : B6[i];
    if (pa >= na || pb >= nb) continue;
    const uint32_t ap = a + pa * a_part, bp = b + pb * b_part;
#pragma unroll 1
    for (int k = 0; k < ksteps; ++k) {
      const uint64_t da = TA ? make_desc(ap + k * a_step, 128, 1024)
                             : make_desc(ap + k * a_step, 1024, 128);
      const uint64_t db = TB ? make_desc(bp + k * b_step, 128, 1024)
                             : make_desc(bp + k * b_step, 1024, 128);
      if constexpr (N == 64) mma_n64<TA, TB>(acc, da, db, keep);
      else mma_n48<TA, TB>(acc, da, db, keep);
      keep = 1;
    }
  }
}

// acc += t, element by element, in IEEE float32.
__device__ __forceinline__ void add(float (&acc)[32], const float (&t)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += t[i];
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.0f;
}

}  // namespace hop

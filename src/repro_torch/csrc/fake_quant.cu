// Fused per-channel fake quantization (quantize -> dequantize) for Hopper,
// one launch over a group of tensors.
//
// Replaces the Pallas TPU kernel `fake_quant` in
// src/repro/kernels/fake_quant/fake_quant.py (bodies `_affine_kernel` and
// `_pow2_kernel`), and computes the same function on row-major (K, N)
// float32 or bfloat16 tensors, with one scale of the tensor's type per
// column n, or one for the whole tensor:
//
//   affine: clip(round(w / s[n]), -qmax, qmax) * s[n]
//   pow2:   sign(w) * 2^clip(round(log2(max(|w|, 1e-12))), s[n] - 7, s[n])
//
// What bounds it on the card: memory.  Each element is read once and
// written once and costs a handful of operations (pow2: a log2f and an
// exp2f), plus the scales, so the least time is the bytes over the 3.35
// TB/s of an H100 SXM.  VGG-16's 15 float32 weights (14,977,728 elements,
// about 120 MB moved) take at least about 36 us; in bfloat16 half that.
//
// The design:
// * One launch covers a group of up to kMaxEntries tensors.  Their table
//   goes to the kernel by value, as a __grid_constant__ parameter: no copy
//   to the card and no allocation.  Each entry holds the tensor's
//   pointers, size, columns, mode, qmax, scalar head and first block;
//   block b finds its entry by a binary search over the first blocks and
//   works on one contiguous span of that tensor.  The Python wrapper
//   computes the plan (kernels/fake_quant/fake_quant.py: `plan`); the C
//   entry below recomputes each entry's block count and refuses a table
//   that does not match.
// * 16-byte loads and stores (4 float32 or 8 bfloat16 a vector), kUnroll
//   = 2 vectors in flight per thread before any arithmetic, streaming
//   cache hints (each byte is touched once).  A view whose base is not
//   16-byte aligned has a scalar head up to the first aligned element (its
//   output is placed at the same offset modulo 16 by the wrapper); a
//   span's last elements that fill no vector are a scalar tail.
// * 32-bit element indices (the wrapper refuses tensors of 2^31 or more
//   elements).  A thread finds its first vector's column with one 32-bit
//   modulo, then advances it with a wrap: no 64-bit division per element.
//
// Numerics are the plain torch version's (kernels/fake_quant/ref.py),
// operation by operation, as torch's CUDA kernels compute them: each
// operation in float32 on the widened inputs, its result rounded to the
// tensor's type wherever the torch op writes a tensor (for float32 the
// rounding is the identity).  So for bfloat16: w / s is rounded before
// rint, the clipped code again (qmax = 32767 is no bfloat16 value; torch
// clamps in float32 and rounds), |w| floored at 1e-12 and log2 are rounded
// before rint, s - 7 and exp2 are rounded.  rintf rounds half to even like
// torch.round; IEEE division, log2f and exp2f (this file must not be built
// with --use_fast_math: an approximate log2 flips pow2 codes at exponent
// boundaries, a factor of 2 in that weight); clip is written with
// comparisons so a NaN passes through; sign(0) = 0 keeps zeros at zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;          // 16-byte vectors a thread
constexpr int kMaxEntries = 64;     // tensors a launch; 3 KB of parameters
constexpr float kPow2Levels = 8.0f; // sign + 3-bit exponent
constexpr int kPow2Flag = 1;        // Entry::flags: pow2 (else affine)
constexpr int kPerTensorFlag = 2;   // Entry::flags: one scale for the tensor

// One tensor of a launch (48 bytes; the wrapper mirrors this layout).
struct Entry {
  const void* w;      // (numel / cols, cols), row-major
  const void* scale;  // (cols,), or one value with kPerTensorFlag
  void* out;          // same layout as w, at w's offset modulo 16
  int first_block;    // the launch's first block on this tensor
  int numel;
  int cols;
  int head;           // scalar elements before w's first aligned vector
  float qmax;         // affine: 2^(bits-1) - 1
  int flags;
};

struct Table {
  int count;
  Entry entries[kMaxEntries];
};

template <typename T>
struct Type;

template <>
struct Type<float> {
  static constexpr int kVec = 4;
  __device__ static float load(const float* p) { return __ldg(p); }
  __device__ static float round(float v) { return v; }
  __device__ static void store(float* p, float v) { *p = v; }
  __device__ static float get(const unsigned (&words)[4], int k) {
    return __uint_as_float(words[k]);
  }
  __device__ static void set(unsigned (&words)[4], int k, float v) {
    words[k] = __float_as_uint(v);
  }
};

template <>
struct Type<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
  }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  __device__ static float get(const unsigned (&words)[4], int k) {
    const unsigned word = words[k >> 1];
    return __uint_as_float((k & 1) ? (word & 0xffff0000u) : (word << 16));
  }
  __device__ static void set(unsigned (&words)[4], int k, float v) {
    const unsigned bits = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    const unsigned word = words[k >> 1];
    words[k >> 1] = (k & 1) ? ((word & 0xffffu) | (bits << 16))
                            : ((word & 0xffff0000u) | bits);
  }
};

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  x = (x < lo) ? lo : x;
  return (x > hi) ? hi : x;
}

__device__ __forceinline__ float sign(float x) {
  return (x > 0.0f) ? 1.0f : ((x < 0.0f) ? -1.0f : x);
}

// One element, widened to float32; the result is rounded to T on store.
template <typename T, bool kPow2>
__device__ __forceinline__ float quantize(float x, float s, float qmax) {
  using R = Type<T>;
  if (!kPow2) {
    const float q = R::round(clip(rintf(R::round(x / s)), -qmax, qmax));
    return q * s;
  }
  float mag = fabsf(x);
  mag = R::round((mag < 1e-12f) ? 1e-12f : mag);
  const float e = clip(rintf(R::round(log2f(mag))),
                       R::round(s - (kPow2Levels - 1.0f)), s);
  return sign(x) * R::round(exp2f(e));
}

template <typename T, bool kPow2, bool kPerTensor>
__device__ __forceinline__ void run_span(const Entry& e, int j) {
  using R = Type<T>;
  constexpr int kVec = R::kVec;
  constexpr int kSpan = kThreads * kVec * kUnroll;
  const T* __restrict__ w = static_cast<const T*>(e.w);
  const T* __restrict__ scale = static_cast<const T*>(e.scale);
  T* __restrict__ out = static_cast<T*>(e.out);
  const int cols = e.cols;
  const float qmax = e.qmax;
  const float s_tensor = R::load(scale);

  // this block's span: [start, stop), start 16-byte aligned
  const int start = e.head + j * kSpan;
  const int stop = (e.numel - start < kSpan) ? e.numel : start + kSpan;
  const int n_vec = (stop - start) / kVec;
  const uint4* src = reinterpret_cast<const uint4*>(w + start);
  uint4* dst = reinterpret_cast<uint4*>(out + start);

  uint4 v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < n_vec) v[u] = __ldcs(src + i);
  }
  int col = (int)((unsigned)(start + threadIdx.x * kVec) % (unsigned)cols);
  const int step = (kThreads * kVec) % cols;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < n_vec) {
      unsigned words[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      int c = col;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float s = kPerTensor ? s_tensor : R::load(scale + c);
        R::set(words, k, quantize<T, kPow2>(R::get(words, k), s, qmax));
        c = (c + 1 == cols) ? 0 : c + 1;
      }
      __stcs(dst + i, make_uint4(words[0], words[1], words[2], words[3]));
    }
    col += step;
    col = (col >= cols) ? col - cols : col;
  }

  // the scalar head (threads 0..head-1 of the first block) and tail
  // (threads kVec.. of every block, at most kVec - 1 elements)
  const int t = threadIdx.x;
  const int tail = start + n_vec * kVec;
  int i = -1;
  if (j == 0 && t < e.head) i = t;
  if (t >= kVec && t - kVec < stop - tail) i = tail + t - kVec;
  if (i >= 0) {
    const int c = (int)((unsigned)i % (unsigned)cols);
    const float s = kPerTensor ? s_tensor : R::load(scale + c);
    R::store(out + i, quantize<T, kPow2>(R::load(w + i), s, qmax));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fake_quant_group_kernel(const __grid_constant__ Table table) {
  const int b = blockIdx.x;
  int lo = 0, hi = table.count - 1;
  while (lo < hi) {  // the last entry whose first block is <= b
    const int mid = (lo + hi + 1) >> 1;
    if (table.entries[mid].first_block <= b) lo = mid; else hi = mid - 1;
  }
  const Entry& e = table.entries[lo];
  const int j = b - e.first_block;
  const bool per_tensor = e.flags & kPerTensorFlag;
  if (e.flags & kPow2Flag) {
    if (per_tensor) run_span<T, true, true>(e, j);
    else run_span<T, true, false>(e, j);
  } else {
    if (per_tensor) run_span<T, false, true>(e, j);
    else run_span<T, false, false>(e, j);
  }
}

template <typename T>
int check_and_launch(const Table& table, int blocks, cudaStream_t stream) {
  const int span = kThreads * Type<T>::kVec * kUnroll;
  int next = 0;
  for (int i = 0; i < table.count; ++i) {
    const Entry& e = table.entries[i];
    const int pad = (int)((16 - (reinterpret_cast<uintptr_t>(e.w) & 15)) & 15)
                    / (int)sizeof(T);
    const int head = pad < e.numel ? pad : e.numel;
    const bool same_offset = ((reinterpret_cast<uintptr_t>(e.w) ^
                               reinterpret_cast<uintptr_t>(e.out)) & 15) == 0;
    if (e.numel < 1 || e.cols < 1 || e.numel % e.cols || e.head != head ||
        !same_offset || e.first_block != next)
      return (int)cudaErrorInvalidValue;
    const int rest = e.numel - head;
    next += rest > 0 ? (rest - 1) / span + 1 : 1;
  }
  if (next != blocks) return (int)cudaErrorInvalidValue;
  fake_quant_group_kernel<T><<<blocks, kThreads, 0, stream>>>(table);
  return (int)cudaGetLastError();
}

}  // namespace

// sizeof(Entry) and kMaxEntries, for the wrapper to check its mirror.
extern "C" int fake_quant_entry_bytes() { return (int)sizeof(Entry); }
extern "C" int fake_quant_max_entries() { return kMaxEntries; }

// entries: `count` Entry structs in host memory, first blocks ascending
// from 0; blocks: the launch's total; bf16: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch (0 when it was accepted), or
// cudaErrorInvalidValue for a table that is not the plan's.
extern "C" int fake_quant_group_launch(const void* entries, int count,
                                       int blocks, int bf16, void* stream) {
  if (count < 1 || count > kMaxEntries || blocks < 1)
    return (int)cudaErrorInvalidValue;
  Table table;
  table.count = count;
  std::memcpy(table.entries, entries, sizeof(Entry) * count);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? check_and_launch<__nv_bfloat16>(table, blocks, s)
              : check_and_launch<float>(table, blocks, s);
}

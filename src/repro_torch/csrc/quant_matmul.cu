// Matrix product with packed low-bit weights (LightPE on the card) for Hopper.
//
// Replaces the Pallas TPU kernel `quant_matmul` in
// src/repro/kernels/quant_matmul/quant_matmul.py (bodies `_mm_kernel_int4`,
// `_mm_kernel_pow2`, `_mm_kernel_int8`, with `_unpack_tile`; the padded
// `quant_matmul_any` of ops.py is the same function), and computes
//
//   y (M, N) float32 = x (M, K) @ dequant(W)
//
// with x float32 or bfloat16 (widened exactly) and W in one of three modes:
//   int4: (K/2, N) bytes, two 4-bit two's-complement codes per byte along K
//         (row 2r in the low nibble, 2r+1 in the high), value q * scale[n];
//   pow2: the same packing, code = sign bit 3 + 3-bit index, value
//         +-2^idx * 2^(e_max[n] - 7) (LightPE-1; `scale` holds e_max);
//   int8: (K, N) int8 codes, value q * scale[n].
// The per-column factor is applied once, after the last K step, to the
// float32 sum of x * (code value), as the TPU kernel does.  For pow2 that
// factor is a power of two, so the result equals x @ dequant(W) up to the
// order of the sum.
//
// What bounds it on the card: for decode (M = batch, a few rows) memory,
// the code bytes (K*N/2 for int4/pow2, K*N for int8) plus 4*N bytes of
// scales, read once; a decode step of SmolLM-135M reads 53 MB of 4-bit
// codes, 16 us at 3.35 TB/s.  For prefill (M in the hundreds) the 2*M*K*N
// float32 multiply-adds on the CUDA cores (67 TFLOP/s): the serving
// tolerance (rtol 1e-5) rules out TF32 tensor cores.
//
// What the design does about it: one block per 64-column by BM-row output
// tile (BM = 64 for prefill, 16 for decode, so small M wastes less), a
// K loop in steps of 32 that stages x (widened to float) and the decoded
// codes in shared memory, and a 4x4 (or 1x4) register tile of float32
// accumulators per thread.  The next step's x values and code bytes are
// loaded into registers while the current step is multiplied, so their
// memory latency hides behind the arithmetic.  Codes are decoded on their
// way to shared memory, so device memory only ever holds the packed
// bytes.  Ragged M, K and N are masked
// in the loads and the store: no padding copy.  Nothing is asynchronous
// beyond the launch on the caller's stream; nothing is allocated.
// IEEE float32 throughout; no --use_fast_math.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;  // 16 x 16: tx along columns, ty along rows

enum Mode { kInt4 = 0, kPow2 = 1, kInt8 = 2 };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The byte holding the code of row k, column n (int8: the code itself).
template <int MODE>
__device__ __forceinline__ uint8_t code_byte(const uint8_t* __restrict__ w,
                                             long long k, long long n,
                                             long long N) {
  return (MODE == kInt8) ? w[k * N + n] : w[(k >> 1) * N + n];
}

// The value of that code before the per-column factor.
template <int MODE>
__device__ __forceinline__ float code_value(uint8_t byte, long long k) {
  if (MODE == kInt8) return (float)(int8_t)byte;
  const int c = (k & 1) ? (byte >> 4) : (byte & 0xF);
  if (MODE == kInt4) return (float)(c >= 8 ? c - 16 : c);
  const float mag = (float)(1 << (c & 7));
  return (c & 8) ? -mag : mag;
}

template <typename XT, int MODE, int TM>
__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ w,
                    const float* __restrict__ scale, float* __restrict__ out,
                    int M, int K, int N) {
  constexpr int BM = 16 * TM;
  constexpr int XN = BM * kBK / kThreads;   // x elements a thread stages
  constexpr int WN = kBK * kBN / kThreads;  // codes a thread stages
  __shared__ float xs[kBK][BM + 1];   // transposed; +1 spreads the banks
  __shared__ float ws[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.y * BM;
  const long long n0 = (long long)blockIdx.x * kBN;

  // The next tile's raw x values and code bytes wait in registers while
  // the current tile is multiplied: its loads are all issued at once and
  // their latency hides behind the arithmetic.
  XT xr[XN];
  uint8_t wr[WN];
  auto fetch = [&](long long k0) {
#pragma unroll
    for (int r = 0; r < XN; ++r) {
      const int e = tid + r * kThreads;
      const long long m = m0 + e / kBK, k = k0 + e % kBK;
      if (m < M && k < K) xr[r] = x[m * K + k];  // masked again when stored
    }
#pragma unroll
    for (int r = 0; r < WN; ++r) {
      const int e = tid + r * kThreads;
      const long long k = k0 + e / kBN, n = n0 + e % kBN;
      wr[r] = (k < K && n < N) ? code_byte<MODE>(w, k, n, N) : 0;
    }
  };

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  fetch(0);
  for (long long k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < XN; ++r) {
      const int e = tid + r * kThreads;
      const int row = e / kBK, kk = e % kBK;
      xs[kk][row] = (m0 + row < M && k0 + kk < K) ? widen(xr[r]) : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < WN; ++r) {
      const int e = tid + r * kThreads;
      const int kk = e / kBN, c = e % kBN;
      const long long k = k0 + kk;
      ws[kk][c] = (k < K && n0 + c < N) ? code_value<MODE>(wr[r], k) : 0.0f;
    }
    __syncthreads();
    if (k0 + kBK < K) fetch(k0 + kBK);
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long n = n0 + tx + 16 * j;
    if (n >= N) continue;
    const float s = (MODE == kPow2) ? ldexpf(1.0f, (int)scale[n] - 7)
                                    : scale[n];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long m = m0 + ty + 16 * i;
      if (m < M) out[m * N + n] = acc[i][j] * s;
    }
  }
}

template <typename XT, int MODE>
void launch(const void* x, const void* w, const void* scale, void* out,
            int M, int K, int N, cudaStream_t stream) {
  const dim3 block(kThreads);
  const unsigned gx = (unsigned)((N + kBN - 1) / kBN);
  if (M <= 16) {
    const dim3 grid(gx, (unsigned)((M + 15) / 16));
    quant_matmul_kernel<XT, MODE, 1><<<grid, block, 0, stream>>>(
        static_cast<const XT*>(x), static_cast<const uint8_t*>(w),
        static_cast<const float*>(scale), static_cast<float*>(out), M, K, N);
  } else {
    const dim3 grid(gx, (unsigned)((M + 63) / 64));
    quant_matmul_kernel<XT, MODE, 4><<<grid, block, 0, stream>>>(
        static_cast<const XT*>(x), static_cast<const uint8_t*>(w),
        static_cast<const float*>(scale), static_cast<float*>(out), M, K, N);
  }
}

template <typename XT>
void launch_mode(const void* x, const void* w, const void* scale, void* out,
                 int M, int K, int N, int mode, cudaStream_t stream) {
  if (mode == kInt4) launch<XT, kInt4>(x, w, scale, out, M, K, N, stream);
  else if (mode == kPow2) launch<XT, kPow2>(x, w, scale, out, M, K, N, stream);
  else launch<XT, kInt8>(x, w, scale, out, M, K, N, stream);
}

}  // namespace

// x_bf16: 0 = float32 x, 1 = bfloat16 x; mode: 0 int4, 1 pow2, 2 int8.
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int quant_matmul_launch(const void* x, int x_bf16, const void* w,
                                   const void* scale, void* out, int M, int K,
                                   int N, int mode, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (mode < kInt4 || mode > kInt8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) launch_mode<__nv_bfloat16>(x, w, scale, out, M, K, N, mode, s);
  else launch_mode<float>(x, w, scale, out, M, K, N, mode, s);
  return (int)cudaGetLastError();
}

// Fused per-channel fake quantization (quantize -> dequantize) for Hopper.
//
// Replaces the Pallas TPU kernel `fake_quant` in
// src/repro/kernels/fake_quant/fake_quant.py (bodies `_affine_kernel` and
// `_pow2_kernel`), and computes the same function on a row-major (K, N)
// float32 weight with one float32 value per output channel n:
//
//   affine: clip(round(w / s[n]), -qmax, qmax) * s[n]
//   pow2:   sign(w) * 2^clip(round(log2(max(|w|, 1e-12))), e[n] - 7, e[n])
//
// What bounds it on the card: memory.  Each element is read once and
// written once (8 bytes) and costs a handful of flops, plus 4*N bytes of
// scales, so the least time is 8*K*N bytes over the 3.35 TB/s of an H100
// SXM.  VGG-16's whole weight set (14,977,728 floats, about 120 MB) is
// about 36 us; its largest layer, 4608 x 512 (about 18.9 MB), is about
// 5.6 us, the same order as a launch.
//
// What the design does about that bound: one grid-stride pass, one load
// and one store per element and nothing in between; the scale vector is
// small and stays in L1/L2.  Ragged K and N need no padding.  The kernel
// launches on the caller's stream, synchronizes nothing and allocates
// nothing.
//
// Numerics follow jnp exactly: rintf rounds half to even like jnp.round;
// IEEE division, log2f and exp2f (this file must not be built with
// --use_fast_math: an approximate log2 flips pow2 codes at exponent
// boundaries, a factor of 2 in that weight); clip is min(max(x, lo), hi)
// written with comparisons so a NaN passes through as in jnp; sign(0) = 0
// keeps exact zeros at zero.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 8192;
constexpr float kPow2Levels = 8.0f;  // sign + 3-bit exponent

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  x = (x < lo) ? lo : x;
  return (x > hi) ? hi : x;
}

__device__ __forceinline__ float sign(float x) {
  return (x > 0.0f) ? 1.0f : ((x < 0.0f) ? -1.0f : x);
}

__global__ void fake_quant_kernel(const float* __restrict__ w,
                                  const float* __restrict__ scale,
                                  float* __restrict__ out,
                                  long long total, long long n_cols,
                                  int mode, float qmax) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const float x = w[i];
    const float s = scale[i % n_cols];
    float y;
    if (mode == 0) {
      y = clip(rintf(x / s), -qmax, qmax) * s;
    } else {
      float mag = fabsf(x);
      mag = (mag < 1e-12f) ? 1e-12f : mag;
      const float e = clip(rintf(log2f(mag)), s - (kPow2Levels - 1.0f), s);
      y = sign(x) * exp2f(e);
    }
    out[i] = y;
  }
}

}  // namespace

// mode 0 = affine (scale = per-channel step), 1 = pow2 (scale = e_max).
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int fake_quant_launch(const void* w, const void* scale, void* out,
                                 long long n_rows, long long n_cols, int mode,
                                 float qmax, void* stream) {
  const long long total = n_rows * n_cols;
  if (total <= 0) return 0;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  fake_quant_kernel<<<(unsigned)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(scale),
      static_cast<float*>(out), total, n_cols, mode, qmax);
  return (int)cudaGetLastError();
}

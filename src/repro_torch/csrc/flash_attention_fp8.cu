// Flash attention forward for Hopper, with grouped KV heads, on an fp8
// (float8_e4m3fn) K/V cache: the split and mma kernels of
// flash_attention_fwd.cuh (its header says what they compute and how)
// with e4m3 K and V and a float32 or bfloat16 q, without and with the
// window and the soft-cap (MASK).  A source of its own, so that its
// instances build beside flash_attention.cu's and
// flash_attention_masked.cu's.
//
// What it computes is the reference model's attention on an fp8 cache
// (repro/models/transformer.py `_attention_dynwin`: q . K in float32,
// the normalized P rounded to e4m3 before a float32 P V; with round_p =
// 0, repro/models/layers.py `_attend`: float32 P).  What bounds it on the
// card is the cache's bytes at decode, half of a bfloat16 cache's (a
// decode_32k step of Qwen3-32B reads 8 x 32,768 x 8 x 128 x 2 bytes a
// layer: 0.54 GB, 0.16 ms at 3.35 TB/s), so the e4m3 rows are read as they
// are and converted in registers (cvt.f16x2.e4m3x2, exact).

#include "flash_attention_fwd.cuh"

// The arguments of flash_attention_slice_launch (flash_attention.cu),
// kv_type 2 (float8_e4m3fn K and V); the window and the soft-cap taken.
extern "C" int flash_attention_fp8_slice_launch(
    const void* q, const void* k, const void* v, void* out,
    const void* q_start, int q_bf16, int kv_type, int B, int Sq, int Skv,
    int Hq, int Hkv, int D, const long long* q_strides,
    const long long* k_strides, const long long* v_strides,
    const long long* o_strides, float scale, int causal, int round_p,
    int window, float softcap, int variant, int rows, int splits, int vec,
    int mode, void* stats, void* stream) {
  if (window > 0 || softcap > 0.0f)
    return launch_impl<true, true>(
        q, k, v, out, q_start, q_bf16, kv_type, B, Sq, Skv, Hq, Hkv, D,
        q_strides, k_strides, v_strides, o_strides, scale, causal, round_p,
        window, softcap, variant, rows, splits, vec, mode, stats, stream);
  return launch_impl<false, true>(
      q, k, v, out, q_start, q_bf16, kv_type, B, Sq, Skv, Hq, Hkv, D,
      q_strides, k_strides, v_strides, o_strides, scale, causal, round_p,
      window, softcap, variant, rows, splits, vec, mode, stats, stream);
}

// The arguments of flash_attention_launch (flash_attention.cu), kv_type 2
// (float8_e4m3fn K and V); the window and the soft-cap taken.
extern "C" int flash_attention_fp8_launch(
    const void* q, const void* k, const void* v, void* out,
    const void* q_start, int q_bf16, int kv_type, int B, int Sq, int Skv,
    int Hq, int Hkv, int D, const long long* q_strides,
    const long long* k_strides, const long long* v_strides,
    const long long* o_strides, float scale, int causal, int round_p,
    int window, float softcap, int variant, int rows, int splits, int vec,
    void* stream) {
  return flash_attention_fp8_slice_launch(
      q, k, v, out, q_start, q_bf16, kv_type, B, Sq, Skv, Hq, Hkv, D,
      q_strides, k_strides, v_strides, o_strides, scale, causal, round_p,
      window, softcap, variant, rows, splits, vec, 0, nullptr, stream);
}

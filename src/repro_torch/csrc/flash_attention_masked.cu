// Flash attention forward for Hopper, with grouped KV heads: the split
// and mma kernels of flash_attention_fwd.cuh (its header says what they
// compute and how) with a sliding window or a logit soft-cap (MASK);
// flash_attention.cu builds them without.

#include "flash_attention_fwd.cuh"

// The arguments of flash_attention_launch (flash_attention.cu), for a
// launch with a window or a soft-cap (or neither: the masked kernels take
// every launch).
extern "C" int flash_attention_masked_launch(
    const void* q, const void* k, const void* v, void* out,
    const void* q_start, int q_bf16, int kv_type, int B, int Sq, int Skv,
    int Hq, int Hkv, int D, const long long* q_strides,
    const long long* k_strides, const long long* v_strides,
    const long long* o_strides, float scale, int causal, int round_p,
    int window, float softcap, int variant, int rows, int splits, int vec,
    void* stream) {
  return launch_impl<true, false>(
      q, k, v, out, q_start, q_bf16, kv_type, B, Sq, Skv, Hq, Hkv, D,
      q_strides, k_strides, v_strides, o_strides, scale, causal, round_p,
      window, softcap, variant, rows, splits, vec, 0, nullptr, stream);
}

// The same launch on one rank's slice of the keys (the sequence-sharded
// cache; flash_attention_fwd.cuh's header): mode 1 writes each row's (M,
// L) over the slice to stats (two float32 planes of B * Sq * Hq, M then
// L) and, without two passes, the output normalized by the slice's L;
// mode 2 reads the group's (M, L) from stats and writes the slice's P V.
// q_start may be negative (the slice starts past the query).
extern "C" int flash_attention_masked_slice_launch(
    const void* q, const void* k, const void* v, void* out,
    const void* q_start, int q_bf16, int kv_type, int B, int Sq, int Skv,
    int Hq, int Hkv, int D, const long long* q_strides,
    const long long* k_strides, const long long* v_strides,
    const long long* o_strides, float scale, int causal, int round_p,
    int window, float softcap, int variant, int rows, int splits, int vec,
    int mode, void* stats, void* stream) {
  return launch_impl<true, false>(
      q, k, v, out, q_start, q_bf16, kv_type, B, Sq, Skv, Hq, Hkv, D,
      q_strides, k_strides, v_strides, o_strides, scale, causal, round_p,
      window, softcap, variant, rows, splits, vec, mode, stats, stream);
}

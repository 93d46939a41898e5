// Flash attention forward for Hopper, with grouped KV heads: the split
// and mma kernels of flash_attention_fwd.cuh (its header says what they
// compute and how) without a window or a soft-cap;
// flash_attention_masked.cu builds them with both.  Two sources, so that
// the two halves of the instances build in parallel.

#include "flash_attention_fwd.cuh"

// q: (B, Sq, Hq, D), k, v: (B, Skv, Hkv, D), out: (B, Sq, Hq, D) float32,
// each given by its (batch, sequence, head) element strides with the D axis
// contiguous (out's rows 8-byte aligned); q_start: (B,) int32 on the
// card.  q_bf16, kv_bf16: 0 = float32, 1 = bfloat16 (k and v share a
// type).  D is 16, 32, 64, 112, 128 or 256.  round_p: round the probabilities
// to V's type before P V.  window: 0 (global) or the sliding window's
// width (causal only); softcap: 0 (off) or the logit soft-cap (this
// entry refuses both: flash_attention_masked_launch takes them).  The
// launch plan (the wrapper's `plan`): variant 0 = split (rows a block: 4
// or 8; splits: the cluster's blocks along the keys, 1..8), 1 = mma (rows
// 64, splits 1..8; D up to 128, a float32 q up to 64); vec: K and V rows
// on a 16-byte boundary.  Returns the launch's CUDA error: 0 when it was
// accepted.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out,
    const void* q_start, int q_bf16, int kv_bf16, int B, int Sq, int Skv,
    int Hq, int Hkv, int D, const long long* q_strides,
    const long long* k_strides, const long long* v_strides,
    const long long* o_strides, float scale, int causal, int round_p,
    int window, float softcap, int variant, int rows, int splits, int vec,
    void* stream) {
  return launch_impl<false>(q, k, v, out, q_start, q_bf16, kv_bf16, B, Sq,
                            Skv, Hq, Hkv, D, q_strides, k_strides, v_strides,
                            o_strides, scale, causal, round_p, window,
                            softcap, variant, rows, splits, vec, stream);
}

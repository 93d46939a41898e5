// Flash attention backward for Hopper at head_dims 112, 128 and 256: the
// rows and keys kernels of flash_attention_bwd_wgmma.cuh (its header says
// what they compute and how) with a sliding window or a logit soft-cap
// (MASK); flash_attention_bwd_wgmma.cu builds them without.

#include "flash_attention_bwd_wgmma.cuh"

// The arguments of flash_attention_bwd_wgmma_launch
// (flash_attention_bwd_wgmma.cu), for a launch with a window or a
// soft-cap (or neither: the masked kernels take every launch).
extern "C" int flash_attention_bwd_wgmma_masked_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* q_start, void* dq, void* dk, void* dv, void* stats,
    void* packed, int bf16, int B, int Sq, int Skv, int Hq, int Hkv, int D,
    float scale, int causal, int round_p, int window, float softcap,
    int splits, void* stream) {
  return launch_impl<true>(q, k, v, dout, q_start, dq, dk, dv, stats, packed,
                          bf16, B, Sq, Skv, Hq, Hkv, D, scale, causal,
                          round_p, window, softcap, splits, stream);
}

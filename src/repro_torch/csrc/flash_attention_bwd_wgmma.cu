// Flash attention backward for Hopper at head_dims 112, 128 and 256: the
// rows and keys kernels of flash_attention_bwd_wgmma.cuh (its header says
// what they compute and how) without a window or a soft-cap;
// flash_attention_bwd_wgmma_masked.cu builds them with both.  Two sources,
// so that the two halves of the instances build in parallel.

#include "flash_attention_bwd_wgmma.cuh"

// Shared memory bytes of the rows (keys = 0) or keys kernel at head_dim D
// (0 for a head_dim this source does not take): the wrapper's plan holds
// its own numbers to these.
extern "C" int flash_attention_bwd_wgmma_smem(int D, int bf16, int keys) {
  switch (D) {
    case 112: return smem_of<112>(bf16, keys);
    case 128: return smem_of<128>(bf16, keys);
    case 256: return smem_of<256>(bf16, keys);
    default: return 0;
  }
}

// q, k, v: contiguous (B, Sq, Hq, D), (B, Skv, Hkv, D) of one type (bf16 =
// 1: bfloat16, else float32), D in 112, 128, 256; dout: contiguous float32
// like q; dq, dk, dv: like q, k, v; stats: 3 * B * Sq * Hq floats of
// scratch; packed: bf16 scratch of B * Hkv * 64 * D * (rtiles * (XP + 3)
// + 2 * ktiles * XP) elements (rtiles = ceil(G * Sq / 64), ktiles =
// ceil(Skv / 64), XP = 1 for bfloat16, 3 for float32), 16-byte aligned.
// window: 0 (global) or the sliding window's width (causal only);
// softcap: 0 (off) or the logit soft-cap (this entry refuses both:
// flash_attention_bwd_wgmma_masked_launch takes them); splits: the keys
// kernel's cluster on a key tile (1..8; the wrapper's `bwd_key_splits`).
// Returns 0 or the CUDA error of a refused launch.
extern "C" int flash_attention_bwd_wgmma_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* q_start, void* dq, void* dk, void* dv, void* stats,
    void* packed, int bf16, int B, int Sq, int Skv, int Hq, int Hkv, int D,
    float scale, int causal, int round_p, int window, float softcap,
    int splits, void* stream) {
  return launch_impl<false>(q, k, v, dout, q_start, dq, dk, dv, stats, packed,
                           bf16, B, Sq, Skv, Hq, Hkv, D, scale, causal,
                           round_p, window, softcap, splits, stream);
}

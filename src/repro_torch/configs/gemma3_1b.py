"""Gemma3-1B [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144 — 5:1 local:global (window 512), 128k ctx.
[hf:google/gemma-3-1b-pt; unverified]"""

from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="gemma3-1b", family="lm",
    n_layers=26, d_model=1152, n_heads=4, kv_heads=1, head_dim=256,
    d_ff=6912, vocab=262144, qk_norm=True, window=512,
    layer_pattern="gemma3", rope_theta=1e6, act="gelu",
    tie_embeddings=True, zero_centered_norm=True, embed_scale=True,
    sub_quadratic=True,
)


def reduced():
    return ARCH.replace(n_layers=6, d_model=64, n_heads=2, kv_heads=1,
                        head_dim=32, d_ff=128, vocab=256, window=8)

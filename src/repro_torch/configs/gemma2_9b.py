"""Gemma2-9B [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000 — local(4096)/global alternating, logit softcaps (50/30).
[arXiv:2408.00118; hf]"""

from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="gemma2-9b", family="lm",
    n_layers=42, d_model=3584, n_heads=16, kv_heads=8, head_dim=256,
    d_ff=14336, vocab=256000, window=4096, layer_pattern="alt_local_global",
    attn_softcap=50.0, final_softcap=30.0, act="gelu",
    tie_embeddings=True, zero_centered_norm=True, embed_scale=True,
    query_scale=1.0 / 16.0,  # query_pre_attn_scalar=256 -> 1/sqrt(256)
    sub_quadratic=True,
)


def reduced():
    return ARCH.replace(n_layers=4, d_model=64, n_heads=4, kv_heads=2,
                        head_dim=16, d_ff=128, vocab=256, window=8,
                        query_scale=0.25)

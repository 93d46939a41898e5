"""Qwen3-32B [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936 — qk_norm, GQA. [hf:Qwen/Qwen3-8B family; hf]"""

from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="qwen3-32b", family="lm",
    n_layers=64, d_model=5120, n_heads=64, kv_heads=8, head_dim=128,
    d_ff=25600, vocab=151936, qk_norm=True, rope_theta=1e6,
)


def reduced():
    return ARCH.replace(n_layers=2, d_model=64, n_heads=4, kv_heads=2,
                        head_dim=16, d_ff=128, vocab=256)

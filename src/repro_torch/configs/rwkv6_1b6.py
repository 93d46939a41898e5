"""RWKV6-1.6B "Finch" [ssm]: 24L d_model=2048 (attn-free) d_ff=7168
vocab=65536 — data-dependent decay. [arXiv:2404.05892; unverified]"""

from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=0, kv_heads=0, head_dim=64,
    d_ff=7168, vocab=65536, ssm_heads=32, sub_quadratic=True,
)


def reduced():
    return ARCH.replace(n_layers=2, d_model=64, d_ff=128, vocab=256,
                        ssm_heads=4, head_dim=16)

"""Zamba2-7B [hybrid]: 81L d_model=3584 32H (kv=32) d_ff=14336
ssm_state=64 — Mamba2 backbone + 2 alternating SHARED attention blocks
applied every 6th layer (adaptation documented in DESIGN.md).
[arXiv:2411.15242; unverified]"""

from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000, ssm_state=64,
    shared_attn_every=6, n_shared_blocks=2, sub_quadratic=True,
)


def reduced():
    return ARCH.replace(n_layers=5, d_model=64, n_heads=4, kv_heads=4,
                        head_dim=16, d_ff=128, vocab=256, ssm_state=16,
                        shared_attn_every=2, n_shared_blocks=2)

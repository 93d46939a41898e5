"""Phi-3.5-MoE-42B-A6.6B [moe]: 32L d_model=4096 32H (GQA kv=8)
d_ff=6400/expert vocab=32064, 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""

from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, kv_heads=8, head_dim=128,
    d_ff=6400, vocab=32064,
    moe_experts=16, moe_topk=2, moe_d_ff=6400,
)


def reduced():
    return ARCH.replace(n_layers=2, d_model=64, n_heads=4, kv_heads=2,
                        head_dim=16, d_ff=128, vocab=256,
                        moe_experts=4, moe_topk=2, moe_d_ff=64)

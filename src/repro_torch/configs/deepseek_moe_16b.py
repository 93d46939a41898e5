"""DeepSeekMoE-16B [moe]: 28L d_model=2048 16H (MHA kv=16) d_ff=1408/expert
vocab=102400 — 2 shared + 64 routed top-6, fine-grained; layer 0 dense
(d_ff 10944). [arXiv:2401.06066; hf]"""

from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, kv_heads=16, head_dim=128,
    d_ff=1408, vocab=102400,
    moe_experts=64, moe_topk=6, moe_d_ff=1408, moe_shared=2,
    first_dense=1, dense_d_ff=10944,
)


def reduced():
    return ARCH.replace(n_layers=3, d_model=64, n_heads=4, kv_heads=4,
                        head_dim=16, d_ff=64, vocab=256,
                        moe_experts=8, moe_topk=2, moe_d_ff=32,
                        moe_shared=1, first_dense=1, dense_d_ff=128)

"""Qwen2-VL-72B [vlm backbone]: 80L d_model=8192 64H (GQA kv=8)
d_ff=29568 vocab=152064 — M-RoPE (t/h/w sections), dynamic resolution.
Vision frontend is a stub: input_specs() supplies patch embeddings + 3-D
position ids. [arXiv:2409.12191; hf]"""

from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, kv_heads=8, head_dim=128,
    d_ff=29568, vocab=152064, rope_theta=1e6,
    mrope_sections=(16, 24, 24),
)


def reduced():
    return ARCH.replace(n_layers=2, d_model=64, n_heads=4, kv_heads=2,
                        head_dim=16, d_ff=128, vocab=256,
                        mrope_sections=(2, 3, 3))

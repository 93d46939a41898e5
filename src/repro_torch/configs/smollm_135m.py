"""SmolLM-135M [dense]: 30L d_model=576 9H (GQA kv=3) d_ff=1536
vocab=49152 — llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]"""

from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="smollm-135m", family="lm",
    n_layers=30, d_model=576, n_heads=9, kv_heads=3, head_dim=64,
    d_ff=1536, vocab=49152, tie_embeddings=True,
)


def reduced():
    return ARCH.replace(n_layers=2, d_model=48, n_heads=3, kv_heads=1,
                        head_dim=16, d_ff=96, vocab=256)

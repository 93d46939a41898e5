"""Whisper-medium [audio enc-dec]: 24L enc + 24L dec, d_model=1024 16H
(kv=16) d_ff=4096 vocab=51865 — conv frontend STUB (input_specs supplies
frame embeddings). [arXiv:2212.04356; unverified]"""

from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, kv_heads=16, head_dim=64,
    d_ff=4096, vocab=51865, enc_layers=24, dec_layers=24, act="gelu",
    tie_embeddings=True,
)


def reduced():
    return ARCH.replace(n_layers=2, d_model=64, n_heads=4, kv_heads=4,
                        head_dim=16, d_ff=128, vocab=256,
                        enc_layers=2, dec_layers=2)

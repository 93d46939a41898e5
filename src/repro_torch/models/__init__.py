"""Model families of the port (port of ``repro.models``): every family
of the JAX package, and the paper's CNNs.

``family_module(cfg)`` dispatches an ArchConfig to its implementation:
  lm / moe / vlm -> transformer (decoder-only, a loop over stacked layers;
                    MoE blocks in ``moe``; the VLM's text backbone; the
                    perf variants' attentions in ``block_attn`` and
                    ``flash_attn``)
  ssm            -> rwkv (RWKV6 chunked linear attention, ``ssm_common``)
  hybrid         -> hybrid (zamba2: Mamba2 blocks, ``mamba``, and shared
                    attention blocks)
  encdec         -> encdec (whisper-style)
The CNNs (``cnn``) take no ArchConfig: ``resnet_*`` and ``vgg16_*``.
"""

from repro_torch.models import (block_attn, cnn, encdec, flash_attn, hybrid,
                                layers, mamba, moe, rwkv, ssm_common,
                                transformer)


def family_module(cfg):
    if cfg.family in ("lm", "moe", "vlm"):
        return transformer
    if cfg.family == "ssm":
        return rwkv
    if cfg.family == "hybrid":
        return hybrid
    if cfg.family == "encdec":
        return encdec
    raise ValueError(f"unknown family {cfg.family!r}")


__all__ = ["block_attn", "cnn", "encdec", "flash_attn", "hybrid", "layers",
           "mamba", "moe", "rwkv", "ssm_common", "transformer",
           "family_module"]

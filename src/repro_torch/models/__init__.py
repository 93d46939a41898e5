"""Model families of the port (port of ``repro.models``; so far the
decoder-only families, the encoder-decoder family and the paper's CNNs).

``family_module(cfg)`` dispatches an ArchConfig to its implementation:
  lm / moe / vlm -> transformer (decoder-only, a loop over stacked layers;
                    MoE blocks in ``moe``; the VLM's text backbone; the
                    perf variants' attentions in ``block_attn`` and
                    ``flash_attn``)
  encdec         -> encdec (whisper-style)
The CNNs (``cnn``) take no ArchConfig: ``resnet_*`` and ``vgg16_*``.
"""

from repro_torch.models import (block_attn, cnn, encdec, flash_attn, layers,
                                moe, transformer)


def family_module(cfg):
    if cfg.family in ("lm", "moe", "vlm"):
        return transformer
    if cfg.family == "encdec":
        return encdec
    raise ValueError(f"the port has no model family {cfg.family!r} yet "
                     f"(ROADMAP A)")


__all__ = ["block_attn", "cnn", "encdec", "flash_attn", "layers", "moe",
           "transformer", "family_module"]

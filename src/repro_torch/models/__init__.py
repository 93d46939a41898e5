"""Model families of the port (port of ``repro.models``; so far the
decoder-only families and the paper's CNNs).

``family_module(cfg)`` dispatches an ArchConfig to its implementation:
  lm / moe / vlm -> transformer (decoder-only, a loop over stacked layers;
                    MoE blocks in ``moe``; the VLM's text backbone)
The CNNs (``cnn``) take no ArchConfig: ``resnet_*`` and ``vgg16_*``.
"""

from repro_torch.models import cnn, layers, moe, transformer


def family_module(cfg):
    if cfg.family in ("lm", "moe", "vlm"):
        return transformer
    raise ValueError(f"the port has no model family {cfg.family!r} yet "
                     f"(ROADMAP A)")


__all__ = ["cnn", "layers", "moe", "transformer", "family_module"]

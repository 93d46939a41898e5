"""Model families of the port (port of ``repro.models``; so far the
decoder-only LM and the paper's CNNs).

``family_module(cfg)`` dispatches an ArchConfig to its implementation:
  lm -> transformer (decoder-only, a loop over stacked layers)
The CNNs (``cnn``) take no ArchConfig: ``resnet_*`` and ``vgg16_*``.
"""

from repro_torch.models import cnn, layers, transformer


def family_module(cfg):
    if cfg.family == "lm":
        return transformer
    raise ValueError(f"the port has no model family {cfg.family!r} yet "
                     f"(ROADMAP A)")


__all__ = ["cnn", "layers", "transformer", "family_module"]

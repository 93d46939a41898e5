"""Architecture configs of the port (port of ``repro.configs``): one
module per assigned architecture, copied with its ``reduced()``."""

from repro_torch.configs.base import (ArchConfig, ARCH_IDS, ASSIGNED, get,
                                      reduced, list_archs)

__all__ = ["ArchConfig", "ARCH_IDS", "ASSIGNED", "get", "reduced",
           "list_archs"]

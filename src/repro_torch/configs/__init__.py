"""Architecture configs of the port (port of ``repro.configs``; only the
configs the port serves)."""

from repro_torch.configs.base import ArchConfig, ARCH_IDS, get, reduced

__all__ = ["ArchConfig", "ARCH_IDS", "get", "reduced"]

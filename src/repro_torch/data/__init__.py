"""Synthetic data and its pipeline (port of ``repro.data``)."""

from repro_torch.data import synthetic
from repro_torch.data.pipeline import DataPipeline, cifar_pipeline, lm_pipeline

__all__ = ["synthetic", "DataPipeline", "cifar_pipeline", "lm_pipeline"]

"""Per-(model, PE-type) accuracy surrogate for joint co-exploration
(port of ``repro.core.accuracy``).

A cheap predictor of top-1 accuracy for any (model, PE type) pair:

* seeded deltas from ``pe.ACC_DELTA_BY_NAME`` (the paper's Figs. 5-6,
  keyed by PE-type name), multiplied by ``capacity_scale(macs)`` (the
  gap shrinks with model size: 1.0 at ResNet-20/CIFAR, ``(ref/macs)**0.2``
  above it, floored at 0.25);
* base accuracies from published FP32 results (``BASE_ACC_SEED``),
  scaled members falling back to their canonical member's seed and
  unknown models to a smooth capacity curve;
* ``calibrate`` / ``load_qat_results`` record measured accuracies, which
  beat every seed (a measured FP32 point rebases the family);
* an opt-in layer-class mix (``workloads.acc_class_mix``) weights the
  delta by ``ACC_CLASS_SENS``; ``None`` or an all-default mix gives the
  scalar delta exactly.

All host arithmetic is Python/numpy float64, as in the reference, so
every prediction equals the reference's bit for bit; ``delta_array`` is
the float32 positional view on a device.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from repro_torch.core.arch import PE_TYPE_CODES, PE_TYPE_NAMES
from repro_torch.core.pe import ACC_DELTA_BY_NAME
from repro_torch.core.workloads import ACC_CLASSES
from repro_torch.device import resolve_device

# Reference capacity: ResNet-20 / CIFAR-10 forward MACs — the smallest
# paper model, where the paper reports the largest quantization gaps.
REF_MACS = 4.1e7

# Per-layer-class quantization-sensitivity priors, aligned with
# ``workloads.ACC_CLASSES`` = ("default", "attn", "ffn", "expert").
# Softmax-adjacent attention GEMMs amplify quantization error (~1.3x),
# over-parameterized FFN blocks absorb it (~0.9x), and top-k-gated
# experts see fewer tokens per weight than dense FFNs (less averaging:
# ~1.15x).  "default" MUST stay exactly 1.0: an untagged workload's mix
# is all-default and its delta must equal the scalar path bit-exactly.
ACC_CLASS_SENS = {"default": 1.0, "attn": 1.3, "ffn": 0.9, "expert": 1.15}

# Published FP32 top-1 seeds for the paper's models (fractions).
BASE_ACC_SEED = {
    "resnet20-cifar10": 0.916,
    "resnet32-cifar10": 0.925,
    "resnet44-cifar10": 0.927,
    "resnet56-cifar10": 0.930,
    "resnet20-cifar100": 0.683,
    "resnet56-cifar100": 0.716,
    "vgg16-cifar10": 0.938,
    "vgg16-cifar100": 0.724,
    "vgg16-imagenet": 0.715,
    "resnet34-imagenet": 0.733,
    "resnet50-imagenet": 0.761,
}


def _pe_name(pe_type) -> str:
    """Normalize a PE type given as name or code to its name."""
    if isinstance(pe_type, str):
        if pe_type not in PE_TYPE_CODES:
            raise KeyError(f"unknown PE type {pe_type!r}; "
                           f"known: {PE_TYPE_NAMES}")
        return pe_type
    return PE_TYPE_NAMES[int(pe_type)]


def _strip_scale_suffix(name: str) -> str:
    """Canonical family member of a scaled model name.

    Scale suffixes are the ``-w<mult>`` / ``-r<res>`` tags appended by the
    workload families ('resnet20-cifar10-w2-r16' -> 'resnet20-cifar10').
    """
    parts = name.split("-")
    while len(parts) > 1 and (
            (parts[-1][:1] == "w" and parts[-1][1:]
             .replace(".", "", 1).isdigit())
            or (parts[-1][:1] == "r" and parts[-1][1:].isdigit())):
        parts.pop()
    return "-".join(parts)


def capacity_scale(macs: float) -> float:
    """Quantization-gap multiplier: 1.0 at REF_MACS, shrinking with size."""
    return float(np.clip((REF_MACS / max(float(macs), 1.0)) ** 0.2,
                         0.25, 1.0))


def seeded_base_accuracy(model_name: str, macs: float | None = None) -> float:
    """FP32 base accuracy: exact seed, canonical-member seed for scaled
    names, else a smooth monotone capacity curve (proxy for unseeded
    models — see the module docstring's provenance contract)."""
    if model_name in BASE_ACC_SEED:
        return BASE_ACC_SEED[model_name]
    stripped = _strip_scale_suffix(model_name)
    if stripped in BASE_ACC_SEED:
        return BASE_ACC_SEED[stripped]
    m = 1.0 if macs is None else max(float(macs), 1.0)
    return float(np.clip(0.72 + 0.045 * np.log10(m / 1e6), 0.30, 0.99))


class AccuracySurrogate:
    """Name-keyed accuracy predictor with a measurement-calibration hook.

    Seeds (deltas + base accuracies) follow the module-docstring contract;
    every prediction path is keyed by PE-type *name* — the positional
    ``ACC_DELTA_PP`` array in ``pe.py`` is only a derived view.
    """

    def __init__(self, deltas_pp: dict[str, float] | None = None,
                 class_sens: dict[str, float] | None = None):
        unknown = set(deltas_pp or ()) - set(PE_TYPE_NAMES)
        if unknown:
            raise KeyError(f"unknown PE types in deltas: {sorted(unknown)}")
        unknown = set(class_sens or ()) - set(ACC_CLASS_SENS)
        if unknown:
            raise KeyError(f"unknown accuracy classes in class_sens: "
                           f"{sorted(unknown)}")
        self._deltas = dict(ACC_DELTA_BY_NAME, **(deltas_pp or {}))
        self._class_sens = dict(ACC_CLASS_SENS, **(class_sens or {}))
        self._measured: dict[tuple[str, str], float] = {}

    # -- seeded prediction ---------------------------------------------------

    def class_multiplier(self, class_mix=None) -> float:
        """Delta multiplier for a MAC-weighted ``ACC_CLASSES`` mix
        (``workloads.acc_class_mix``): ``sum(mix * sens)``.

        ``None`` (untagged model) returns exactly 1.0, and so does an
        all-default mix — the scalar-delta paths are reproduced bit-exactly
        for every pre-existing workload."""
        if class_mix is None:
            return 1.0
        mix = tuple(float(v) for v in class_mix)
        if len(mix) != len(ACC_CLASSES):
            raise ValueError(f"class_mix needs {len(ACC_CLASSES)} entries "
                             f"({ACC_CLASSES}), got {len(mix)}")
        if mix[0] == 1.0 and not any(mix[1:]):
            return 1.0  # exact: no float dot product on the legacy path
        return float(sum(m * self._class_sens[c]
                         for m, c in zip(mix, ACC_CLASSES)))

    def delta_pp(self, pe_type, macs: float | None = None,
                 class_mix=None) -> float:
        """Accuracy delta vs FP32 (pp) for one PE type at a capacity,
        optionally weighted by a layer-class sensitivity mix."""
        d = self._deltas[_pe_name(pe_type)]
        d = d * (1.0 if macs is None else capacity_scale(macs))
        mult = self.class_multiplier(class_mix)
        return d if mult == 1.0 else d * mult

    def delta_array(self, macs: float | None = None, class_mix=None,
                    device: str | torch.device | None = None) -> torch.Tensor:
        """Thin float32 positional view aligned with ``PE_TYPE_NAMES``
        (gather by pe_type code), on ``device``."""
        return torch.tensor([self.delta_pp(n, macs, class_mix)
                             for n in PE_TYPE_NAMES], dtype=torch.float32,
                            device=resolve_device(device))

    # -- calibration ---------------------------------------------------------

    def calibrate(self, model_name: str, pe_type, accuracy: float) -> None:
        """Record a measured top-1 accuracy (fraction) — overrides seeds."""
        self._measured[(model_name, _pe_name(pe_type))] = float(accuracy)

    def load_qat_results(self, path: str = "results/qat_pareto.json",
                         model_name: str = "resnet20-cifar10") -> int:
        """Ingest ``examples/train_qat.py --mode cnn`` output (a
        ``{pe_name: {"top1_mean": ...}}`` table). Returns #entries loaded."""
        with open(path) as f:
            table = json.load(f)
        n = 0
        for pe, row in table.items():
            if pe in PE_TYPE_CODES and "top1_mean" in row:
                self.calibrate(model_name, pe, row["top1_mean"])
                n += 1
        return n

    # -- prediction ----------------------------------------------------------

    def predict(self, model_name: str, pe_type,
                macs: float | None = None,
                base_acc: float | None = None,
                class_mix=None) -> float:
        """Top-1 accuracy (fraction) of ``model_name`` under ``pe_type``.

        Priority: measured (model, pe) point > measured FP32 base + seeded
        delta > supplied/seeded base + seeded delta.  ``class_mix`` (a
        ``workloads.acc_class_mix`` tuple) weights the delta by layer-class
        sensitivity; measured points are never reweighted.
        """
        pe = _pe_name(pe_type)
        if (model_name, pe) in self._measured:
            return self._measured[(model_name, pe)]
        base = self._measured.get((model_name, "fp32"))
        if base is None:
            base = (base_acc if base_acc is not None
                    else seeded_base_accuracy(model_name, macs))
        return base + self.delta_pp(pe, macs, class_mix) / 100.0

    def predict_per_type(self, model_name: str,
                         macs: float | None = None,
                         base_acc: float | None = None,
                         class_mix=None) -> np.ndarray:
        """Predicted accuracy for every PE type, aligned with
        ``PE_TYPE_NAMES`` (the per-model accuracy column of the joint DSE)."""
        return np.array([self.predict(model_name, n, macs, base_acc,
                                      class_mix)
                         for n in PE_TYPE_NAMES])

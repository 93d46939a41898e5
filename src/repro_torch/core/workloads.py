"""Layer-wise DNN workloads (port of ``repro.core.workloads``, the CNN
part).

A workload is a stack of conv (or GEMM-as-1x1-conv) layer specs with a
``count`` multiplicity, kept as parallel (L,) float32 tensors so the
dataflow cost model prices every layer of a network at once.  Each layer
also carries the reference's four operand-residency fields (``kind``,
``stream_words``, ``active_frac``, ``acc_class``); at their neutral
defaults the cost model is the paper's conv-only model.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.device import host, resolve_device

# Layer kinds: how the second operand resides (stored as float codes).
LAYER_KINDS = ("conv", "gemm", "attn_kv", "moe_expert")
KIND_CONV, KIND_GEMM, KIND_ATTN_KV, KIND_MOE_EXPERT = range(len(LAYER_KINDS))

# Accuracy-sensitivity classes.
ACC_CLASSES = ("default", "attn", "ffn", "expert")
ACC_DEFAULT, ACC_ATTN, ACC_FFN, ACC_EXPERT = range(len(ACC_CLASSES))


class LayerSpec(NamedTuple):
    """One conv layer: input HxWxC, K filters of RxS, given stride & batch.

    A GEMM (M x Kd) @ (Kd x N) is the conv H=1, W=M, C=Kd, K=N,
    R=S=stride=1.  The trailing fields are the phase-aware IR: ``kind``
    (LAYER_KINDS code), ``stream_words`` (streamed operand words per
    batch element), ``active_frac`` (active-MAC fraction per weight
    read) and ``acc_class`` (ACC_CLASSES code).
    """

    H: torch.Tensor
    W: torch.Tensor
    C: torch.Tensor
    K: torch.Tensor
    R: torch.Tensor
    S: torch.Tensor
    stride: torch.Tensor
    batch: torch.Tensor
    count: torch.Tensor  # multiplicity (identical repeated layers)
    kind: torch.Tensor | float = 0.0
    stream_words: torch.Tensor | float = 0.0
    active_frac: torch.Tensor | float = 1.0
    acc_class: torch.Tensor | float = 0.0

    def out_hw(self):
        E = torch.floor((self.H - self.R) / self.stride) + 1.0
        F = torch.floor((self.W - self.S) / self.stride) + 1.0
        return E, F

    def macs(self):
        E, F = self.out_hw()
        return self.batch * self.K * self.C * self.R * self.S * E * F * self.count


class Workload(NamedTuple):
    name: str
    layers: LayerSpec           # stacked, leading dim = n_layers
    layer_names: tuple


# Neutral IR defaults for rows that do not set the phase-aware fields.
_IR_DEFAULTS = dict(kind=float(KIND_CONV), stream_words=0.0,
                    active_frac=1.0, acc_class=float(ACC_DEFAULT))


def _stack(rows: Sequence[dict], name: str, names: Sequence[str],
           device: str | torch.device | None = None) -> Workload:
    device = resolve_device(device)
    arr = {f: torch.as_tensor(
        np.array([r.get(f, _IR_DEFAULTS.get(f)) for r in rows], np.float64),
        dtype=torch.float32, device=device) for f in LayerSpec._fields}
    return Workload(name=name, layers=LayerSpec(**arr), layer_names=tuple(names))


def conv(H, W, C, K, R=3, S=None, stride=1, batch=1, count=1):
    S = R if S is None else S
    return dict(H=H + (R - 1), W=W + (S - 1),  # 'same' padding baked into H,W
                C=C, K=K, R=R, S=S, stride=stride, batch=batch, count=count)


def conv_valid(H, W, C, K, R, S=None, stride=1, batch=1, count=1):
    S = R if S is None else S
    return dict(H=H, W=W, C=C, K=K, R=R, S=S, stride=stride, batch=batch,
                count=count)


def gemm(M, Kd, N, batch=1, count=1, kind=KIND_GEMM, stream_words=0.0,
         active_frac=1.0, acc_class=ACC_DEFAULT):
    return dict(H=1, W=M, C=Kd, K=N, R=1, S=1, stride=1, batch=batch,
                count=count, kind=float(kind),
                stream_words=float(stream_words),
                active_frac=float(active_frac), acc_class=float(acc_class))


def _scale_suffix(width_mult: float, resolution: int | None,
                  base_res: int) -> str:
    """Name suffix for scaled family members ('' for the canonical member)."""
    parts = []
    if width_mult != 1.0:
        parts.append(f"w{width_mult:g}")
    if resolution is not None and resolution != base_res:
        parts.append(f"r{resolution}")
    return "".join(f"-{p}" for p in parts)


def vgg16(dataset: str = "imagenet", batch: int = 1,
          width_mult: float = 1.0, resolution: int | None = None,
          device: str | torch.device | None = None) -> Workload:
    """VGG-16, optionally width- and resolution-scaled; the defaults are
    the paper's VGG-16."""
    if dataset == "imagenet":
        base_res, n_cls, fc_w = 224, 1000, 4096
    else:  # cifar10 / cifar100
        base_res = 32
        n_cls, fc_w = (100 if dataset == "cifar100" else 10), 512
    hw = base_res if resolution is None else resolution
    if hw < 16:
        raise ValueError(f"vgg16 needs resolution >= 16, got {hw}")
    w = lambda k: max(1, round(k * width_mult))  # noqa: E731
    rows, names = [], []
    cfg = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
    c, h = 3, hw
    for blk, (k, reps) in enumerate(cfg):
        for r in range(reps):
            rows.append(conv(h, h, c, w(k), 3, batch=batch))
            names.append(f"conv{blk + 1}_{r + 1}")
            c = w(k)
        h //= 2  # maxpool
    fc_in = max(h, 1) ** 2 * c
    if dataset == "imagenet":
        fcs = [(fc_in, w(fc_w)), (w(fc_w), w(fc_w)), (w(fc_w), n_cls)]
    else:
        fcs = [(fc_in, w(fc_w)), (w(fc_w), n_cls)]
    for i, (m, n) in enumerate(fcs):
        rows.append(gemm(1, m, n, batch=batch))
        names.append(f"fc{i + 1}")
    name = f"vgg16-{dataset}" + _scale_suffix(width_mult, resolution, base_res)
    return _stack(rows, name, names, device)


def resnet_cifar(depth: int, dataset: str = "cifar10", batch: int = 1,
                 width_mult: float = 1.0, resolution: int = 32,
                 device: str | torch.device | None = None) -> Workload:
    """ResNet-20/56 for CIFAR (He et al.): 3 stages of n=(depth-2)/6 blocks."""
    n = (depth - 2) // 6
    n_cls = 100 if dataset == "cifar100" else 10
    if resolution < 4:
        raise ValueError(f"resnet_cifar needs resolution >= 4, got {resolution}")
    w = lambda k: max(1, round(k * width_mult))  # noqa: E731
    rows = [conv(resolution, resolution, 3, w(16), 3, batch=batch)]
    names = ["stem"]
    c, h = w(16), resolution
    for stage, k0 in enumerate((16, 32, 64)):
        k = w(k0)
        for b in range(n):
            s = 2 if (stage > 0 and b == 0) else 1
            rows.append(conv(h // s if s == 1 else h, h // s if s == 1 else h,
                             c, k, 3, stride=s, batch=batch))
            h = h // s
            rows.append(conv(h, h, k, k, 3, batch=batch))
            names += [f"s{stage}b{b}c1", f"s{stage}b{b}c2"]
            if s == 2 or c != k:
                rows.append(conv(h * s, h * s, c, k, 1, stride=s, batch=batch))
                names.append(f"s{stage}b{b}sc")
            c = k
    rows.append(gemm(1, w(64), n_cls, batch=batch))
    names.append("fc")
    name = (f"resnet{depth}-{dataset}"
            + _scale_suffix(width_mult, resolution, 32))
    return _stack(rows, name, names, device)


def workload_macs(wl: Workload, per_inference: bool = False) -> float:
    """Total forward MACs of the workload, summed on the host in float64
    (``per_inference=True`` divides the batch factor back out)."""
    m = host(wl.layers.macs()).astype(np.float64)
    if per_inference:
        m = m / host(wl.layers.batch).astype(np.float64)
    return float(np.sum(m))


def weight_shapes(wl: Workload) -> list[tuple[int, int]]:
    """Each layer's weight matrix as (R*S*C, K): the (K, N) layout with
    the output channel last that ``quant.fake_quant_weight`` quantizes
    per channel."""
    R, S, C, K = (host(getattr(wl.layers, f)) for f in "RSCK")
    return [(int(r * s * c), int(k)) for r, s, c, k in zip(R, S, C, K)]

"""The paper's CNNs (VGG-16, CIFAR ResNets) with QAT hooks (port of
``repro.models.cnn``).

Used for the paper-faithful QAT Pareto experiment (Figs. 5-6): the same
model trains under each PE type's numerics, and its accuracy lands on
the accuracy x hardware-efficiency plots.

The reference's layouts are kept at every function: NHWC images, HWIO
conv weights, params as nested dicts and lists.  The convolutions are
cuDNN's (``F.conv2d``; the reference leaves them to XLA, outside any
Pallas kernel), in IEEE float32 (the port turns TF32 off at import):
NHWC and HWIO are permuted to NCHW and OIHW at the call only (an NHWC
tensor so viewed is channels-last).  Two places where the frameworks
differ are written out:

  * ``"SAME"`` padding is XLA's: a total of max((ceil(n/s) - 1) s + k - n,
    0), the smaller half before.  A 3x3 stride-2 conv on 32x32 pads
    (0, 1), where PyTorch's ``padding=1`` pads (1, 1); so the input is
    padded explicitly and the conv runs with ``padding=0``.
  * ``groupnorm`` takes the biased variance (``jnp.var``) over (H, W,
    channels of the group), groups min(8, c), eps 1e-5.

Deviation of the reference, kept: GroupNorm instead of BatchNorm, so the
forward is stateless.  ``fake_quant`` runs on every conv's weight (per
output channel, the last axis of HWIO) and on its NHWC input activation
(per tensor), through the ``fake_quant`` kernel.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.quant.fake_quant import fake_quant_act, fake_quant_weight
from repro_torch.quant.qconfig import QuantConfig, preset

Params = Dict[str, Any]


def conv_init(gen: torch.Generator, c_in: int, c_out: int, k: int = 3,
              dtype=torch.float32, device=None) -> torch.Tensor:
    """(k, k, c_in, c_out) HWIO, N(0, 1 / (c_in k^2)), drawn from ``gen``."""
    device = resolve_device(device)
    scale = 1.0 / torch.sqrt(torch.tensor(c_in * k * k, dtype=torch.float32))
    w = torch.randn((k, k, c_in, c_out), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * scale.to(gen.device)).to(device=device, dtype=dtype)


def same_pads(n: int, k: int, stride: int) -> tuple:
    """XLA's ``"SAME"`` padding (before, after) of one spatial axis."""
    total = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def qconv(x: torch.Tensor, w: torch.Tensor, qcfg: QuantConfig,
          stride: int = 1) -> torch.Tensor:
    """NHWC conv with an HWIO weight, QAT fake quantization of the weight
    and the activation, and XLA's ``"SAME"`` padding."""
    if not qcfg.is_identity:
        w = fake_quant_weight(w, qcfg)
        x = fake_quant_act(x, qcfg)
    k_h, k_w = w.shape[0], w.shape[1]
    (hl, hh), (wl, wh) = (same_pads(x.shape[1], k_h, stride),
                          same_pads(x.shape[2], k_w, stride))
    xc = x.permute(0, 3, 1, 2)                     # NCHW, channels-last
    if hl or hh or wl or wh:
        xc = F.pad(xc, (wl, wh, hl, hh))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def groupnorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    b, h, w, c = x.shape
    g = min(groups, c)
    xg = x.reshape(b, h, w, g, c // g).to(torch.float32)
    mu = torch.mean(xg, dim=(1, 2, 4), keepdim=True)
    var = torch.var(xg, dim=(1, 2, 4), correction=0, keepdim=True)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return (xg.reshape(b, h, w, c) * scale + bias).to(x.dtype)


def _gn_init(c: int, dtype, device) -> Params:
    return {"scale": torch.ones((c,), dtype=dtype, device=device),
            "bias": torch.zeros((c,), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# ResNet for CIFAR (He et al.): depth = 6n + 2
# ---------------------------------------------------------------------------

def _resnet_plan(depth: int):
    """[(c_in, c_out, stride), ...] of the blocks of ResNet-``depth``."""
    n = (depth - 2) // 6
    plan, c = [], 16
    for stage, k in enumerate((16, 32, 64)):
        for b in range(n):
            plan.append((c, k, 2 if (stage > 0 and b == 0) else 1))
            c = k
    return plan


def resnet_init(gen: torch.Generator, depth: int = 20, n_classes: int = 10,
                dtype=torch.float32, device=None) -> Params:
    device = resolve_device(device)
    p: Params = {"stem": conv_init(gen, 3, 16, 3, dtype, device),
                 "stem_gn": _gn_init(16, dtype, device), "blocks": []}
    for c, k, s in _resnet_plan(depth):
        blk = {"c1": conv_init(gen, c, k, 3, dtype, device),
               "gn1": _gn_init(k, dtype, device),
               "c2": conv_init(gen, k, k, 3, dtype, device),
               "gn2": _gn_init(k, dtype, device)}
        # stride is structural: exactly the shortcut blocks downsample
        if s != 1 or c != k:
            blk["sc"] = conv_init(gen, c, k, 1, dtype, device)
        p["blocks"].append(blk)
    fc = torch.randn((64, n_classes), generator=gen, dtype=torch.float32,
                     device=gen.device) * 0.01
    p["fc"] = fc.to(device=device, dtype=dtype)
    return p


def numpy_resnet(depth: int = 20, n_classes: int = 10, seed: int = 0) -> dict:
    """ResNet-``depth`` params as numpy float32 arrays in the reference's
    layout and init scales, from ``np.random.default_rng(seed)``: the same
    weights for both packages (``convert.params_from_numpy`` here,
    ``jnp.asarray`` there)."""
    rng = np.random.default_rng(seed)

    def conv(c_in, c_out, k):
        scale = np.float32(1.0) / np.sqrt(np.float32(c_in * k * k))
        return rng.standard_normal((k, k, c_in, c_out), dtype=np.float32) \
            * scale

    def gn(c):
        return {"scale": np.ones((c,), np.float32),
                "bias": np.zeros((c,), np.float32)}

    p = {"stem": conv(3, 16, 3), "stem_gn": gn(16), "blocks": []}
    for c, k, s in _resnet_plan(depth):
        blk = {"c1": conv(c, k, 3), "gn1": gn(k), "c2": conv(k, k, 3),
               "gn2": gn(k)}
        if s != 1 or c != k:
            blk["sc"] = conv(c, k, 1)
        p["blocks"].append(blk)
    p["fc"] = rng.standard_normal((64, n_classes), dtype=np.float32) \
        * np.float32(0.01)
    return p


def resnet_apply(p: Params, x: torch.Tensor,
                 pe_type: str = "fp32") -> torch.Tensor:
    qcfg = preset(pe_type)
    x = qconv(x, p["stem"], qcfg)
    x = F.relu(groupnorm(x, p["stem_gn"]["scale"], p["stem_gn"]["bias"]))
    for blk in p["blocks"]:
        # downsampling blocks are exactly those with a shortcut conv
        s = 2 if "sc" in blk else 1
        h = qconv(x, blk["c1"], qcfg, s)
        h = F.relu(groupnorm(h, blk["gn1"]["scale"], blk["gn1"]["bias"]))
        h = qconv(h, blk["c2"], qcfg)
        h = groupnorm(h, blk["gn2"]["scale"], blk["gn2"]["bias"])
        sc = qconv(x, blk["sc"], qcfg, s) if "sc" in blk else x
        x = F.relu(h + sc)
    x = torch.mean(x, dim=(1, 2))
    return x @ p["fc"]


# ---------------------------------------------------------------------------
# VGG-16 for CIFAR
# ---------------------------------------------------------------------------

VGG_CFG = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]


def vgg16_init(gen: torch.Generator, n_classes: int = 10,
               dtype=torch.float32, device=None) -> Params:
    device = resolve_device(device)
    p: Params = {"convs": [], "gns": []}
    c = 3
    for k, reps in VGG_CFG:
        for _ in range(reps):
            p["convs"].append(conv_init(gen, c, k, 3, dtype, device))
            p["gns"].append(_gn_init(k, dtype, device))
            c = k
    for name, shape in (("fc1", (512, 512)), ("fc2", (512, n_classes))):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * 0.02
        p[name] = w.to(device=device, dtype=dtype)
    return p


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, stride 2, ``"VALID"``, on NHWC."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2)
    return y.permute(0, 2, 3, 1)


def vgg16_apply(p: Params, x: torch.Tensor,
                pe_type: str = "fp32") -> torch.Tensor:
    qcfg = preset(pe_type)
    i = 0
    for _k, reps in VGG_CFG:
        for _ in range(reps):
            x = qconv(x, p["convs"][i], qcfg)
            x = F.relu(groupnorm(x, p["gns"][i]["scale"],
                                 p["gns"][i]["bias"]))
            i += 1
        x = _max_pool(x)
    x = torch.mean(x, dim=(1, 2))
    x = F.relu(x @ p["fc1"])
    return x @ p["fc2"]


def cnn_loss(apply_fn, params, batch, pe_type):
    """(mean cross entropy, top-1 accuracy) of ``apply_fn`` on a batch of
    NHWC images and int labels."""
    logits = apply_fn(params, batch["images"], pe_type).to(torch.float32)
    labels = batch["labels"].to(torch.int64)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    loss = torch.mean(logz - gold)
    acc = torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
    return loss, acc

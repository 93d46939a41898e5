"""Layer-wise DNN workloads (port of ``repro.core.workloads``).

A workload is a stack of conv (or GEMM-as-1x1-conv) layer specs with a
``count`` multiplicity, kept as parallel (L,) float32 tensors so the
dataflow cost model prices every layer of a network at once.  Each layer
also carries the reference's four operand-residency fields (``kind``,
``stream_words``, ``active_frac``, ``acc_class``); at their neutral
defaults the cost model is the paper's conv-only model.

Beyond the paper's CNNs, the transformer families extract per-layer
GEMMs from an ``ArchConfig`` (``transformer_workload``): decode-phase
attention streams the KV cache (``attn_kv`` rows), routed experts are
``moe_expert`` rows shaped by the active top-k compute.  Every row is
computed in Python float64 exactly as the reference computes it and
rounded once to float32 by ``_stack``, so every field equals the
reference's bit for bit.

``pad_workload`` / ``stack_workloads`` give models of different depths
one (M, L) layer stack: zero-count padding rows add exact 0.0 to every
fold, so a padded evaluation equals the unpadded one bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.device import host, resolve_device

Device = str | torch.device | None

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
           device: Device = None) -> Workload:
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
          device: Device = None) -> Workload:
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
                 device: Device = None) -> Workload:
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


def resnet34(batch: int = 1, device: Device = None) -> Workload:
    rows = [conv_valid(230, 230, 3, 64, 7, stride=2, batch=batch)]
    names = ["stem"]
    c, h = 64, 56
    for stage, (k, reps) in enumerate([(64, 3), (128, 4), (256, 6), (512, 3)]):
        for b in range(reps):
            s = 2 if (stage > 0 and b == 0) else 1
            rows.append(conv(h, h, c, k, 3, stride=s, batch=batch))
            h = h // s
            rows.append(conv(h, h, k, k, 3, batch=batch))
            names += [f"s{stage}b{b}c1", f"s{stage}b{b}c2"]
            if c != k:
                rows.append(conv(h * s, h * s, c, k, 1, stride=s, batch=batch))
                names.append(f"s{stage}b{b}sc")
            c = k
    rows.append(gemm(1, 512, 1000, batch=batch))
    names.append("fc")
    return _stack(rows, "resnet34-imagenet", names, device)


def resnet50(batch: int = 1, device: Device = None) -> Workload:
    rows = [conv_valid(230, 230, 3, 64, 7, stride=2, batch=batch)]
    names = ["stem"]
    c, h = 64, 56
    for stage, (k, reps) in enumerate([(64, 3), (128, 4), (256, 6), (512, 3)]):
        for b in range(reps):
            s = 2 if (stage > 0 and b == 0) else 1
            rows.append(conv(h, h, c, k, 1, batch=batch))          # reduce
            rows.append(conv(h, h, k, k, 3, stride=s, batch=batch))
            h = h // s
            rows.append(conv(h, h, k, 4 * k, 1, batch=batch))      # expand
            names += [f"s{stage}b{b}c1", f"s{stage}b{b}c2", f"s{stage}b{b}c3"]
            if c != 4 * k:
                rows.append(conv(h * s, h * s, c, 4 * k, 1, stride=s,
                                 batch=batch))
                names.append(f"s{stage}b{b}sc")
            c = 4 * k
    rows.append(gemm(1, 2048, 1000, batch=batch))
    names.append("fc")
    return _stack(rows, "resnet50-imagenet", names, device)


PAPER_WORKLOADS = {
    "vgg16-cifar10": lambda batch=1, device=None: vgg16(
        "cifar10", batch, device=device),
    "vgg16-cifar100": lambda batch=1, device=None: vgg16(
        "cifar100", batch, device=device),
    "vgg16-imagenet": lambda batch=1, device=None: vgg16(
        "imagenet", batch, device=device),
    "resnet20-cifar10": lambda batch=1, device=None: resnet_cifar(
        20, "cifar10", batch, device=device),
    "resnet20-cifar100": lambda batch=1, device=None: resnet_cifar(
        20, "cifar100", batch, device=device),
    "resnet56-cifar10": lambda batch=1, device=None: resnet_cifar(
        56, "cifar10", batch, device=device),
    "resnet56-cifar100": lambda batch=1, device=None: resnet_cifar(
        56, "cifar100", batch, device=device),
    "resnet34-imagenet": lambda batch=1, device=None: resnet34(
        batch, device=device),
    "resnet50-imagenet": lambda batch=1, device=None: resnet50(
        batch, device=device),
}


# ---------------------------------------------------------------------------
# Beyond the paper: transformer-family GEMM extraction
# ---------------------------------------------------------------------------

def touched_experts(experts: int, topk: int, routed_tokens: int) -> float:
    """Expected number of DISTINCT experts touched by ``routed_tokens``
    independent top-k routings over ``experts`` choices (uniform router):
    weight traffic follows touched experts, compute follows active
    (token, expert) pairs."""
    if experts <= 0 or topk <= 0 or routed_tokens <= 0:
        return 0.0
    frac = min(float(topk) / float(experts), 1.0)
    t = float(experts) * (1.0 - (1.0 - frac) ** float(routed_tokens))
    return float(np.clip(t, float(min(topk, experts)), float(experts)))


def transformer_workload(cfg, seq: int, batch: int, mode: str = "train",
                         name: str | None = None,
                         device: Device = None) -> Workload:
    """Per-layer GEMMs of an ArchConfig-like object (forward MACs only).

    ``mode``: 'train'/'prefill' use the full ``seq``; 'decode' is one token
    against a ``seq``-long KV cache, whose score/value GEMMs become
    ``attn_kv`` rows streaming ``seq * head_dim`` words per batch element.
    MoE configs honour ``first_dense`` / ``dense_d_ff`` (leading dense
    layers); routed experts are ``moe_expert`` rows shaped by the active
    top-k compute with ``active_frac`` = 1 / touched experts, and shared
    experts plain resident GEMMs.
    """
    d, L = cfg.d_model, cfg.n_layers
    hq, hkv = cfg.n_heads, cfg.kv_heads
    dh = getattr(cfg, "head_dim", d // max(hq, 1))
    decode = mode == "decode"
    tokens = 1 if decode else seq
    kvlen = seq
    rows, names = [], []

    def add(tag, M, Kd, N, count=1, **ir):
        rows.append(gemm(M, Kd, N, batch=batch, count=count, **ir))
        names.append(tag)

    attn_layers = getattr(cfg, "attn_layers", L if hq > 0 else 0)
    if attn_layers:
        add("wq", tokens, d, hq * dh, attn_layers, acc_class=ACC_ATTN)
        add("wk", tokens, d, hkv * dh, attn_layers, acc_class=ACC_ATTN)
        add("wv", tokens, d, hkv * dh, attn_layers, acc_class=ACC_ATTN)
        add("wo", tokens, hq * dh, d, attn_layers, acc_class=ACC_ATTN)
        # score/value GEMMs per head: decode streams the KV cache, prefill
        # computes K/V on the fly (resident-operand costing)
        kv_ir = dict(kind=KIND_ATTN_KV, stream_words=float(kvlen) * dh,
                     acc_class=ACC_ATTN) if decode \
            else dict(acc_class=ACC_ATTN)
        add("qk", tokens, dh, kvlen, attn_layers * hq, **kv_ir)
        add("av", tokens, kvlen, dh, attn_layers * hq, **kv_ir)
    if cfg.moe_experts:
        n_dense = min(int(getattr(cfg, "first_dense", 0) or 0), L)
        n_moe = L - n_dense
        dense_ff = int(getattr(cfg, "dense_d_ff", 0) or 0) or cfg.d_ff
    else:
        n_dense, n_moe, dense_ff = L, 0, cfg.d_ff
    if n_dense:
        add("ffn_in", tokens, d, dense_ff * 2, n_dense,
            acc_class=ACC_FFN)   # gate+up (SwiGLU)
        add("ffn_out", tokens, dense_ff, d, n_dense, acc_class=ACC_FFN)
    if n_moe:
        experts, topk = cfg.moe_experts, cfg.moe_topk
        shared = getattr(cfg, "moe_shared", 0)
        touched = touched_experts(experts, topk, tokens * batch)
        gated = dict(kind=KIND_MOE_EXPERT,
                     active_frac=1.0 / max(touched, 1.0),
                     acc_class=ACC_EXPERT)
        add("moe_in", tokens * topk, d, cfg.moe_d_ff * 2, n_moe, **gated)
        add("moe_out", tokens * topk, cfg.moe_d_ff, d, n_moe, **gated)
        if shared:  # always-active shared experts: dense resident weights
            add("moe_shared_in", tokens, d, cfg.moe_d_ff * 2,
                n_moe * shared, acc_class=ACC_EXPERT)
            add("moe_shared_out", tokens, cfg.moe_d_ff, d,
                n_moe * shared, acc_class=ACC_EXPERT)
        add("router", tokens, d, experts, n_moe, acc_class=ACC_FFN)
    add("lm_head", tokens, d, cfg.vocab, 1)
    return _stack(rows, name or f"{cfg.name}-{mode}", names, device)


class _TfmSpec(NamedTuple):
    """Minimal ArchConfig-like stand-in for ``transformer_workload``."""
    name: str
    d_model: int
    n_layers: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    moe_experts: int = 0


def transformer_gemm(seq: int = 512, d_model: int = 512, n_layers: int = 8,
                     n_heads: int = 8, d_ff: int = 2048, vocab: int = 32000,
                     batch: int = 1, mode: str = "prefill",
                     name: str | None = None,
                     device: Device = None) -> Workload:
    """Self-contained decoder-block GEMM workload, seq-length-scaled (the
    transformer member of the co-exploration model families)."""
    spec = _TfmSpec(name=name or f"tfm-d{d_model}-L{n_layers}",
                    d_model=d_model, n_layers=n_layers, n_heads=n_heads,
                    kv_heads=n_heads, d_ff=d_ff, vocab=vocab)
    return transformer_workload(
        spec, seq=seq, batch=batch, mode=mode,
        name=name or f"tfm-d{d_model}-L{n_layers}-s{seq}-{mode}",
        device=device)


# ---------------------------------------------------------------------------
# LLM serving families: decode-phase and MoE workloads from the configs
# ---------------------------------------------------------------------------

def _arch_config(arch):
    """An ``llm_*`` family's ``arch``: a CLI id / module name of the port's
    config registry, or an ArchConfig-like object passed through."""
    if isinstance(arch, str):
        from repro_torch.configs import get as _get
        return _get(arch)
    return arch


def llm_decode(arch="qwen3-32b", context: int = 4096, batch: int = 1,
               name: str | None = None, device: Device = None) -> Workload:
    """Decode-phase serving member: one generated token against a
    ``context``-long KV cache."""
    cfg = _arch_config(arch)
    return transformer_workload(
        cfg, seq=context, batch=batch, mode="decode",
        name=name or f"{cfg.name}-decode-c{context}-b{batch}", device=device)


def llm_moe(arch="deepseek-moe-16b", experts: int | None = None,
            topk: int | None = None, seq: int = 512, batch: int = 1,
            mode: str = "decode", name: str | None = None,
            device: Device = None) -> Workload:
    """MoE serving member: top-k-gated expert layers, the expert count and
    top-k optionally overridden."""
    cfg = _arch_config(arch)
    if experts is not None or topk is not None:
        cfg = cfg.replace(
            moe_experts=cfg.moe_experts if experts is None else int(experts),
            moe_topk=cfg.moe_topk if topk is None else int(topk))
    if cfg.moe_experts <= 0 or cfg.moe_topk <= 0:
        raise ValueError(f"llm_moe needs an MoE config (moe_experts/moe_topk"
                         f" > 0), got {cfg.name} with "
                         f"experts={cfg.moe_experts} topk={cfg.moe_topk}")
    tag = (f"{cfg.name}-moe-e{cfg.moe_experts}k{cfg.moe_topk}"
           f"-{mode}-s{seq}-b{batch}")
    return transformer_workload(cfg, seq=seq, batch=batch, mode=mode,
                                name=name or tag, device=device)


def acc_class_mix(wl: Workload) -> tuple:
    """MAC-weighted fraction of each ``ACC_CLASSES`` accuracy class (sums
    to 1; an all-default workload gives ``(1, 0, 0, 0)``)."""
    macs = host(wl.layers.macs()).astype(np.float64)
    cls = host(wl.layers.acc_class).astype(np.float64).astype(np.int64)
    mix = np.zeros(len(ACC_CLASSES), np.float64)
    np.add.at(mix, np.clip(cls, 0, len(ACC_CLASSES) - 1), macs)
    total = mix.sum()
    if total <= 0.0:
        return tuple(1.0 if i == ACC_DEFAULT else 0.0
                     for i in range(len(ACC_CLASSES)))
    return tuple(float(v) for v in mix / total)


# family name -> constructor; each constructor's keyword grid spans the
# model axis of the joint co-exploration space
MODEL_FAMILIES = {
    "resnet-cifar": resnet_cifar,
    "vgg16": vgg16,
    "transformer-gemm": transformer_gemm,
    "llm-decode": llm_decode,
    "llm-moe": llm_moe,
}


# ---------------------------------------------------------------------------
# Layer-count padding and bucketing: one (M, L) stack for a model axis
# ---------------------------------------------------------------------------

# Padding row: count=0 zeroes MACs and every traffic/energy term exactly
# (``reduce_layer_costs`` masks it to 0.0); H=R=S=1 keeps the per-layer
# arithmetic finite, and the IR fields stay neutral.
_PAD_ROW = dict(H=1.0, W=1.0, C=1.0, K=1.0, R=1.0, S=1.0,
                stride=1.0, batch=1.0, count=0.0, **_IR_DEFAULTS)


def workload_layers(wl: Workload) -> int:
    """Number of stacked layers (including any padding rows)."""
    return int(wl.layers.H.shape[0])


def pad_workload(wl: Workload, n_layers: int) -> Workload:
    """Pad a workload to ``n_layers`` with zero-cost (count=0) layers.

    Padding rows add exact 0.0 to every folded cost field and weight 0 to
    the MAC-weighted utilization, so a padded evaluation equals the
    unpadded one bit for bit.  Idempotent at the current depth; refuses to
    truncate.
    """
    n = workload_layers(wl)
    if n_layers < n:
        raise ValueError(f"cannot pad {wl.name} ({n} layers) down to "
                         f"{n_layers}")
    if n_layers == n:
        return wl
    pad = n_layers - n
    layers = LayerSpec(*[
        torch.cat([f, torch.full((pad,), _PAD_ROW[name], dtype=torch.float32,
                                 device=f.device)])
        for name, f in zip(LayerSpec._fields, wl.layers)])
    names = wl.layer_names + tuple(f"pad{i}" for i in range(pad))
    return Workload(name=wl.name, layers=layers, layer_names=names)


def layer_bucket(n_layers: int,
                 buckets: Sequence[int] | None = None) -> int:
    """Canonical padded depth for an ``n_layers``-deep model: the first of
    the ascending ``buckets`` that fits, else the next power of two,
    floored at 8."""
    if n_layers < 1:
        raise ValueError(f"n_layers must be >= 1, got {n_layers}")
    if buckets is not None:
        for b in sorted(buckets):
            if n_layers <= b:
                return int(b)
    return max(8, 1 << (n_layers - 1).bit_length())


class StackedWorkload(NamedTuple):
    """M workloads padded to one shared depth and stacked: fields (M, L).

    ``dse.evaluate_chunk(model_ids=...)`` gathers each lane's row, so a
    chunk mixes models freely.
    """
    names: tuple            # model names, in stack order
    layers: LayerSpec       # stacked+padded, fields (M, L)
    n_layers: tuple         # true (pre-padding) depth per model


def stack_workloads(workloads: Sequence[Workload],
                    pad_to: int | None = None,
                    buckets: Sequence[int] | None = None) -> StackedWorkload:
    """Stack workloads into (M, L) fields at one bucketed depth
    (``pad_to`` fixes it; default ``layer_bucket`` of the deepest)."""
    workloads = tuple(workloads)
    if not workloads:
        raise ValueError("need at least one workload to stack")
    counts = [workload_layers(w) for w in workloads]
    depth = layer_bucket(max(counts), buckets) if pad_to is None else pad_to
    padded = [pad_workload(w, depth) for w in workloads]
    layers = LayerSpec(*[
        torch.stack([getattr(p.layers, f) for p in padded])
        for f in LayerSpec._fields])
    return StackedWorkload(names=tuple(w.name for w in workloads),
                           layers=layers, n_layers=tuple(counts))


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

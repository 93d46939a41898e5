"""Zamba2-style hybrid, the ``hybrid`` family (port of
``repro.models.hybrid``): a Mamba2 backbone with shared attention blocks.

As in the reference: ``n_layers`` Mamba2 blocks in groups of
``shared_attn_every`` (Zamba2-7B: 13 groups of 6 and a tail of 3); after
each group one of ``n_shared_blocks`` shared transformer blocks (full
causal attention and a gated MLP) runs, picked round-robin by the
group's index (``gidx % n_shared_blocks``: the reference's tree-select
inside its scan, here an index, so no weights are copied).  The shared
attention is ``layers.attention`` over the group's own KV cache, which
ends on the ``flash_attention`` kernel on the card (Zamba2-7B: 32 / 32
heads of 112, float32 q as the reference's ``_attend`` computes, the
engine's float32 cache).

Under the tensor-parallel split (``keeps_model_shard``) each rank
computes its heads of every Mamba2 block (``mamba.mamba_apply``), its
heads of the shared attention (``layers.attention``: its KV cache the
rank's heads), its MLP columns and its vocabulary rows.

Params keep the reference's layout: ``groups`` stacked (n_groups, period,
...), ``tail`` (tail, ...), ``shared`` a list of block trees.  The
layers run as Python loops where JAX scans.  The cache: ``groups`` with
``mamba`` states (n_groups, period, ...) and ``kv`` (n_groups, B, max_len,
Hkv, Dh) written in place at one host ``index`` a group; ``tail``'s
states or None.

The serving packer packs by size: at full width it packs the stacked
group leaves ``ln``, ``mamba/conv_b`` and ``mamba/norm`` and the tail's
``conv_w``, on which the reference's group scan fails ("different
leading axis sizes"; ROADMAP C); the port raises ``NotImplementedError``
there, naming that failure.  Packed 3-D tail projections
(``tail/mamba/in_proj`` at the reduced size) are indexed a layer at a
time for ``quant_matmul``.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import torch

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import ModelSplit
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import params as P
from repro_torch.models.transformer import _positions
from repro_torch.quant.qconfig import preset

Params = Dict[str, Any]

_PACKED_GROUP = ("the reference's group scan over a packed stacked leaf "
                 "raises 'different leading axis sizes' (ROADMAP C)")


def check_supported(cfg):
    if cfg.family != "hybrid":
        raise NotImplementedError(f"{cfg.name}: the hybrid module does not "
                                  f"run the {cfg.family} family")


def _group_shape(cfg):
    period = cfg.shared_attn_every
    n_groups = cfg.n_layers // period
    tail = cfg.n_layers - n_groups * period
    return period, n_groups, tail


def _attn_spec(cfg) -> L.AttnSpec:
    return L.AttnSpec(n_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
                      head_dim=cfg.head_dim, causal=True,
                      rope_theta=cfg.rope_theta)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def param_shapes(cfg) -> dict:
    """{path: (shape, kind)} of the params tree (``models.params``'
    kinds), the reference's ``init_params`` shape for shape."""
    d, f, vp = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    period, n_groups, tail = _group_shape(cfg)
    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
    out = {"embed": ((vp, d), "embed")}
    for name, lead in (("groups", (n_groups, period)), ("tail", (tail,))):
        if name == "tail" and not tail:
            continue
        out.update({f"{name}/mamba/{k}": v
                    for k, v in M.param_shapes(cfg, lead).items()})
        out[f"{name}/ln"] = ((*lead, d), "ones")
    for i in range(cfg.n_shared_blocks):
        out.update({f"shared/{i}/attn/wq": ((d, hq), "dense"),
                    f"shared/{i}/attn/wk": ((d, hkv), "dense"),
                    f"shared/{i}/attn/wv": ((d, hkv), "dense"),
                    f"shared/{i}/attn/wo": ((hq, d), "dense"),
                    f"shared/{i}/mlp/w_up": ((d, f), "dense"),
                    f"shared/{i}/mlp/w_down": ((f, d), "dense"),
                    f"shared/{i}/mlp/w_gate": ((d, f), "dense"),
                    f"shared/{i}/ln1": ((d,), "ones"),
                    f"shared/{i}/ln2": ((d,), "ones")})
    out["final_norm"] = ((d,), "ones")
    out["lm_head"] = ((d, vp), "dense")
    return out


def numpy_params(cfg, seed: int = 0) -> Params:
    """Random params as numpy float32 arrays in the reference's layout
    (``models.params.numpy_params``)."""
    check_supported(cfg)
    return P.numpy_params(param_shapes(cfg), seed)


def init_params(cfg, gen: torch.Generator, device=None) -> Params:
    """Random params with the reference's shapes and scales, drawn from
    ``gen``."""
    check_supported(cfg)
    return P.torch_params(param_shapes(cfg), gen, device)


_SPLIT_LEAVES = re.compile(
    r"(attn/w[qkvo]|mlp/w_(up|gate|down)|(^|/)embed|(^|/)lm_head)$")
_MAMBA_SPLIT = re.compile(r"mamba/(in_proj|out_proj)$")


def keeps_model_shard(cfg, path: str, model: int = 0) -> bool:
    """Whether the mesh steps keep this param leaf's ``model`` shard (of a
    ``model`` axis of ``model`` ranks; 0: any) and compute on it: the
    embedding and the head, the shared blocks' attention and MLP
    products, and the Mamba blocks' ``in_proj`` / ``out_proj`` where the
    axis splits the blocks (``mamba.heads``).  The rest is gathered over
    ``model`` first: the conv, ``a_log``, ``dt_bias``, ``d_skip``, the
    gated norm's and the other norm scales, which every rank uses whole
    or at its heads (the rules split the conv and the norm evenly, across
    the heads' boundaries)."""
    if _SPLIT_LEAVES.search(path):
        return True
    return bool(_MAMBA_SPLIT.search(path)) and (
        model <= 1 or M.heads(cfg, ModelSplit(None, model, 0)).split)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _refuse_packed_groups(params):
    def walk(node, path):
        if isinstance(node, dict):
            if any(k.startswith("codes__") for k in node):
                raise NotImplementedError(f"packed {path!r}: {_PACKED_GROUP}")
            for k, v in node.items():
                walk(v, f"{path}/{k}")
    walk(params["groups"], "groups")


def _mamba_layer(p, x, cfg, qcfg, state=None, chunk=16):
    P.refuse_packed(p, ("ln",), M._PACKED)
    h = L.rmsnorm(x, p["ln"])
    out, new_state = M.mamba_apply(p["mamba"], h, cfg, qcfg, state, chunk)
    return x + out.to(x.dtype), new_state


def _shared_layer(p, x, cfg, qcfg, positions, q_start, cache=None):
    h = L.rmsnorm(x, p["ln1"])
    att, new_cache = L.attention(p["attn"], h, _attn_spec(cfg), qcfg,
                                 positions, cache, q_start=q_start)
    x = x + att.to(x.dtype)
    h = L.rmsnorm(x, p["ln2"])
    mlp = L.mlp(p["mlp"], h, qcfg, cfg.act,
                split=L.split_over(cfg.d_ff) is not None)
    return x + mlp.to(x.dtype), new_cache


def _backbone(params, x, cfg, positions, q_start, caches=None, chunk=16):
    """Embed-less forward over every layer; ``caches``: None, or
    ``init_cache``'s tree (the KV rows written in place).  Returns (y,
    caches)."""
    _refuse_packed_groups(params)
    qcfg = preset(cfg.pe_type)
    period, n_groups, tail = _group_shape(cfg)
    new_m, new_t = [], []

    def group(x, gp, shared):
        """A group without a cache: its Mamba layers and the shared
        block."""
        for j in range(period):
            x, _ = _mamba_layer(P.layer(gp, j), x, cfg, qcfg, None, chunk)
        return _shared_layer(shared, x, cfg, qcfg, positions, q_start)[0]

    for g in range(n_groups):
        gp = P.layer(params["groups"], g)
        shared = params["shared"][g % cfg.n_shared_blocks]
        if caches is None:
            # rematerialized without a cache, as the reference's group scan
            x = L.remat(group, x, gp, shared)
            continue
        for j in range(period):
            st = P.layer(P.layer(caches["groups"]["mamba"], g), j)
            x, st = _mamba_layer(P.layer(gp, j), x, cfg, qcfg, st, chunk)
            new_m.append(st)
        ckv = caches["groups"]["kv"]
        kv = {"k": ckv["k"][g], "v": ckv["v"][g], "index": ckv["index"][g]}
        x, kv = _shared_layer(shared, x, cfg, qcfg, positions, q_start, kv)
        caches["groups"]["kv"]["index"][g] = kv["index"]
    for j in range(tail):
        st = None if caches is None else P.layer(caches["tail"], j)
        x, st = _mamba_layer(P.layer(params["tail"], j), x, cfg, qcfg, st,
                             chunk)
        new_t.append(st)
    if caches is not None:
        caches["groups"]["mamba"] = {
            k: torch.stack([st[k] for st in new_m]).reshape(
                n_groups, period, *new_m[0][k].shape) for k in new_m[0]}
        if tail:
            caches["tail"] = {k: torch.stack([st[k] for st in new_t])
                              for k in new_t[0]}
    return x, caches


def _embed(params, tokens, cfg):
    return L.embed_rows(params["embed"], tokens, cfg.padded_vocab).to(
        getattr(torch, cfg.dtype))


def _logits(params, x, cfg):
    x = L.rmsnorm(x, params["final_norm"])
    return L.head_logits(x, params["lm_head"], preset(cfg.pe_type),
                         cfg.padded_vocab)


def forward(params, tokens, cfg, positions=None):
    """tokens: (B, S) -> logits (B, S, Vp).  ``positions`` (B, S) must be
    start + arange(S) a row (the kernel masks by index)."""
    check_supported(cfg)
    positions, q_start = _positions(tokens, positions, 0)
    x = _embed(params, tokens, cfg)
    x, _ = _backbone(params, x, cfg, positions, q_start)
    return _logits(params, x, cfg)


def loss_fn(params, batch, cfg):
    """batch: {'tokens': (B, S), 'labels': (B, S)} -> scalar CE loss.  On
    the card the shared blocks' attention gradient (head_dim 112 at full
    size) is the ``flash_attention`` backward kernel."""
    logits = forward(params, batch["tokens"], cfg)
    return L.softmax_xent(logits, batch["labels"],
                          split=L.split_over(cfg.padded_vocab) is not None)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """Mamba states of every group's blocks and the tail's (float32, as
    the reference's ``init_state`` makes them), and a KV cache in
    ``dtype`` a group with one host ``index`` a group."""
    check_supported(cfg)
    device = resolve_device(device)
    period, n_groups, tail = _group_shape(cfg)
    one = L.make_cache(batch, max_len, _attn_spec(cfg), dtype, device)
    kv = {"k": one["k"][None].repeat(n_groups, 1, 1, 1, 1),
          "v": one["v"][None].repeat(n_groups, 1, 1, 1, 1),
          "index": [0] * n_groups}
    return {"groups": {"mamba": M.init_state(cfg, batch, device=device,
                                             lead=(n_groups, period)),
                       "kv": kv},
            "tail": (M.init_state(cfg, batch, device=device, lead=(tail,))
                     if tail else None)}


def prefill(params, tokens, cfg, cache, positions=None):
    """Fill the caches with a prompt; returns (logits_last, cache)."""
    check_supported(cfg)
    positions, q_start = _positions(tokens, positions, 0)
    x = _embed(params, tokens, cfg)
    x, cache = _backbone(params, x, cfg, positions, q_start, cache)
    return _logits(params, x[:, -1:], cfg), cache


def decode_step(params, token, cfg, cache, positions=None):
    """token: (B, 1) -> (logits (B, 1, Vp), new cache); the position is
    the first group's cache index, as in the reference."""
    check_supported(cfg)
    positions, q_start = _positions(token, positions,
                                    cache["groups"]["kv"]["index"][0])
    x = _embed(params, token, cfg)
    x, cache = _backbone(params, x, cfg, positions, q_start, cache)
    return _logits(params, x, cfg), cache

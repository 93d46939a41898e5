"""Mamba2 block in its SSD form, the hybrid family's backbone (port of
``repro.models.mamba``).

A block: ``in_proj`` -> [z | x | B | C | dt], a causal depthwise conv of
width 4 over [x | B | C], a per-head scalar decay a_t = exp(-exp(A_log) *
softplus(dt + bias)), the SSD state update

    S_t = a_t S_{t-1} + dt_t * B_t ⊗ x_t        (state: (H, d_state, hd))
    y_t = C_t . S_t + D ⊙ x_t

through ``ssm_common`` (Mamba mode: r pre-scaled by a, u = 1), then a
gated RMSNorm and ``out_proj``.  A decode step updates the state once
and rolls the conv window.  Softplus is ``logaddexp(x, 0)`` written out
as JAX computes it (max(x, 0) + log1p(exp(-|x|))), not torch's
thresholded ``softplus``; the conv sums its taps in the reference's
order.  No kernel of its own: on the card its projections reach
``quant_matmul`` on packed codes and ``fake_quant`` under QAT numerics.
Under the tensor-parallel split each rank computes its heads
(``mamba_apply``'s docstring); a block whose heads the ``model`` group
does not divide stays whole on every rank.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (copy_to_model, current_split,
                                     gather_from_model, reduce_from_model)
from repro_torch.launch.sharding import ssm_heads
from repro_torch.models import layers as L
from repro_torch.models import params as P
from repro_torch.models import ssm_common as SSM

Params = Dict[str, Any]

CONV_W = 4
EXPAND = 2

_PACKED = ("the reference's mamba_apply reads it as a dense tensor "
           "(KeyError: 0 at a conv tap, or a product with a dict; "
           "ROADMAP C)")


def dims(cfg):
    """(d_in, headdim, heads, d_state): at Zamba2-7B's full width d_in
    7168 in 112 heads of 64, d_state 64."""
    d_in = EXPAND * cfg.d_model
    headdim = 64
    n_heads = d_in // headdim
    return d_in, headdim, n_heads, cfg.ssm_state


def param_shapes(cfg, lead=()) -> dict:
    """{name: (shape, kind)} of one block's params (``models.params``'
    kinds), stacked on the ``lead`` axes."""
    d = cfg.d_model
    d_in, hd, nh, ds = dims(cfg)
    conv_ch = d_in + 2 * ds
    lead = tuple(lead)
    return {
        "in_proj": ((*lead, d, 2 * d_in + 2 * ds + nh), "dense"),
        "conv_w": ((*lead, CONV_W, conv_ch), "conv"),
        "conv_b": ((*lead, conv_ch), "zeros"),
        "a_log": ((*lead, nh), np.log(np.linspace(1.0, 16.0, nh))),
        "dt_bias": ((*lead, nh), "zeros"),
        "d_skip": ((*lead, nh), "ones"),
        "norm": ((*lead, d_in), "ones"),
        "out_proj": ((*lead, d_in, d), "dense"),
    }


def _causal_conv(x, w, b, carry=None):
    """Depthwise causal conv.  x: (B, S, C); w: (W, C); carry: (B, W-1, C).
    The taps summed in the reference's order, then the bias, then SiLU."""
    pad = (torch.zeros((x.shape[0], CONV_W - 1, x.shape[-1]), dtype=x.dtype,
                       device=x.device) if carry is None else carry)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s] * w[i] for i in range(CONV_W)) + b
    new_carry = xp[:, -(CONV_W - 1):]
    return torch.nn.functional.silu(out), new_carry


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def heads(cfg, split):
    """The rank's ``sharding.SsmHeads`` of a block under ``split`` (a
    ``mesh.ModelSplit`` or None): its heads where the ``model`` group
    divides them and ``in_proj``'s columns, else the block whole."""
    d_in, hd, nh, ds = dims(cfg)
    return ssm_heads(nh, split, 2 * d_in + 2 * ds + nh)


def mamba_apply(p: Params, x, cfg, qcfg, state=None, chunk=16):
    """x: (B, S, D).  state: None or {"s": (B, H, ds, hd), "conv": (B,
    W-1, C)}.  Returns (out, new_state).

    Under the tensor-parallel split the rank computes its heads
    (``heads``): ``in_proj``'s stored columns (an even split, which
    crosses the z | x | B | C | dt boundaries) are multiplied and the
    product gathered over the group, of which the rank takes its heads'
    z / x / dt and all of B / C; the conv runs on its x channels and B /
    C, the scan on its heads; the gated norm's mean square spans the
    group; ``out_proj`` holds its heads' rows, the partial sums summed.
    The state's ``s`` holds the rank's heads; its conv window the
    channels ``cache_spec`` gives the rank (an even split), gathered a
    step and written back at the rank's channels."""
    P.refuse_packed(p, ("conv_w", "conv_b", "a_log", "dt_bias", "d_skip",
                        "norm"), _PACKED)
    b, s, d = x.shape
    d_in, hd, nh, ds = dims(cfg)
    conv_ch = d_in + 2 * ds
    f32 = torch.float32
    own = heads(cfg, current_split())
    h, lo = own.n, own.lo
    cols = slice(lo * hd, (lo + h) * hd)        # the rank's x / z channels
    whole = "tokens" if current_split() and not own.split else None
    if state is not None and state["s"].shape[-3] != h:
        raise ValueError(f"a state of {state['s'].shape[-3]} heads for a "
                         f"rank that computes {h}")

    if own.split:
        x = copy_to_model(x)
        p = {**p, **L.replicated_leaves(p, ("conv_w", "conv_b", "a_log",
                                            "dt_bias", "d_skip", "norm"))}
        zxbcdt = gather_from_model(L.qdense(x, p["in_proj"], qcfg,
                                            split="col"), into_split=True)
    else:
        zxbcdt = L.qdense(x, p["in_proj"], qcfg, split=whole)
    z, xc, bc, cc, dt = torch.split(zxbcdt, [d_in, d_in, ds, ds, nh], dim=-1)
    conv_w, conv_b = p["conv_w"], p["conv_b"]
    if own.split:
        z, xc, dt = z[..., cols], xc[..., cols], dt[..., lo:lo + h]
        conv_w = torch.cat([conv_w[..., cols], conv_w[..., d_in:]], dim=-1)
        conv_b = torch.cat([conv_b[..., cols], conv_b[..., d_in:]], dim=-1)

    conv_in = torch.cat([xc, bc, cc], dim=-1)
    window = None if state is None else state["conv"]
    if window is not None and window.shape[-1] != conv_ch:
        window = gather_from_model(window)      # the cache's even slice
    carry = window
    if window is not None and own.split:
        carry = torch.cat([window[..., cols], window[..., d_in:]], dim=-1)
    conv_out, new_conv = _causal_conv(conv_in, conv_w, conv_b, carry)
    if state is not None and (own.split or window is not state["conv"]):
        # the whole window from the whole input, at the cache's channels
        width = state["conv"].shape[-1]
        at = current_split().rank * width if width != conv_ch else 0
        new_conv = torch.cat([window, zxbcdt[..., d_in:d_in + conv_ch]],
                             dim=1)[:, -(CONV_W - 1):, at:at + width]
    xc, bc, cc = torch.split(conv_out, [h * hd, ds, ds], dim=-1)

    dt = softplus(dt.to(f32) + p["dt_bias"][lo:lo + h])       # (B, S, H)
    a = torch.exp(p["a_log"][lo:lo + h].to(f32))              # (H,)
    log_decay = -a[None, None, :] * dt                        # (B, S, H)

    v = xc.reshape(b, s, h, hd)
    # B/C shared across heads (one group); dt folded into k
    k = bc[:, :, None, :].expand(b, s, h, ds) * dt[..., None].to(bc.dtype)
    r = cc[:, :, None, :].expand(b, s, h, ds)
    # Mamba mode: the decay applies before use -> r pre-scaled by a_t, u = 1
    r = r * torch.exp(log_decay)[..., None].to(r.dtype)
    lw = log_decay[..., None].expand(b, s, h, ds)

    s_in = None if state is None else state["s"]
    if s == 1 and state is not None:
        o, s_out = SSM.single_step(r[:, 0], k[:, 0], v[:, 0], lw[:, 0],
                                   None, s_in)
        o = o[:, None]
    else:
        o, s_out = SSM.chunked_linear_attention(r, k, v, lw, None,
                                                chunk=chunk,
                                                initial_state=s_in)
    o = o + v * p["d_skip"][lo:lo + h][None, None, :, None]
    o = o.reshape(b, s, h * hd)
    o = L.rmsnorm(o * torch.nn.functional.silu(z), p["norm"][cols],
                  split=own.split)
    out = L.qdense(o.to(x.dtype), p["out_proj"], qcfg,
                   split="row" if own.split else whole)
    if own.split:
        out = reduce_from_model(out)
    new_state = None
    if state is not None:
        new_state = {"s": s_out, "conv": new_conv}
    return out, new_state


def init_state(cfg, batch: int, dtype=torch.float32, device=None,
               lead=()):
    """A block's serving state (stacked on the ``lead`` axes): ``s`` (B,
    H, ds, hd) float32 and the conv window ``conv`` (B, W-1, C) in
    ``dtype``."""
    device = resolve_device(device)
    d_in, hd, nh, ds = dims(cfg)
    lead = tuple(lead)
    return {"s": torch.zeros((*lead, batch, nh, ds, hd), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((*lead, batch, CONV_W - 1, d_in + 2 * ds),
                                dtype=dtype, device=device)}

"""Mixture-of-Experts layer: top-k routing with sort-based dispatch (port
of ``repro.models.moe``).

As in the reference:

  1. router logits (float32, outside ``qdense``: never fake-quantized)
     -> softmax -> top-k experts a token (renormalized);
  2. the (token, slot) assignments stable-sorted by expert id;
  3. each assignment's position in its expert from the run starts --
     assignments at or past the capacity C are dropped (the e-th bucket);
  4. the (E, C, d) buffer, every expert's FFN on its whole buffer, and the
     gather-combine.

C = max(8, ceil(T * topk * capacity_factor / E)) for T tokens.  Under the
launcher's mesh context with more than one dp rank, T is the global
batch's tokens and an assignment's place in its expert is its place in
the global batch, token-major, as the reference's pjit step computes it
on the whole batch: the ranks all-gather their per-expert counts over the
dp group, and a rank's assignments start after those of the ranks before
it (``_earlier_counts``).  DeepSeekMoE's
always-on shared experts are one MLP of width moe_shared * moe_d_ff, added
to the routed output.

The reference's numerics, held by ``tests/test_torch_moe.py``:
  * under a quantizing PE type every expert's weights and activations are
    fake-quantized on their own, as the reference's vmap over
    ``_expert_ffn`` does (``quant.fake_quant_experts`` and
    ``fake_quant_expert_acts``: one ``fake_quant`` launch a projection for
    up to 64 experts, one for their activations);
  * the combine adds a token's k contributions, each rounded to x's type,
    to zeros of x's type in increasing expert id (the order in which XLA's
    scatter-add meets them in the stable-sorted list), one add at a time:
    no atomics, so two calls give the same bits;
  * ``out + shared`` promotes as JAX does (bfloat16 + float32 -> float32).

``moe_apply_ep`` (perf variant ``moe_ep_shard_map``) is the reference's
expert parallelism over the launcher's mesh: each rank of a ``model``
group dispatches its slice of the sequence, holds E / n_tp experts, and
exchanges token payloads with two ``all_to_all_single`` calls over the
group (int8 codes and their per-row scales, in the payload's type,
under ``moe_ep_int8_payload``); with no mesh, or a sequence the group does not
divide (decode), it is ``moe_apply``, as the reference falls back.  The
reference cannot apply a router packed by ``serve.quantize_params``
(ROADMAP C), and the port raises for one too.

``RouterLog`` records each call's routing (expert ids and the margin of
the k-th probability over the (k+1)-th) for ``serve.check``, which holds
the port's routing to the reference's up to near ties; ``RoutePins``
gives ``moe_apply`` the reference's experts at those near ties, so that
a run can be held to the reference past them.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import (axis_sizes, coordinate, current_dp,
                                     current_mesh, dp_index, in_context,
                                     saved_context)
from repro_torch.models import layers as L
from repro_torch.quant.fake_quant import (fake_quant_expert_acts,
                                          fake_quant_experts)
from repro_torch.quant.qconfig import QuantConfig

Params = Dict[str, Any]

PACKED_ROUTER = (
    "the MoE router is packed: the reference's moe_apply calls "
    "p['router'].astype(...) on the packed dict that "
    "serve.quantize_params makes of it and fails with AttributeError: "
    "'dict' object has no attribute 'astype' (src/repro/models/moe.py:73; "
    "ROADMAP C), so the port has no packed MoE path either; serve the "
    "dense weights or dequantize_params of the packed ones")


def moe_init(gen: torch.Generator, cfg, dtype=torch.float32,
             device=None) -> Params:
    """The router, E stacked gated expert MLPs and the shared experts, at
    the reference's scales, drawn from ``gen``."""
    e, d, f = cfg.moe_experts, cfg.d_model, cfg.moe_d_ff
    router = L.dense_init(gen, d, e, dtype, device)
    experts = [L.mlp_init(gen, d, f, True, dtype, device) for _ in range(e)]
    p: Params = {"router": router,
                 "experts": {k: torch.stack([x[k] for x in experts])
                             for k in experts[0]}}
    if cfg.moe_shared:
        p["shared"] = L.mlp_init(gen, d, cfg.moe_shared * f, True, dtype,
                                 device)
    return p


def capacity(tokens: int, cfg) -> int:
    return max(8, int(math.ceil(tokens * cfg.moe_topk * cfg.capacity_factor
                                / cfg.moe_experts)))


def kept(ids, c: int) -> np.ndarray:
    """(B, S, k) bool: which of one call's assignments (expert ids (B, S,
    k)) hold one of their expert's first ``c`` places in token order, as
    ``moe_apply`` places them."""
    ids = np.asarray(ids)
    flat = ids.reshape(-1)
    pos = np.zeros(flat.size, np.int64)
    for e in np.unique(flat):
        at = np.flatnonzero(flat == e)
        pos[at] = np.arange(at.size)
    return (pos < c).reshape(ids.shape)


def dropped(ids, cfg) -> int:
    """The assignments past capacity among one call's expert ids."""
    ids = np.asarray(ids)
    return int((~kept(ids, capacity(ids.shape[0] * ids.shape[1], cfg))).sum())


class RouterLog:
    """Within ``with RouterLog() as log:`` every ``moe_apply`` appends its
    routing: ids (B, S, k) in increasing expert id and margin (B, S), the
    k-th largest router probability less the (k+1)-th.  The tensors stay
    where they were made until ``drain`` takes them to the host."""

    active = None

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self._outer, RouterLog.active = RouterLog.active, self
        return self

    def __exit__(self, *exc):
        RouterLog.active = self._outer

    def drain(self) -> list:
        """The calls since the last drain, as numpy (ids, margin) pairs."""
        calls, self.calls = self.calls, []
        return [(ids.cpu().numpy(), margin.cpu().numpy())
                for ids, margin in calls]


class RoutePins:
    """Within ``with RoutePins(tol) as pins:`` each ``moe_apply`` takes the
    next of the calls given to ``load``: a reference's routing, expert ids
    (B, S, k) in increasing id and margins (B, S).  At a token whose own
    experts differ from the reference's where the reference's margin is
    below ``tol`` (a router near tie) it takes the reference's experts,
    weighted by its own probabilities of them, renormalized; elsewhere it
    keeps its own.  ``pinned`` counts the tokens so taken, ``masks`` holds
    each call's (B, S) numpy mask of them."""

    active = None

    def __init__(self, tol: float):
        self.tol = tol
        self.queue = []
        self.pinned = 0
        self.masks = []

    def __enter__(self):
        self._outer, RoutePins.active = RoutePins.active, self
        return self

    def __exit__(self, *exc):
        RoutePins.active = self._outer

    def load(self, calls):
        """The reference's routing of the next ``moe_apply`` calls, as
        (ids, margin) pairs of arrays."""
        self.queue = list(calls)

    def pin(self, vals, ids, top_ids, top_w, shape, cols=None):
        """(top_ids, top_w) with the next call's near ties pinned; ``vals``,
        ``ids``: the router's sorted probabilities and their ids (T, E).
        ``cols``: the slice of the reference call's sequence that this
        call routes (an EP rank's), default all of it."""
        if not self.queue:
            raise RuntimeError("RoutePins: an MoE call past the routing "
                               "loaded for this step")
        ref_ids, ref_margin = self.queue.pop(0)
        if cols is not None:
            ref_ids = np.asarray(ref_ids)[:, cols]
            ref_margin = np.asarray(ref_margin)[:, cols]
        t, k = top_ids.shape
        if tuple(np.shape(ref_ids)) != (*shape, k):
            raise ValueError(f"RoutePins: reference routing of shape "
                             f"{np.shape(ref_ids)} for a call of "
                             f"{(*shape, k)}")
        dev = top_ids.device
        ref_ids = torch.as_tensor(np.array(ref_ids, np.int64),
                                  device=dev).reshape(t, k)
        near = torch.as_tensor(np.asarray(ref_margin) < self.tol,
                               device=dev).reshape(t)
        pin = (top_ids != ref_ids).any(-1) & near
        probs = torch.empty_like(vals).scatter_(-1, ids, vals)
        w = torch.gather(probs, -1, ref_ids)
        w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
        mask = pin.cpu().numpy()
        self.pinned += int(mask.sum())
        self.masks.append(mask.reshape(shape))
        return (torch.where(pin[:, None], ref_ids, top_ids),
                torch.where(pin[:, None], w, top_w))


def _route(xf: torch.Tensor, router: torch.Tensor):
    """The router's probabilities in descending order and their expert
    ids, both (T, E): lax.top_k's order, the lower id first among equal
    ones."""
    logits = xf.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    return torch.sort(probs, dim=-1, descending=True, stable=True)


def _expert_dense(x: torch.Tensor, w, qcfg: QuantConfig) -> torch.Tensor:
    """x (E, C, K) @ w (E, K, N) per expert, ``qdense``'s numerics on each
    expert alone; the product promotes as JAX does, or takes the
    ``compute_dtype`` context's type."""
    if isinstance(w, dict):
        raise NotImplementedError("the port takes dense expert weights: "
                                  "serve.quantize_params leaves the 4-D "
                                  "expert stacks dense")
    if not qcfg.is_identity:
        w = fake_quant_experts(w, qcfg)
        x = fake_quant_expert_acts(x, qcfg)
    dt = L.current_compute_dtype() or torch.promote_types(x.dtype, w.dtype)
    return torch.bmm(x.to(dt), w.to(dt))


def _experts_ffn(ps: Params, x: torch.Tensor, qcfg: QuantConfig,
                 act: str) -> torch.Tensor:
    """``layers.mlp`` of every expert on its (C, d) buffer: x (E, C, d)."""
    up = _expert_dense(x, ps["w_up"], qcfg)
    if "w_gate" in ps:
        h = L._act(_expert_dense(x, ps["w_gate"], qcfg), act) * up
    else:
        h = L._act(up, act)
    return _expert_dense(h, ps["w_down"], qcfg)


def _topk(xf: torch.Tensor, router, k: int, shape, cols=None):
    """Each token's k experts in increasing id and their renormalized
    weights (T, k), with ``RoutePins``' near ties pinned; also the
    router's sorted probabilities (T, E)."""
    vals, ids = _route(xf, router)
    top_w, top_ids = vals[:, :k], ids[:, :k]
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    # each token's slots in increasing expert id: the order in which the
    # reference's scatter-add meets them; no position in an expert moves
    # (a token holds an expert once, so the stable sort of the dispatch
    # orders an expert's assignments by token alone)
    top_ids, slot = torch.sort(top_ids, dim=-1)
    top_w = torch.gather(top_w, -1, slot)
    if RoutePins.active is not None:
        top_ids, top_w = RoutePins.active.pin(vals, ids, top_ids, top_w,
                                              shape, cols)
    return top_ids, top_w, vals


def _dispatch(top_ids: torch.Tensor, e: int, c: int, dp=None):
    """(dest_e, dest_p, keep) of every (token, slot) assignment in
    token-major order: its expert (e, the drop bucket, past capacity) and
    its place there, by the stable sort on expert id.  ``dp`` ((mesh,
    axes) of more than one dp rank): an assignment is kept when its
    place in the global batch, after the earlier ranks' assignments to
    its expert, is below ``c``; its place in this rank's buffer is its
    place among the rank's own."""
    flat_e = top_ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    ids = torch.arange(e, device=se.device, dtype=se.dtype)
    starts = torch.searchsorted(se, ids)
    pos = torch.empty_like(se)
    pos[order] = torch.arange(se.numel(), device=se.device) - starts[se]
    keep = pos < c
    if dp is not None:
        counts = torch.searchsorted(se, ids, right=True) - starts
        keep = pos + _earlier_counts(counts, *dp)[flat_e] < c
    return torch.where(keep, flat_e, e), torch.where(keep, pos, 0), keep


def _earlier_counts(counts: torch.Tensor, mesh, axes) -> torch.Tensor:
    """(E,) the assignments to each expert on the dp ranks before this
    one (row-major over ``axes``, the pod axis major): ``counts`` gathered
    over each axis's group, the minor axis first."""
    rows = counts[None]
    for a in reversed(axes):
        parts = [torch.empty_like(rows) for _ in range(axis_sizes(mesh)[a])]
        dist.all_gather(parts, rows.contiguous(), group=mesh.get_group(a))
        rows = torch.cat(parts)                  # (ranks so far, E)
    return rows[:dp_index(mesh)].sum(0)


def _combine(ybuf, dest_e, dest_p, keep, top_w, t, k, dtype):
    """A token's k contributions, each rounded to ``dtype``, added to
    zeros of ``dtype`` one at a time in increasing expert id."""
    e = ybuf.shape[0]
    gathered = ybuf[torch.clamp_max(dest_e, e - 1), dest_p]   # (T*k, d)
    contrib = gathered * (top_w.reshape(-1) * keep.to(top_w.dtype))[:, None]
    contrib = contrib.to(dtype).reshape(t, k, -1)
    out = torch.zeros((t, contrib.shape[-1]), dtype=dtype,
                      device=ybuf.device)
    for j in range(k):
        out = out + contrib[:, j]
    return out


def moe_apply(p: Params, x: torch.Tensor, cfg,
              qcfg: QuantConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d) (float32 with shared experts, as the
    reference promotes ``out + shared``; else x's type)."""
    if isinstance(p["router"], dict):
        raise NotImplementedError(PACKED_ROUTER)
    b, s, d = x.shape
    t = b * s
    e, k = cfg.moe_experts, cfg.moe_topk
    mesh, _ = current_mesh()
    axes = current_dp()
    n_dp = math.prod(axis_sizes(mesh)[a] for a in axes) if mesh else 1
    dp = (mesh, axes) if n_dp > 1 else None
    c = capacity(t * (n_dp if dp else 1), cfg)
    xf = x.reshape(t, d)
    dev = x.device

    # --- routing and sort-based dispatch --------------------------------------
    top_ids, top_w, vals = _topk(xf, p["router"], k, (b, s))
    dest_e, dest_p, keep = _dispatch(top_ids, e, c, dp)
    log = RouterLog.active
    if log is not None:
        margin = (vals[:, k - 1] - vals[:, k] if k < e
                  else torch.full((t,), torch.inf, device=dev))
        log.calls.append((top_ids.reshape(b, s, k), margin.reshape(b, s)))

    buf = torch.zeros((e + 1, c, d), dtype=x.dtype, device=dev)
    buf[dest_e, dest_p] = xf.repeat_interleave(k, dim=0)  # bucket e: unused

    # --- every expert's FFN on its whole buffer ------------------------------
    ybuf = _experts_ffn(p["experts"], buf[:e], qcfg, cfg.act)  # (E, C, d)

    # --- combine: a token's contributions one at a time, in expert order -----
    out = _combine(ybuf, dest_e, dest_p, keep, top_w, t, k, x.dtype)

    # --- shared experts (DeepSeekMoE) ----------------------------------------
    if "shared" in p:
        out = out + L.mlp(p["shared"], xf, qcfg, cfg.act)
    return out.reshape(b, s, d)


# ---------------------------------------------------------------------------
# expert parallelism over the launcher's mesh (perf variant moe_ep_shard_map)
# ---------------------------------------------------------------------------

def _int8_payload(x: torch.Tensor):
    """The reference's int8 wire payload of x (..., d), in x's type:
    codes clip(round(x / scale), -127, 127) with scale = max(absmax over
    d, 1e-8) / 127, one scale a row."""
    absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = torch.div(torch.clamp_min(absmax, 1e-8),
                      torch.tensor(127.0, dtype=x.dtype, device=x.device))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    if PayloadPins.active is not None:
        q = PayloadPins.active.pin(x / scale, q)
    return q, scale


class PayloadPins:
    """Within ``with PayloadPins(codes, tol) as pins:`` each int8 payload
    that ``moe_apply_ep`` sends (in call order) takes a reference's codes
    where its own differ by one step at a rounding tie (its x / scale
    within ``tol`` of a half-integer: the last float bit of x, summed in
    another order, decides such a code); ``pinned`` counts them, ``away``
    the codes that differ anywhere else (a fault)."""

    active = None

    def __init__(self, codes, tol: float):
        self.codes = list(codes)
        self.tol = tol
        self.pinned = 0
        self.away = 0

    def __enter__(self):
        self._outer, PayloadPins.active = PayloadPins.active, self
        return self

    def __exit__(self, *exc):
        PayloadPins.active = self._outer

    def pin(self, ratio: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        if not self.codes:
            raise RuntimeError("PayloadPins: a payload past those loaded")
        ref = torch.as_tensor(np.asarray(self.codes.pop(0)),
                              device=q.device).to(q.dtype)
        if ref.shape != q.shape:
            raise ValueError(f"PayloadPins: a reference payload of "
                             f"{tuple(ref.shape)} for {tuple(q.shape)}")
        differ = ref != q
        mag = torch.abs(ratio.to(torch.float64))
        tie = ((torch.abs(mag - torch.floor(mag) - 0.5) < self.tol)
               & (torch.abs(ref.to(torch.int32) - q.to(torch.int32)) == 1))
        self.pinned += int((differ & tie).sum())
        self.away += int((differ & ~tie).sum())
        return torch.where(differ & tie, ref, q)


class _AllToAll(torch.autograd.Function):
    """Block i of dim 0 to rank i of ``group``; block j of the result
    from rank j (``lax.all_to_all(x, axis, 0, 0, tiled=False)``).  Its
    gradient is the same exchange of the output's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


class _GatherSeq(torch.autograd.Function):
    """Every rank's (B, S / n, d) slice of ``group``, in rank order, as
    one (B, S, d) tensor on every rank.  What follows it is the same on
    every rank of the group (one loss), so the gradient of a rank's slice
    is its own part of the output's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        i = dist.get_group_rank(ctx.group, dist.get_rank())
        return g.chunk(n, dim=1)[i].contiguous(), None


class _Whole(torch.autograd.Function):
    """The identity on a tensor that every rank of ``group`` holds whole
    but uses in part (its slice of the tokens, its experts): its gradient
    is the sum of the ranks' parts, so that every rank holds the whole
    gradient, as on one device."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _payload_all_to_all(x: torch.Tensor, group, int8: bool) -> torch.Tensor:
    if not int8:
        return _AllToAll.apply(x, group)
    # int8 codes, and their per-row scales in a second exchange of x's type
    q, scale = _int8_payload(x)
    q = _AllToAll.apply(q, group)
    scale = _AllToAll.apply(scale, group)
    return q.to(x.dtype) * scale


def moe_apply_ep(p: Params, x: torch.Tensor, cfg,
                 qcfg: QuantConfig) -> torch.Tensor:
    """x: (B, S, d), this rank's batch, the same on every rank of its
    ``model`` group; returns the same shape, on every rank of the group.
    ``moe_apply`` with no launcher mesh (``mesh.activation_sharding``)
    or where the group does not divide S.  Its gradient: a rank's part
    of the gradient of x, the router, its experts and the shared experts
    is summed over the group, so every rank holds the whole gradient."""
    mesh, tp = current_mesh()
    if mesh is None or x.shape[1] % axis_sizes(mesh)[tp] != 0:
        return moe_apply(p, x, cfg, qcfg)      # CPU tests / decode: fall back
    if isinstance(p["router"], dict):
        raise NotImplementedError(PACKED_ROUTER)
    group = mesh.get_group(tp)
    n_tp, i = axis_sizes(mesh)[tp], coordinate(mesh)[tp]
    e, k = cfg.moe_experts, cfg.moe_topk
    if e % n_tp:
        raise ValueError(f"{e} experts do not split over {n_tp} ranks")
    e_loc = e // n_tp
    b, s, d = x.shape
    sl = s // n_tp
    cols = slice(i * sl, (i + 1) * sl)
    whole = lambda w: _Whole.apply(w, group)  # noqa: E731
    xb = whole(x)[:, cols]                 # this rank's slice of the tokens
    t = b * sl
    c = capacity(t, cfg)
    xf = xb.reshape(t, d)

    top_ids, top_w, _ = _topk(xf, whole(p["router"]), k, (b, sl), cols)
    dest_e, dest_p, keep = _dispatch(top_ids, e, c)
    send = torch.zeros((e + 1, c, d), dtype=x.dtype, device=x.device)
    send = send.index_put((dest_e, dest_p), xf.repeat_interleave(k, dim=0))
    # dispatch: (n_tp, E_loc, C, d) to the peers; dim 0 of what arrives is
    # the source rank
    int8 = cfg.moe_ep_int8_payload
    recv = _payload_all_to_all(send[:e].reshape(n_tp, e_loc, c, d), group,
                               int8)
    tokens_in = recv.transpose(0, 1).reshape(e_loc, n_tp * c, d)
    experts = {name: whole(w)[i * e_loc:(i + 1) * e_loc]
               for name, w in p["experts"].items()}
    # the reference's experts run inside its shard_map: their activation
    # scales span the rank's own buffers, not the dp ranks
    with in_context((None, saved_context()[1])):
        ybuf = _experts_ffn(experts, tokens_in, qcfg, cfg.act)
    back = _payload_all_to_all(
        ybuf.reshape(e_loc, n_tp, c, d).transpose(0, 1), group, int8)
    out = _combine(back.reshape(e, c, d), dest_e, dest_p, keep, top_w, t, k,
                   x.dtype)
    if "shared" in p:
        shared = {name: whole(w) if torch.is_tensor(w) else w
                  for name, w in p["shared"].items()}
        out = out + L.mlp(shared, xf, qcfg, cfg.act).to(x.dtype)
    out = out.reshape(b, sl, d)
    # every rank's slice of the sequence back to every rank of the group
    return _GatherSeq.apply(out, group)


def router_aux_loss(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style): E * sum_e f_e * P_e."""
    if isinstance(p["router"], dict):
        raise NotImplementedError(PACKED_ROUTER)
    xf = x.reshape(-1, x.shape[-1])
    logits = xf.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    frac = torch.mean(torch.nn.functional.one_hot(
        top1, cfg.moe_experts).to(torch.float32), dim=0)
    prob_mean = torch.mean(probs, dim=0)
    return cfg.moe_experts * torch.sum(frac * prob_mean)


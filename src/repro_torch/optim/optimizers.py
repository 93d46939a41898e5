"""Optimizers (port of ``repro.optim.optimizers``: optax-style
init/update pairs on parameter trees of nested dicts and lists).

* sgd_nesterov -- the paper's training recipe (Sec. IV-B): SGD with
  Nesterov momentum 0.9 and weight decay 5e-4.
* adamw -- for the LM training driver.

``update(grads, state, params) -> (params, state)``.  The reference's
jitted step donates its state, so the port updates in place: the param,
``mu`` and ``nu`` tensors are overwritten (under ``torch.no_grad``) and
the same trees are returned.  The formulas and their order are the
reference's; weight decay applies to every leaf.  The state is
``{"mu", "nu", "step"}`` laid out as the reference's (``step`` a 0-d
int32 tensor), so checkpoints cross between the packages.  The learning
rate is a schedule of the step (``schedule.py``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (params, state), in place


def tree_leaves(tree) -> list:
    """The tensors of a tree of dicts and lists, in the reference's order
    (``jax.tree.leaves``: dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(template, leaves):
    """The tree of ``template``'s structure with ``leaves`` (in
    ``tree_leaves`` order) in place of its own."""
    it = iter(leaves)

    def build(tree):
        if isinstance(tree, dict):
            out = {k: build(tree[k]) for k in sorted(tree)}
            return {k: out[k] for k in tree}       # the template's key order
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(v) for v in tree)
        return next(it)

    return build(template)


def _zeros_like(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=p.dtype, device=p.device)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def sgd_nesterov(lr_fn: Callable, momentum: float = 0.9,
                 weight_decay: float = 5e-4) -> Optimizer:
    def init(params):
        return {"mu": tree_map(_zeros_like, params), "step": _step0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr = lr_fn(step)
        for g, m, p in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                           tree_leaves(params)):
            g = g + weight_decay * p
            m.mul_(momentum).add_(g)                 # m = momentum m + g
            d = momentum * m + g                     # nesterov lookahead
            p.sub_(lr * d)
        return params, {"mu": state["mu"], "step": step}

    return Optimizer(init, update)


def adamw(lr_fn: Callable, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return {"mu": tree_map(_zeros_like, params),
                "nu": tree_map(_zeros_like, params),
                "step": _step0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr = lr_fn(step)
        s = step.to(torch.float32)
        one = torch.ones((), dtype=torch.float32, device=s.device)
        c1 = one - torch.pow(torch.full_like(one, b1), s)
        c2 = one - torch.pow(torch.full_like(one, b2), s)
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                              tree_leaves(state["nu"]), tree_leaves(params)):
            g32 = g.to(torch.float32)
            m.mul_(b1).add_((1 - b1) * g32)
            v.mul_(b2).add_((1 - b2) * torch.square(g32))
            d = (m / c1) / (torch.sqrt(v / c2) + eps)
            p.sub_((lr * (d + weight_decay * p)).to(p.dtype))
        return params, {"mu": state["mu"], "nu": state["nu"], "step": step}

    return Optimizer(init, update)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, summed leaf
    by leaf in the reference's leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(grads)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before clipping).  The grads are scaled in place."""
    leaves = tree_leaves(grads)
    gnorm = global_norm(grads)
    cap = torch.tensor(max_norm, dtype=torch.float32, device=gnorm.device)
    scale = torch.clamp(torch.div(cap, torch.clamp(gnorm, min=1e-9)),
                        max=1.0)
    for g in leaves:
        g.copy_(g * scale)
    return grads, gnorm

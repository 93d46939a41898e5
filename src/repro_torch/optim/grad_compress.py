"""Quantization-aware gradient compression (port of
``repro.optim.grad_compress``).

Gradients are quantized to int8 (a per-tensor symmetric scale shared by
the data-parallel ranks) before the data-parallel all-reduce, with
error feedback: the quantization residual re-enters the next step's
gradient (Karimireddy et al., "EF-SGD").  The reference runs it inside
``shard_map`` with ``pmax`` / ``psum``; here they are collectives over
the mesh's dp process groups:

  * the shared scale: an ``all_reduce(MAX)`` of the float32 absmax;
  * the int8 codes go out as an int32 ``all_reduce(SUM)``;
  * ``mean = total * (scale / n)``, ``new_err = g32 - q * scale``, in
    the reference's order of operations.

Every scalar division goes through a tensor: CUDA divides by a Python
scalar as a multiply by its reciprocal.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import all_reduce, axis_sizes
from repro_torch.optim.optimizers import tree_map


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    return torch.div(x, torch.tensor(d, dtype=x.dtype, device=x.device))


def quantize(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 codes ``clip(round(g / scale), -127, 127)`` (round half to
    even, as ``jnp.round``)."""
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def shared_scale(absmax: torch.Tensor) -> torch.Tensor:
    return _div(torch.clamp_min(absmax, 1e-12), 127.0)


def compressed_psum_mean(g: torch.Tensor, err: torch.Tensor, mesh, axes,
                         n_shards: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-reduce-mean ``g`` (plus the error-feedback buffer ``err``)
    over the mesh ``axes``.  Returns (mean in g's dtype, new_err in
    float32).  The wire payload is int8 codes, summed in int32."""
    g32 = g.to(torch.float32) + err
    absmax = torch.max(torch.abs(g32))
    # agree on a shared scale: the max over the ranks (one float32 value)
    all_reduce(absmax, mesh, axes, dist.ReduceOp.MAX)
    scale = shared_scale(absmax)
    q = quantize(g32, scale)
    dequant_local = q.to(torch.float32) * scale
    new_err = g32 - dequant_local                      # error feedback
    total = all_reduce(q.to(torch.int32), mesh, axes)
    mean = total.to(torch.float32) * _div(scale, float(n_shards))
    return mean.to(g.dtype), new_err


def make_compressed_allreduce(mesh, dp_axes=("data",)):
    """f(grads, errs) -> (mean_grads, new_errs) over the trees of this
    rank's gradients and error buffers (float32, zeros at the start)."""
    sizes = axis_sizes(mesh)
    n = 1
    for a in dp_axes:
        n *= sizes[a]

    def f(grads, errs):
        out = tree_map(lambda g, e: compressed_psum_mean(g, e, mesh,
                                                         dp_axes, n),
                       grads, errs)
        is_pair = lambda t: isinstance(t, tuple) and len(t) == 2 \
            and torch.is_tensor(t[0])  # noqa: E731
        return _split(out, 0, is_pair), _split(out, 1, is_pair)

    return f


def _split(tree, i, is_pair):
    if is_pair(tree):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _split(v, i, is_pair) for k, v in tree.items()}
    return type(tree)(_split(v, i, is_pair) for v in tree)

"""Random parameter trees from a table of shapes, for the model modules
that describe their params as ``{path: (shape, kind)}`` (``rwkv``,
``hybrid``).

Kinds: "dense" N(0, 1/d_in) with d_in = shape[-2]; "lora_b" the same
times 0.1 (RWKV's decay LoRA output); "embed" N(0, 0.02^2); "conv"
N(0, 0.2^2) (Mamba2's conv taps); "ones"; "zeros"; or a numpy array, a
constant that every stacked layer holds (broadcast over the leading
axes).  Paths join keys with "/"; a key made of digits is an index of a
list (the hybrid's ``shared`` blocks).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device

_SCALES = {"embed": 0.02, "conv": 0.2}


def _scale(shape, kind) -> float:
    if kind == "dense":
        return 1.0 / math.sqrt(shape[-2])
    if kind == "lora_b":
        return 0.1 / math.sqrt(shape[-2])
    return _SCALES[kind]


def nest(flat: dict):
    """{"a/b/0/c": leaf} -> nested dicts, with lists where keys are
    digits."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *head, last = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def numpy_params(shapes: dict, seed: int = 0):
    """The params of ``shapes`` as numpy float32 arrays, drawn in table
    order from ``np.random.default_rng(seed)``: both packages load them
    (``convert.params_from_numpy`` here, ``jnp.asarray`` there), so they
    serve the very same weights."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path, (shape, kind) in shapes.items():
        if isinstance(kind, np.ndarray):
            flat[path] = np.broadcast_to(kind.astype(np.float32),
                                         shape).copy()
        elif kind in ("ones", "zeros"):
            flat[path] = (np.ones if kind == "ones" else np.zeros)(
                shape, np.float32)
        else:
            scale = np.float32(_scale(shape, kind))
            flat[path] = rng.standard_normal(shape, dtype=np.float32) * scale
    return nest(flat)


def torch_params(shapes: dict, gen: torch.Generator, device=None):
    """The params of ``shapes`` drawn from ``gen`` on its device (the
    card draws a 7 B model in a second), moved to ``device``."""
    device = resolve_device(device)
    flat = {}
    for path, (shape, kind) in shapes.items():
        if isinstance(kind, np.ndarray):
            flat[path] = torch.as_tensor(
                np.broadcast_to(kind.astype(np.float32), shape).copy(),
                device=device)
        elif kind in ("ones", "zeros"):
            flat[path] = (torch.ones if kind == "ones" else torch.zeros)(
                shape, dtype=torch.float32, device=device)
        else:
            flat[path] = (torch.randn(shape, generator=gen,
                                      dtype=torch.float32, device=gen.device)
                          * _scale(shape, kind)).to(device)
    return nest(flat)


def layer(tree, i: int):
    """Layer i of a stacked params (or state) tree: every leaf indexed on
    its leading axis, packed leaves too."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def count(shapes: dict) -> int:
    """Parameters of a table, from its shapes alone (nothing allocated)."""
    return sum(math.prod(shape) for shape, _ in shapes.values())


def refuse_packed(p: dict, names, what: str):
    """Raise ``NotImplementedError`` naming ``what`` (the reference's
    failure) when a leaf ``p[name]`` of ``names`` is a packed-code dict:
    the serving packer packs it by its size, and the model reads it as a
    dense tensor, as the reference's does."""
    for name in names:
        if isinstance(p.get(name), dict):
            raise NotImplementedError(f"packed {name!r}: {what}")

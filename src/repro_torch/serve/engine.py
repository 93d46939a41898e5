"""Serving engine: batched prefill + decode with KV caches, on weights
packed into the code format of the QADAM PE type the DSE chose (port of
``repro.serve.engine``).

``quantize_params`` packs every large 2-D weight and every stacked 3-D
weight into low-bit codes; the model's ``qdense`` then sends each packed
projection through the ``quant_matmul`` kernel, so the card reads the
codes and never a dense copy of the weights.

``ServeEngine`` holds fixed-size batch slots (continuous batching:
finished requests free their slot, queued prompts claim it).  Its slot,
admission, prefill/decode and cache-index behaviour is the reference's,
including that the cache index is never reset between requests (ROADMAP
C).  Telemetry (``repro.obs``) is not ported yet: the engine takes no
``telemetry=``.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional

import numpy as np
import torch

from repro_torch.models.layers import packed_mode
from repro_torch.quant.pack import DEQUANTIZE, QUANTIZE


# ---------------------------------------------------------------------------
# packed-weight serving path
# ---------------------------------------------------------------------------

PACK_MODES = {"lightpe1": "pow2", "lightpe2": "int8", "int8": "int8",
              "int4": "int4"}


def _map_with_path(fn, tree, path: str = ""):
    """Map ``fn(path, leaf)`` over a params tree; paths are joined with
    "/" like the reference's ``tree_map_with_path`` keys."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, f"{path}/{i}" if path
                                         else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def quantize_params(params, pe_type: str, min_size: int = 1 << 14):
    """Pack every large 2-D (or stacked 3-D) weight into low-bit codes.

    Returns a tree where packed leaves become dicts
    {"codes__<mode>": codes, "scale": scale} and small leaves pass through.
    """
    mode = PACK_MODES[pe_type]
    ckey = f"codes__{mode}"

    def f(pstr, leaf):
        if "embed" in pstr:      # gathers need the dense table
            return leaf
        if "layers/" in pstr and leaf.ndim == 2:
            return leaf          # stacked (L, d) norm scales, not weights
        if leaf.ndim in (2, 3) and leaf.numel() >= min_size:
            codes, scale = QUANTIZE[mode](leaf)   # 3-D: each layer its own
            return {ckey: codes, "scale": scale}
        return leaf

    return _map_with_path(f, params)


pack_mode_of = packed_mode   # (mode, key) of a packed leaf


def is_packed(x):
    return isinstance(x, dict) and pack_mode_of(x)[0] is not None


def dequantize_params(qparams):
    """Inverse of quantize_params (the dense view of the packed weights)."""
    if is_packed(qparams):
        mode, ckey = pack_mode_of(qparams)
        return DEQUANTIZE[mode](qparams[ckey], qparams["scale"])
    if isinstance(qparams, dict):
        return {k: dequantize_params(v) for k, v in qparams.items()}
    if isinstance(qparams, (list, tuple)):
        return type(qparams)(dequantize_params(v) for v in qparams)
    return qparams


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif torch.is_tensor(tree):
        yield tree


def packed_bytes(qparams) -> int:
    """Device bytes of the packed representation (roofline accounting),
    from each tensor's shape and type: nothing is copied to the host."""
    return sum(t.numel() * t.element_size() for t in _tensors(qparams))


# ---------------------------------------------------------------------------
# request slots / continuous batching
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    prompt: np.ndarray
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Fixed-slot continuous batching around a model's prefill/decode.

    The KV cache lives on the device of ``params`` (the embedding), in
    float32 as the reference's engine asks for.
    """

    def __init__(self, cfg, mod, params, batch_slots: int = 8,
                 max_len: int = 256):
        self.cfg = cfg
        self.mod = mod
        self.params = params
        self.batch = batch_slots
        self.max_len = max_len
        self.device = params["embed"].device
        self.cache = mod.init_cache(cfg, batch_slots, max_len, torch.float32,
                                    device=self.device)
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.queue: Deque[Request] = deque()
        self._decode = lambda p, t, c: mod.decode_step(p, t, cfg, c)
        self._prefill = lambda p, t, c: mod.prefill(p, t, cfg, c)

    def submit(self, prompt: np.ndarray, max_new: int = 16) -> Request:
        req = Request(prompt=np.asarray(prompt), max_new=max_new)
        self.queue.append(req)
        return req

    def _admit(self):
        for i in range(self.batch):
            if self.slots[i] is None and self.queue:
                self.slots[i] = self.queue.popleft()

    def step(self):
        """One engine iteration: admit, prefill new, decode one token."""
        self._admit()
        active = [r for r in self.slots if r is not None]
        if not active:
            return False
        # simple synchronous batch: prompts left-padded to the same length
        plen = max(len(r.prompt) for r in active)
        toks = np.zeros((self.batch, plen), np.int64)
        for i, r in enumerate(self.slots):
            if r is not None:
                toks[i, -len(r.prompt):] = r.prompt
        if all(not r.out for r in active):           # first step: prefill
            logits, self.cache = self._prefill(
                self.params, torch.as_tensor(toks, device=self.device),
                self.cache)
        else:
            last = np.zeros((self.batch, 1), np.int64)
            for i, r in enumerate(self.slots):
                if r is not None and r.out:
                    last[i, 0] = r.out[-1]
            logits, self.cache = self._decode(
                self.params, torch.as_tensor(last, device=self.device),
                self.cache)
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            r.out.append(int(nxt[i]))
            if len(r.out) >= r.max_new:
                r.done = True
                self.slots[i] = None               # free the slot
        return True

    def run(self, max_iters: int = 1000):
        it = 0
        while (self.queue or any(self.slots)) and it < max_iters:
            self.step()
            it += 1
        return it

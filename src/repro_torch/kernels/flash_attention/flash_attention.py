"""Flash attention forward: the wrapper of the CUDA kernels in
``repro_torch/csrc/flash_attention.cu`` (which replace the Pallas kernel
``repro.kernels.flash_attention.flash_attention``).

Three entry points, one launch a call:

  flash_attention(q, k, v)        one head, (S, D) -- the Pallas signature;
  flash_attention_bh(q, k, v)     (B, H, S, D), as ops.py's vmapped form;
  flash_attention_gqa(q, k, v, q_start, round_p=...)
                                  the model's layout (B, S, H, D) with
                                  grouped KV heads, a query start position
                                  per batch row (prompt: 0; decode: the
                                  cache index), the model's type rules and
                                  its sliding window and logit soft-cap.

A CUDA tensor launches a kernel, or raises: there is no fallback.  A CPU
tensor takes the plain torch version in ``ref.py``, which the kernels are
held to on the card.  ``flash_attention.launches`` counts the kernels'
launches through any of the three.

The gradient: on CUDA tensors that need one (autograd on),
``flash_attention_gqa`` is a ``torch.autograd.Function`` whose forward is
the kernel above, unchanged, and whose backward is the CUDA kernel pair
of ``csrc/flash_attention_bwd.cu`` (``attention_backward``; one entry,
two kernels on the bf16 tensor cores: rows, then keys; counted once a
backward in ``flash_attention.backward_launches``; ``emulate_attention_bwd``
in ``ref.py`` writes out their arithmetic and tiles).  It takes q, k,
v of one type (float32 or bfloat16), head_dim 64 or 128, no window and
no soft-cap, and raises otherwise.  On CPU tensors autograd runs through the plain version.  A call without
gradients (serving) launches the forward only, as before.

``plan`` is the launch plan, computed here so that the CPU tests can hold
it to the shapes.  A block serves rows (query i, head g of one KV head's
group of G), numbered r = i * G + g, so each K/V row it reads serves all
G heads.  Variant "split" (CUDA cores, any types): 4 or 8 rows a block,
the visible keys split across the blocks of a thread-block cluster (at
most 8) and merged in rank order -- decode (at most 8 rows a KV head).
Variant "mma" (bf16 tensor cores): more rows (prefill), 64 rows a block,
keys in chunks of 64, split across a cluster while every block has an SM
of its own (one fits an SM: ``benchmarks/torch_fa_sweep.py``); float32 q
and K as three bf16 parts each, so only up to head_dim 64
(float32 q at 112 and 128 takes the split kernel), and bfloat16 q up to
128 (112 included: 7 k-steps of 16, 14 column tiles of 8)
(head_dim 256 takes the split kernel: a 64-row block's accumulators and
chunk buffers would not fit registers and shared memory).

With a sliding window a row tile's keys start at the first key its first
row sees: the cluster divides [kv_begin, kv_end) and never visits a key
below every row's window; the soft-cap is c * tanhf(s / c) in IEEE
float32 on the scaled logits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (check_mask,
                                                     ref_attention_gqa,
                                                     ref_attention_gqa_bwd,
                                                     ref_flash_attention)

_HEAD_DIMS = (16, 32, 64, 112, 128, 256)
BWD_HEAD_DIMS = (64, 128)    # the backward kernel's instances
_TYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {"split": 0, "mma": 1}
_Strides = ctypes.c_longlong * 3

THREADS = 128                # threads of a block, both variants
SPLIT_MAX_ROWS = 8           # rows a split block holds (buckets 4 and 8)
MMA_ROWS = 64                # rows of an mma block: 4 warps x 16
MMA_KEYS = 64                # keys of an mma chunk
MMA_F32_MAX_D = 64           # float32 q's three bf16 parts fit registers
MMA_MAX_D = 128              # bfloat16 q: acc and chunks fit the block
SPLIT_BLOCKS = 264           # split keys until about 2 blocks an SM
SMS = 132                    # streaming multiprocessors of an H100 SXM
MAX_SPLITS = 8               # a portable cluster size


class Plan(NamedTuple):
    """One launch of ``csrc/flash_attention.cu``.

    variant "split": rows = rows a block (4 or 8), splits = the cluster's
    blocks along the key axis, chunk = keys a block holds in registers at
    once, grid = (splits, row tiles, B * Hkv).  variant "mma": rows = 64,
    splits = the cluster's blocks along the key axis (whole chunks each),
    chunk = 64 keys, grid = (row tiles * splits, Hkv, B)."""
    variant: str
    rows: int
    splits: int
    chunk: int
    grid: tuple

    @property
    def tiles(self) -> int:
        """Row tiles of the launch (each a cluster of ``splits`` blocks)."""
        return self.grid[1] if self.variant == "split" else \
            self.grid[0] // self.splits


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def lane_columns(d: int) -> int:
    """Columns a lane of the split kernel holds: 4, or D / 32 past 128,
    so that a key's lanes stay within one warp."""
    return 4 if d <= 128 else d // 32


def key_lanes(d: int) -> int:
    """Lanes of the split kernel that share a key: D / ``lane_columns``
    rounded up to a power of two (at head_dim 112, 32 lanes of which 28
    hold columns), so that a key's lanes meet in one warp's shuffles."""
    lanes = d // lane_columns(d)
    return 1 << (lanes - 1).bit_length()


@functools.lru_cache(maxsize=4096)
def plan(b: int, sq: int, skv: int, hq: int, hkv: int, d: int,
         q_bf16: bool, window: int = 0) -> Plan:
    """The launch plan for q (b, sq, hq, d) against k, v (b, skv, hkv, d).

    The key axis is split by the keys a row tile can see at most (skv,
    or with a window the window and the tile's queries); each cluster
    then divides the keys its rows really see (from q_start, on the
    card) evenly among its blocks."""
    rows = (hq // hkv) * sq
    if rows > SPLIT_MAX_ROWS and d <= MMA_MAX_D and (q_bf16
                                                     or d <= MMA_F32_MAX_D):
        tiles = _ceil(rows, MMA_ROWS)
        keys = min(skv, window + MMA_ROWS + MMA_KEYS) if window else skv
        splits = max(1, min(MAX_SPLITS, _ceil(keys, MMA_KEYS),
                            SMS // (tiles * b * hkv)))
        return Plan("mma", MMA_ROWS, splits, MMA_KEYS,
                    (tiles * splits, hkv, b))
    rb = 4 if rows <= 4 else 8
    lanes = key_lanes(d)                 # lanes of a key
    chunk = (THREADS // lanes) * (16 // rb)
    tiles = _ceil(rows, rb)
    blocks = tiles * b * hkv
    keys = min(skv, window + rb) if window else skv
    splits = max(1, min(MAX_SPLITS, _ceil(keys, chunk),
                        _ceil(SPLIT_BLOCKS, blocks)))
    return Plan("split", rb, splits, chunk, (splits, tiles, b * hkv))


def block_rows(p: Plan, tile: int, g: int, sq: int):
    """The (query, head-in-group) pairs of row tile ``tile``, by the
    kernels' formula r = i * G + g."""
    total = g * sq
    return [(r // g, r % g)
            for r in range(tile * p.rows, min(total, (tile + 1) * p.rows))]


def block_keys(p: Plan, tile: int, rank: int, g: int, sq: int, skv: int,
               start: int, causal: bool, window: int = 0) -> range:
    """The keys that block ``rank`` of row tile ``tile``'s cluster visits:
    [kv_begin, kv_end) cut into ``splits`` equal spans (of whole 64-key
    chunks for the mma kernel), where kv_end is past the last key the
    tile's last query can see and kv_begin the first key its first query
    sees (0 without a window) (the kernels' formulas)."""
    last = min(g * sq, (tile + 1) * p.rows) - 1
    kv_end = min(skv, start + last // g + 1) if causal else skv
    kv_begin = 0
    if window:
        first = tile * p.rows // g
        kv_begin = min(kv_end, max(0, start + first - window + 1))
    if p.variant == "mma":      # whole chunks of 64 keys a block
        c0, c1 = kv_begin // p.chunk, _ceil(kv_end, p.chunk)
        span = _ceil(c1 - c0, p.splits)
        lo = min(c1, c0 + rank * span)
        return range(lo * p.chunk, min(kv_end, (lo + span) * p.chunk))
    span = _ceil(kv_end - kv_begin, p.splits)
    lo = min(kv_end, kv_begin + rank * span)
    return range(lo, min(kv_end, lo + span))


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 8
                   + [ctypes.POINTER(ctypes.c_longlong)] * 4
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_float] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, q_start):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash attention needs 4-D q, k, v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if k.shape[1] < 1 or k.shape[2] < 1 or hq % k.shape[2]:
        raise ValueError(f"flash attention needs Skv >= 1 and Hq a multiple "
                         f"of Hkv, got {tuple(k.shape)} for Hq={hq}")
    if q_start is not None and (tuple(q_start.shape) != (b,)
                                or q_start.device != q.device):
        raise ValueError(f"flash attention needs q_start of shape ({b},) on "
                         f"{q.device}, got {tuple(q_start.shape)} on "
                         f"{q_start.device}")


def _one_type(q, k, v):
    """The Pallas signature widens q, k and v alike: it takes one type."""
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"flash_attention takes q, k, v of one type, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")


def _vec_ok(t: torch.Tensor) -> bool:
    """Rows can be read with vector loads and 16-byte copies: the base
    and the (batch, sequence, head) strides on a 16-byte boundary."""
    return (t.data_ptr() % 16 == 0
            and all(s * t.element_size() % 16 == 0 for s in t.stride()[:3]))


def _launch(q, k, v, q_start, causal: bool, scale: float, round_p: bool,
            window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """A kernel on (B, S, H, D) views; returns (B, Sq, Hq, D) float32."""
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    if q.dtype not in _TYPES or k.dtype not in _TYPES or v.dtype != k.dtype:
        raise ValueError(f"flash attention takes float32 or bfloat16 q and "
                         f"k, v of one type, float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.stride(3) != 1:
            raise ValueError(f"flash attention needs {name} on {q.device} "
                             f"with a contiguous last axis")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash attention takes head_dim in {_HEAD_DIMS}, "
                         f"got {d}")
    check_mask(causal, window, softcap)
    if max(b * hkv, sq * hq, skv, window) >= 2 ** 31:
        raise ValueError("flash attention: a dimension exceeds int32")
    if q_start is None:
        q_start = torch.zeros(b, dtype=torch.int32, device=q.device)
    elif q_start.dtype != torch.int32 or not q_start.is_contiguous():
        raise ValueError(f"flash attention needs a contiguous int32 q_start, "
                         f"got {q_start.dtype}")
    out = torch.empty((b, sq, hq, d), dtype=torch.float32, device=q.device)
    p = plan(b, sq, skv, hq, hkv, d, q.dtype == torch.bfloat16, window)
    if max(p.grid[1], p.grid[2]) > 65535:
        raise ValueError(f"flash attention: grid {p.grid} exceeds the "
                         f"card's 65535 blocks in y or z")
    strides = [_Strides(*t.stride()[:3]) for t in (q, k, v, out)]
    launch = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    q_start.data_ptr(), _TYPES[q.dtype], _TYPES[k.dtype],
                    b, sq, skv, hq, hkv, d, *strides, scale or d ** -0.5,
                    int(causal), int(round_p), int(window), float(softcap),
                    _VARIANTS[p.variant], p.rows, p.splits,
                    int(_vec_ok(k) and _vec_ok(v)), stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error "
                           f"{rc}")
    flash_attention.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                   + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_bwd(q, k, v, window: int = 0, softcap: float = 0.0):
    """What the backward kernel takes: q, k, v of one type, float32 or
    bfloat16, head_dim 64 or 128, and neither a window nor a soft-cap
    (its kernels compute neither)."""
    if window or softcap:
        raise NotImplementedError(
            f"the flash attention backward takes no sliding window or "
            f"soft-cap, got window={window}, softcap={softcap}")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _TYPES:
        raise ValueError(f"the flash attention backward takes q, k, v of one "
                         f"type, float32 or bfloat16, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if q.shape[3] not in BWD_HEAD_DIMS:
        raise ValueError(f"the flash attention backward takes head_dim in "
                         f"{BWD_HEAD_DIMS}, got {q.shape[3]}")


def _launch_bwd(q, k, v, q_start, dout, causal: bool, scale: float,
                round_p: bool):
    """The backward kernels on contiguous copies; returns (dq, dk, dv) in
    the inputs' type."""
    _check_bwd(q, k, v)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if b > 65535 or max(b * sq * hq * d, b * skv * hkv * d) >= 2 ** 31:
        raise ValueError("flash attention backward: a dimension exceeds the "
                         "kernel's grid or int32 indices")
    if dout.shape != q.shape or dout.device != q.device:
        raise ValueError(f"flash attention backward: dout {tuple(dout.shape)} "
                         f"on {dout.device} does not match q {tuple(q.shape)}")
    if q_start is None:
        q_start = torch.zeros(b, dtype=torch.int32, device=q.device)
    elif q_start.dtype != torch.int32:
        raise ValueError(f"flash attention needs an int32 q_start, got "
                         f"{q_start.dtype}")
    q, k, v, q_start = (t.contiguous() for t in (q, k, v, q_start))
    dout = dout.to(torch.float32).contiguous()
    # the kernels copy rows 16 bytes at a time: a view off that boundary
    # is copied
    q, k, v, dout = (t if t.data_ptr() % 16 == 0 else t.clone()
                     for t in (q, k, v, dout))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    stats = torch.empty(3 * b * sq * hq, dtype=torch.float32, device=q.device)
    launch = _bwd_entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                    q_start.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), stats.data_ptr(),
                    int(q.dtype == torch.bfloat16), b, sq, skv, hq, hkv, d,
                    scale or d ** -0.5, int(causal), int(round_p), stream)
    if rc != 0:
        raise RuntimeError(f"flash attention backward launch failed: CUDA "
                           f"error {rc}")
    flash_attention.backward_launches += 1
    return dq, dk, dv


def attention_backward(q, k, v, q_start, dout, *, causal: bool = True,
                       scale: float = 0.0, round_p: bool = False,
                       window: int = 0, softcap: float = 0.0):
    """(dq, dk, dv) of ``flash_attention_gqa(q, k, v, q_start, ...)``
    against the float32 output gradient ``dout``, each in its input's
    type: the backward kernel for CUDA tensors, the plain version's
    autograd for CPU tensors.  Raises for a window or a soft-cap on
    either device: the kernel computes neither."""
    _check(q, k, v, q_start)
    if window or softcap:
        _check_bwd(q, k, v, window, softcap)
    if q.device.type == "cpu":
        start = (torch.zeros(q.shape[0], dtype=torch.int32)
                 if q_start is None else q_start)
        return ref_attention_gqa_bwd(q, k, v, start, dout, causal, scale,
                                     round_p)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    return _launch_bwd(q, k, v, q_start, dout, causal, scale, round_p)


class _Attention(torch.autograd.Function):
    """The kernel's forward, and the backward kernel for its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_start, causal, scale, round_p, window,
                softcap):
        _check_bwd(q, k, v, window, softcap)
        ctx.save_for_backward(q, k, v, q_start)
        ctx.opts = (causal, scale, round_p)   # no window, no soft-cap
        return _launch(q, k, v, q_start, causal, scale, round_p)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_start = ctx.saved_tensors
        causal, scale, round_p = ctx.opts
        dq, dk, dv = _launch_bwd(q, k, v, q_start, dout, causal, scale,
                                 round_p)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_start: torch.Tensor | None = None, *,
                        causal: bool = True, scale: float = 0.0,
                        round_p: bool = False, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D) float32.

    Query head h reads KV head h // (Hq / Hkv).  With ``causal``, query i
    of batch row b sits at position p = q_start[b] + i (q_start: (B,)
    int32, non-negative; None = 0) and sees keys 0 .. p, or with
    ``window`` > 0 (causal only) keys p - window + 1 .. p.  ``scale`` 0
    means 1/sqrt(D).  The logits are q . (K rounded to q's type) in
    float32, scaled, then with ``softcap`` > 0 soft-capped to c * tanh(s
    / c); ``round_p`` rounds the probabilities to V's type before P V, as
    the reference model does (a no-op for float32 V).

    Differentiable: on CUDA tensors that need a gradient the backward is
    the backward kernel (``attention_backward``; no window or soft-cap),
    on CPU tensors autograd of the plain version.
    """
    _check(q, k, v, q_start)
    if q.device.type == "cpu":
        start = (torch.zeros(q.shape[0], dtype=torch.int32)
                 if q_start is None else q_start)
        return ref_attention_gqa(q, k, v, start, causal, scale, round_p,
                                 window, softcap)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Attention.apply(q, k, v, q_start, causal, scale, round_p,
                                window, softcap)
    return _launch(q, k, v, q_start, causal, scale, round_p, window,
                   softcap)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float = 0.0) -> torch.Tensor:
    """q: (Sq, D); k, v: (Skv, D) -> (Sq, D) float32.  One head; any Sq and
    Skv (the kernel masks the ragged tile itself); float32 P, as the
    Pallas kernel keeps it."""
    if q.ndim != 2 or k.ndim != 2 or v.ndim != 2:
        raise ValueError("flash_attention takes (S, D) q, k, v")
    _one_type(q, k, v)
    if q.device.type == "cpu":
        _check(q[None, :, None], k[None, :, None], v[None, :, None], None)
        return ref_flash_attention(q, k, v, causal, scale)
    out = flash_attention_gqa(q[None, :, None], k[None, :, None],
                              v[None, :, None], causal=causal, scale=scale)
    return out[0, :, 0]


flash_attention.launches = 0
flash_attention.backward_launches = 0


def flash_attention_bh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True,
                       scale: float = 0.0) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, H, Skv, D) -> (B, H, Sq, D) float32.

    Unlike the reference's ops.py, nothing is padded: keys past Skv do not
    exist for any query, causal or not.  Float32 P, as the Pallas kernel."""
    _one_type(q, k, v)
    out = flash_attention_gqa(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal, scale=scale)
    return out.transpose(1, 2)

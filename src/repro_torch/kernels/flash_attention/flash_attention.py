"""Flash attention forward: the wrapper of the CUDA kernels in
``repro_torch/csrc/flash_attention_fwd.cuh`` (built by
``csrc/flash_attention.cu`` without a window or a soft-cap, by
``csrc/flash_attention_masked.cu`` with them, and for an fp8 K/V cache
by ``csrc/flash_attention_fp8.cu``) and ``csrc/flash_attention_wgmma.cu``,
which replace the Pallas kernel
``repro.kernels.flash_attention.flash_attention``.

q is float32 or bfloat16; K and V share a type, float32, bfloat16 or
``float8_e4m3fn`` (the reference's fp8 cache: the kernels convert the
e4m3 codes in registers, exactly, and sum P V in float32; with
``round_p`` the normalized P is rounded to e4m3 as the reference rounds
it).  The backward takes float32 or bfloat16 only.

Three entry points, one launch a call:

  flash_attention(q, k, v)        one head, (S, D) -- the Pallas signature;
  flash_attention_bh(q, k, v)     (B, H, S, D), as ops.py's vmapped form;
  flash_attention_gqa(q, k, v, q_start, round_p=...)
                                  the model's layout (B, S, H, D) with
                                  grouped KV heads, a query start position
                                  per batch row (prompt: 0; decode: the
                                  cache index), the model's type rules and
                                  its sliding window and logit soft-cap.

and two on one rank's slice of the keys (a cache split over its sequence,
``models.layers.seq_attention`` combines the ranks), each one launch of
the same kernels, q_start shifted by the slice's first row (it may be
negative: a row may see no key of the slice, and then has M = -inf, L = 0
and adds exactly 0):

  flash_attention_stats(q, k, v, q_start, round_p=...)
                                  each row's (M, L) over the slice, and
                                  where P needs no rounding (float32 V, or
                                  no round_p) the slice's output
                                  normalized by its own L;
  flash_attention_pass2(q, k, v, q_start, stats, round_p=...)
                                  given the group's (M, L), the slice's
                                  P V with P = exp(s - M) / L rounded to
                                  V's type: the second of two passes.

A CUDA tensor launches a kernel, or raises: there is no fallback.  A CPU
tensor takes the plain torch version in ``ref.py``, which the kernels are
held to on the card.  A ``meta`` tensor (the dry run) takes the CUDA
branch's checks, ``_check_bwd`` included, and its allocations, and
launches nothing.  Under an analyzer (``launch.op_analysis``, through
``repro_torch._work``) each launch, after it is made, or its ``meta``
stand-in declares its work: the plain version's
products (dense, as the reference's einsums count them: 4*B*Hq*Sq*Skv*D
forward, 8*B*Hq*Sq*Skv*D backward) and the bytes it reads and writes.
``flash_attention.launches`` counts the kernels' launches through any of
them (``flash_attention.wgmma_launches`` those of the wgmma variant,
``flash_attention.fp8_launches`` those of the split and mma kernels on
e4m3 K and V, ``flash_attention.stats_launches`` and
``pass2_launches`` those of the two slice forms).  A slice launch
declares the plain version's products over the slice's keys: 2 for the
one-pass stats form (Q K^T and P V), 1 each for the two-pass stats form
(Q K^T) and pass 2 (P V), so that a group's slices declare what one
device's launch declares.

The gradient: on CUDA tensors that need one (autograd on),
``flash_attention_gqa`` is a ``torch.autograd.Function`` whose forward is
the kernel above, unchanged, and whose backward is a CUDA kernel pair
(``attention_backward``; one entry, two kernels on the bf16 tensor cores:
rows, then keys; counted once a backward in
``flash_attention.backward_launches``; ``emulate_attention_bwd`` in
``ref.py`` writes out their arithmetic and tiles): up to head_dim 64
``csrc/flash_attention_bwd.cu`` (mma.sync), at 112, 128 and 256
``csrc/flash_attention_bwd_wgmma.cuh`` (wgmma, after a packing launch;
built without and with the window and soft-cap by two sources;
``bwd_wgmma_plan`` states its tiles and shared memory).  It takes q, k,
v of one type (float32 or bfloat16), every head_dim the forward takes,
the sliding window and the logit soft-cap, and raises otherwise.  On CPU
tensors autograd runs through the plain version.  A call without
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
and K as three bf16 parts each, so only up to head_dim 64, and bfloat16 q
up to 128 (112 included: 7 k-steps of 16, 14 column tiles of 8).
Variant "wgmma" (``csrc/flash_attention_wgmma.cu``): prefill at head_dim
256 and at 112 and 128 with a float32 q, where the mma kernel's registers
fall short: a packing launch lays q, K and V out in bf16 parts, then 64
rows a block (one warpgroup) against chunks of 64 keys brought in by bulk
copies, split across a cluster as the mma kernel's (``wgmma_smem`` states
its shared memory).

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

from repro_torch import _work
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (CLUSTER_MAX, SMS,
                                                     bwd_key_splits,
                                                     check_mask,
                                                     ref_attention_gqa,
                                                     ref_attention_gqa_bwd,
                                                     ref_attention_pass2,
                                                     ref_attention_stats,
                                                     ref_flash_attention)

_HEAD_DIMS = (16, 32, 64, 112, 128, 256)
BWD_HEAD_DIMS = _HEAD_DIMS   # the backward kernels' instances
WGMMA_DIMS = (112, 128, 256)  # the wgmma kernels' (forward and backward)
_TYPES = {torch.float32: 0, torch.bfloat16: 1}   # q's (and the backward's)
FP8 = torch.float8_e4m3fn
_KV_TYPES = {**_TYPES, FP8: 2}                     # K and V's
_VARIANTS = {"split": 0, "mma": 1}   # the split / mma entry's variants
WHOLE, STATS, PASS2 = 0, 1, 2        # the slice entries' modes
_Strides = ctypes.c_longlong * 3

THREADS = 128                # threads of a block, both variants
SPLIT_MAX_ROWS = 8           # rows a split block holds (buckets 4 and 8)
MMA_ROWS = 64                # rows of an mma block: 4 warps x 16
MMA_KEYS = 64                # keys of an mma chunk
MMA_F32_MAX_D = 64           # float32 q's three bf16 parts fit registers
MMA_MAX_D = 128              # bfloat16 q: acc and chunks fit the block
SPLIT_BLOCKS = 264           # split keys until about 2 blocks an SM
MAX_SPLITS = CLUSTER_MAX     # a portable cluster size
TILE = 64                    # rows of a packed tile (wgmma kernels)
SMEM_LIMIT = 232448          # shared memory a block can take (H100)
# csrc/flash_attention_wgmma.cu: a ring of 3 stages of 24 KB
WGMMA_STAGES, WGMMA_STAGE_BYTES = 3, 24 * 1024
# csrc/flash_attention_bwd_wgmma.cuh: two rings (one a warpgroup) of 3
# stages of 24 KB
BWD_STAGES, BWD_STAGE_BYTES = 3, 24 * 1024


class Plan(NamedTuple):
    """One launch of the forward's kernels.

    variant "split": rows = rows a block (4 or 8), splits = the cluster's
    blocks along the key axis, chunk = keys a block holds in registers at
    once, grid = (splits, row tiles, B * Hkv).  variants "mma" and
    "wgmma": rows = 64, splits = the cluster's blocks along the key axis
    (whole chunks each), chunk = 64 keys, grid = (row tiles * splits, Hkv,
    B)."""
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
    wide = d == 256 or (d in WGMMA_DIMS and not q_bf16)
    if rows > SPLIT_MAX_ROWS and (wide or d <= MMA_MAX_D and (
            q_bf16 or d <= MMA_F32_MAX_D)):
        tiles = _ceil(rows, MMA_ROWS)
        keys = min(skv, window + MMA_ROWS + MMA_KEYS) if window else skv
        splits = max(1, min(MAX_SPLITS, _ceil(keys, MMA_KEYS),
                            SMS // (tiles * b * hkv)))
        return Plan("wgmma" if wide else "mma", MMA_ROWS, splits, MMA_KEYS,
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
    tile's last query can see (0 at least: a slice of the keys may start
    past it) and kv_begin the first key its first query sees (0 without a
    window) (the kernels' formulas)."""
    last = min(g * sq, (tile + 1) * p.rows) - 1
    kv_end = max(0, min(skv, start + last // g + 1)) if causal else skv
    kv_begin = 0
    if window:
        first = tile * p.rows // g
        kv_begin = min(kv_end, max(0, start + first - window + 1))
    if p.variant != "split":    # whole chunks of 64 keys a block
        c0, c1 = kv_begin // p.chunk, _ceil(kv_end, p.chunk)
        span = _ceil(c1 - c0, p.splits)
        lo = min(c1, c0 + rank * span)
        return range(lo * p.chunk, min(kv_end, (lo + span) * p.chunk))
    span = _ceil(kv_end - kv_begin, p.splits)
    lo = min(kv_end, kv_begin + rank * span)
    return range(lo, min(kv_end, lo + span))


def wgmma_smem(d: int) -> int:
    """Shared memory of a block of the forward's wgmma kernel (``Cfg`` in
    ``csrc/flash_attention_wgmma.cu``): q's three parts at most, the ring,
    P's three parts."""
    return 3 * TILE * d * 2 + WGMMA_STAGES * WGMMA_STAGE_BYTES \
        + 3 * TILE * TILE * 2


class BwdPlan(NamedTuple):
    """The wgmma backward's tiles (``Cfg`` in
    ``csrc/flash_attention_bwd_wgmma.cuh``): rows and keys 64 a tile;
    s_slab, dp_slab = columns of head_dim an S / dP stage holds (a chain of
    its part pairs over the slab's 16-deep steps); dp_tail = dP's last
    slabs summed as one chain (in bfloat16 the rows kernel's first
    warpgroup forms them); dq_split = the rows kernel's first warpgroup's
    dq columns; the items' bytes (each fits a stage of the rings,
    ``BWD_STAGES`` of ``BWD_STAGE_BYTES``) and each kernel's shared
    memory."""
    s_slab: int
    dp_slab: int
    dp_tail: int
    dq_split: int
    s_stage_bytes: tuple      # (q, K) and (dout, V) slabs
    piece_bytes: tuple        # pieces of K or q, and of dout
    rows_smem: int
    keys_smem: int


def bwd_wgmma_plan(d: int, bf16: bool) -> BwdPlan:
    xp = 1 if bf16 else 3
    s_slab, dp_slab = (64 if bf16 else 32), 32
    ring = 2 * BWD_STAGES * BWD_STAGE_BYTES
    plane, dp = TILE * TILE * 2, TILE * TILE * 4
    return BwdPlan(s_slab, dp_slab, (2 if d > 128 else 1) if bf16 else 0,
                   128 if d > 128 else 64,
                   (2 * xp * TILE * s_slab * 2,
                    (3 + xp) * TILE * dp_slab * 2),
                   (xp * TILE * 64 * 2, 3 * TILE * 64 * 2),
                   ring + dp + 3 * plane, ring + dp + 6 * plane)


def _tiles(n: int) -> int:
    return _ceil(n, TILE)


def fwd_packed_elems(b, sq, skv, hq, hkv, d, q_bf16, kv_exact) -> int:
    """bf16 elements of the forward wgmma kernel's packed q, K, V
    (``kv_exact``: K and V are bfloat16 or e4m3, one exact bf16 part
    each)."""
    qp = 1 if q_bf16 else 3
    kp = 3 if not q_bf16 and not kv_exact else 1
    vp = 1 if kv_exact else 3
    plane = b * hkv * TILE * d
    return plane * (_tiles(hq // hkv * sq) * qp + _tiles(skv) * (kp + vp))


def bwd_packed_elems(b, sq, skv, hq, hkv, d, bf16) -> int:
    """bf16 elements of the wgmma backward's packed q, dout, K, V."""
    xp = 1 if bf16 else 3
    plane = b * hkv * TILE * d
    return plane * (_tiles(hq // hkv * sq) * (xp + 3) + 2 * _tiles(skv) * xp)


@functools.lru_cache(maxsize=None)
def _entry(masked: bool, fp8: bool = False, part: bool = False):
    """The split / mma kernels' entry: built without the window and the
    soft-cap (``csrc/flash_attention.cu``) or with them
    (``csrc/flash_attention_masked.cu``); on e4m3 K and V, with or
    without them (``csrc/flash_attention_fp8.cu``).  ``part``: the
    source's ``*_slice_launch``, which also takes a mode and the stats
    buffer (one rank's slice of the keys)."""
    name = ("flash_attention_fp8" if fp8 else
            "flash_attention_masked" if masked else "flash_attention")
    fn = getattr(_build.load(name),
                 f"{name}_slice_launch" if part else f"{name}_launch")
    fn.argtypes = ([ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 8
                   + [ctypes.POINTER(ctypes.c_longlong)] * 4
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_float] + [ctypes.c_int] * 4
                   + ([ctypes.c_int, ctypes.c_void_p] if part else [])
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _wgmma_entry(part: bool = False):
    """The wgmma kernel's entry; ``part``: the one that also takes a
    mode and the stats buffer."""
    lib = _build.load("flash_attention_wgmma")
    fn = (lib.flash_attention_wgmma_slice_launch if part
          else lib.flash_attention_wgmma_launch)
    fn.argtypes = ([ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 8
                   + [ctypes.POINTER(ctypes.c_longlong)] * 4
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_float] + [ctypes.c_int]
                   + ([ctypes.c_int, ctypes.c_void_p] if part else [])
                   + [ctypes.c_void_p] * 2)
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
    check_types(q, k, v)
    if k.shape[1] < 1 or k.shape[2] < 1 or hq % k.shape[2]:
        raise ValueError(f"flash attention needs Skv >= 1 and Hq a multiple "
                         f"of Hkv, got {tuple(k.shape)} for Hq={hq}")
    if q_start is not None and (tuple(q_start.shape) != (b,)
                                or q_start.device != q.device):
        raise ValueError(f"flash attention needs q_start of shape ({b},) on "
                         f"{q.device}, got {tuple(q_start.shape)} on "
                         f"{q_start.device}")


def check_types(q, k, v):
    """What the forward kernels take: a float32 or bfloat16 q, and K and
    V of one type, float32, bfloat16 or float8_e4m3fn (an fp8 cache)."""
    if q.dtype not in _TYPES or k.dtype not in _KV_TYPES \
            or v.dtype != k.dtype:
        raise ValueError(f"flash attention takes a float32 or bfloat16 q "
                         f"and k, v of one type, float32, bfloat16 or "
                         f"float8_e4m3fn, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")


def _one_type(q, k, v):
    """The Pallas signature widens q, k and v alike: it takes one type."""
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"flash_attention takes q, k, v of one type, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")



def _declare(kernel: str, products: int, q, k, read, written) -> None:
    """One launch's work: ``products`` dense (B, Hq, Sq, Skv, D) products
    of 2 FLOPs an element, the bytes read and written (nothing without
    an analyzer)."""
    if _work.active() is None:
        return
    b, sq, hq, d = q.shape
    _work.declare(kernel, 2.0 * products * b * hq * sq * k.shape[1] * d,
                        read, written)


def _vec_ok(t: torch.Tensor) -> bool:
    """Rows can be read with vector loads and 16-byte copies: the base
    and the (batch, sequence, head) strides on a 16-byte boundary."""
    return (_work.address(t) % 16 == 0
            and all(s * t.element_size() % 16 == 0 for s in t.stride()[:3]))


def two_passes(round_p: bool, v) -> bool:
    """P is rounded to V's type (round_p with a bfloat16 or e4m3 V): the
    kernels need the final (M, L) before any P V."""
    return bool(round_p) and v.dtype != torch.float32


def _launch(q, k, v, q_start, causal: bool, scale: float, round_p: bool,
            window: int = 0, softcap: float = 0.0, mode: int = WHOLE,
            stats=None):
    """A kernel on (B, S, H, D) views; returns (B, Sq, Hq, D) float32
    (None for the two-pass stats form, which writes ``stats`` alone).
    ``mode`` STATS / PASS2: one rank's slice of the keys, ``stats`` (2, B,
    Sq, Hq) float32 written / read."""
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
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
    stats_only = mode == STATS and two_passes(round_p, v)
    out = None if stats_only else torch.empty(
        (b, sq, hq, d), dtype=torch.float32, device=q.device)
    p = plan(b, sq, skv, hq, hkv, d, q.dtype == torch.bfloat16, window)
    if max(p.grid[1], p.grid[2]) > 65535:
        raise ValueError(f"flash attention: grid {p.grid} exceeds the "
                         f"card's 65535 blocks in y or z")
    work = _slice_work(mode, stats_only, q, k, v, q_start, out, stats)
    if q.device.type == "meta":
        _declare(*work)
        return out
    strides = [_Strides(*t.stride()[:3]) for t in (q, k, v)]
    strides.append(_Strides(0, 0, 0) if out is None
                   else _Strides(*out.stride()[:3]))
    part = (mode, stats.data_ptr()) if mode != WHOLE else ()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        common = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  0 if out is None else out.data_ptr(),
                  q_start.data_ptr(), _TYPES[q.dtype], _KV_TYPES[k.dtype],
                  b, sq, skv, hq, hkv, d, *strides, scale or d ** -0.5,
                  int(causal), int(round_p), int(window), float(softcap))
        if p.variant == "wgmma":
            packed = torch.empty(fwd_packed_elems(
                b, sq, skv, hq, hkv, d, q.dtype == torch.bfloat16,
                k.dtype != torch.float32), dtype=torch.bfloat16,
                device=q.device)
            rc = _wgmma_entry(bool(part))(*common, p.splits, *part,
                                          packed.data_ptr(), stream)
        else:
            rc = _entry(bool(window or softcap), k.dtype == FP8, bool(part))(
                *common, _VARIANTS[p.variant], p.rows, p.splits,
                int(_vec_ok(k) and _vec_ok(v)), *part, stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error "
                           f"{rc}")
    flash_attention.launches += 1
    if p.variant == "wgmma":
        flash_attention.wgmma_launches += 1
    elif k.dtype == FP8:
        flash_attention.fp8_launches += 1
    if mode == STATS:
        flash_attention.stats_launches += 1
    elif mode == PASS2:
        flash_attention.pass2_launches += 1
    _declare(*work)
    return out


def _slice_work(mode: int, stats_only: bool, q, k, v, q_start, out, stats):
    """``_declare``'s arguments for a launch of ``mode``: the products and
    the tensors read and written (the module docstring)."""
    if mode == WHOLE:
        return "flash_attention", 2, q, k, (q, k, v, q_start), (out,)
    if mode == PASS2:
        return "flash_attention", 1, q, k, (q, k, v, q_start, stats), (out,)
    if stats_only:
        return "flash_attention", 1, q, k, (q, k, q_start), (stats,)
    return "flash_attention", 2, q, k, (q, k, v, q_start), (out, stats)


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_float] + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_wgmma_entry(masked: bool):
    """The wgmma backward's entry: built without the window and the
    soft-cap (``csrc/flash_attention_bwd_wgmma.cu``) or with them
    (``csrc/flash_attention_bwd_wgmma_masked.cu``)."""
    name = ("flash_attention_bwd_wgmma_masked" if masked
            else "flash_attention_bwd_wgmma")
    fn = getattr(_build.load(name), f"{name}_launch")
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_float] + [ctypes.c_int] + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_bwd(q, k, v, causal: bool = True, window: int = 0,
               softcap: float = 0.0):
    """What the backward kernel takes: q, k, v of one type, float32 or
    bfloat16, a head_dim of ``BWD_HEAD_DIMS``, and the forward's mask (a
    window only with the causal mask)."""
    check_mask(causal, window, softcap)
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _TYPES:
        raise ValueError(f"the flash attention backward takes q, k, v of one "
                         f"type, float32 or bfloat16, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if q.shape[3] not in BWD_HEAD_DIMS:
        raise ValueError(f"the flash attention backward takes head_dim in "
                         f"{BWD_HEAD_DIMS}, got {q.shape[3]}")


def _launch_bwd(q, k, v, q_start, dout, causal: bool, scale: float,
                round_p: bool, window: int = 0, softcap: float = 0.0):
    """The backward kernels on contiguous copies; returns (dq, dk, dv) in
    the inputs' type."""
    _check_bwd(q, k, v, causal, window, softcap)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if b > 65535 or max(b * sq * hq * d, b * skv * hkv * d,
                        window) >= 2 ** 31:
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
    q, k, v, dout = (t if _work.address(t) % 16 == 0 else t.clone()
                     for t in (q, k, v, dout))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    stats = torch.empty(3 * b * sq * hq, dtype=torch.float32, device=q.device)
    work = ("flash_attention_backward", 4, q, k, (q, k, v, dout, q_start),
            (dq, dk, dv, stats))
    if q.device.type == "meta":
        _declare(*work)
        return dq, dk, dv
    bf16 = q.dtype == torch.bfloat16
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                q_start.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), stats.data_ptr())
        opts = (int(bf16), b, sq, skv, hq, hkv, d, scale or d ** -0.5,
                int(causal), int(round_p), int(window), float(softcap))
        if d in WGMMA_DIMS:
            packed = torch.empty(bwd_packed_elems(b, sq, skv, hq, hkv, d,
                                                  bf16),
                                 dtype=torch.bfloat16, device=q.device)
            rc = _bwd_wgmma_entry(bool(window or softcap))(
                *ptrs, packed.data_ptr(), *opts, bwd_key_splits(b, hkv, skv),
                stream)
        else:
            rc = _bwd_entry()(*ptrs, *opts, stream)
    if rc != 0:
        raise RuntimeError(f"flash attention backward launch failed: CUDA "
                           f"error {rc}")
    flash_attention.backward_launches += 1
    if d in WGMMA_DIMS:
        flash_attention.backward_wgmma_launches += 1
    _declare(*work)
    return dq, dk, dv


def attention_backward(q, k, v, q_start, dout, *, causal: bool = True,
                       scale: float = 0.0, round_p: bool = False,
                       window: int = 0, softcap: float = 0.0):
    """(dq, dk, dv) of ``flash_attention_gqa(q, k, v, q_start, ...)``
    against the float32 output gradient ``dout``, each in its input's
    type: the backward kernel for CUDA tensors, the plain version's
    autograd for CPU tensors."""
    _check(q, k, v, q_start)
    if q.device.type == "cpu":
        start = (torch.zeros(q.shape[0], dtype=torch.int32)
                 if q_start is None else q_start)
        return ref_attention_gqa_bwd(q, k, v, start, dout, causal, scale,
                                     round_p, window, softcap)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    return _launch_bwd(q, k, v, q_start, dout, causal, scale, round_p,
                       window, softcap)


class _Attention(torch.autograd.Function):
    """The kernel's forward, and the backward kernel for its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_start, causal, scale, round_p, window,
                softcap):
        _check_bwd(q, k, v, causal, window, softcap)
        ctx.save_for_backward(q, k, v, q_start)
        ctx.opts = (causal, scale, round_p, window, softcap)
        return _launch(q, k, v, q_start, causal, scale, round_p, window,
                       softcap)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_start = ctx.saved_tensors
        dq, dk, dv = _launch_bwd(q, k, v, q_start, dout, *ctx.opts)
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
    the backward kernel (``attention_backward``), on CPU tensors autograd
    of the plain version.
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


def _check_slice(q, k, v, q_start):
    _check(q, k, v, q_start)
    if q_start is None:
        raise ValueError("a slice of the keys needs q_start (shifted by the "
                         "slice's first row)")


def flash_attention_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_start: torch.Tensor, *, causal: bool = True,
                          scale: float = 0.0, round_p: bool = False,
                          window: int = 0, softcap: float = 0.0):
    """One rank's slice of the keys: k, v (B, Skv, Hkv, D) are the
    slice's rows, q_start (B,) int32 the query positions less the slice's
    first row (negative where the slice starts past the query).  Returns
    (out, stats): stats (2, B, Sq, Hq) float32, each row's max M of the
    scaled (soft-capped) visible logits over the slice and L = sum exp(s -
    M) (-inf and 0 for a row that sees no key of the slice); out (B, Sq,
    Hq, D) float32, the slice's P V normalized by its own L (0 for such a
    row), or None where ``two_passes`` (then ``flash_attention_pass2``
    takes the group's (M, L)).  One launch (``stats_launches``); no
    gradient."""
    _check_slice(q, k, v, q_start)
    if q.device.type == "cpu":
        return ref_attention_stats(q, k, v, q_start, causal, scale, round_p,
                                   window, softcap)
    b, sq, hq, _ = q.shape
    stats = torch.empty((2, b, sq, hq), dtype=torch.float32, device=q.device)
    out = _launch(q, k, v, q_start, causal, scale, round_p, window, softcap,
                  STATS, stats)
    return out, stats


def flash_attention_pass2(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_start: torch.Tensor, stats: torch.Tensor, *,
                          causal: bool = True, scale: float = 0.0,
                          round_p: bool = False, window: int = 0,
                          softcap: float = 0.0) -> torch.Tensor:
    """The second pass over one rank's slice of the keys (arguments as
    ``flash_attention_stats``'s), given the group's (M, L) in ``stats``
    (2, B, Sq, Hq) float32: the slice's sum over its visible keys of P V,
    P = exp(s - M) / L, rounded to V's type with ``round_p``.  The ranks'
    outputs sum to the group's attention.  One launch
    (``pass2_launches``); no gradient."""
    _check_slice(q, k, v, q_start)
    b, sq, hq, _ = q.shape
    if (tuple(stats.shape) != (2, b, sq, hq) or stats.dtype != torch.float32
            or stats.device != q.device or not stats.is_contiguous()):
        raise ValueError(f"flash attention pass 2 needs contiguous float32 "
                         f"stats of shape {(2, b, sq, hq)} on {q.device}, got "
                         f"{stats.dtype} {tuple(stats.shape)} on "
                         f"{stats.device}")
    if q.device.type == "cpu":
        return ref_attention_pass2(q, k, v, q_start, stats, causal, scale,
                                   round_p, window, softcap)
    return _launch(q, k, v, q_start, causal, scale, round_p, window, softcap,
                   PASS2, stats)


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
# of those, the launches of the wgmma kernels (a packing launch and the
# forward's prefill kernel, or the backward's two)
flash_attention.wgmma_launches = 0
flash_attention.backward_wgmma_launches = 0
# and those of the split / mma kernels on an e4m3 K/V cache
# (``csrc/flash_attention_fp8.cu``)
flash_attention.fp8_launches = 0
# and the slice forms' (``flash_attention_stats``, ``flash_attention_pass2``)
flash_attention.stats_launches = 0
flash_attention.pass2_launches = 0


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

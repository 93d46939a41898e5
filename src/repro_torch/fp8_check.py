"""Hold the port's serving on an fp8 (float8_e4m3fn) K/V cache to the JAX
package's.

``chip_smoke.py`` (phase 17.2) and ``tests/_torch_fp8_ref.py``, which
writes ``tests/data/torch_fp8_ref.json`` from the JAX package, run the
same inputs through the same entry points: Qwen3-32B at full width (d_model
5120, 64 / 8 heads of 128, d_ff 25600, vocab 151,936) with its depth cut
to ``REF_LAYERS``, float32 weights from ``hashed_params(cfg, PARAM_SEED)``
(the perf variant ``v1b_f8_cache_seqshard``'s dense weights at the
reference's init scales, drawn by an integer hash: the same bits on the
CPU and the card, where a numpy draw of its 2.5 G values took a minute
of the card host's time), the
residual stream in float32 (``dtype="float32"``: no bfloat16 rounding
between the packages, so that the comparison sees the cache and P), an
fp8 cache of ``MAX_LEN`` rows, a prefill of ``BATCH`` x ``PROMPT`` numpy
tokens and ``STEPS`` greedy decode steps (the port is fed the reference's
tokens).

``summary`` keeps, of a run, the logits at ``COLUMNS`` fixed columns of
every step, each step's argmax and top-2 margin, and layer 0's K and V
codes as a sha256 and a histogram of the 256 codes (a few codes one
apart, at e4m3 rounding ties of the cache write, move the hash but
barely the histogram).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

CONFIG = "qwen3-32b"
PARAM_SEED = 0
TOKEN_SEED = 18
REF_LAYERS = 2
BATCH, PROMPT, STEPS, MAX_LEN = 2, 130, 8, 160
N_COLUMNS = 64
COLUMN_SEED = 1
# the CPU test's rebuild of the file's format
REDUCED = dict(batch=2, prompt=16, steps=4, max_len=24)


def config(size: str = "full"):
    """The reference's config: full width cut to ``REF_LAYERS``, or the
    reduced one; float32 activations."""
    from repro_torch.configs import get, reduced
    cfg = (get(CONFIG).replace(n_layers=REF_LAYERS) if size == "full"
           else reduced(CONFIG))
    return cfg.replace(dtype="float32")


# a 32-bit integer hash (lowbias32's shape, multipliers below 2^31 so that
# a product of two 32-bit values stays inside int64) of a counter
_M32 = 0xFFFFFFFF
_MUL = (0x7FEB352D, 0x2C1B3C6D)
_SEED_STEP = 0x9E3779B9
_CHUNK = 1 << 26


def hashed_uniform(n: int, offset: int, device) -> torch.Tensor:
    """n float32 values in [0, 1): (h(offset + i mod 2^32) >> 8) / 2^24,
    h the hash above.  Integer ops and exact conversions only, so every
    device gives the same bits."""
    out = torch.empty(n, dtype=torch.float32, device=device)
    for lo in range(0, n, _CHUNK):
        hi = min(n, lo + _CHUNK)
        x = (torch.arange(lo, hi, dtype=torch.int64, device=device)
             + offset) & _M32
        x ^= x >> 16
        x = (x * _MUL[0]) & _M32
        x ^= x >> 15
        x = (x * _MUL[1]) & _M32
        x ^= x >> 16
        out[lo:hi] = (x >> 8).to(torch.float32) * (2.0 ** -24)
    return out


def hashed_params(cfg, seed: int = PARAM_SEED, device=None):
    """A decoder's params (``transformer.init_params``' tree) at the
    reference's init scales: dense weights uniform with variance 1 /
    d_in, the embedding's with standard deviation 0.02, norm scales 1;
    leaf after leaf from one counter (``hashed_uniform``), each scaled by
    one float32 product."""
    from repro_torch.models import transformer as T
    from repro_torch.models.params import nest
    from repro_torch.device import resolve_device
    device = resolve_device(device)
    shapes = T.init_params(cfg, torch.Generator(), device="meta")
    flat: dict = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], f"{path}/{k}" if path else k)
        elif isinstance(tree, (list, tuple)):
            for i, x in enumerate(tree):
                walk(x, f"{path}/{i}")
        else:
            flat[path] = tree
    walk(shapes, "")
    offset = (seed * _SEED_STEP) & _M32
    out = {}
    for path, meta in flat.items():
        name = path.rsplit("/", 1)[-1]
        if "norm" in name or name.startswith("ln"):
            out[path] = torch.ones(meta.shape, device=device)
            continue
        std = 0.02 if name == "embed" else 1.0 / np.sqrt(meta.shape[-2])
        # U(-sqrt(3) std, sqrt(3) std): (u - 1/2), exact, times one float32
        span = torch.tensor(np.float32(2.0 * np.sqrt(3.0) * std),
                            device=device)
        u = hashed_uniform(meta.numel(), offset, device)
        offset = (offset + meta.numel()) & _M32
        out[path] = ((u - 0.5) * span).reshape(meta.shape)
    return nest(out)


def shape(size: str = "full") -> dict:
    if size == "full":
        return dict(batch=BATCH, prompt=PROMPT, steps=STEPS, max_len=MAX_LEN)
    return dict(REDUCED)


def prompt_tokens(cfg, size: str = "full") -> np.ndarray:
    s = shape(size)
    return np.random.default_rng(TOKEN_SEED).integers(
        0, cfg.vocab, size=(s["batch"], s["prompt"]))


def columns(cfg) -> np.ndarray:
    """The logit columns a summary keeps, sorted."""
    n = min(N_COLUMNS, cfg.vocab)
    return np.sort(np.random.default_rng(COLUMN_SEED).choice(
        cfg.vocab, n, replace=False))


def code_summary(k_bits: np.ndarray, v_bits: np.ndarray) -> dict:
    """Layer 0's K and V codes (uint8 arrays): their sha256 and the count
    of each of the 256 codes."""
    h = hashlib.sha256(np.ascontiguousarray(k_bits).tobytes())
    h.update(np.ascontiguousarray(v_bits).tobytes())
    return {"cache_sha256": h.hexdigest(),
            "cache_histogram": [np.bincount(np.ravel(x), minlength=256)
                                .tolist() for x in (k_bits, v_bits)]}


def summary(steps: np.ndarray, cols: np.ndarray, k_bits, v_bits) -> dict:
    """steps: (STEPS + 1, B, V) float32 logits of the prefill's last
    position and each decode step."""
    top2 = np.sort(steps, axis=-1)[..., -2:]
    return {"logits": steps[..., cols].tolist(),
            "argmax": np.argmax(steps, axis=-1).tolist(),
            "margin": (top2[..., 1] - top2[..., 0]).tolist(),
            **code_summary(k_bits, v_bits)}


def layer0_bits(cache) -> tuple:
    """The port's cache (``transformer.init_cache``'s tree): layer 0's K
    and V codes as uint8 numpy arrays."""
    k, v = cache["scan"]["k"][0], cache["scan"]["v"][0]
    return tuple(t.view(torch.uint8).cpu().numpy() for t in (k, v))


@torch.no_grad()
def port_run(params, cfg, prompt, greedy, max_len: int, device,
             cache_dtype=torch.float8_e4m3fn) -> tuple:
    """The port's prefill of ``prompt`` (B, S) into a cache of ``max_len``
    rows (fp8 unless ``cache_dtype`` says otherwise) and a decode step on
    each column of ``greedy`` (B, STEPS): ((STEPS + 1, B, V) float32
    logits on the host, the cache)."""
    from repro_torch.models import transformer as T
    cache = T.init_cache(cfg, prompt.shape[0], max_len, cache_dtype,
                         device=device)
    toks = torch.as_tensor(prompt, device=device)
    logits, cache = T.prefill(params, toks, cfg, cache)
    out = [logits[:, -1].float().cpu().numpy()]
    nxt = torch.as_tensor(greedy, device=device)
    for i in range(nxt.shape[1]):
        logits, cache = T.decode_step(params, nxt[:, i:i + 1], cfg, cache)
        out.append(logits[:, -1].float().cpu().numpy())
    return np.stack(out), cache


# A P this close (relative) to an e4m3 rounding midpoint may round either
# way between the kernels and their plain version: their float32 P's
# differ in the last bits (exp, the row sums and the logits' sums run in
# other orders)
P_TIE_REL = 2.0 ** -18


@torch.no_grad()
def p_ties(q, k, v, q_start, *, causal: bool = True, scale: float = 0.0,
           window: int = 0, softcap: float = 0.0) -> dict:
    """What P's e4m3 rounding (``round_p`` on an e4m3 V) leaves to chance
    between a kernel and the plain version, from the plain version's P:
    ``allowance`` (B, Sq, Hq, D), each output element's sum over the keys
    whose P lies within ``P_TIE_REL`` of a rounding midpoint of one code
    step times |v| (a kernel's output may differ from the plain one's by
    that much more); ``ties``, the count of such P's; ``nonzero_share``,
    the share of the visible keys' P codes that are not 0 (0 when every P
    underflows: at 32,768 near-uniform keys every P is below 2^-10)."""
    from repro_torch.kernels.flash_attention.ref import (_visible,
                                                         attention_probs,
                                                         round_probs)
    f8 = torch.float8_e4m3fn
    probs = attention_probs(q, k, q_start, causal, scale, window, softcap)
    up = round_probs(probs * (1 + P_TIE_REL), f8).float()
    down = round_probs(probs * (1 - P_TIE_REL), f8).float()
    step = up - down                    # one code at a tie, else 0
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    allowance = torch.einsum("bhgqk,bkhd->bqhgd", step,
                             v.float().abs()).reshape(b, sq, hq, d)
    codes = round_probs(probs, f8).view(torch.uint8)
    if causal:
        vis = _visible(q_start, sq, k.shape[1], q.device, window)
        vis = vis[:, None, None].expand(b, hkv, hq // hkv, sq, k.shape[1])
    else:
        vis = torch.ones_like(probs, dtype=torch.bool)
    nonzero = int(((codes != 0) & vis).sum())
    return {"allowance": allowance, "ties": int((step > 0).sum()),
            "nonzero_share": nonzero / max(1, int(vis.sum()))}

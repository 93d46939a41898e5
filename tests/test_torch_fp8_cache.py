"""The port on a float8_e4m3fn K/V cache against the JAX package.

The JAX package serves on an fp8 cache where the caller asks for one
(``init_cache(..., jnp.float8_e4m3fn)``; the perf runner's
``v1b_f8_cache_seqshard`` / ``v3_f8_cache``).  A step writes
``k.astype(cache.dtype)`` (to nearest even, NaN past 464, where torch's
cast saturates: ``layers.to_cache``), and the decoder family's attention
rounds its normalized P to e4m3 before a float32 P V; Whisper's and
Zamba2's attention upcast the cache and keep P in float32.  Held here,
on the CPU (the kernels' plain versions): the cast bit for bit; the plain
attention against the reference's arithmetic; the kernels' emulation and
plan on fp8 K/V; reduced Qwen3-32B, Gemma-3-1B (its window), Whisper and
Zamba2-7B served on an fp8 cache (prefill and 4 decode steps) with caches
bitwise and logits within the CPU model tests' 1e-4, over token seeds
0-7; ``convert``'s round trip of fp8 arrays; RWKV6's refusal of 8-bit
float states, in both packages; and the full-width reference file's
format (``tests/_torch_fp8_ref.py``).

A P or a K / V value at an e4m3 rounding midpoint may round one code
apart in the two packages (their float32 sums run in other orders): the
port takes the JAX code there (``_torch_act_pins.ProbPins``,
``CachePins``), counted, and a code that differs anywhere else fails.
"""

import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import reduced
from repro_torch.kernels.flash_attention import (
    flash_attention_gqa, fwd_packed_elems, plan)
from repro_torch.kernels.flash_attention.ref import (emulate_attention,
                                                     ref_attention_gqa)
from repro_torch.models import family_module, layers as L

import _torch_fp8_ref as R
from _torch_act_pins import (CachePins, ProbPins, jax_probs_log,  # noqa: F401
                             one_torch_thread)

F8 = torch.float8_e4m3fn
JF8 = jnp.float8_e4m3fn
LOGIT_TOL = 1e-4          # the CPU model tests' float32 tolerance
TOKEN_SEEDS = tuple(range(8))
BATCH, PROMPT, STEPS, MAX_LEN = 2, 16, 4, 24
FAMILIES = ("qwen3-32b", "gemma3-1b", "whisper-medium", "zamba2-7b")


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.uint8)


# ---------------------------------------------------------------------------
# the cast
# ---------------------------------------------------------------------------

EDGES = [448.0, 464.0, 465.0, 470.0, 480.0, 500.0, math.inf, -math.inf,
         math.nan, 2.0 ** -10, 1.5 * 2.0 ** -9, 3 * 2.0 ** -11, -448.0,
         -464.0, -470.0, -500.0, 0.0, -0.0, 1e-30, 240.0, 1.0625, 1.1875]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_cast_matches_jax_bitwise(dtype):
    """``layers.to_cache`` to e4m3 gives JAX's ``astype`` bits: the edges
    (448 / the 464 tie / NaN past it and for inf / subnormals) and 200,000
    normal draws over the e4m3 range, in float32 and bfloat16; torch's
    own cast saturates where JAX gives NaN."""
    rng = np.random.default_rng(0)
    draws = (rng.standard_normal(200_000)
             * np.exp2(rng.uniform(-12, 9.5, 200_000))).astype(np.float32)
    x = np.concatenate([np.asarray(EDGES, np.float32), draws])
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = _bits(jx.astype(JF8))
    # the very same inputs: JAX's bfloat16 bits (torch's own cast makes
    # every NaN negative)
    tx = (torch.from_numpy(x) if dtype == "float32" else torch.from_numpy(
        np.asarray(jx).view(np.int16).copy()).view(torch.bfloat16))
    got = convert.bits_to_numpy(L.to_cache(tx, F8))
    np.testing.assert_array_equal(got, want)
    # the difference the helper exists for
    plain = convert.bits_to_numpy(tx.to(F8))
    assert plain[EDGES.index(500.0)] == 0x7E and want[EDGES.index(500.0)] == 0x7F
    # the other cache types take the plain cast
    assert L.to_cache(tx, torch.bfloat16).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the plain attention against the reference's arithmetic
# ---------------------------------------------------------------------------

def _qkv(seed, b, sq, skv, hq, hkv, d, q_dtype, scale_q=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, sq, hq, d)) * scale_q).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    q = np.array(jnp.asarray(q).astype(getattr(jnp, q_dtype)), np.float32)
    k8 = np.asarray(jnp.asarray(k).astype(JF8))
    v8 = np.asarray(jnp.asarray(v).astype(JF8))
    return q, k8, v8


def _jax_dynwin(q, k8, v8, start, q_dtype, window, softcap, scale):
    """``_attention_dynwin``'s arithmetic on the cache (its lines, with
    positions start + arange(Sq) and the cache's keys 0..Skv-1): (out,
    the float32 P before its rounding)."""
    b, sq, hq, d = q.shape
    skv, hkv = k8.shape[1], k8.shape[2]
    qg = jnp.asarray(q).astype(getattr(jnp, q_dtype)).reshape(
        b, sq, hkv, hq // hkv, d)
    k, v = jnp.asarray(k8), jnp.asarray(v8)
    logits = jnp.einsum("bqhgd,bkhd->bhgqk", qg, k.astype(qg.dtype),
                        preferred_element_type=jnp.float32) * scale
    if softcap > 0.0:
        logits = softcap * jnp.tanh(logits / softcap)
    qp = (start[:, None] + np.arange(sq)[None])[:, None, None, :, None]
    kp = np.arange(skv)[None, None, None, None, :]
    win = window if window > 0 else 1 << 30
    logits = jnp.where((kp <= qp) & (kp > qp - win), logits, -1e30)
    probs = jax.nn.softmax(logits, axis=-1)
    out = jnp.einsum("bhgqk,bkhd->bqhgd", probs.astype(v.dtype), v,
                     preferred_element_type=jnp.float32)
    return np.asarray(out.reshape(b, sq, hq, d)), np.asarray(probs)


@pytest.mark.parametrize("q_dtype,sq,window,softcap", [
    ("float32", 1, 0, 0.0), ("float32", 7, 0, 0.0),
    ("bfloat16", 1, 0, 0.0), ("bfloat16", 7, 5, 0.0),
    ("float32", 7, 5, 30.0)])
def test_plain_attention_rounds_p_as_the_reference(monkeypatch, q_dtype, sq,
                                                   window, softcap):
    """``ref_attention_gqa`` with e4m3 K/V and ``round_p`` against the
    reference's ``_attention_dynwin`` arithmetic at 1e-6 (P's rounding
    pinned at ties)."""
    b, skv, hq, hkv, d = 2, 40, 4, 2, 16
    q, k8, v8 = _qkv(1, b, sq, skv, hq, hkv, d, q_dtype, scale_q=3.0)
    start = np.array([30, 33], np.int32)
    scale = 1.0 / math.sqrt(d)
    pins = ProbPins(monkeypatch)
    want, probs = _jax_dynwin(q, k8, v8, start, q_dtype, window, softcap,
                              scale)
    pins.load([probs])
    tq = torch.from_numpy(q).to(getattr(torch, q_dtype))
    got = ref_attention_gqa(tq, convert.tensor_from_numpy(k8, "cpu"),
                            convert.tensor_from_numpy(v8, "cpu"),
                            torch.from_numpy(start), True, scale, True,
                            window, softcap)
    assert pins.done()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the rounding is there: P in float32 reads otherwise
    unrounded = ref_attention_gqa(tq, convert.tensor_from_numpy(k8, "cpu"),
                                  convert.tensor_from_numpy(v8, "cpu"),
                                  torch.from_numpy(start), True, scale,
                                  False, window, softcap)
    assert float((unrounded - got).abs().max()) > 1e-3


@pytest.mark.parametrize("mask_mode", ["causal", "full"])
def test_plain_attention_without_round_p_is_attend(mask_mode):
    """Without ``round_p`` (Whisper's, Zamba2's attention) the plain
    version on an e4m3 cache is the reference's ``layers._attend``: every
    operand upcast, float32 P."""
    from repro.models import layers as JL
    from repro.models.layers import AttnSpec
    b, sq, skv, hq, hkv, d = 2, 5, 24, 4, 4, 16
    q, k8, v8 = _qkv(2, b, sq, skv, hq, hkv, d, "float32")
    start = np.array([11, 19], np.int32)
    spec = AttnSpec(n_heads=hq, kv_heads=hkv, head_dim=d)
    qpos = start[:, None] + np.arange(sq)[None]
    kpos = np.broadcast_to(np.arange(skv)[None], (b, skv))
    want = np.asarray(JL._attend(jnp.asarray(q), jnp.asarray(k8),
                                 jnp.asarray(v8), spec, jnp.asarray(qpos),
                                 jnp.asarray(kpos), mask_mode))
    got = L._attend(torch.from_numpy(q), convert.tensor_from_numpy(k8, "cpu"),
                    convert.tensor_from_numpy(v8, "cpu"),
                    L.AttnSpec(n_heads=hq, kv_heads=hkv, head_dim=d),
                    torch.from_numpy(start) if mask_mode == "causal"
                    else None, mask_mode)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the kernels' arithmetic and plan on fp8 K/V
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_dtype,sq,d,round_p", [
    ("float32", 1, 128, True), ("bfloat16", 1, 64, True),
    ("float32", 70, 64, True), ("bfloat16", 70, 128, True),
    ("float32", 70, 128, True), ("bfloat16", 70, 256, False),
    ("float32", 70, 112, False)])
def test_emulation_matches_plain_on_fp8(q_dtype, sq, d, round_p):
    """The kernels' arithmetic (``emulate_attention``: the split, mma and
    wgmma plans, e4m3 K and V as one exact bf16 part, two passes with
    ``round_p``) against the plain version at 2e-5, P at e4m3's codes: a
    code one apart moves a row by far more."""
    b, skv, hq, hkv = 1, 150, 8, 2
    q, k8, v8 = _qkv(3, b, sq, skv, hq, hkv, d, q_dtype)
    tq = torch.from_numpy(q).to(getattr(torch, q_dtype))
    k, v = (convert.tensor_from_numpy(x, "cpu") for x in (k8, v8))
    st = torch.tensor([skv - sq], dtype=torch.int32)
    p = plan(b, sq, skv, hq, hkv, d, q_dtype == "bfloat16")
    want = ref_attention_gqa(tq, k, v, st, round_p=round_p)
    got = emulate_attention(tq, k, v, st, p, round_p=round_p)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5)
    assert p.variant == ("split" if sq == 1 else
                         "wgmma" if d == 256 or (d > 64 and q_dtype ==
                                                 "float32") else "mma")


def test_packed_elems_and_vector_rows_of_fp8():
    """The wgmma kernel packs e4m3 K and V as one bf16 part each (a
    float32 q three), and 1-byte rows take vector loads on a 16-byte
    boundary (16 elements)."""
    from repro_torch.kernels.flash_attention.flash_attention import _vec_ok
    args = (2, 130, 4096, 64, 8, 128)
    plane = 2 * 8 * 64 * 128
    assert fwd_packed_elems(*args, False, True) == plane * (
        math.ceil(8 * 130 / 64) * 3 + 64 * 2)
    assert fwd_packed_elems(*args, True, True) == plane * (
        math.ceil(8 * 130 / 64) + 64 * 2)
    assert fwd_packed_elems(*args, False, False) == plane * (
        math.ceil(8 * 130 / 64) * 3 + 64 * 6)
    t = torch.zeros((2, 40, 8, 128), dtype=F8)
    assert _vec_ok(t) and _vec_ok(t[:, 3:])       # 1,024-byte rows
    u = torch.zeros((2, 40, 3, 24), dtype=F8)     # 72-byte positions
    assert not _vec_ok(u)


def test_wrapper_takes_fp8_only_for_k_and_v():
    """fp8 K and V of one type pass the wrapper's checks (and reach the
    plain version on the CPU); an fp8 q, or K and V of two types, raise;
    the backward refuses fp8 as before."""
    from repro_torch.kernels.flash_attention import attention_backward
    q = torch.randn(1, 2, 4, 16)
    k = torch.randn(1, 8, 2, 16).to(F8)
    out = flash_attention_gqa(q, k, k, torch.tensor([6], dtype=torch.int32),
                              round_p=True)
    assert out.dtype == torch.float32 and bool(out.isfinite().all())
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        flash_attention_gqa(q.to(F8), k, k)
    with pytest.raises(ValueError, match="one type"):
        flash_attention_gqa(q, k, k.to(torch.bfloat16))
    meta = [t.to("meta") for t in (q, k, k)]
    with pytest.raises(ValueError, match="backward"):
        attention_backward(*meta, None, torch.zeros(1, 2, 4, 16,
                                                    device="meta"))


# ---------------------------------------------------------------------------
# the reduced models served on an fp8 cache
# ---------------------------------------------------------------------------

def _tokens(cfg, seed: int, whisper: bool):
    """(tokens (B, PROMPT + STEPS), Whisper's frames (B, 24, D) or
    None), numpy, from ``seed``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(BATCH, PROMPT + STEPS))
    frames = (rng.standard_normal((BATCH, 24, cfg.d_model), dtype=np.float32)
              if whisper else None)
    return toks, frames


def _f8_leaves(tree, out):
    """The float8 arrays / tensors of a cache tree, in key order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            _f8_leaves(tree[key], out)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _f8_leaves(x, out)
    elif getattr(tree, "dtype", None) in (JF8, F8):
        out.append(tree)
    return out


def _serve(mod, params, cfg, toks, frames, cache, jitted=None):
    """Prefill of ``PROMPT`` tokens and ``STEPS`` decode steps: (logits
    (B, 1 + STEPS, V), cache), with JAX's jitted entries or the port's."""
    pre = jitted[0] if jitted else mod.prefill
    dec = jitted[1] if jitted else mod.decode_step
    head = toks[:, :PROMPT]
    if frames is not None:
        logits, cache, enc = pre(params, {"frames": frames, "tokens": head},
                                 cfg, cache)
    else:
        logits, cache = pre(params, head, cfg, cache)
    steps = [np.asarray(logits, np.float32) if jitted
             else logits.float().numpy()]
    for i in range(PROMPT, PROMPT + STEPS):
        t = toks[:, i:i + 1]
        logits, cache = (dec(params, t, enc, cfg, cache) if frames is not None
                         else dec(params, t, cfg, cache))
        steps.append(np.asarray(logits, np.float32) if jitted
                     else logits.float().numpy())
    return np.concatenate(steps, axis=1), cache


@pytest.fixture(scope="module")
def jax_served():
    """{(family, seed): (logits, cache bits, P log)} of the JAX package."""
    from repro.configs import reduced as jreduced
    from repro.models import family_module as jfamily
    out = {}
    with jax_probs_log() as log:
        for name in FAMILIES:
            cfg = jreduced(name).replace(dtype="float32")
            mod = jfamily(cfg)
            arrays = family_module(reduced(name)).numpy_params(
                reduced(name).replace(dtype="float32"), 0)
            params = jax.tree.map(jnp.asarray, arrays)
            enc = name.startswith("whisper")
            jitted = (jax.jit(mod.prefill, static_argnums=2),
                      jax.jit(mod.decode_step,
                              static_argnums=3 if enc else 2))
            for seed in TOKEN_SEEDS:
                toks, frames = _tokens(cfg, seed, enc)
                cache = mod.init_cache(cfg, BATCH, MAX_LEN, JF8)
                logits, cache = _serve(
                    mod, params, cfg, jnp.asarray(toks),
                    None if frames is None else jnp.asarray(frames), cache,
                    jitted)
                out[name, seed] = (logits, [_bits(x) for x in
                                            _f8_leaves(cache, [])],
                                   log.drain())
    return out


@pytest.mark.parametrize("seed", TOKEN_SEEDS)
@pytest.mark.parametrize("name", FAMILIES)
def test_reduced_model_on_fp8_cache_matches_jax(monkeypatch, jax_served,
                                                name, seed):
    """Prefill of 2 x 16 tokens into a 24-row fp8 cache and 4 decode
    steps: every cache code equal and the logits within 1e-4 of the JAX
    package's (P's e4m3 codes pinned at rounding ties)."""
    want_logits, want_caches, probs = jax_served[name, seed]
    cfg = reduced(name).replace(dtype="float32")
    mod = family_module(cfg)
    params = convert.params_from_numpy(mod.numpy_params(cfg, 0), "cpu")
    enc = name.startswith("whisper")
    toks, frames = _tokens(cfg, seed, enc)
    # the decoders' attention rounds P; Whisper's and Zamba2's keep it
    # float32 (their softmax calls logged on the JAX side are not pinned)
    rounds_p = name in ("qwen3-32b", "gemma3-1b")
    if rounds_p:
        p_pins = ProbPins(monkeypatch)
        p_pins.load(probs)
    c_pins = CachePins(monkeypatch, *want_caches, PROMPT)
    cache = mod.init_cache(cfg, BATCH, MAX_LEN, F8, device="cpu")
    logits, cache = _serve(mod, params, cfg, torch.as_tensor(toks),
                           None if frames is None
                           else torch.as_tensor(frames), cache)
    assert not rounds_p or p_pins.done()
    assert c_pins.n == 2 * want_caches[0].shape[0] * (1 + STEPS)
    got = [convert.bits_to_numpy(t) for t in _f8_leaves(cache, [])]
    assert len(got) == len(want_caches) == 2
    for g, w in zip(got, want_caches):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(logits, want_logits, rtol=0, atol=LOGIT_TOL)


# ---------------------------------------------------------------------------
# convert, RWKV, the reference file
# ---------------------------------------------------------------------------

def test_convert_moves_fp8_as_bits():
    """JAX's float8 arrays (ml_dtypes on the host) reach torch bit for bit
    and come back so, alone and inside a cache tree."""
    x = np.random.default_rng(4).standard_normal((3, 5, 2, 16)) * 100
    j = jnp.asarray(x.astype(np.float32)).astype(JF8)
    t = convert.tensor_from_numpy(np.asarray(j), "cpu")
    assert t.dtype == F8 and t.shape == (3, 5, 2, 16)
    np.testing.assert_array_equal(convert.bits_to_numpy(t), _bits(j))
    back = convert.bits_to_numpy(t).view(ml_dtypes.float8_e4m3fn)
    np.testing.assert_array_equal(back.astype(np.float32),
                                  np.asarray(j.astype(jnp.float32)))
    tree = convert.params_from_numpy(
        {"k": np.asarray(j), "index": np.asarray(3)}, "cpu")
    assert tree["k"].dtype == F8 and int(tree["index"]) == 3


def test_rwkv_refuses_float8_states_in_both_packages():
    """RWKV6's ``init_cache(dtype=)`` types its token-shift states; with
    float8 the reference's prefill raises (``jnp.concatenate`` of 8-bit
    floats has no promotion path) and so does the port's, naming it."""
    from repro.configs import reduced as jreduced
    from repro.models import rwkv as JR
    from repro_torch.models import rwkv as TR
    cfg = reduced("rwkv6-1.6b")
    toks = np.zeros((2, 4), np.int64)
    jp = jax.tree.map(jnp.asarray, TR.numpy_params(cfg, 0))
    with pytest.raises(Exception, match="promotion"):
        JR.prefill(jp, jnp.asarray(toks), jreduced("rwkv6-1.6b"),
                   JR.init_cache(jreduced("rwkv6-1.6b"), 2, 8, JF8))
    tp = convert.params_from_numpy(TR.numpy_params(cfg, 0), "cpu")
    with pytest.raises(ValueError, match="float8"):
        TR.prefill(tp, torch.as_tensor(toks), cfg,
                   TR.init_cache(cfg, 2, 8, F8, device="cpu"))


def test_full_width_reference_file_format():
    """``tests/data/torch_fp8_ref.json`` (``tests/_torch_fp8_ref.py``, the
    JAX package's Qwen3-32B at full width, 2 layers): its config, the
    logits of every step at the fixed columns, the cache hash and the
    share of nonzero P codes; the reduced rebuild has the same format and
    the port at the reduced size matches it at 1e-4."""
    from repro_torch import fp8_check as F
    ref = json.loads(R.REF_PATH.read_text())
    assert ref["config"]["d_model"] == 5120
    assert ref["config"]["n_layers"] == F.REF_LAYERS
    assert ref["cache_dtype"] == "float8_e4m3fn"
    assert ref["shape"] == F.shape("full")
    assert np.asarray(ref["logits"]).shape == (F.STEPS + 1, F.BATCH,
                                               F.N_COLUMNS)
    assert np.asarray(ref["greedy"]).shape == (F.BATCH, F.STEPS)
    assert 0.0 < ref["p_nonzero_share"] <= 1.0
    small = R.build(size="reduced")
    assert set(small) == set(ref)
    got = R.port_run("reduced", small["greedy"])
    np.testing.assert_allclose(got["logits"], small["logits"], rtol=0,
                               atol=LOGIT_TOL)
    assert got["cache_sha256"] == small["cache_sha256"]
    assert got["argmax"] == small["argmax"]

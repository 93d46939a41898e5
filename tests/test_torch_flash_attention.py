"""The plain version of the port's ``flash_attention`` kernel (what its
wrappers compute on CPU tensors) against the JAX package: the Pallas
kernel in interpret mode at the reference test's shapes and tolerances
(``tests/test_kernels.py``: 2e-5 for float32, 0.03 for bfloat16), and the
JAX model's own attention (``transformer._attention_dynwin``, with and
without a KV cache, in float32 and bfloat16) for grouped KV heads and
non-zero query offsets.  The launch plan of the CUDA kernels and their
arithmetic (``ref.emulate_attention``) are held to the same references."""

import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_fa
from repro.kernels.flash_attention import flash_attention_bh as jax_fa_bh
from repro.kernels.flash_attention.ref import ref_flash_attention as jax_ref
from repro.models import transformer as JT
from repro.quant.qconfig import preset as jax_preset
from repro_torch.kernels.flash_attention import (block_keys, block_rows,
                                                 flash_attention,
                                                 flash_attention_bh,
                                                 flash_attention_gqa, plan)
from repro_torch.kernels.flash_attention.ref import (emulate_attention,
                                                     ref_attention_gqa)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.quant import preset

TOL = 2e-5
# the JAX model's attention, compiled once per shape (spec, numerics and
# window are static)
_jax_attention = jax.jit(JT._attention_dynwin, static_argnums=(2, 3, 5))


def _n(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("bq,bk", [(64, 64), (128, 128), (64, 128), (256, 64)])
def test_block_sweep_vs_pallas(rng, bq, bk):
    q, k, v = (_n(rng, 256, 64) for _ in range(3))
    want = jax_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bq=bq,
                  bk=bk, interpret=True)
    before = flash_attention.launches
    got = flash_attention(_t(q), _t(k), _t(v))
    assert flash_attention.launches == before   # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("sq,skv,d", [(100, 100, 32), (64, 256, 16),
                                      (1, 128, 64)])
def test_ragged_batched_vs_pallas(rng, sq, skv, d):
    q, k, v = _n(rng, 2, 2, sq, d), _n(rng, 2, 2, skv, d), _n(rng, 2, 2, skv, d)
    want = jax_fa_bh(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     interpret=True)
    got = flash_attention_bh(_t(q), _t(k), _t(v))
    assert got.shape == (2, 2, sq, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, TOL),
                                       (jnp.bfloat16, 0.03)])
def test_dtypes_vs_pallas(rng, dtype, tol):
    q, k, v = (jnp.asarray(_n(rng, 128, 32), dtype) for _ in range(3))
    want = jax_fa(q, k, v, interpret=True, bq=64, bk=64)
    tq, tk, tv = (torch.as_tensor(np.array(a.astype(jnp.float32)))
                  .to(torch.bfloat16 if dtype == jnp.bfloat16
                      else torch.float32) for a in (q, k, v))
    got = flash_attention(tq, tk, tv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def test_noncausal_vs_pallas(rng):
    q, k, v = (_n(rng, 128, 32) for _ in range(3))
    want = jax_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=False, interpret=True, bq=64, bk=64)
    got = flash_attention(_t(q), _t(k), _t(v), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d", [
    (2, 5, 40, 9, 3, 16), (3, 1, 64, 4, 1, 32), (1, 33, 33, 2, 2, 64)])
def test_gqa_with_offsets_vs_jax_reference(rng, b, sq, skv, hq, hkv, d):
    """Query head h reads KV head h // (Hq / Hkv); a start of s puts the
    queries at positions s.. of the key axis, which is the reference
    oracle on q with s leading rows, from row s on."""
    q, k, v = _n(rng, b, sq, hq, d), _n(rng, b, skv, hkv, d), \
        _n(rng, b, skv, hkv, d)
    starts = rng.integers(0, skv - sq + 1, size=b).astype(np.int32)
    got = flash_attention_gqa(_t(q), _t(k), _t(v), _t(starts)).numpy()
    kv_head = np.arange(hq) // (hq // hkv)
    # the oracle on every head at once: vmapped over the head axis
    heads = jax.jit(jax.vmap(jax_ref, in_axes=(1, 1, 1), out_axes=1))
    for i in range(b):
        s = int(starts[i])
        qpad = np.concatenate([np.zeros((s, hq, d), np.float32), q[i]])
        want = heads(jnp.asarray(qpad), jnp.asarray(k[i][:, kv_head]),
                     jnp.asarray(v[i][:, kv_head]))[s:]
        np.testing.assert_allclose(got[i], np.asarray(want), rtol=TOL,
                                   atol=TOL)


def _bf16_ulp(a):
    """One bfloat16 ulp of each element of a (8 significant bits)."""
    a = np.abs(np.asarray(a, np.float64))
    e = np.floor(np.log2(np.where(a > 0, a, 2.0 ** -126)))
    return np.exp2(np.maximum(e, -126) - 7)


def _attention_case(rng, dtype, s, index, max_len, b=2):
    """Weights, input, positions and (max_len > 0) a float32 cache, as
    numpy, for the reduced SmolLM's attention."""
    from repro_torch.configs import reduced
    cfg = reduced("smollm-135m").replace(dtype=dtype)
    dm, dh = cfg.d_model, cfg.head_dim
    p = {"wq": _n(rng, dm, cfg.n_heads * dh) / 7,
         "wk": _n(rng, dm, cfg.kv_heads * dh) / 7,
         "wv": _n(rng, dm, cfg.kv_heads * dh) / 7,
         "wo": _n(rng, cfg.n_heads * dh, dm) / 7}
    case = dict(p, x=_n(rng, b, s, dm), index=index, dtype=dtype,
                positions=np.broadcast_to(np.arange(s) + index, (b, s))
                .astype(np.int32))
    if max_len:
        case.update(cache_k=_n(rng, b, max_len, cfg.kv_heads, dh),
                    cache_v=_n(rng, b, max_len, cfg.kv_heads, dh))
    return cfg, case


def _port_attention(cfg, case):
    """The port's model attention on a case, in the case's type; the
    cache (if any) in float32, as the serving engine holds it."""
    dt = getattr(torch, case["dtype"])
    cache = None
    if "cache_k" in case:
        cache = {"k": _t(case["cache_k"]).clone(),
                 "v": _t(case["cache_v"]).clone(), "index": case["index"]}
    b = case["x"].shape[0]
    q_start = torch.full((b,), case["index"] if cache else 0,
                         dtype=torch.int32)
    return T._attention_dynwin(
        {n: _t(case[n]).to(dt) for n in ("wq", "wk", "wv", "wo")},
        _t(case["x"]).to(dt), T.attn_spec(cfg), preset("fp32"),
        torch.as_tensor(case["positions"]), q_start, cache)


def _jax_attention_of(case):
    from repro.configs import reduced as jax_reduced
    dt = jnp.dtype(case["dtype"])
    jcfg = jax_reduced("smollm-135m").replace(dtype=case["dtype"])
    jcache = None
    if "cache_k" in case:
        jcache = {"k": jnp.asarray(case["cache_k"]),
                  "v": jnp.asarray(case["cache_v"]),
                  "index": jnp.asarray(case["index"], jnp.int32)}
    return _jax_attention(
        {n: jnp.asarray(case[n], dt) for n in ("wq", "wk", "wv", "wo")},
        jnp.asarray(case["x"], dt), JT.attn_spec(jcfg), jax_preset("fp32"),
        jnp.asarray(case["positions"]), 1 << 30, jcache)


@pytest.mark.parametrize("dtype,s,index,max_len", [
    ("float32", 6, 0, 16), ("float32", 1, 9, 16), ("float32", 3, 20, 16),
    ("bfloat16", 40, 0, 0), ("bfloat16", 6, 5, 64), ("bfloat16", 1, 37, 64)])
def test_model_attention_with_cache_vs_jax(rng, dtype, s, index, max_len):
    """The model's attention (projections, RoPE, cache write, GQA 3/1,
    flash attention, output projection) against the JAX model's on the
    same weights and cache; index 20 > max_len - s exercises the clamped
    write of ``dynamic_update_slice``.  float32 within 1e-5; bfloat16
    (max_len 0: no cache; else the engine's float32 cache) within one
    bf16 ulp of each output: XLA's default excess precision skips some of
    the model's bf16 roundings (the bit-exact comparison is
    ``test_model_attention_bf16_vs_jax_bitwise``)."""
    cfg, case = _attention_case(rng, dtype, s, index, max_len)
    jout, jnew = _jax_attention_of(case)
    out, new = _port_attention(cfg, case)
    got, want = out.float().numpy(), np.asarray(jout.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert out.dtype == torch.bfloat16
        assert np.all(np.abs(got - want) <= _bf16_ulp(want)), \
            float(np.abs(got - want).max())
    if max_len:
        np.testing.assert_allclose(new["k"].numpy(), np.asarray(jnew["k"]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(new["v"].numpy(), np.asarray(jnew["v"]),
                                   rtol=1e-6, atol=1e-6)
        assert new["index"] == int(jnew["index"]) == index + s


@pytest.mark.parametrize("s,index,max_len", [(40, 0, 0), (40, 5, 64),
                                             (1, 50, 64)])
def test_model_attention_bf16_vs_jax_bitwise(rng, tmp_path, s, index,
                                             max_len):
    """bfloat16 attention without a cache and with the engine's float32
    cache equals the JAX model's bit for bit, with XLA's excess precision
    off (in a subprocess: the flag is read when JAX starts).  This needs
    the reference's type rules: P rounded to V's type before P V (without
    a cache V is bf16), and a float32 cache's V kept in float32."""
    cfg, case = _attention_case(rng, "bfloat16", s, index, max_len)
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, **case)
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    run = subprocess.run([sys.executable,
                          str(root / "tests" / "_torch_attention_ref.py"),
                          str(src), str(dst)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    want = np.load(dst)
    out, new = _port_attention(cfg, case)
    np.testing.assert_array_equal(out.float().numpy(), want["out"])
    if max_len:
        np.testing.assert_array_equal(new["v"].numpy(), want["cache_v"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_p_off_matches_pallas(rng, dtype):
    """round_p=False keeps the Pallas kernel's float32 P: the GQA entry
    (each KV head repeated for the Pallas kernel's heads) matches it in
    interpret mode within 2e-5 on the same inputs, float32 or bfloat16;
    round_p=True changes a bfloat16 result and leaves a float32 one."""
    dt = jnp.dtype(dtype)
    q = jnp.asarray(_n(rng, 2, 4, 48, 32), dt)      # (B, H, S, D)
    k = jnp.asarray(_n(rng, 2, 2, 48, 32), dt)
    v = jnp.asarray(_n(rng, 2, 2, 48, 32), dt)
    want = jax_fa_bh(q, jnp.repeat(k, 2, axis=1), jnp.repeat(v, 2, axis=1),
                     interpret=True)
    tq, tk, tv = (torch.as_tensor(np.array(a.astype(jnp.float32)))
                  .to(getattr(torch, dtype)).transpose(1, 2)
                  for a in (q, k, v))
    got = flash_attention_gqa(tq, tk, tv, round_p=False)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    rounded = flash_attention_gqa(tq, tk, tv, round_p=True)
    assert torch.equal(rounded, got) == (dtype == "float32")


# ---------------------------------------------------------------------------
# the launch plan and the kernels' arithmetic
# ---------------------------------------------------------------------------

# (b, sq, skv, hq, hkv, d): SmolLM-135M's decode and prefill (4 slots, a
# 256-row cache, GQA 9/3, head_dim 64) and ragged shapes.
PLAN_SHAPES = [(4, 1, 256, 9, 3, 64), (4, 130, 256, 9, 3, 64),
               (4, 2, 256, 9, 3, 64), (2, 33, 70, 4, 1, 32),
               (1, 64, 64, 2, 2, 16), (2, 40, 80, 4, 2, 128),
               (3, 1, 4096, 16, 1, 128), (1, 5, 7, 6, 2, 16)]
DECODE_OFFSETS = (0, 1, 63, 135, 255)


def _starts(sq, skv, offset):
    """Per-row query starts: the offset, clamped so that the last query
    is a key; row 1 one behind."""
    hi = max(0, skv - sq)
    return [min(offset, hi), max(0, min(offset, hi) - 1)]


@pytest.mark.parametrize("q_bf16", [False, True])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d", PLAN_SHAPES)
def test_launch_plan_covers_each_pair_once(b, sq, skv, hq, hkv, d, q_bf16):
    """Every (batch row, query head, query row, visible key) is visited by
    exactly one block, by the kernels' own row and key formulas, at every
    decode offset; a cluster has at most 8 blocks; keys past the causal
    limit of a tile's last query are never visited."""
    p = plan(b, sq, skv, hq, hkv, d, q_bf16)
    g = hq // hkv
    assert 1 <= p.splits <= 8
    wide = d == 256 or (d in (112, 128) and not q_bf16)
    assert p.variant == ("split" if g * sq <= 8 else "wgmma" if wide
                         else "mma")
    tiles = p.tiles
    assert tiles == -(-g * sq // p.rows)
    assert p.grid[0] == (p.splits if p.variant == "split"
                         else tiles * p.splits)
    for offset in DECODE_OFFSETS:
        for causal in (True, False):
            start = _starts(sq, skv, offset)[0]
            seen = {}
            for tile in range(tiles):
                rows = block_rows(p, tile, g, sq)
                last = max(start + i for i, _ in rows)
                for rank in range(p.splits):
                    keys = block_keys(p, tile, rank, g, sq, skv, start,
                                      causal)
                    assert not causal or keys.stop <= last + 1
                    for i, gg in rows:
                        for j in keys:
                            if not causal or j <= start + i:
                                pair = (i, gg, j)
                                seen[pair] = seen.get(pair, 0) + 1
            want = {(i, gg, j) for i in range(sq) for gg in range(g)
                    for j in range(skv) if not causal or j <= start + i}
            assert set(seen) == want and set(seen.values()) == {1}


def test_launch_plan_at_smollm_decode_and_prefill():
    """SmolLM-135M's plans: decode takes the split kernel with its 3
    query heads in one block of 4 rows, the cache split across a cluster
    of 8 (32 keys a block at most: one chunk in registers); prefill takes
    the tensor cores for float32 and bfloat16 q (64 rows a block, 84
    blocks: no key split, which would pass one block an SM); one batch row
    splits its keys across clusters of 4; a float32 q at head_dim 128
    takes the wgmma kernel."""
    d = plan(4, 1, 256, 9, 3, 64, False)
    assert d == plan(4, 1, 256, 9, 3, 64, True)
    assert (d.variant, d.rows, d.splits, d.chunk, d.grid) == (
        "split", 4, 8, 32, (8, 1, 12))
    at = [block_keys(d, 0, r, 3, 1, 256, 135, True) for r in range(8)]
    assert [len(r) for r in at] == [17] * 8
    for q_bf16 in (False, True):
        m = plan(4, 130, 256, 9, 3, 64, q_bf16)
        assert (m.variant, m.rows, m.splits, m.grid) == ("mma", 64, 1,
                                                         (7, 3, 4))
        assert block_keys(m, 6, 0, 3, 130, 256, 0, True) == range(0, 130)
    one = plan(1, 130, 256, 9, 3, 64, True)     # 21 tiles: 6 an SM
    assert (one.splits, one.grid) == (4, (28, 3, 1))
    assert [block_keys(one, 6, r, 3, 130, 256, 0, True)
            for r in range(4)] == [range(0, 64), range(64, 128),
                                   range(128, 130), range(130, 130)]
    f = plan(4, 130, 256, 9, 3, 128, False)
    assert (f.variant, f.rows, f.splits, f.grid) == ("wgmma", 64, 1,
                                                     (7, 3, 4))


# (b, sq, skv, hq, hkv, d, window): the wgmma kernel's shapes (head_dims
# 112, 128, 256; rows past one tile of 64, keys past one chunk of 64, a
# window narrower than a chunk and one across chunks, keys split across a
# cluster)
WGMMA_PLAN_SHAPES = [(2, 40, 90, 2, 1, 256, 0), (1, 70, 70, 4, 2, 112, 9),
                     (2, 33, 130, 4, 1, 128, 70), (1, 130, 130, 2, 2, 256, 0),
                     (1, 24, 1024, 4, 1, 256, 512)]


@pytest.mark.parametrize("q_bf16", [False, True])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,window", WGMMA_PLAN_SHAPES)
def test_wgmma_plan_covers_each_pair_once(b, sq, skv, hq, hkv, d, window,
                                          q_bf16):
    """At head_dims 112, 128 and 256, with and without a window, in both
    types: every (batch row, query head, query row, visible key) is
    visited by exactly one block of the plan (the wgmma kernel's prefill,
    or at 112 / 128 the mma kernel's for a bfloat16 q), by the kernels'
    own row and key formulas, and no block starts below its first row's
    window by a whole chunk."""
    p = plan(b, sq, skv, hq, hkv, d, q_bf16, window)
    g = hq // hkv
    assert p.variant == ("wgmma" if d == 256 or not q_bf16 else "mma")
    assert 1 <= p.splits <= 8 and p.tiles == -(-g * sq // 64)
    for start in (0, max(0, skv - sq)):
        seen = {}
        for tile in range(p.tiles):
            rows = block_rows(p, tile, g, sq)
            for rank in range(p.splits):
                keys = block_keys(p, tile, rank, g, sq, skv, start, True,
                                  window)
                if len(keys):
                    first = min(start + i for i, _ in rows)
                    assert keys.start > first - window - 64 if window \
                        else True
                for i, gg in rows:
                    for j in keys:
                        if j <= start + i and (not window
                                               or j > start + i - window):
                            seen[(i, gg, j)] = seen.get((i, gg, j), 0) + 1
        want = {(i, gg, j) for i in range(sq) for gg in range(g)
                for j in range(skv) if j <= start + i
                and (not window or j > start + i - window)}
        assert set(seen) == want and set(seen.values()) == {1}


# (config, q type) -> the forward's variant at decode and at prefill
MODEL_ROUTES = [("gemma3-1b", "float32", "split", "wgmma"),
                ("gemma3-1b", "bfloat16", "split", "wgmma"),
                ("gemma2-9b", "float32", "split", "wgmma"),
                ("gemma2-9b", "bfloat16", "split", "wgmma"),
                ("zamba2-7b", "float32", "split", "wgmma"),
                ("zamba2-7b", "bfloat16", "split", "mma"),
                ("smollm-135m", "float32", "split", "mma")]


@pytest.mark.parametrize("arch,q_type,decode,prefill", MODEL_ROUTES)
def test_plan_routes_each_model_and_fits_shared_memory(arch, q_type, decode,
                                                       prefill):
    """Each model's attention (its heads, head_dim and window) takes the
    split kernel at decode and the wgmma kernel at prefill where its
    head_dim or type leaves the mma kernel short; the wgmma kernels'
    shared memory (forward, and both backward kernels) fits a block."""
    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import (bwd_wgmma_plan,
                                                     wgmma_smem)
    F = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    cfg = get(arch)
    hq, hkv, d, window = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.window
    bf16 = q_type == "bfloat16"
    assert plan(4, 1, 1024, hq, hkv, d, bf16, window).variant == decode
    assert plan(4, 130, 1024, hq, hkv, d, bf16, window).variant == prefill
    if d in F.WGMMA_DIMS:
        assert wgmma_smem(d) <= F.SMEM_LIMIT
        p = bwd_wgmma_plan(d, bf16)
        assert max(p.rows_smem, p.keys_smem) <= F.SMEM_LIMIT


def _pallas_gqa(q, k, v, starts):
    """The Pallas kernel (interpret mode) on the model's layout: each KV
    head repeated for its query heads, q shifted by its start (leading
    zero rows), as ``test_gqa_with_offsets_vs_jax_reference`` does."""
    b, sq, hq, d = q.shape
    g = hq // k.shape[2]
    out = []
    for i in range(b):
        s = int(starts[i])
        qp = np.concatenate([np.zeros((s, hq, d), np.float32),
                             np.asarray(q[i], np.float32)])
        kk = np.repeat(np.asarray(k[i], np.float32), g, axis=1)
        vv = np.repeat(np.asarray(v[i], np.float32), g, axis=1)
        o = jax_fa_bh(*(jnp.asarray(a.transpose(1, 0, 2))[None]
                        for a in (qp, kk, vv)), interpret=True)
        out.append(np.asarray(o[0]).transpose(1, 0, 2)[s:])
    return np.stack(out)


EMULATED = [(2, 1, 64, 6, 2, 16, 37, False), (2, 20, 48, 4, 2, 32, 5, False),
            (1, 40, 96, 6, 2, 16, 0, True), (2, 3, 40, 4, 1, 32, 11, True),
            (2, 9, 30, 4, 2, 128, 4, False),
            # the wgmma kernel: head_dims 112 and 256, 2 heads
            (1, 40, 70, 2, 1, 112, 0, False), (2, 36, 80, 2, 1, 256, 9, True),
            (1, 70, 70, 2, 2, 256, 0, False)]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,offset,q_bf16", EMULATED)
def test_emulated_arithmetic_vs_pallas(rng, b, sq, skv, hq, hkv, d, offset,
                                       q_bf16):
    """The kernels' arithmetic (split-KV partials merged in rank order;
    the tensor cores' bf16 parts of a float32 q and K, of P and of a
    float32 V) against the Pallas kernel in interpret mode on the same
    values (q and K exact in bf16 where q is bf16), float32 P, within
    2e-5."""
    q, k, v = _n(rng, b, sq, hq, d), _n(rng, b, skv, hkv, d), \
        _n(rng, b, skv, hkv, d)
    if q_bf16:
        q, k = (torch.as_tensor(a).to(torch.bfloat16).float().numpy()
                for a in (q, k))
    starts = np.array(_starts(sq, skv, offset)[:b], np.int32)
    tq = _t(q).to(torch.bfloat16 if q_bf16 else torch.float32)
    p = plan(b, sq, skv, hq, hkv, d, q_bf16)
    got = emulate_attention(tq, _t(k), _t(v), _t(starts), p)
    np.testing.assert_allclose(got.numpy(), _pallas_gqa(q, k, v, starts),
                               rtol=TOL, atol=TOL)
    plain = ref_attention_gqa(tq, _t(k), _t(v), _t(starts))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("dtype,s,index,max_len", [
    ("float32", 1, 9, 16), ("bfloat16", 40, 0, 0), ("bfloat16", 40, 5, 64),
    ("bfloat16", 1, 37, 64)])
def test_emulated_arithmetic_in_model_vs_jax(rng, monkeypatch, dtype, s,
                                             index, max_len):
    """The model's attention with the kernels' arithmetic in place of the
    plain version (the plan the card would take for these tensors,
    round_p as the model asks) against the JAX model's: float32 within
    1e-5, bfloat16 within one bf16 ulp of each output."""
    def emulated(q, k, v, q_start, causal=True, scale=0.0, round_p=False,
                 window=0, softcap=0.0):
        b, sq, hq, d = q.shape
        p = plan(b, sq, k.shape[1], hq, k.shape[2], d,
                 q.dtype == torch.bfloat16, window)
        return emulate_attention(q, k, v, q_start, p, causal, scale, round_p,
                                 window, softcap)

    monkeypatch.setattr(T, "flash_attention_gqa", emulated)
    cfg, case = _attention_case(rng, dtype, s, index, max_len)
    jout, _ = _jax_attention_of(case)
    out, _ = _port_attention(cfg, case)
    got, want = out.float().numpy(), np.asarray(jout.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.all(np.abs(got - want) <= _bf16_ulp(want)), \
            float(np.abs(got - want).max())


def test_wrappers_refuse_bad_shapes():
    q = torch.zeros(1, 4, 6, 16)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention_gqa(q, torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 4, 16))
    with pytest.raises(ValueError, match="do not match"):
        flash_attention_gqa(q, torch.zeros(1, 8, 3, 8), torch.zeros(1, 8, 3, 8))
    with pytest.raises(ValueError, match="q_start"):
        flash_attention_gqa(q, torch.zeros(1, 8, 3, 16),
                            torch.zeros(1, 8, 3, 16),
                            torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="start \\+ arange"):
        T._positions(torch.zeros(2, 3, dtype=torch.long),
                     torch.tensor([[0, 1, 2], [5, 7, 8]]), 0)
    assert L.AttnSpec(9, 3, 64).kv_heads == 3

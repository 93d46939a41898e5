"""The plain version of the port's ``flash_attention`` kernel (what its
wrappers compute on CPU tensors) against the JAX package: the Pallas
kernel in interpret mode at the reference test's shapes and tolerances
(``tests/test_kernels.py``: 2e-5 for float32, 0.03 for bfloat16), and the
JAX model's own attention (``transformer._attention_dynwin`` with a KV
cache) for grouped KV heads and non-zero query offsets."""

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
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bh,
                                                 flash_attention_gqa)
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


@pytest.mark.parametrize("s,index,max_len", [(6, 0, 16), (1, 9, 16),
                                             (3, 20, 16)])
def test_model_attention_with_cache_vs_jax(rng, s, index, max_len):
    """The model's attention (projections, RoPE, cache write, GQA 3/1,
    flash attention, output projection) against the JAX model's on the
    same weights and cache; index 20 > max_len - s exercises the clamped
    write of ``dynamic_update_slice``."""
    from repro.configs import reduced as jax_reduced
    from repro_torch.configs import reduced
    jcfg = jax_reduced("smollm-135m").replace(dtype="float32")
    cfg = reduced("smollm-135m").replace(dtype="float32")
    b, dm = 2, cfg.d_model
    hq, hkv, dh = cfg.n_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim, \
        cfg.head_dim
    p = {"wq": _n(rng, dm, hq) / 7, "wk": _n(rng, dm, hkv) / 7,
         "wv": _n(rng, dm, hkv) / 7, "wo": _n(rng, hq, dm) / 7}
    x = _n(rng, b, s, dm)
    ck, cv = (_n(rng, b, max_len, cfg.kv_heads, dh) for _ in range(2))
    pos = np.broadcast_to(np.arange(s) + index, (b, s)).astype(np.int32)
    jcache = {"k": jnp.asarray(ck), "v": jnp.asarray(cv),
              "index": jnp.asarray(index, jnp.int32)}
    jout, jnew = _jax_attention(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), JT.attn_spec(jcfg),
        jax_preset("fp32"), jnp.asarray(pos), 1 << 30, jcache)
    cache = {"k": _t(ck), "v": _t(cv), "index": index}
    q_start = torch.full((b,), index, dtype=torch.int32)
    out, new = T._attention_dynwin({k: _t(a) for k, a in p.items()}, _t(x),
                                   T.attn_spec(cfg), preset("fp32"),
                                   torch.as_tensor(pos), q_start, cache)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(new["k"].numpy(), np.asarray(jnew["k"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(new["v"].numpy(), np.asarray(jnew["v"]),
                               rtol=1e-6, atol=1e-6)
    assert new["index"] == int(jnew["index"]) == index + s


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

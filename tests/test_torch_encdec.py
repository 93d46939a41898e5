"""The port's encoder-decoder family (``repro_torch.models.encdec``,
Whisper) against the JAX package's (``repro.models.encdec``), mirroring
the Whisper rows of ``tests/test_models.py`` (``TestFullConfigs``,
``TestSmoke``), and on the same numpy weights and inputs: ``encode``,
the loss and its gradients, ``prefill`` and ``decode_step``, under FP32
and LightPE-1 numerics in float32 and bfloat16; ``layernorm``.

The JAX side runs in a subprocess with XLA's excess precision off
(``tests/_torch_encdec_ref.py``).  Tolerances: logits and encoder states
1e-4 in float32 and 2e-2 in bfloat16 (the model tests'); the loss 1e-5
relative in float32 and 1e-3 in bfloat16; gradients 1e-4 (float32) and
1e-2 (bfloat16) of each leaf's largest.  Under LightPE-1 the port takes
the JAX activation codes at round(x / s) ties (``ActPins``, counted).
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get, reduced
from repro_torch.models import encdec as E
from repro_torch.models import family_module, layers as L

import _torch_encdec_ref as R
from _torch_act_pins import ActPins, one_torch_thread  # noqa: F401

TESTS = Path(__file__).resolve().parent
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("encdec") / "jax.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(TESTS.parent / "src"),
                                           str(TESTS)]))
    subprocess.run([sys.executable, str(TESTS / "_torch_encdec_ref.py"),
                    str(out)], env=env, check=True, timeout=600,
                   capture_output=True)
    with open(out, "rb") as f:
        return pickle.load(f)


def test_exact_hparams():
    """``TestFullConfigs``' Whisper row: the assigned hyperparameters."""
    cfg = get("whisper-medium")
    want = dict(d_model=1024, n_heads=16, kv_heads=16, d_ff=4096,
                vocab=51865, enc_layers=24, dec_layers=24, head_dim=64,
                act="gelu", tie_embeddings=True, family="encdec")
    for k, v in want.items():
        assert getattr(cfg, k) == v, k


@pytest.mark.parametrize("size", ["reduced", "full"])
def test_params_have_the_reference_layout(size):
    """``param_shapes`` (no allocation) is the JAX package's
    ``init_params`` tree shape for shape, at full size too (Whisper-medium
    has 791,670,784 float32 parameters with its decoder position table of
    ``MAX_DEC_POS`` rows); at the reduced size so are ``numpy_params``,
    the port's ``init_params`` and the numpy params carried across by
    ``convert.params_from_numpy``, value for value."""
    from repro.configs import get as jax_get, reduced as jax_reduced
    from repro.models import encdec as JE
    jcfg = (jax_get if size == "full" else jax_reduced)("whisper-medium")
    cfg = (get if size == "full" else reduced)("whisper-medium")
    want = jax.tree.map(lambda a: a.shape, jax.eval_shape(
        lambda key: JE.init_params(jcfg, key), jax.random.PRNGKey(0)))
    shapes = E._nest({k: s for k, (s, _) in E.param_shapes(cfg).items()})
    assert shapes == want
    assert E.MAX_DEC_POS == JE.MAX_DEC_POS
    if size == "full":
        # per layer 4 d^2 of attention (the decoder's twice), 2 d f of MLP
        # and 2 d a LayerNorm; the tied table, the position table, 2 final
        # LayerNorms
        d, f = cfg.d_model, cfg.d_ff
        enc = 4 * d * d + 2 * d * f + 2 * 2 * d
        dec = 8 * d * d + 2 * d * f + 3 * 2 * d
        n = (24 * enc + 24 * dec + cfg.padded_vocab * d
             + E.MAX_DEC_POS * d + 2 * 2 * d)
        assert n == 791_670_784
        assert sum(int(np.prod(s)) for s, _ in
                   E.param_shapes(cfg).values()) == n
        return
    arrays = E.numpy_params(cfg, 0)
    assert jax.tree.map(lambda a: a.shape, arrays) == want
    port = E.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), port) == want
    carried = convert.params_from_numpy(arrays, "cpu")
    for a, t in zip(jax.tree.leaves(arrays), jax.tree.leaves(carried)):
        assert t.dtype == torch.float32 and np.array_equal(a, t.numpy())


def test_family_and_supported():
    cfg = reduced("whisper-medium")
    assert family_module(cfg) is E
    E.check_supported(cfg)
    with pytest.raises(NotImplementedError, match="lm"):
        E.check_supported(reduced("smollm-135m"))


def _port_batch(cfg):
    return {k: torch.as_tensor(v) for k, v in R.inputs(cfg).items()}


def test_train_step_shapes_no_nans():
    """``TestSmoke.test_train_step_shapes_no_nans``'s Whisper row: a finite
    loss and finite gradients for every parameter."""
    cfg = reduced("whisper-medium")
    params = E.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    leaves = jax.tree.leaves(params)
    for t in leaves:
        t.requires_grad_()
    loss = E.loss_fn(params, _port_batch(cfg), cfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert np.isfinite(float(loss))
    assert all(g is not None and bool(torch.isfinite(g).all())
               for g in grads)


def test_forward_shapes():
    """``TestSmoke.test_forward_shapes``'s Whisper row: the encoder's
    states, and the decoder's logits at prefill and decode."""
    cfg = reduced("whisper-medium")
    params = E.init_params(cfg, torch.Generator().manual_seed(1),
                           device="cpu")
    b, s = 2, 16
    frames = torch.randn((b, s, cfg.d_model),
                         generator=torch.Generator().manual_seed(2))
    enc = E.encode(params, frames, cfg)
    assert enc.shape == (b, s, cfg.d_model) and enc.dtype == torch.bfloat16
    cache = E.init_cache(cfg, b, 8, torch.float32, device="cpu")
    toks = torch.zeros((b, 3), dtype=torch.long)
    logits, cache, enc = E.prefill(params, {"frames": frames,
                                            "tokens": toks}, cfg, cache)
    assert logits.shape == (b, 1, cfg.padded_vocab)
    assert cache["index"] == [3] * cfg.dec_layers
    logits, cache = E.decode_step(params, toks[:, :1], enc, cfg, cache)
    assert logits.shape == (b, 1, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())
    assert cache["index"] == [4] * cfg.dec_layers


def test_decode_steps_match_prefill():
    """Decode token by token == the prefill of the same prefix (float32:
    1e-5), the cross-attention over the same encoder states."""
    cfg = reduced("whisper-medium").replace(dtype="float32")
    params = convert.params_from_numpy(E.numpy_params(cfg, 0), "cpu")
    b = _port_batch(cfg)
    cache = E.init_cache(cfg, R.BATCH, R.MAX_LEN, torch.float32,
                         device="cpu")
    _, cache, enc = E.prefill(params, {"frames": b["frames"],
                                       "tokens": b["tokens"][:, :4]},
                              cfg, cache)
    got, _ = E.decode_step(params, b["tokens"][:, 4:5], enc, cfg, cache)
    full = E.init_cache(cfg, R.BATCH, R.MAX_LEN, torch.float32, device="cpu")
    want, _, _ = E.prefill(params, {"frames": b["frames"],
                                    "tokens": b["tokens"][:, :5]}, cfg, full)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("pe,dtype", R.CASES)
def test_model_matches_jax(jax_runs, pe, dtype, monkeypatch,
                           record_property):
    want = jax_runs[(pe, dtype)]
    cfg = reduced(R.CONFIG).replace(pe_type=pe, dtype=dtype)
    params = convert.params_from_numpy(E.numpy_params(cfg, 0), "cpu")
    b = _port_batch(cfg)
    pins = ActPins(monkeypatch)
    tol = TOL[dtype]

    pins.load(want["encode_acts"])
    enc = E.encode(params, b["frames"], cfg)
    assert pins.done()
    np.testing.assert_allclose(enc.float().numpy(), want["encode"], rtol=0,
                               atol=tol)

    # the pins are taken in the forward's call order; each layer's
    # recomputation in the backward would call the activations' quantizer
    # again, and it changes no value (tests/test_torch_remat.py)
    monkeypatch.setattr(L, "remat", lambda fn, *args: fn(*args))
    pins.load(want["loss_acts"])
    ps = jax.tree.map(lambda t: t.clone().requires_grad_(), params)
    loss = E.loss_fn(ps, b, cfg)
    assert pins.done()
    np.testing.assert_allclose(float(loss), want["loss"],
                               rtol=LOSS_RTOL[dtype])
    grads = torch.autograd.grad(loss, jax.tree.leaves(ps))
    assert len(grads) == len(want["grads"])
    for g, w in zip(grads, want["grads"]):
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0,
            atol=GRAD_TOL[dtype] * max(np.abs(w).max(), 1e-6))

    pins.load(want["step_acts"])
    cache = E.init_cache(cfg, R.BATCH, R.MAX_LEN, torch.float32,
                         device="cpu")
    logits, cache, enc = E.prefill(
        params, {"frames": b["frames"], "tokens": b["tokens"][:, :R.PROMPT]},
        cfg, cache)
    steps = [logits.float().numpy()]
    for i in range(R.PROMPT, R.SEQ):
        logits, cache = E.decode_step(params, b["tokens"][:, i:i + 1], enc,
                                      cfg, cache)
        steps.append(logits.float().numpy())
    assert pins.done()
    record_property("activation_codes_pinned", pins.pinned)
    np.testing.assert_allclose(np.concatenate(steps, axis=1), want["steps"],
                               rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    """LayerNorm with the biased variance (``jnp.var``): float32 within
    1e-6, bfloat16 within one bfloat16 step of the output's scale."""
    from repro.models import layers as JL
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 5, 64)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(JL.layernorm(jnp.asarray(x).astype(dtype),
                                   jnp.asarray(scale), jnp.asarray(bias)),
                      np.float32)
    got = L.layernorm(torch.as_tensor(x).to(getattr(torch, dtype)),
                      torch.as_tensor(scale), torch.as_tensor(bias))
    assert str(got.dtype).endswith(dtype)
    atol = 1e-6 if dtype == "float32" else 2 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)
    # torch's default (unbiased) variance would be another function
    unbiased = (torch.as_tensor(x) - torch.as_tensor(x).mean(-1, True)) \
        / torch.sqrt(torch.as_tensor(x).var(-1, keepdim=True) + 1e-5)
    if dtype == "float32":
        assert not np.allclose(unbiased.numpy() * scale + bias, want,
                               atol=1e-4)


def test_attention_matches_jax_at_offset_positions():
    """The unified attention against the JAX package's on one layer, with
    positions 7 + arange(S): causal with no cache (the keys are the
    queries, so only offsets mask), causal over a cache written at 7,
    bidirectional, and cross over 11 encoder rows (float32: 1e-5)."""
    from repro.models import layers as JL
    from repro.quant.qconfig import preset as jax_preset
    from repro_torch.quant import preset
    rng = np.random.default_rng(5)
    d, b, s = 32, 2, 6
    spec = L.AttnSpec(n_heads=4, kv_heads=2, head_dim=8)
    jspec = JL.AttnSpec(n_heads=4, kv_heads=2, head_dim=8)
    params = {k: rng.standard_normal(sh).astype(np.float32) / 4
              for k, sh in (("wq", (d, 32)), ("wk", (d, 16)), ("wv", (d, 16)),
                            ("wo", (32, d)))}
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    enc = rng.standard_normal((b, 11, d)).astype(np.float32)
    pos = np.broadcast_to(7 + np.arange(s), (b, s)).astype(np.int32)
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    for kw, jkw in ((dict(), dict()),
                    (dict(mask_mode="full"), dict(mask_mode="full")),
                    (dict(cross_kv=torch.as_tensor(enc)),
                     dict(cross_kv=jnp.asarray(enc)))):
        got, _ = L.attention(tp, torch.as_tensor(x), spec, preset("fp32"),
                             torch.as_tensor(pos), **kw)
        want, _ = JL.attention(jp, jnp.asarray(x), jspec, jax_preset("fp32"),
                               jnp.asarray(pos), **jkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5, err_msg=str(list(kw)))
    cache = L.make_cache(b, 16, spec, torch.float32, device="cpu")
    cache["index"] = 7
    jcache = JL.make_cache(b, 16, jspec, jnp.float32)
    jcache["index"] = jnp.asarray(7, jnp.int32)
    got, cache = L.attention(tp, torch.as_tensor(x), spec, preset("fp32"),
                             torch.as_tensor(pos), cache)
    want, jcache = JL.attention(jp, jnp.asarray(x), jspec, jax_preset("fp32"),
                                jnp.asarray(pos), jcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert cache["index"] == int(jcache["index"]) == 13

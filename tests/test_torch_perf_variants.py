"""The port's perf variants (mirroring ``tests/test_perf_variants.py``,
except ``TestHLOAnalysis``, which belongs to the launch layer) and each
against the JAX package's same variant, on the same numpy weights and
inputs: block-local attention (``attn_block_local``), KV-head
replication (``kv_replicate_to``), the mixed-precision context
(``compute_dtype``), the EP MoE's fallback with no mesh
(``moe_ep_shard_map``) and chunked flash prefill (``attn_flash``).

Tolerances: within the port, the reference test's own (block-local 2e-3
logits and 5e-3 gradients, KV replication 2e-3, flash 1e-4 and 1e-5 at
the unit, EP 1e-6); across the packages in float32 1e-4 on logits (the
order of float32 sums, as the model tests) and 1e-4 relative on
gradients.  Under LightPE-1 the port takes the JAX activation codes at
round(x / s) ties (``_torch_act_pins.ActPins``, counted).  In bfloat16
under ``compute_dtype`` (in this process XLA keeps bfloat16 intermediates
in float32, ROADMAP C) the loss is held at 1e-2 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as jax_reduced
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.flash_attn import flash_attention as jax_flash
from repro.models.layers import compute_dtype as jax_compute_dtype
from repro.quant.qconfig import preset as jax_preset
from repro_torch import convert
from repro_torch.configs import reduced
from repro_torch.models import family_module, moe as MOE
from repro_torch.models import transformer as T
from repro_torch.models.block_attn import block_local_attention, block_size
from repro_torch.models.flash_attn import flash_attention
from repro_torch.models.layers import compute_dtype, qdense
from repro_torch.quant import preset

from _torch_act_pins import (ActPins, jax_act_log,  # noqa: F401
                             one_torch_thread)

TOL = 1e-4


def _setup(arch, seq=32, batch=2, pe="fp32", dtype="float32", seed=1,
           **knobs):
    """(port cfg, JAX cfg, port params, JAX params, tokens (numpy))."""
    cfg = reduced(arch).replace(pe_type=pe, dtype=dtype, **knobs)
    jcfg = jax_reduced(arch).replace(pe_type=pe, dtype=dtype, **knobs)
    arrays = T.numpy_params(cfg, 0)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab,
                                                size=(batch, seq))
    return (cfg, jcfg, convert.params_from_numpy(arrays, "cpu"),
            jax.tree.map(jnp.asarray, arrays), toks)


def _jax_forward(params, toks, cfg):
    return np.asarray(jax.jit(JT.forward, static_argnums=2)(
        params, jnp.asarray(toks), cfg), np.float32)


class TestBlockLocalAttention:
    @pytest.mark.parametrize("arch", ["gemma3-1b", "gemma2-9b"])
    def test_matches_masked_full(self, arch):
        """The grouped backbone's block-local local layers equal the
        baseline's masked full attention (2e-3), and the JAX package's
        block-local forward (1e-4), at a sequence of 4 blocks."""
        cfg, jcfg, params, jparams, toks = _setup(arch, seq=64)
        local = cfg.replace(attn_block_local=True)
        assert block_size(64, cfg.window) == 64 and cfg.window < 64
        base = T.forward(params, torch.as_tensor(toks), cfg).numpy()
        fast = T.forward(params, torch.as_tensor(toks), local).numpy()
        np.testing.assert_allclose(base, fast, rtol=2e-3, atol=2e-3)
        want = _jax_forward(jparams, toks,
                            jcfg.replace(attn_block_local=True))
        np.testing.assert_allclose(fast, want, rtol=0, atol=TOL)

    def test_lightpe1_matches_jax_with_pins(self, monkeypatch,
                                            record_property):
        """Under LightPE-1 numerics, the activation codes at rounding
        ties pinned to JAX's (counted)."""
        cfg, jcfg, params, jparams, toks = _setup(
            "gemma3-1b", seq=64, pe="lightpe1", attn_block_local=True)
        with jax_act_log() as acts:
            want = _jax_forward(jparams, toks, jcfg)
            calls = acts.drain()
        pins = ActPins(monkeypatch)
        pins.load(calls)
        got = T.forward(params, torch.as_tensor(toks), cfg).numpy()
        assert pins.done()
        record_property("activation_codes_pinned", pins.pinned)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)

    def test_gradients_match(self):
        """Block-local gradients equal the baseline's (5e-3) and the JAX
        package's block-local gradients (1e-4 of each leaf's largest)."""
        cfg, jcfg, params, jparams, toks = _setup("gemma3-1b", seq=32,
                                                  batch=1)
        batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
        local = cfg.replace(attn_block_local=True)

        def grads(c):
            ps = jax.tree.map(lambda t: t.clone().requires_grad_(), params)
            loss = T.loss_fn(ps, {k: torch.as_tensor(v)
                                  for k, v in batch.items()}, c)
            leaves = jax.tree.leaves(ps)
            return [g.numpy() for g in torch.autograd.grad(loss, leaves)]

        g1, g2 = grads(cfg), grads(local)
        for a, b in zip(g1, g2):
            np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-3)
        jg = jax.tree.leaves(jax.grad(JT.loss_fn)(
            jparams, jax.tree.map(jnp.asarray, batch),
            jcfg.replace(attn_block_local=True)))
        assert len(jg) == len(g2)
        for a, b in zip(g2, jg):
            b = np.asarray(b)
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=TOL * max(np.abs(b).max(), 1e-6))

    @pytest.mark.parametrize("s,window,softcap", [(128, 40, 0.0),
                                                  (128, 7, 3.0),
                                                  (96, 40, 0.0)])
    def test_unit_matches_jax(self, s, window, softcap):
        """``block_local_attention`` against the JAX package's on one
        layer's q, k, v (positions offset by 5), and against the exact
        windowed attention where the reference's block is at least the
        window; at S = 96 the reference's blocks of 32 are narrower than
        a window of 40, which the plain version mirrors (and the kernel
        path, which computes the exact window, refuses)."""
        from repro.models.block_attn import block_local_attention as jax_bl
        from repro_torch.kernels.flash_attention.ref import ref_attention_gqa
        rng = np.random.default_rng(0)
        b, h, g, d = 2, 2, 2, 16
        q, k, v = (rng.standard_normal(sh).astype(np.float32)
                   for sh in ((b, s, h, g, d), (b, s, h, d), (b, s, h, d)))
        pos = np.ascontiguousarray(np.broadcast_to(5 + np.arange(s), (b, s)))
        got = block_local_attention(*map(torch.as_tensor, (q, k, v, pos)),
                                    window, softcap, 0.0)
        want = jax_bl(*map(jnp.asarray, (q, k, v, pos)), window, softcap,
                      0.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
        exact = ref_attention_gqa(
            torch.as_tensor(q).reshape(b, s, h * g, d), torch.as_tensor(k),
            torch.as_tensor(v), torch.zeros(b, dtype=torch.int32),
            window=window, softcap=softcap).reshape(b, s, h, g, d)
        err = float((got - exact).abs().max())
        if block_size(s, window) >= window:
            assert err <= 1e-5
        else:
            assert block_size(s, window) == 32 and err > 1e-2


class TestKVReplication:
    def test_decode_matches_baseline(self):
        """Replicated KV heads give the baseline forward's logits at
        prefill and decode (2e-3), and the JAX package's replicated run
        (1e-4)."""
        cfg, jcfg, params, jparams, toks = _setup("qwen3-32b", seq=12,
                                                  batch=1, seed=2)
        cfg_kv, jcfg_kv = (c.replace(kv_replicate_to=4) for c in (cfg, jcfg))
        cache = T.init_cache(cfg_kv, 1, 16, torch.float32, device="cpu")
        t = torch.as_tensor(toks)
        logits, cache = T.prefill(params, t[:, :8], cfg_kv, cache)
        ref = T.forward(params, t[:, :8], cfg)
        np.testing.assert_allclose(logits[:, -1].numpy(),
                                   ref[:, -1].numpy(), atol=2e-3)
        lg, _ = T.decode_step(params, t[:, 8:9], cfg_kv, cache)
        ref2 = T.forward(params, t[:, :9], cfg)
        np.testing.assert_allclose(lg[:, 0].numpy(), ref2[:, -1].numpy(),
                                   atol=2e-3)
        jcache = JT.init_cache(jcfg_kv, 1, 16, jnp.float32)
        jl, jcache = JT.prefill(jparams, jnp.asarray(toks[:, :8]), jcfg_kv,
                                jcache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0,
                                   atol=TOL)
        jl2, _ = JT.decode_step(jparams, jnp.asarray(toks[:, 8:9]), jcfg_kv,
                                jcache)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl2), rtol=0,
                                   atol=TOL)

    def test_cache_shape_padded(self):
        cfg = reduced("qwen3-32b").replace(kv_replicate_to=4)
        cache = T.init_cache(cfg, 1, 16, torch.float32, device="cpu")
        assert cache["scan"]["k"].shape[-2] == 4  # padded heads
        jcache = JT.init_cache(jax_reduced("qwen3-32b").replace(
            kv_replicate_to=4), 1, 16, jnp.float32)
        assert tuple(cache["scan"]["k"].shape) == jcache["scan"]["k"].shape


class TestMixedPrecision:
    def test_context_casts(self):
        x = torch.ones((2, 8), dtype=torch.float32)
        w = torch.ones((8, 4), dtype=torch.float32)
        with compute_dtype(torch.bfloat16):
            y = qdense(x, w, preset("fp32"))
            assert qdense(x, w, preset("fp32"), cast=torch.float32).dtype \
                == torch.float32
        assert y.dtype == torch.bfloat16
        y2 = qdense(x, w, preset("fp32"))
        assert y2.dtype == torch.float32

    def test_packed_codes_under_a_cast_raise(self):
        """The reference rounds the dequantized weight to the cast type
        before its product, and so does ``quant_matmul`` under a bfloat16
        cast: the packed path under ``compute_dtype(bfloat16)`` gives the
        JAX package's bfloat16 product (within one bfloat16 step, 2^-7
        relative: the float32 sums run in another order); a cast to a
        type the kernel does not round to (float16) still raises."""
        from repro.models.layers import qdense as jax_qdense
        from repro_torch.serve import quantize_params
        w = torch.randn(64, 32, generator=torch.Generator().manual_seed(0))
        x = torch.randn(2, 64, generator=torch.Generator().manual_seed(1))
        packed = quantize_params({"w": w}, "int8", min_size=1)["w"]
        with compute_dtype(torch.bfloat16):
            got = qdense(x, packed, preset("fp32"))
        assert got.dtype == torch.bfloat16
        jw = {k: jnp.asarray(v.numpy()) for k, v in packed.items()}
        with jax_compute_dtype(jnp.bfloat16):
            want = jax_qdense(jnp.asarray(x.numpy()), jw, jax_preset("fp32"))
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=2.0 ** -7, atol=0)
        with compute_dtype(torch.float16):
            with pytest.raises(NotImplementedError, match="float16"):
                qdense(x, packed, preset("fp32"))

    @pytest.mark.parametrize("pe", ["fp32", "lightpe1"])
    def test_loss_finite_and_matches_jax(self, pe):
        """The loss under ``compute_dtype(bfloat16)`` is finite and within
        1e-2 relative of the JAX package's under its context."""
        cfg, jcfg, params, jparams, toks = _setup("smollm-135m", seq=16,
                                                  batch=1, pe=pe,
                                                  dtype="bfloat16")
        mod = family_module(cfg)
        batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
        with compute_dtype(torch.bfloat16):
            loss = mod.loss_fn(params, {k: torch.as_tensor(v)
                                        for k, v in batch.items()}, cfg)
        assert np.isfinite(float(loss))
        with jax_compute_dtype(jnp.bfloat16):
            want = JT.loss_fn(jparams, jax.tree.map(jnp.asarray, batch), jcfg)
        np.testing.assert_allclose(float(loss), float(want), rtol=1e-2)


class TestEPMoEFallback:
    def test_falls_back_without_mesh(self):
        """With no mesh the JAX package's EP layer falls back to
        ``moe_apply``, which the port runs under ``moe_ep_shard_map``
        (1e-4 between them)."""
        cfg = reduced("deepseek-moe-16b").replace(capacity_factor=8.0)
        jcfg = jax_reduced("deepseek-moe-16b").replace(capacity_factor=8.0)
        arrays = jax.tree.map(lambda a: a[0],
                              T.numpy_params(cfg, 0)["layers"]["moe"])
        x = np.random.default_rng(1).standard_normal(
            (2, 8, cfg.d_model)).astype(np.float32)
        p = convert.params_from_numpy(arrays, "cpu")
        b = MOE.moe_apply(p, torch.as_tensor(x), cfg, preset("fp32"))
        want = JM.moe_apply_ep(jax.tree.map(jnp.asarray, arrays),
                               jnp.asarray(x), jcfg, jax_preset("fp32"))
        np.testing.assert_allclose(b.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL)

    def test_model_with_ep_matches_jax(self):
        cfg, jcfg, params, jparams, toks = _setup(
            "phi3.5-moe-42b-a6.6b", seq=8, moe_ep_shard_map=True)
        got = T.forward(params, torch.as_tensor(toks), cfg).numpy()
        np.testing.assert_allclose(got, _jax_forward(jparams, toks, jcfg),
                                   rtol=0, atol=TOL)


class TestFlashAttention:
    @pytest.mark.parametrize("arch", ["qwen3-32b", "smollm-135m",
                                      "phi3.5-moe-42b-a6.6b"])
    def test_matches_baseline_f32(self, arch):
        """Chunked online-softmax prefill == masked full attention (1e-4),
        and the JAX package's flash forward (1e-4)."""
        cfg, jcfg, params, jparams, toks = _setup(arch)
        base = T.forward(params, torch.as_tensor(toks), cfg).numpy()
        fast = T.forward(params, torch.as_tensor(toks),
                         cfg.replace(attn_flash=True)).numpy()
        np.testing.assert_allclose(base, fast, rtol=1e-4, atol=1e-4)
        want = _jax_forward(jparams, toks, jcfg.replace(attn_flash=True))
        np.testing.assert_allclose(fast, want, rtol=0, atol=TOL)

    def test_unit_vs_reference_blocks(self, rng):
        B, S, H, G, D = 1, 32, 2, 2, 8
        q = rng.normal(size=(B, S, H, G, D)).astype(np.float32)
        k = rng.normal(size=(B, S, H, D)).astype(np.float32)
        v = rng.normal(size=(B, S, H, D)).astype(np.float32)
        pos = np.arange(S)[None, :]
        sc = 1 / np.sqrt(D)
        logits = np.einsum("bqhgd,bkhd->bhgqk", q, k) * sc
        logits = np.where(pos[:, None, None, None, :]
                          <= pos[:, None, None, :, None], logits, -1e30)
        p = np.exp(logits - logits.max(-1, keepdims=True))
        ref = np.einsum("bhgqk,bkhd->bqhgd", p / p.sum(-1, keepdims=True), v)
        tq, tk, tv, tp = map(torch.as_tensor, (q, k, v, pos))
        for bk in (4, 8, 32):
            out = flash_attention(tq, tk, tv, tp, tp, 1 << 30, 0.0, 0.0,
                                  block_k=bk)
            np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5,
                                       atol=1e-5, err_msg=f"bk={bk}")
            want = jax_flash(*map(jnp.asarray, (q, k, v, pos, pos)),
                             1 << 30, 0.0, 0.0, block_k=bk)
            np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-6, err_msg=f"bk={bk}")

    def test_gradients_match_jax(self):
        """The flash path's gradients (the reference differentiates its
        scan; the port its plain version here, the backward kernel on the
        card) within 1e-4 of each leaf's largest."""
        cfg, jcfg, params, jparams, toks = _setup("smollm-135m", seq=16,
                                                  batch=1, attn_flash=True)
        batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
        ps = jax.tree.map(lambda t: t.clone().requires_grad_(), params)
        loss = T.loss_fn(ps, {k: torch.as_tensor(v)
                              for k, v in batch.items()}, cfg)
        got = torch.autograd.grad(loss, jax.tree.leaves(ps))
        jg = jax.tree.leaves(jax.grad(JT.loss_fn)(
            jparams, jax.tree.map(jnp.asarray, batch), jcfg))
        for a, b in zip(got, jg):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=TOL * max(np.abs(b).max(), 1e-6))

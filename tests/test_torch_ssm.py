"""The port's SSM and hybrid families against the JAX package:
``ssm_common`` (the chunked linear attention and its decode step),
RWKV6 (``rwkv``) and Zamba2 (``mamba``, ``hybrid``), reduced
(``configs.reduced``), on the same numpy weights, under FP32 and
LightPE-1 numerics, in float32 and bfloat16: ``forward``, ``prefill``, a
``decode_step`` sequence and ``loss_fn`` with its gradients.  Also the
rows of the reference's ``TestSSMCommon``, ``TestFullConfigs`` and
``TestSmoke`` for these two models, head_dim 112 in the attention's plain
version and plan, ``qdense`` on packed codes under a bfloat16 cast, the
serving packer's full-width failures in both packages, the serving
engine on both reduced models (dense and packed) and the phase-13
reference file's format.

The model runs' JAX side runs in a subprocess with XLA's excess
precision off (``tests/_torch_ssm_ref.py --cases``), where bfloat16 is
rounded where the source rounds it; the tolerances are the decoder
tests': 1e-4 in float32, 2e-2 in bfloat16, on each of 4 token seeds.
Under LightPE-1 an 8-bit activation code at a round(x / s) tie may
differ by one step between the packages; the port takes the JAX code
there (``_torch_act_pins.ActPins``), counted.  In bfloat16 the rounding
of a norm, a time or channel mix, a Mamba2 block's output or a shared
block's attention or MLP output may differ by one bfloat16 step where
both float32 values sit at the midpoint; the port takes the JAX rounding
there (``RoundPins`` at ``SSM_ROUND_SITES``), counted.  Any other
difference fails, except that RWKV's gated time-mix output is rounded
inside the layer where no site pins: a difference there ends the pins
for the run (counted), and the logits still take the tolerance.
"""

import json
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
from repro_torch.models import family_module, hybrid, mamba, rwkv
from repro_torch.models import params as P
from repro_torch.models import ssm_common as SSM
from repro_torch.serve import ServeEngine, check, quantize_params

import _torch_decoder_ref as D
import _torch_ssm_ref as R
from _torch_act_pins import (SSM_ROUND_SITES, ActPins, RoundPins,  # noqa: F401
                             one_torch_thread)

TESTS = Path(__file__).resolve().parent
NAMES = tuple(R.CUT_LAYERS)
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("ssm") / "jax.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(TESTS.parent / "src"),
                                           str(TESTS)]))
    subprocess.run([sys.executable, str(TESTS / "_torch_ssm_ref.py"),
                    "--cases", str(out)], env=env, check=True, timeout=600,
                   capture_output=True)
    with open(out, "rb") as f:
        return pickle.load(f)


def _port_params(cfg):
    return convert.params_from_numpy(family_module(cfg).numpy_params(cfg, 0),
                                     "cpu")


def _port_run(name, pe, dtype, seed, pins, want):
    """The port's forward, prefill and decode steps on the JAX run's
    inputs, ``pins`` (an ``ActPins`` and a ``RoundPins``) loaded with its
    logs."""
    cfg = reduced(name).replace(pe_type=pe, dtype=dtype)
    mod = family_module(cfg)
    params = _port_params(cfg)
    toks = torch.as_tensor(D.tokens(cfg.vocab, seed))
    out = {}
    for pin, key in zip(pins, ("forward_acts", "forward_rounds")):
        pin.load(want[key])
    out["forward"] = mod.forward(params, toks, cfg).float().numpy()
    assert all(pin.done() for pin in pins)
    for pin, key in zip(pins, ("step_acts", "step_rounds")):
        pin.load(want[key])
    cache = mod.init_cache(cfg, D.BATCH, D.MAX_LEN, torch.float32,
                           device="cpu")
    logits, cache = mod.prefill(params, toks[:, :D.PROMPT], cfg, cache)
    steps = [logits.float().numpy()]
    for i in range(D.PROMPT, D.SEQ):
        logits, cache = mod.decode_step(params, toks[:, i:i + 1], cfg, cache)
        steps.append(logits.float().numpy())
    out["steps"] = np.concatenate(steps, axis=1)
    assert all(pin.done() for pin in pins)
    return out


@pytest.mark.parametrize("seed", R.TOKEN_SEEDS)
@pytest.mark.parametrize("name,pe,dtype", R.CASES)
def test_model_matches_jax(jax_runs, name, pe, dtype, seed, monkeypatch,
                           record_property):
    """forward, prefill and 3 decode steps within ``LOGIT_TOL`` of the
    JAX package, activation codes and bfloat16 roundings pinned at ties
    only."""
    want = jax_runs[(name, pe, dtype)][seed]
    acts = ActPins(monkeypatch)
    # RWKV rounds its gated time-mix output inside (o * g), where no site
    # pins: a difference there ends the rounding pins for the run
    rounds = RoundPins(monkeypatch, strict=name != "rwkv6-1.6b",
                       sites=SSM_ROUND_SITES)
    got = _port_run(name, pe, dtype, seed, (acts, rounds), want)
    record_property("activation_codes_pinned", acts.pinned)
    record_property("bf16_roundings_pinned", rounds.pinned)
    record_property("bf16_rounding_pins_ended", rounds.ended)
    tol = LOGIT_TOL[dtype]
    for key in ("forward", "steps"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=tol,
                                   err_msg=f"{name} {pe} {dtype} {key}")


# ---------------------------------------------------------------------------
# ssm_common against the JAX package (float32, 1e-4)
# ---------------------------------------------------------------------------

SSM_TOL = 1e-4


def _ssm_inputs(seed, b=2, s=32, h=3, dk=4, dv=5):
    rng = np.random.default_rng(seed)
    r, k = (rng.standard_normal((b, s, h, dk), dtype=np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, s, h, dv), dtype=np.float32)
    lw = -np.abs(rng.standard_normal((b, s, h, dk), dtype=np.float32)) * 2
    u = rng.standard_normal((h, dk), dtype=np.float32)
    s0 = rng.standard_normal((b, h, dk, dv), dtype=np.float32)
    return r, k, v, lw, u, s0


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("bonus", [True, False])
@pytest.mark.parametrize("chunk", [16, 8, 2, 1])
def test_chunked_linear_attention_matches_jax(chunk, bonus, carry):
    """The chunked form against the reference's at chunk 16, 8, 2 and 1
    (log-decays down to the clamp and below), with the bonus u (RWKV) and
    without (Mamba2), from zeros and from a state: output and final state
    within 1e-4."""
    from repro.models.ssm_common import chunked_linear_attention as jax_cla
    r, k, v, lw, u, s0 = _ssm_inputs(chunk)
    kw = dict(u=u if bonus else None, chunk=chunk,
              initial_state=s0 if carry else None)
    want_o, want_s = jax_cla(*map(jnp.asarray, (r, k, v, lw)),
                             **{k_: None if a is None else jnp.asarray(a)
                                for k_, a in kw.items() if k_ != "chunk"},
                             chunk=chunk)
    got_o, got_s = SSM.chunked_linear_attention(
        *map(torch.as_tensor, (r, k, v, lw)),
        **{k_: None if a is None else torch.as_tensor(a)
           for k_, a in kw.items() if k_ != "chunk"}, chunk=chunk)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               rtol=SSM_TOL, atol=SSM_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=SSM_TOL, atol=SSM_TOL)


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("bonus", [True, False])
def test_single_step_matches_jax(bonus, carry):
    """One decode step against the reference's: output and state within
    1e-4."""
    from repro.models.ssm_common import single_step as jax_step
    r, k, v, lw, u, s0 = (a[:, 0] if a.ndim == 4 and a.shape[1] == 32
                          else a for a in _ssm_inputs(7))
    uu = u if bonus else None
    st = s0 if carry else None
    want = jax_step(*map(jnp.asarray, (r, k, v, lw)),
                    None if uu is None else jnp.asarray(uu),
                    None if st is None else jnp.asarray(st))
    got = SSM.single_step(*map(torch.as_tensor, (r, k, v, lw)),
                          None if uu is None else torch.as_tensor(uu),
                          None if st is None else torch.as_tensor(st))
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=SSM_TOL,
                                   atol=SSM_TOL)


class TestSSMCommon:
    """The reference's ``tests/test_models.py::TestSSMCommon`` on the
    port."""

    def test_chunked_matches_naive(self):
        r, k, v, lw, u, _ = (torch.as_tensor(a) for a in _ssm_inputs(
            0, s=32, h=2, dk=4, dv=4))
        lw = lw / 2
        o16, s16 = SSM.chunked_linear_attention(r, k, v, lw, u, chunk=16)
        o8, s8 = SSM.chunked_linear_attention(r, k, v, lw, u, chunk=8)
        np.testing.assert_allclose(o16, o8, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(s16, s8, rtol=1e-4, atol=1e-4)

    def test_state_carries_across_calls(self):
        """prefill(x[:16]) then prefill(x[16:]) == prefill(x)."""
        r, k, v, lw, u, _ = (torch.as_tensor(a) for a in _ssm_inputs(
            1, b=1, s=32, h=2, dk=4, dv=4))
        lw = lw / 2
        o_full, s_full = SSM.chunked_linear_attention(r, k, v, lw, u,
                                                      chunk=16)
        o1, s1 = SSM.chunked_linear_attention(
            r[:, :16], k[:, :16], v[:, :16], lw[:, :16], u, chunk=16)
        o2, s2 = SSM.chunked_linear_attention(
            r[:, 16:], k[:, 16:], v[:, 16:], lw[:, 16:], u, chunk=16,
            initial_state=s1)
        np.testing.assert_allclose(torch.cat([o1, o2], 1), o_full,
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(s2, s_full, rtol=1e-4, atol=1e-4)

    def test_steps_match_chunks(self):
        """single_step token by token == the chunked prompt (1e-4)."""
        r, k, v, lw, u, _ = (torch.as_tensor(a) for a in _ssm_inputs(
            2, b=1, s=12, h=2, dk=4, dv=3))
        o, s = SSM.chunked_linear_attention(r, k, v, lw, u)
        state, outs = None, []
        for t in range(12):
            ot, state = SSM.single_step(r[:, t], k[:, t], v[:, t], lw[:, t],
                                        u, state)
            outs.append(ot)
        np.testing.assert_allclose(torch.stack(outs, 1), o, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(state, s, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# configs and params (the reference's TestFullConfigs rows)
# ---------------------------------------------------------------------------

EXPECT = {"rwkv6-1.6b": dict(n_layers=24, d_model=2048, d_ff=7168,
                             vocab=65536),
          "zamba2-7b": dict(n_layers=81, d_model=3584, n_heads=32,
                            kv_heads=32, d_ff=14336, vocab=32000,
                            ssm_state=64)}


@pytest.mark.parametrize("name", NAMES)
def test_exact_hparams(name):
    cfg = get(name)
    for k, v in EXPECT[name].items():
        assert getattr(cfg, k) == v, (name, k)


@pytest.mark.parametrize("name,lo,hi", [("rwkv6-1.6b", 1.5e9, 1.7e9),
                                        ("zamba2-7b", 6.5e9, 7.5e9)])
def test_param_count_from_shapes(name, lo, hi):
    """The full model's parameter count from its shape table (nothing
    allocated) equals the reference's ``init_params`` under
    ``jax.eval_shape``."""
    from repro.configs import get as jax_get
    from repro.models import family_module as jax_family
    cfg = get(name)
    n = P.count(family_module(cfg).param_shapes(cfg))
    jcfg = jax_get(name)
    shapes = jax.eval_shape(lambda k: jax_family(jcfg).init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert lo < n < hi


@pytest.mark.parametrize("name", NAMES)
def test_params_have_the_reference_layout(name):
    """The reduced model's numpy params and the port's ``init_params``
    have the JAX package's ``init_params`` tree, shape for shape (the
    hybrid's ``shared`` a list of two blocks)."""
    from repro.configs import reduced as jax_reduced
    from repro.models import family_module as jax_family
    jcfg = jax_reduced(name)
    want = jax.eval_shape(lambda k: jax_family(jcfg).init_params(jcfg, k),
                          jax.random.PRNGKey(0))
    cfg = reduced(name)
    mod = family_module(cfg)
    arrays = mod.numpy_params(cfg, 0)
    drawn = mod.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shape = lambda a: tuple(a.shape)  # noqa: E731
    assert jax.tree.map(shape, arrays) == jax.tree.map(shape, want)
    assert jax.tree.map(shape, drawn) == jax.tree.map(shape, want)


def test_zamba_tree_crosses_unchanged():
    """``convert.params_from_numpy`` keeps a Zamba2 tree as it is: the
    stacked groups, the tail and ``shared`` as a list of two blocks, every
    leaf equal."""
    cfg = reduced("zamba2-7b")
    arrays = hybrid.numpy_params(cfg, 0)
    got = convert.params_from_numpy(arrays, "cpu")
    assert isinstance(got["shared"], list) and len(got["shared"]) == 2
    flat_a = jax.tree_util.tree_flatten_with_path(arrays)
    flat_g = jax.tree_util.tree_flatten_with_path(got)
    assert flat_a[1] == flat_g[1]
    for (_, a), (_, g_) in zip(flat_a[0], flat_g[0]):
        assert g_.dtype == torch.float32
        np.testing.assert_array_equal(g_.numpy(), a)


@pytest.mark.parametrize("name,module", [("rwkv6-1.6b", rwkv),
                                         ("zamba2-7b", hybrid)])
def test_family_module(name, module):
    """``family_module`` maps ssm to ``rwkv`` and hybrid to ``hybrid``;
    each module's ``check_supported`` refuses the other families."""
    cfg = get(name)
    assert family_module(cfg) is module
    module.check_supported(cfg)
    with pytest.raises(NotImplementedError, match="lm"):
        module.check_supported(get("smollm-135m"))


# ---------------------------------------------------------------------------
# the reference's TestSmoke rows, on the port
# ---------------------------------------------------------------------------

def _drawn(name, seed, dtype="bfloat16"):
    cfg = reduced(name).replace(dtype=dtype)
    params = family_module(cfg).init_params(
        cfg, torch.Generator().manual_seed(seed), "cpu")
    return cfg, family_module(cfg), params


# The reference's rows run in bfloat16 under XLA's excess precision,
# which keeps RWKV's bfloat16 token-shift differences unrounded; the
# port rounds them where the source says (as the reference does with the
# excess precision off), and a prompt's first shift from the float32
# cache state is unrounded where the forward's zero row is bfloat16, so
# the port holds these rows in float32, at the reference's tolerances.
@pytest.mark.parametrize("name", NAMES)
def test_prefill_matches_forward(name):
    cfg, mod, params = _drawn(name, 2, "float32")
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 16)))
    cache = mod.init_cache(cfg, 2, 32, torch.float32, device="cpu")
    logits, _ = mod.prefill(params, toks, cfg, cache)
    full = mod.forward(params, toks, cfg)
    np.testing.assert_allclose(logits[:, -1].float().numpy(),
                               full[:, -1].float().numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("name", NAMES)
def test_decode_steps_match_prefill(name):
    """Greedy decode token by token == the forward of the same prefix."""
    cfg, mod, params = _drawn(name, 3, "float32")
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (1, 12)))
    cache = mod.init_cache(cfg, 1, 32, torch.float32, device="cpu")
    _, cache = mod.prefill(params, toks[:, :8], cfg, cache)
    outs = []
    for t in range(4):
        lg, cache = mod.decode_step(params, toks[:, 8 + t:9 + t], cfg, cache)
        outs.append(lg[:, 0])
    ref = mod.forward(params, toks, cfg)
    np.testing.assert_allclose(torch.stack(outs, 1).float().numpy(),
                               ref[:, 8:12].float().numpy(), rtol=5e-3,
                               atol=5e-3)


@pytest.mark.parametrize("pe", ["fp32", "int16", "lightpe1", "lightpe2",
                                "int8"])
@pytest.mark.parametrize("name", NAMES)
def test_train_step_finite(name, pe):
    """Loss and every gradient finite, for every PE type's numerics."""
    cfg, mod, params = _drawn(name, 0)
    cfg = cfg.replace(pe_type=pe)
    for leaf in jax.tree.leaves(params):
        leaf.requires_grad_(True)
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (2, 32)))
             for k in ("tokens", "labels")}
    loss = mod.loss_fn(params, batch, cfg)
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    for leaf in jax.tree.leaves(params):
        assert leaf.grad is not None and bool(torch.isfinite(leaf.grad).all())


# ---------------------------------------------------------------------------
# the loss and its gradients against jax.grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients_match_jax(name):
    """``loss_fn`` and its gradient with respect to every parameter, in
    float32 under the FP32 preset, against ``jax.value_and_grad`` of the
    reference's on the same weights and batch: the loss within 1e-5
    relative, each gradient within 1e-4 of its largest element."""
    from repro.configs import reduced as jax_reduced
    from repro.models import family_module as jax_family
    cfg = reduced(name).replace(dtype="float32")
    jcfg = jax_reduced(name).replace(dtype="float32")
    arrays = family_module(cfg).numpy_params(cfg, 0)
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, cfg.vocab, (2, 24)) for k in
             ("tokens", "labels")}
    jloss, jgrads = jax.value_and_grad(jax_family(jcfg).loss_fn)(
        jax.tree.map(jnp.asarray, arrays),
        jax.tree.map(jnp.asarray, batch), jcfg)
    params = convert.params_from_numpy(arrays, "cpu")
    for leaf in jax.tree.leaves(params):
        leaf.requires_grad_(True)
    loss = family_module(cfg).loss_fn(
        params, {k: torch.as_tensor(v) for k, v in batch.items()}, cfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.grad.numpy(), params))[0]
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    for (path, g_), (_, w_) in zip(got, want):
        w_ = np.asarray(w_)
        scale = max(float(np.abs(w_).max()), 1e-30)
        np.testing.assert_allclose(g_, w_, rtol=0, atol=1e-4 * scale,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# head_dim 112 in the attention (Zamba2-7B's shared blocks)
# ---------------------------------------------------------------------------

FA_TOL = 2e-5      # the reference's kernel tolerance (tests/test_kernels.py)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_at_112_matches_reference(causal):
    """The plain version at head_dim 112 (grouped, with query starts)
    against the reference's ``ref_flash_attention`` head by head, within
    2e-5."""
    from repro.kernels.flash_attention.ref import ref_flash_attention
    from repro_torch.kernels.flash_attention.ref import ref_attention_gqa
    rng = np.random.default_rng(11)
    b, sq, skv, hq, hkv, d = 2, 9, 20, 4, 2, 112
    q = rng.standard_normal((b, sq, hq, d), dtype=np.float32)
    k, v = (rng.standard_normal((b, skv, hkv, d), dtype=np.float32)
            for _ in range(2))
    start = skv - sq if causal else 0
    got = ref_attention_gqa(*map(torch.as_tensor, (q, k, v)),
                            torch.full((b,), start, dtype=torch.int32),
                            causal)
    for bi in range(b):
        for h in range(hq):
            qp = np.concatenate([np.zeros((start, d), np.float32),
                                 q[bi, :, h]])
            want = ref_flash_attention(jnp.asarray(qp),
                                       jnp.asarray(k[bi, :, h // 2]),
                                       jnp.asarray(v[bi, :, h // 2]),
                                       causal=causal)
            np.testing.assert_allclose(got[bi, :, h].numpy(),
                                       np.asarray(want)[start:],
                                       rtol=FA_TOL, atol=FA_TOL)


def test_plan_at_zamba_shapes():
    """Zamba2-7B's shared attention (32 / 32 heads of 112, 4 slots, a
    256-row cache): a key takes 32 lanes of the split kernel (28 hold
    columns), decode takes the split kernel, the float32 prefill (the
    unified attention's q) the wgmma kernel, a bfloat16 q's prefill the
    mma kernel."""
    from repro_torch.kernels.flash_attention import (key_lanes,
                                                     lane_columns)
    from repro_torch.kernels.flash_attention import plan as fa_plan
    assert (lane_columns(112), key_lanes(112)) == (4, 32)
    assert all(key_lanes(d) == d // lane_columns(d)
               for d in (16, 32, 64, 128, 256))
    dec = fa_plan(4, 1, 256, 32, 32, 112, False)
    assert (dec.variant, dec.rows, dec.chunk) == ("split", 4, 16)
    pre = fa_plan(4, 130, 256, 32, 32, 112, False)
    assert (pre.variant, pre.rows, pre.splits, pre.grid) == (
        "wgmma", 64, 1, (3, 32, 4))
    mma = fa_plan(4, 130, 256, 32, 32, 112, True)
    assert (mma.variant, mma.rows, mma.grid) == ("mma", 64, (3, 32, 4))


@pytest.mark.parametrize("sq,skv,q_bf16,start", [
    (1, 40, False, 30), (2, 40, False, 17), (20, 40, True, 5),
    (70, 90, True, 0), (12, 24, False, 3)])
def test_emulated_kernels_at_112(sq, skv, q_bf16, start):
    """The kernels' arithmetic at head_dim 112 under their plans (split:
    a key over 32 lanes; mma: 7 k-steps, 14 column tiles) against the
    plain version, within 2e-5."""
    from repro_torch.kernels.flash_attention import plan as fa_plan
    from repro_torch.kernels.flash_attention.ref import (emulate_attention,
                                                         ref_attention_gqa)
    rng = np.random.default_rng(sq)
    b, hq, hkv, d = 2, 4, 2, 112
    q = torch.as_tensor(rng.standard_normal((b, sq, hq, d),
                                            dtype=np.float32))
    k, v = (torch.as_tensor(rng.standard_normal((b, skv, hkv, d),
                                                dtype=np.float32))
            for _ in range(2))
    if q_bf16:
        q, k = q.to(torch.bfloat16), k.to(torch.bfloat16).float()
    st = torch.full((b,), start, dtype=torch.int32)
    p = fa_plan(b, sq, skv, hq, hkv, d, q_bf16)
    got = emulate_attention(q, k, v, st, p)
    want = ref_attention_gqa(q, k, v, st)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=FA_TOL,
                               atol=FA_TOL)


# ---------------------------------------------------------------------------
# packed codes under a bfloat16 cast (ROADMAP C's repair)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [3, 40])
@pytest.mark.parametrize("pe", ["int4", "lightpe1", "int8"])
def test_qdense_cast_on_codes_matches_jax(pe, m):
    """``qdense(x, codes, cast=bfloat16)`` on int4, pow2 and int8 codes
    against the reference's ``qdense`` on the same codes: the dequantized
    weight rounded to bfloat16 before the product, a bfloat16 result;
    within one bfloat16 step (2^-7 relative: the float32 sums run in
    another order).  The tensor-core kernel's arithmetic under the cast
    (``emulate_mma``) gives the same within the same step."""
    from repro.models.layers import qdense as jax_qdense
    from repro.quant.qconfig import preset as jax_preset
    from repro_torch.kernels.quant_matmul.ref import (emulate_mma,
                                                      ref_quant_matmul)
    from repro_torch.models.layers import packed_mode, qdense
    from repro_torch.quant import preset
    rng = np.random.default_rng(m)
    w = torch.as_tensor(rng.standard_normal((96, 48), dtype=np.float32)
                        * 0.1)
    x = torch.as_tensor(rng.standard_normal((m, 96), dtype=np.float32))
    packed = quantize_params({"w": w}, pe, min_size=1)["w"]
    got = qdense(x, packed, preset("fp32"), cast=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    jw = {k: jnp.asarray(v.numpy()) for k, v in packed.items()}
    want = np.asarray(jax_qdense(jnp.asarray(x.numpy()), jw,
                                 jax_preset("fp32"), cast=jnp.bfloat16),
                      np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                               atol=0)
    mode, key = packed_mode(packed)
    emu = emulate_mma(x, packed[key], packed["scale"], mode, torch.bfloat16)
    plain = ref_quant_matmul(x, packed[key], packed["scale"], mode,
                             torch.bfloat16)
    np.testing.assert_allclose(emu.float().numpy(), plain.float().numpy(),
                               rtol=2.0 ** -7, atol=0)


# ---------------------------------------------------------------------------
# what the reference cannot pack at full width
# ---------------------------------------------------------------------------

def _alone(path, shape):
    t = np.full(shape, 0.5, np.float32)
    for key in reversed(path.split("/")):
        t = {key: t}
    return t


# the full-width leaves the serving packer takes by their size: RWKV6-1.6B's
# token-shift mixes, decay LoRA and (at 24 layers) bonus and head norm;
# Zamba2-7B's stacked group norms, conv biases and gated norms, the tail's
# conv taps
FULL_WIDTH_LEAVES = [
    ("layers/tm/mu", (2, 5, 2048)), ("layers/cm/mu", (24, 2, 2048)),
    ("layers/tm/wa", (2, 2048, 64)), ("layers/tm/wb", (2, 64, 2048)),
    ("layers/tm/u", (24, 32, 64)), ("layers/tm/ln_x", (24, 32, 64)),
    ("groups/ln", (13, 6, 3584)), ("groups/mamba/conv_b", (13, 6, 7296)),
    ("groups/mamba/norm", (13, 6, 7168)),
    ("tail/mamba/conv_w", (3, 4, 7296))]


@pytest.mark.parametrize("pe", ["lightpe1", "int8"])
@pytest.mark.parametrize("path,shape", FULL_WIDTH_LEAVES)
def test_full_width_leaves_pack_alike(path, shape, pe):
    """Each such leaf, built alone, is packed by both packages at the
    default floor (the same code shapes), except RWKV's (5, 2048) rows
    under pow2, where the reference's ``pack_nibbles`` raises TypeError
    and the port NotImplementedError naming it."""
    from repro.serve import quantize_params as jax_quantize
    tree = _alone(path, shape)
    if pe == "lightpe1" and shape[-2] % 2:
        with pytest.raises(TypeError):
            jax_quantize(jax.tree.map(jnp.asarray, tree), pe)
        with pytest.raises(NotImplementedError, match="TypeError"):
            quantize_params(convert.params_from_numpy(tree, "cpu"), pe)
        return
    want = jax_quantize(jax.tree.map(jnp.asarray, tree), pe)
    got = quantize_params(convert.params_from_numpy(tree, "cpu"), pe)
    shape_of = lambda a: tuple(a.shape)  # noqa: E731
    assert jax.tree.map(shape_of, got) == jax.tree.map(shape_of, want)


@pytest.mark.parametrize("pe", ["lightpe1", "int8"])
@pytest.mark.parametrize("name", NAMES)
def test_packed_non_weights_raise_in_both_packages(name, pe):
    """Packed with a floor low enough to take the same kinds of leaves at
    the reduced size, RWKV under pow2 fails in both packers (the (5, d)
    rows), under INT8 in both models (``mu[0]``: the reference's
    KeyError); Zamba2's packed group leaves fail in the reference's group
    scan ("different leading axis sizes") and in the port, naming it."""
    from repro.configs import reduced as jax_reduced
    from repro.models import family_module as jax_family
    from repro.serve import quantize_params as jax_quantize
    cfg = reduced(name).replace(pe_type="fp32")
    arrays = family_module(cfg).numpy_params(cfg, 0)
    toks = np.zeros((1, 4), np.int64)
    floor = 1 << 8
    if name == "rwkv6-1.6b" and pe == "lightpe1":
        with pytest.raises(TypeError):
            jax_quantize(jax.tree.map(jnp.asarray, arrays), pe,
                         min_size=floor)
        with pytest.raises(NotImplementedError, match="layers/tm/mu"):
            quantize_params(convert.params_from_numpy(arrays, "cpu"), pe,
                            min_size=floor)
        return
    jq = jax_quantize(jax.tree.map(jnp.asarray, arrays), pe, min_size=floor)
    err, match = ((KeyError, "mu") if name == "rwkv6-1.6b"
                  else (ValueError, "leading axis sizes"))
    with pytest.raises(err):
        jax_family(jax_reduced(name)).forward(jq, jnp.asarray(toks),
                                              jax_reduced(name))
    pq = quantize_params(convert.params_from_numpy(arrays, "cpu"), pe,
                         min_size=floor)
    with pytest.raises(NotImplementedError, match=match):
        family_module(cfg).forward(pq, torch.as_tensor(toks), cfg)


# ---------------------------------------------------------------------------
# the serving engine and the phase-13 reference file
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced_ref(tmp_path_factory):
    """``tests/_torch_ssm_ref.py`` at the reduced size, in its own process
    (XLA's excess precision off, as the full file was written)."""
    out = tmp_path_factory.mktemp("ssm_ref") / "ref.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(TESTS.parent / "src"),
                                           str(TESTS)]))
    subprocess.run([sys.executable, str(TESTS / "_torch_ssm_ref.py"),
                    "--reduced", str(out)], env=env, check=True,
                   timeout=600, capture_output=True)
    return json.loads(out.read_text())


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()
                if k not in ("run4", "pow2_ties")}
    return type(tree).__name__


def test_reference_file_format(reduced_ref):
    """The full file has the reduced rebuild's format; its packed runs
    (always the reduced models) are the rebuild's, to the bit; the cut
    depths are the smoke's (RWKV6 4 of 24 layers, Zamba2 13 of 81: both
    shared blocks and a tail of 1)."""
    full = json.loads(R.REF_PATH.read_text())
    assert _keys(full) == _keys(reduced_ref)
    assert full["packed"] == reduced_ref["packed"]
    for name, layers in R.CUT_LAYERS.items():
        run = full["dense"][name]
        assert (run["size"], run["n_layers"]) == ("full", layers)
        assert "--xla_allow_excess_precision=false" in run["xla_flags"]
        assert set(run["modes"]) == {"fp32", "lightpe1", "int8"}
        for m in run["modes"].values():
            assert len(m["run4"]["tokens"]) == len(check.PROMPT_LENS)
            assert all(len(t) == check.MAX_NEW for t in m["run4"]["tokens"])
    assert hybrid._group_shape(get("zamba2-7b").replace(n_layers=13)) == \
        (6, 2, 1)


# bfloat16 without pins: the serving runs' tolerance (chip_smoke.py's
# phases 6 and 11; over 12 steps of 130-token prompts one flipped
# rounding moves the reduced Zamba2's logits by 0.024)
SERVE_TOL = 0.1


@pytest.mark.parametrize("key", ["fp32", "lightpe1", "int8"])
@pytest.mark.parametrize("name", NAMES)
def test_dense_serving_matches_reference(reduced_ref, name, key):
    """The port's ``ServeEngine`` on the reduced model's dense weights
    (4 prompts of 8-130 tokens, 4 slots, 12 new tokens), under the FP32
    preset and QAT numerics in bfloat16, held to the JAX engine's record
    within ``SERVE_TOL`` (under QAT numerics coupled across the batch:
    one activation scale for all four rows)."""
    ref = reduced_ref["dense"][name]
    m = ref["modes"][key]
    cfg = reduced(name).replace(pe_type=m["pe_type"], dtype=m["dtype"])
    eng = ServeEngine(cfg, family_module(cfg), _port_params(cfg),
                      ref["batch_slots"], ref["max_len"])
    rec = check.record(eng, [np.array(p) for p in ref["prompts"]],
                       ref["max_new"], lambda t: t.float().numpy())
    problems, _ = check.compare(rec, m["run4"], SERVE_TOL,
                                coupled=m["pe_type"] != "fp32")
    assert not problems, problems
    assert sum(check.compared_steps(rec, m["run4"],
                                    m["pe_type"] != "fp32")) > 0


@pytest.mark.parametrize("key", ["lightpe1", "int8"])
@pytest.mark.parametrize("name", NAMES)
def test_packed_serving_matches_reference(reduced_ref, name, key):
    """The reduced model packed by the port's ``quantize_params``: the
    reference's packed leaves and bytes, and its served record within
    ``SERVE_TOL`` (each packed projection one ``quant_matmul`` call a
    layer)."""
    from repro_torch.serve import packed_bytes
    ref = reduced_ref["packed"][name]
    m = ref["modes"][key]
    cfg = reduced(name).replace(dtype=m["dtype"])
    packed = quantize_params(_port_params(cfg), m["pe_type"],
                             min_size=ref["min_size"])
    assert check.packed_leaves(packed) == m["packed_leaves"]
    assert packed_bytes(packed) == m["packed_bytes"]
    eng = ServeEngine(cfg, family_module(cfg), packed, ref["batch_slots"],
                      ref["max_len"])
    rec = check.record(eng, [np.array(p) for p in ref["prompts"]],
                       ref["max_new"], lambda t: t.float().numpy())
    problems, _ = check.compare(rec, m["run4"], SERVE_TOL)
    assert not problems, problems


def test_rwkv_cache_holds_no_kv_rows():
    """RWKV's serving state is O(1) a layer: no KV rows, whatever max_len;
    the last-token states take the hidden states' type after a step."""
    cfg = reduced("rwkv6-1.6b")
    cache = rwkv.init_cache(cfg, 4, 256, torch.float32, device="cpu")
    assert set(cache) == {"s", "tm_last", "cm_last"}
    assert tuple(cache["s"].shape) == (2, 4, 4, 16, 16)
    assert tuple(cache["tm_last"].shape) == (2, 4, 64)
    params = _port_params(cfg)
    _, cache = rwkv.prefill(params, torch.zeros((4, 3), dtype=torch.long),
                            cfg, cache)
    assert cache["tm_last"].dtype == torch.bfloat16
    assert cache["s"].dtype == torch.float32

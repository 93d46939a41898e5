"""The port's decoder family against the JAX package: Gemma-3 (5:1
local:global windows, head_dim 256 at full size, qk-norm, GELU,
zero-centered norms), Gemma-2 (alternating windows smaller than the
sequence, attention and final soft-caps, a query scale), the Qwen2-VL
backbone (M-RoPE), DeepSeek-MoE (shared experts, a leading dense layer,
tokens dropped past capacity) and Phi-3.5-MoE, each reduced
(``configs.reduced``), on the same numpy weights, under FP32 and
LightPE-1 numerics, in float32 and bfloat16: ``forward``, ``prefill`` and
a ``decode_step`` sequence.  Also the attention kernel's window and
soft-cap in its plan, its emulation and its backward, ``apply_mrope``,
``check_supported`` and the Gemma-3 serving reference's format.

The JAX side runs in a subprocess with XLA's excess precision off
(``tests/_torch_decoder_ref.py``), where the two packages agree to the
last bit or so; the tolerances are the serving tests': 1e-4 in float32,
2e-2 in bfloat16, on each of 8 token seeds.  Under LightPE-1 an 8-bit
activation code at a round(x / s) tie may differ by one step between
the packages (float32 sums in another order); the port takes the JAX
code there (``_torch_act_pins.ActPins``), the pins counted, and a code
that differs anywhere else fails.  In bfloat16 the rounding of a
block's norm, attention or feed-forward output may differ by one
bfloat16 step where both float32 values sit at the midpoint; the port
takes the JAX rounding there (``RoundPins``), counted, and any other
difference fails.  An MoE model's routing is held too: it may differ
only at a router near tie (a margin below ``ROUTER_TOL``), and logits
are compared only on the tokens before the first such difference (a
routed token moves the later ones of its row through attention, and
the later tokens of the batch through capacity); the skipped tokens are
counted.
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
from repro_torch.configs import get, list_archs, reduced
from repro_torch.kernels.flash_attention import (attention_backward,
                                                 block_keys, block_rows,
                                                 flash_attention_gqa, plan)
from repro_torch.kernels.flash_attention.ref import (emulate_attention,
                                                     ref_attention_gqa)
from repro_torch.models import family_module, layers as L, moe as MOE
from repro_torch.models import transformer as T
from repro_torch.serve import ServeEngine, check, quantize_params

import _torch_decoder_ref as D
from _torch_act_pins import ActPins, RoundPins, one_torch_thread  # noqa: F401
from _torch_gemma3_ref import REF_PATH as GEMMA_REF, build_reference
from _torch_moe_ref import ROUTER_TOL

TESTS = Path(__file__).resolve().parent
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("decoder") / "jax.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(TESTS.parent / "src"),
                                           str(TESTS)]))
    subprocess.run([sys.executable, str(TESTS / "_torch_decoder_ref.py"),
                    str(out)], env=env, check=True, timeout=600,
                   capture_output=True)
    with open(out, "rb") as f:
        return pickle.load(f)


def _port_run(name, pe, dtype, seed=D.TOKEN_SEED, pins=(), want=None):
    """The port's forward, prefill and decode steps on the same inputs,
    with the routing of each; ``pins`` (an ``ActPins`` and a
    ``RoundPins``) take the JAX run ``want``'s activation codes and
    bfloat16 roundings at ties."""
    cfg = reduced(name).replace(pe_type=pe, dtype=dtype)
    params = convert.params_from_numpy(T.numpy_params(cfg, 0), "cpu")
    toks = torch.as_tensor(D.tokens(cfg.vocab, seed))
    out = {}
    with MOE.RouterLog() as log:
        for pin, key in zip(pins, ("forward_acts", "forward_rounds")):
            pin.load(want[key])
        out["forward"] = T.forward(params, toks, cfg).float().numpy()
        out["forward_routes"] = log.drain()
        assert all(pin.done() for pin in pins)
        for pin, key in zip(pins, ("step_acts", "step_rounds")):
            pin.load(want[key])
        cache = T.init_cache(cfg, D.BATCH, D.MAX_LEN, torch.float32,
                             device="cpu")
        logits, cache = T.prefill(params, toks[:, :D.PROMPT], cfg, cache)
        steps = [logits.float().numpy()]
        for i in range(D.PROMPT, D.SEQ):
            logits, cache = T.decode_step(params, toks[:, i:i + 1], cfg,
                                          cache)
            steps.append(logits.float().numpy())
        out["steps"] = np.concatenate(steps, axis=1)
        out["step_routes"] = log.drain()
        assert all(pin.done() for pin in pins)
    return cfg, out


def _first_flip(got_routes, want_routes, calls_per_pass: int):
    """(pass, flat token) of the earliest routing difference over the MoE
    calls, or None; each differing token's reference margin must be a
    near tie.  ``calls_per_pass``: MoE calls of one forward / step."""
    assert len(got_routes) == len(want_routes)
    first = None
    for c, ((gi, _), (wi, wm)) in enumerate(zip(got_routes, want_routes)):
        differ = np.flatnonzero(np.any(gi != wi, axis=-1).reshape(-1))
        for t in differ:
            margin = wm.reshape(-1)[t]
            assert margin < ROUTER_TOL, (c, t, margin)
            at = (c // calls_per_pass, int(t))
            first = at if first is None else min(first, at)
    return first


@pytest.mark.parametrize("seed", D.TOKEN_SEEDS)
@pytest.mark.parametrize("name,pe,dtype", D.CASES)
def test_model_matches_jax(jax_runs, name, pe, dtype, seed, monkeypatch,
                           record_property):
    want = jax_runs[(name, pe, dtype)][seed]
    # an MoE layer rounds inside (its combine adds in bfloat16), where no
    # site pins: a difference there ends the rounding pins for the run
    acts = ActPins(monkeypatch)
    rounds = RoundPins(monkeypatch, strict=not reduced(name).moe_experts)
    cfg, got = _port_run(name, pe, dtype, seed, (acts, rounds), want)
    record_property("activation_codes_pinned", acts.pinned)
    record_property("bf16_roundings_pinned", rounds.pinned)
    record_property("bf16_rounding_pins_ended", rounds.ended)
    print(f"{name} {pe} {dtype} seed {seed}: {acts.pinned} activation "
          f"codes and {rounds.pinned} bfloat16 roundings pinned at "
          f"rounding ties")
    tol = LOGIT_TOL[dtype]
    moe_layers = (cfg.n_layers - cfg.first_dense) if cfg.moe_experts else 0
    # forward: every (b, s) token before the first routing near tie
    fwd_g, fwd_w = got["forward"], want["forward"]
    assert fwd_g.shape == fwd_w.shape and np.isfinite(fwd_g).all()
    flip = (_first_flip(got["forward_routes"], want["forward_routes"],
                        moe_layers) if moe_layers else None)
    n = D.BATCH * D.SEQ if flip is None else flip[1]
    skipped = D.BATCH * D.SEQ - n
    err = np.abs(fwd_g - fwd_w).reshape(D.BATCH * D.SEQ, -1)[:n].max(
        initial=0.0)
    assert err <= tol, (err, skipped)
    # prefill and decode: the steps before the first routing near tie
    steps_g, steps_w = got["steps"], want["steps"]
    assert steps_g.shape == steps_w.shape == (D.BATCH, 1 + D.SEQ - D.PROMPT,
                                              cfg.padded_vocab)
    flip = (_first_flip(got["step_routes"], want["step_routes"], moe_layers)
            if moe_layers else None)
    n = steps_g.shape[1] if flip is None else flip[0]
    err = np.abs(steps_g - steps_w)[:, :n].max(initial=0.0)
    assert err <= tol, (err, n)
    if moe_layers:
        assert len(got["forward_routes"]) == moe_layers
        print(f"{name} {pe} {dtype}: {skipped} forward tokens and "
              f"{steps_g.shape[1] - n} steps skipped at router near ties")


def test_deepseek_drops_tokens_past_capacity():
    """The reduced DeepSeek forward of the model tests drops assignments
    in both MoE layers (so capacity is exercised), and its routing
    margins are counted."""
    cfg = reduced("deepseek-moe-16b")
    params = convert.params_from_numpy(T.numpy_params(cfg, 0), "cpu")
    with MOE.RouterLog() as log:
        T.forward(params, torch.as_tensor(D.tokens(cfg.vocab)), cfg)
    calls = log.drain()
    assert len(calls) == 2
    assert all(MOE.dropped(ids, cfg) > 0 for ids, _ in calls)
    assert MOE.capacity(D.BATCH * D.SEQ, cfg) == 13


# ---------------------------------------------------------------------------
# the attention kernel's window and soft-cap (plain, plan, emulation)
# ---------------------------------------------------------------------------

# (b, sq, skv, hq, hkv, d, start, window, softcap): Gemma-3-1B's and
# Gemma-2-9B's heads at decode and prefill past their windows, and small
# shapes whose window cuts a split and a 64-key chunk
WIN_CASES = [(2, 1, 1024, 4, 1, 256, 905, 512, 0.0),
             (1, 24, 1024, 4, 1, 256, 600, 512, 0.0),
             (1, 1, 4608, 16, 8, 256, 4600, 4096, 50.0),
             (2, 1, 300, 9, 3, 64, 250, 40, 0.0),
             (2, 2, 300, 9, 3, 64, 133, 7, 20.0),
             (2, 130, 300, 9, 3, 64, 30, 77, 0.0),
             (2, 70, 200, 4, 2, 128, 100, 33, 30.0),
             (1, 96, 96, 2, 1, 32, 0, 1, 5.0)]


def _inputs(b, sq, skv, hq, hkv, d, start, q_type=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((b, sq, hq, d), generator=gen).to(q_type)
    k = torch.randn((b, skv, hkv, d), generator=gen)
    v = torch.randn((b, skv, hkv, d), generator=gen)
    return q, k, v, torch.full((b,), start, dtype=torch.int32)


@pytest.mark.parametrize("q_type", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,start,window,softcap", WIN_CASES)
def test_emulated_kernel_matches_plain_with_window(b, sq, skv, hq, hkv, d,
                                                   start, window, softcap,
                                                   q_type):
    """The kernels' arithmetic under the plan (its windowed key ranges
    and split points) against the plain version: 2e-5
    (tests/test_kernels.py:122), float32 sums in another order."""
    q, k, v, st = _inputs(b, sq, skv, hq, hkv, d, start, q_type)
    p = plan(b, sq, skv, hq, hkv, d, q_type == torch.bfloat16, window)
    if d == 256:
        assert p.variant == ("wgmma" if hq // hkv * sq > 8 else "split")
    want = ref_attention_gqa(q, k, v, st, round_p=True, window=window,
                             softcap=softcap)
    got = emulate_attention(q, k, v, st, p, round_p=True, window=window,
                            softcap=softcap)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,start,window,softcap", WIN_CASES)
def test_block_keys_cover_every_visible_key_once(b, sq, skv, hq, hkv, d,
                                                 start, window, softcap):
    """A row tile's ranks visit disjoint key ranges, in order, that hold
    every key any of its rows sees; no chunk lies wholly below every
    row's window (the mma kernel's first chunk holds the first key its
    first row sees)."""
    g = hq // hkv
    for q_bf16 in (False, True):
        p = plan(b, sq, skv, hq, hkv, d, q_bf16, window)
        for tile in range(p.tiles):
            rows = block_rows(p, tile, g, sq)
            if not rows:
                continue
            seen = set()
            for i, _ in rows:
                seen |= set(range(max(0, start + i - window + 1),
                                  min(skv, start + i + 1)))
            ranges = [block_keys(p, tile, r, g, sq, skv, start, True, window)
                      for r in range(p.splits)]
            visited = [j for r in ranges for j in r]
            assert len(visited) == len(set(visited))
            assert visited == sorted(visited) and seen <= set(visited)
            lo = min(seen)
            assert min(visited) > lo - (p.chunk if p.variant != "split"
                                        else 1)


def test_plan_takes_head_dim_256_on_the_split_kernel():
    """head_dim 256 runs the split kernel at decode for every type and
    the wgmma kernel at prefill (a 64-row mma block's accumulators would
    not fit); 128 keeps the mma kernel for bfloat16 q at prefill and takes
    the wgmma kernel for a float32 q; a window bounds the keys a cluster
    splits."""
    for q_bf16 in (True, False):
        assert plan(4, 1, 1024, 4, 1, 256, q_bf16).variant == "split"
        assert plan(4, 900, 1024, 4, 1, 256, q_bf16).variant == "wgmma"
    assert plan(4, 130, 256, 16, 16, 128, True).variant == "mma"
    assert plan(4, 130, 256, 16, 16, 128, False).variant == "wgmma"
    # 4 key groups of 32 lanes (8 columns each), 4 keys a group at once
    assert plan(4, 1, 1024, 4, 1, 256, False).chunk == 16
    wide = plan(1, 1, 8192, 4, 1, 256, False)
    narrow = plan(1, 1, 8192, 4, 1, 256, False, 16)
    assert narrow.splits < wide.splits


def test_window_and_softcap_follow_the_reference_model():
    """The plain version's window (p - window < j <= p) and soft-cap
    (after the scale, before the mask) against the reference model's own
    expression (``src/repro/models/transformer.py``, ``_attention_dynwin``)
    on one layer's q, k, v."""
    b, sq, skv, hq, hkv, d = 2, 12, 12, 4, 2, 16
    q, k, v, st = _inputs(b, sq, skv, hq, hkv, d, 0)
    for window, softcap, scale in ((5, 0.0, 0.0), (3, 2.0, 0.25),
                                   (0, 1.5, 0.0)):
        got = ref_attention_gqa(q, k, v, st, scale=scale, window=window,
                                softcap=softcap)
        qg = jnp.asarray(q.numpy()).reshape(b, sq, hkv, hq // hkv, d)
        logits = jnp.einsum("bqhgd,bkhd->bhgqk", qg, jnp.asarray(k.numpy()),
                            preferred_element_type=jnp.float32) * (
            scale or 1.0 / float(np.sqrt(d)))
        if softcap > 0.0:
            logits = softcap * jnp.tanh(logits / softcap)
        pos = jnp.arange(sq)
        qp, kp = pos[None, None, None, :, None], pos[None, None, None, None]
        ok = (kp <= qp) & (kp > qp - (window or (1 << 30)))
        probs = jax.nn.softmax(jnp.where(ok, logits, -1e30), axis=-1)
        want = jnp.einsum("bhgqk,bkhd->bqhgd", probs, jnp.asarray(v.numpy()))
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(want).reshape(b, sq, hq, d),
                                   rtol=0, atol=2e-5)


def test_backward_raises_with_a_window_or_softcap():
    """What the backward still refuses: a window without the causal mask
    (on any device, as the forward) and a head_dim the forward does not
    take.  What it now takes: the window and the soft-cap (the CPU's
    autograd of the plain version; the kernel on the card) and head_dim
    256."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        _check_bwd
    from repro_torch.kernels.flash_attention.ref import ref_attention_gqa_bwd
    q, k, v, st = _inputs(1, 8, 8, 2, 1, 64, 0)
    do = torch.ones_like(q)
    for kw in (dict(window=4), dict(softcap=30.0)):
        got = attention_backward(q, k, v, st, do, **kw)
        want = ref_attention_gqa_bwd(q, k, v, st, do, True, 0.0, False,
                                     kw.get("window", 0),
                                     kw.get("softcap", 0.0))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="causal"):
        attention_backward(q, k, v, st, do, causal=False, window=4)
    q, k, v, st = _inputs(1, 8, 8, 2, 1, 256, 0)
    _check_bwd(q, k, v, True, 4, 30.0)
    with pytest.raises(ValueError, match="causal"):
        flash_attention_gqa(q, k, v, st, causal=False, window=4)
    with pytest.raises(ValueError, match="head_dim"):
        odd = torch.zeros(1, 8, 2, 48)
        _check_bwd(odd, odd, odd)


def test_apply_mrope_matches_jax():
    from repro.models import layers as JL
    gen = np.random.default_rng(3)
    x = gen.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = gen.integers(0, 50, size=(2, 7, 3))
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), (2, 3, 3), 1e6)
    got = L.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), (2, 3, 3),
                        1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="sum"):
        L.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), (2, 3, 2))


def test_mrope_positions_of_three_streams():
    """(B, S, 3) positions reach M-RoPE as they are; the kernel's start
    is stream 0's, which must be start + arange(S)."""
    cfg = reduced("qwen2-vl-72b").replace(dtype="float32")
    params = convert.params_from_numpy(T.numpy_params(cfg, 0), "cpu")
    toks = torch.as_tensor(D.tokens(cfg.vocab))[:, :6]
    flat = T.forward(params, toks, cfg)
    same = torch.arange(6)[None, :, None].expand(2, 6, 3)
    torch.testing.assert_close(T.forward(params, toks, cfg, same), flat,
                               rtol=0, atol=0)
    other = same.clone()
    other[..., 1] = 3
    assert not torch.equal(T.forward(params, toks, cfg, other), flat)
    bad = same.clone()
    bad[0, 2, 0] = 9
    with pytest.raises(ValueError, match="arange"):
        T.forward(params, toks, cfg, bad)


@pytest.mark.parametrize("name", list_archs())
def test_check_supported(name):
    """Every lm / moe / vlm config runs, with any of the four perf
    variants; encdec, ssm and hybrid are their own modules' (``encdec``,
    ``rwkv``, ``hybrid``), which the transformer refuses."""
    cfg = get(name)
    if cfg.family in ("lm", "moe", "vlm"):
        T.check_supported(cfg)
        assert family_module(cfg) is T
        for knob in (dict(kv_replicate_to=16), dict(attn_block_local=True),
                     dict(attn_flash=True), dict(moe_ep_shard_map=True)):
            T.check_supported(cfg.replace(**knob))
    elif cfg.family == "encdec":
        from repro_torch.models import encdec
        assert family_module(cfg) is encdec
        with pytest.raises(NotImplementedError, match=cfg.family):
            T.check_supported(cfg)
    else:
        from repro_torch.models import hybrid, rwkv
        assert family_module(cfg) is {"ssm": rwkv,
                                      "hybrid": hybrid}[cfg.family]
        family_module(cfg).check_supported(cfg)
        with pytest.raises(NotImplementedError, match=cfg.family):
            T.check_supported(cfg)


@pytest.mark.parametrize("name", ["gemma3-1b", "gemma2-9b", "qwen3-32b",
                                  "qwen2-vl-72b", "deepseek-moe-16b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_numpy_params_have_the_reference_layout(name):
    """The reduced model's numpy params have the JAX package's
    ``init_params`` tree, shape for shape, and so does the port's own
    ``init_params``."""
    from repro.configs import reduced as jax_reduced
    from repro.models import transformer as JT
    jcfg = jax_reduced(name)
    want = jax.eval_shape(lambda key: JT.init_params(jcfg, key),
                          jax.random.PRNGKey(0))
    shapes = jax.tree.map(lambda a: a.shape, want)
    ours = T.numpy_params(reduced(name), 0)
    assert jax.tree.map(lambda a: a.shape, ours) == shapes
    port = T.init_params(reduced(name), torch.Generator().manual_seed(0),
                         device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), port) == shapes


# ---------------------------------------------------------------------------
# the Gemma-3-1B serving reference
# ---------------------------------------------------------------------------

def test_pin_pow2_codes_puts_the_reference_codes_in():
    """``check.pin_pow2_codes`` writes the listed codes (either nibble of
    a byte, stacked and 2-D leaves) and counts those it changed; the
    dequantized weights then hold the pinned codes' values."""
    from repro_torch.quant.pack import DEQUANTIZE, unpack_nibbles
    gen = torch.Generator().manual_seed(0)
    w = {"layers": {"wq": torch.randn((2, 8, 4), generator=gen)},
         "head": torch.randn((8, 4), generator=gen)}
    packed = quantize_params(w, "lightpe1", min_size=1)

    def code(leaf, layer, k, n):
        c = leaf["codes__pow2"] if layer < 0 else leaf["codes__pow2"][layer]
        return int(unpack_nibbles(c.T).T[k, n])

    stacked, flat = packed["layers"]["wq"], packed["head"]
    pins = [["layers/wq", 1, 2, 3, code(stacked, 1, 2, 3) ^ 1],
            ["layers/wq", 1, 3, 3, code(stacked, 1, 3, 3)],
            ["head", -1, 5, 0, code(flat, -1, 5, 0) ^ 2]]
    e_max = [["head", -1, 0, float(flat["scale"][0])],
             ["layers/wq", 0, 1, float(stacked["scale"][0, 1]) + 1.0]]
    got = check.pin_pow2_codes(packed, {"codes": pins, "e_max": e_max})
    assert got == {"pinned": 3, "changed": 2, "e_max_ties": 2,
                   "e_max_differ": 1}
    for path, layer, k, n, c in pins:
        leaf = stacked if path.startswith("layers") else flat
        assert code(leaf, layer, k, n) == c
    dense = DEQUANTIZE["pow2"](stacked["codes__pow2"][1], stacked["scale"][1])
    assert float(dense[3, 3]) == float(DEQUANTIZE["pow2"](
        quantize_params(w, "lightpe1", min_size=1)["layers"]["wq"][
            "codes__pow2"][1], stacked["scale"][1])[3, 3])


def test_gemma3_reference_format_is_stable():
    """``build_reference`` at the reduced size (one mode) gives the
    committed full-size file's layout, and the port's record of the same
    run agrees with it at the float32 tolerance."""
    ref = json.loads(GEMMA_REF.read_text())
    assert ref["size"] == "full" and ref["config"] == "gemma3-1b"
    assert "--xla_allow_excess_precision=false" in ref["xla_flags"]
    assert [len(p) for p in ref["prompts"]] == list(check.GEMMA_PROMPT_LENS)
    assert ref["max_len"] == check.GEMMA_MAX_LEN
    ties = ref["pow2_ties"]
    assert ties["codes"] and all(len(t) == 5 and 0 <= t[4] < 16
                                 for t in ties["codes"])
    # Gemma-3-1B's float32 parameters: the tied embedding, the final norm
    # and 26 layers of attention (qk-norm scales included), norms and MLP
    full = get("gemma3-1b")
    d, hd = full.d_model, full.head_dim
    hq, hkv = full.n_heads * hd, full.kv_heads * hd
    layer = 2 * d * hq + 2 * d * hkv + 2 * hd + 2 * d + 3 * d * full.d_ff
    n_params = full.padded_vocab * d + d + full.n_layers * layer
    assert n_params == 999_826_048 and ref["dense_bytes"] == 4 * n_params
    key = check.mode_key("int8", "float32")
    small = build_reference("reduced", modes=(("int8", "float32"),))
    assert small.keys() == ref.keys()
    one = next(iter(ref["modes"].values()))
    assert small["modes"][key].keys() == one.keys()
    a, b = small["modes"][key]["run4"], one["run4"]
    assert a.keys() == b.keys()
    for field in a:
        assert [len(x) for x in a[field]] == [len(x) for x in b[field]]

    cfg = reduced("gemma3-1b").replace(dtype="float32")
    params = quantize_params(convert.params_from_numpy(
        T.numpy_params(cfg, check.PARAM_SEED), "cpu"), "int8",
        min_size=check.MIN_SIZE)
    got = check.record(ServeEngine(cfg, T, params, check.BATCH_SLOTS,
                                   check.GEMMA_MAX_LEN),
                       [np.array(p) for p in small["prompts"]],
                       check.MAX_NEW, lambda t: t.numpy())
    problems, _ = check.compare(got, small["modes"][key]["run4"], 1e-4)
    assert not problems, problems

"""The port's serving slice against the JAX package, on reduced SmolLM
with the same weights carried across (``convert.params_from_numpy``):
the transformer's logits, ``quantize_params`` leaf by leaf,
``packed_bytes``, and ``ServeEngine``'s generated tokens, including the
reference's un-reset cache index and its clamped writes past ``max_len``
(ROADMAP C).  Also rebuilds the serving reference at the reduced size and
checks that its format is the committed file's."""

import gc
import json
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as jax_reduced
from repro.models import transformer as JT
from repro.serve import ServeEngine as JaxEngine
from repro.serve import packed_bytes as jax_packed_bytes
from repro.serve import quantize_params as jax_quantize
from repro_torch import convert
from repro_torch.configs import get, reduced
from repro_torch.models import family_module
from repro_torch.models import transformer as T
from repro_torch.serve import (ServeEngine, check, dequantize_params,
                               is_packed, packed_bytes, quantize_params)

from _torch_act_pins import ActPins, jax_act_log
from _torch_helpers import log2_ties
from _torch_serve_ref import QAT_MODES, REF_PATH, build_reference

MIN_SIZE = 1 << 8   # packs every weight of the reduced model
# Logit tolerances against the JAX package on the CPU.  float32: the two
# differ only in the order of float32 sums (measured 3e-7).  bfloat16:
# besides, XLA keeps some bf16 intermediates in float32 (its default
# excess precision), where the port rounds at every place the source
# rounds (measured 3.6e-3 on logits of scale 0.5).
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _configs(dtype):
    return (jax_reduced("smollm-135m").replace(dtype=dtype),
            reduced("smollm-135m").replace(dtype=dtype))


@pytest.fixture(scope="module")
def weights():
    """The same numpy-drawn params in both packages, dense and packed as
    LightPE-1 by the JAX package (so both serve the very same codes)."""
    arrays = T.numpy_params(reduced("smollm-135m"), seed=0)
    jp = jax.tree.map(jnp.asarray, arrays)
    # packed under jit (quick to build; these codes need only be the same
    # in both packages); the leaf-by-leaf test packs eagerly, as served
    jq = jax.jit(jax_quantize, static_argnums=1,
                 static_argnames="min_size")(jp, "lightpe1", min_size=MIN_SIZE)
    as_numpy = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return dict(jax=jp, jax_packed=jq,
                port=convert.params_from_numpy(arrays, "cpu"),
                port_packed=convert.params_from_numpy(as_numpy(jq), "cpu"))


# the JAX model's entry points, compiled once (eager JAX compiles every
# operation anew for every shape)
_jax_forward = jax.jit(JT.forward, static_argnums=2)
_jax_prefill = jax.jit(JT.prefill, static_argnums=2)
_jax_decode = jax.jit(JT.decode_step, static_argnums=2)


def _tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s))


@pytest.mark.parametrize("size", ["full", "reduced"])
def test_config_is_the_reference_config(size):
    """The port's copy of SmolLM-135M, field for field."""
    import dataclasses
    from repro.configs import get as jax_get
    ours = (get if size == "full" else reduced)("smollm-135m")
    theirs = (jax_get if size == "full" else jax_reduced)("smollm-135m")
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.padded_vocab == theirs.padded_vocab
    with pytest.raises(ValueError, match="no config"):
        get("no-such-arch")
    # every config is ported for the workload IR; the transformer runs the
    # lm / moe / vlm families with any perf variant, and refuses the
    # other families
    T.check_supported(get("gemma3-1b"))
    for supported in (dict(kv_replicate_to=8), dict(attn_block_local=True),
                      dict(attn_flash=True), dict(moe_ep_shard_map=True)):
        T.check_supported(ours.replace(**supported))
    for unsupported in (dict(family="ssm"), dict(family="encdec")):
        with pytest.raises(NotImplementedError, match="does not run"):
            T.check_supported(ours.replace(**unsupported))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("packed", [False, True])
def test_forward_prefill_decode_logits(weights, dtype, packed):
    jcfg, cfg = _configs(dtype)
    jp = weights["jax_packed" if packed else "jax"]
    tp = weights["port_packed" if packed else "port"]
    tol = LOGIT_TOL[dtype]
    toks = _tokens(2, 9, cfg.vocab)
    want = _jax_forward(jp, jnp.asarray(toks), jcfg)
    got = T.forward(tp, torch.as_tensor(toks), cfg)
    assert got.dtype == torch.float32 and got.shape == (2, 9, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)

    jcache = JT.init_cache(jcfg, 2, 16, jnp.float32)
    cache = T.init_cache(cfg, 2, 16, torch.float32, device="cpu")
    want, jcache = _jax_prefill(jp, jnp.asarray(toks), jcfg, jcache)
    got, cache = T.prefill(tp, torch.as_tensor(toks), cfg, cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)
    for step in range(3):
        tok = _tokens(2, 1, cfg.vocab, seed=10 + step)
        want, jcache = _jax_decode(jp, jnp.asarray(tok), jcfg, jcache)
        got, cache = T.decode_step(tp, torch.as_tensor(tok), cfg, cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=tol, err_msg=f"decode {step}")
    assert cache["scan"]["index"] == np.asarray(jcache["scan"]["index"]).tolist()
    np.testing.assert_allclose(cache["scan"]["k"].numpy(),
                               np.asarray(jcache["scan"]["k"]), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("pe", ["lightpe1", "lightpe2", "int8", "int4"])
def test_quantize_params_leaf_by_leaf(weights, pe):
    """Same tree, same packed leaves, codes and scales equal (pow2 codes up
    to log2 ties), the same packed bytes, and dequantize_params undoes
    the packing as the reference's does."""
    from repro.serve import dequantize_params as jax_dequantize
    want = jax_quantize(weights["jax"], pe, min_size=MIN_SIZE)
    got = quantize_params(weights["port"], pe, min_size=MIN_SIZE)
    jflat = jax.tree_util.tree_flatten_with_path(want)[0]
    tflat = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        else:
            tflat[path] = tree

    walk(got, ())
    assert len(jflat) == len(tflat)
    for path, leaf in jflat:
        key = tuple(str(p.key) for p in path)
        mine = tflat[key].numpy()
        assert mine.dtype == np.asarray(leaf).dtype, key
        if key[-1] == "codes__pow2":
            w = weights["port"]
            for k in key[:-1]:
                w = w[k]
            # differing bytes only where a weight of the pair sits at a tie
            diff = np.repeat(mine != np.asarray(leaf), 2, axis=-2)
            assert np.all(log2_ties(w.numpy())[diff]), key
        else:
            np.testing.assert_array_equal(mine, np.asarray(leaf), err_msg=key)
    assert packed_bytes(got) == int(jax_packed_bytes(want))
    assert is_packed(got["layers"]["attn"]["wq"])
    assert not is_packed(got["embed"]) and got["embed"] is weights["port"]["embed"]
    dense = dequantize_params(got)
    jdense = jax_dequantize(want)
    np.testing.assert_allclose(dense["layers"]["mlp"]["w_up"].numpy(),
                               np.asarray(jdense["layers"]["mlp"]["w_up"]),
                               rtol=0, atol=1e-6)


def _serve(engine_cls, cfg, mod, params, prompts, slots, max_len, max_new=3):
    eng = engine_cls(cfg, mod, params, batch_slots=slots, max_len=max_len)
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    eng.run()
    assert all(r.done and len(r.out) == max_new for r in reqs)
    index = [int(i) for i in np.asarray(eng.cache["scan"]["index"])]
    return [r.out for r in reqs], index


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", ["more_requests_than_slots", "unreset_index",
                                  "clamp_past_max_len"])
def test_engine_matches_jax(weights, dtype, case):
    """The same tokens and cache index as the JAX engine.  With 4 equal
    prompts in 2 slots, the second round is prefilled at positions 0..S-1
    but written at the stale index 6, so it differs from the first round
    (the reference's fault, reproduced); with max_len 8 the writes clamp."""
    jcfg, cfg = _configs(dtype)
    if case == "more_requests_than_slots":
        prompts = [_tokens(1, n, cfg.vocab, seed=n)[0] for n in (4, 6, 3, 5)]
    else:
        prompts = [np.arange(4) % cfg.vocab] * 4
    max_len = 8 if case == "clamp_past_max_len" else 64
    want, jindex = _serve(JaxEngine, jcfg, JT, weights["jax_packed"], prompts,
                          2, max_len)
    got, index = _serve(ServeEngine, cfg, family_module(cfg),
                        weights["port_packed"], prompts, 2, max_len)
    assert got == want
    assert index == jindex
    if case != "more_requests_than_slots":
        assert index == [12] * cfg.n_layers
        assert want[2] != want[0]   # the fault is exercised


def test_record_leaves_the_engine_to_reference_counting(weights):
    """``check.record`` puts the engine's own steps back after its run, so
    an engine it served is freed as its last reference goes, with the
    cyclic collector off: its KV cache does not linger into a later run
    (and into that run's peak device memory)."""
    cfg = reduced("smollm-135m").replace(dtype="float32")
    eng = ServeEngine(cfg, T, weights["port"], 2, 32)
    steps = (eng._prefill, eng._decode)
    gc.disable()
    try:
        got = check.record(eng, [np.array([1, 2, 3]), np.array([4, 5])], 2,
                           lambda t: t.numpy())
        assert [len(t) for t in got["tokens"]] == [2, 2]
        assert (eng._prefill, eng._decode) == steps
        alive = weakref.ref(eng)
        del eng
        assert alive() is None
    finally:
        gc.enable()


def test_reference_format_is_stable(monkeypatch, record_property):
    """The reference builder at the reduced size (one PE type and type,
    to stay quick) gives the committed file's layout, and the port's
    record of the same run agrees with it; in the QAT run the port takes
    the JAX activation codes at rounding ties (``ActPins``, counted)."""
    ref = json.loads(REF_PATH.read_text())
    assert ref["size"] == "full" and ref["config"] == "smollm-135m"
    assert "--xla_allow_excess_precision=false" in ref["xla_flags"]
    with jax_act_log() as jacts:
        small = build_reference("reduced", pe_types=("int8",),
                                dtypes=("float32",),
                                qat_modes=(("lightpe1", "float32"),))
        calls = jacts.drain()
    assert calls       # the QAT run's activations
    assert small.keys() == ref.keys()
    key = check.mode_key("int8", "float32")
    qat = check.mode_key("lightpe1", "float32")
    assert sorted(ref["qat_modes"]) == sorted(
        check.mode_key(pe, dt) for pe, dt in QAT_MODES)
    for modes, k in (("modes", key), ("qat_modes", qat)):
        assert small[modes][k].keys() == ref[modes][k].keys()
        a, b = small[modes][k]["run4"], ref[modes][k]["run4"]
        assert a.keys() == b.keys()
        for field in a:
            assert [len(x) for x in a[field]] == [len(x) for x in b[field]]
    assert [len(p) for p in ref["prompts"]] == list(check.PROMPT_LENS)
    # SmolLM-135M's 134,515,008 float32 parameters
    full = get("smollm-135m")
    d, f = full.d_model, full.d_ff
    hq, hkv = full.n_heads * full.head_dim, full.kv_heads * full.head_dim
    n_params = (full.padded_vocab * d + d + full.n_layers * (
        2 * d * hq + 2 * d * hkv + 3 * d * f + 2 * d))
    assert n_params == 134_515_008 and ref["dense_bytes"] == 4 * n_params

    cfg = reduced("smollm-135m").replace(dtype="float32")
    params = quantize_params(convert.params_from_numpy(
        T.numpy_params(cfg, check.PARAM_SEED), "cpu"), "int8",
        min_size=check.MIN_SIZE)
    got = check.record(ServeEngine(cfg, T, params, check.BATCH_SLOTS,
                                   check.MAX_LEN),
                       [np.array(p) for p in small["prompts"]],
                       check.MAX_NEW, lambda t: t.numpy())
    problems, _ = check.compare(got, small["modes"][key]["run4"], 1e-4)
    assert not problems, problems
    # the QAT run on the dense weights, compared as the smoke compares it
    dense = convert.params_from_numpy(T.numpy_params(cfg, check.PARAM_SEED),
                                      "cpu")
    pins = ActPins(monkeypatch)
    pins.load(calls)
    got = check.record(ServeEngine(cfg.replace(pe_type="lightpe1"), T, dense,
                                   check.BATCH_SLOTS, check.MAX_LEN),
                       [np.array(p) for p in small["prompts"]],
                       check.MAX_NEW, lambda t: t.numpy())
    assert pins.done()
    record_property("activation_codes_pinned", pins.pinned)
    problems, _ = check.compare(got, small["qat_modes"][qat]["run4"], 1e-4,
                                coupled=True)
    assert not problems, problems


def test_coupled_compare_stops_every_request_at_the_first_difference():
    """Two requests of 4 steps whose tokens differ in request 1 at step 1
    at a near tie: uncoupled, request 0 is compared at every step;
    coupled, neither is compared past step 1, so a logit difference of
    request 0 at step 3 goes unread, and the steps read are counted."""
    def rec(tokens, top):
        return {"tokens": tokens, "margins": [[1.0] * 4, [1.0, 0.01, 1, 1]],
                "top_logits": top, "logits": [[[0.0]] * 4, [[0.0]] * 4]}
    want = rec([[1, 2, 3, 4], [5, 6, 7, 8]], [[0.0] * 4, [0.0] * 4])
    got = rec([[1, 2, 3, 4], [5, 9, 7, 8]], [[0, 0, 0, 0.5], [0.0] * 4])
    assert check.compared_steps(got, want) == [4, 2]
    assert check.compared_steps(got, want, coupled=True) == [2, 2]
    assert check.max_logit_err(got, want) == 0.5
    assert check.max_logit_err(got, want, coupled=True) == 0.0
    problems, _ = check.compare(got, want, 0.1)
    assert problems == ["request 0 step 3: logits differ by 0.5 > 0.1"]
    problems, notes = check.compare(got, want, 0.1, coupled=True)
    assert not problems
    assert notes == [
        "request 0: not compared after step 1, where a token of the batch "
        "differed",
        "request 1 step 1: token 9 vs 6 at a near tie (margin 0.01); not "
        "compared further"]
    assert check.compared_steps(want, want, coupled=True) == [4, 4]

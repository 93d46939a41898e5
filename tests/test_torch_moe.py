"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``) on the CPU: ``moe_apply`` with tokens
dropped past capacity, under FP32, LightPE-1 and INT8 numerics (each
expert's weights and activations fake-quantized on their own, as the
reference's vmap does), ``capacity``, ``router_aux_loss``; the combine's
determinism; the reference's failure on a packed router, which the port
reproduces as an error; the routing record and ``serve.check``'s
comparison of it; and the DeepSeek serving reference's format.

Tolerance: 1e-4 in float32 (the order of float32 sums, as the model
tests); the routing may differ only at a router near tie (a probability
margin below ``ROUTER_TOL``), and then the tokens from the first such
difference on are not compared (they are counted).  Under LightPE-1 and
INT8 an activation code at a round(x / s) tie takes the JAX code
(``_torch_act_pins.ActPins``, the pins counted), as in the model tests.
"""

import json
from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as jax_reduced
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.quant.qconfig import preset as jax_preset
from repro.serve import dequantize_params as jax_dequantize
from repro.serve import quantize_params as jax_quantize
from repro_torch import convert
from repro_torch.configs import reduced
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.quant import fake_quant as tfq, preset
from repro_torch.serve import (ServeEngine, check, dequantize_params,
                               quantize_params)

from _torch_act_pins import (ActPins, jax_act_log,  # noqa: F401
                             one_torch_thread)
from _torch_moe_ref import (REF_PATH, ROUTER_TOL, build_reference,
                            jax_router_log, reference_config)

TOL = 1e-4
CONFIGS = ("deepseek-moe-16b", "phi3.5-moe-42b-a6.6b")


def _layer(name, seed=0):
    """Layer 0's MoE params of the reduced model (numpy) and an input of
    3 x 24 tokens that drops assignments past capacity."""
    cfg = reduced(name)
    arrays = T.numpy_params(cfg, seed)["layers"]["moe"]
    p = jax.tree.map(lambda a: a[0], arrays)
    # tokens near one direction, as a residual stream's: the router favours
    # a few experts
    rng = np.random.default_rng(seed + 1)
    x = (rng.standard_normal(cfg.d_model)
         + 0.5 * rng.standard_normal((3, 24, cfg.d_model))).astype(np.float32)
    return cfg, p, x


def _both(name, pe, p, x, pins=None):
    """(port output, JAX output, port routing, JAX routing); ``pins`` (an
    ``ActPins``) takes the JAX activation codes at rounding ties."""
    cfg = reduced(name)
    with jax_router_log() as jlog, jax_act_log() as jacts:
        want = np.asarray(JM.moe_apply(jax.tree.map(jnp.asarray, p),
                                       jnp.asarray(x), jax_reduced(name),
                                       jax_preset(pe)))
        jroutes = jlog.drain()
        if pins:
            pins.load(jacts.drain())
    with MOE.RouterLog() as log:
        got = MOE.moe_apply(convert.params_from_numpy(p, "cpu"),
                            torch.as_tensor(x), cfg, preset(pe)).numpy()
        routes = log.drain()
    assert pins is None or pins.done()
    return got, want, routes, jroutes


def _compared_tokens(routes, jroutes):
    """Tokens (flat) before the first routing difference, which must be
    at a router near tie."""
    (ids, _), (jids, jm) = routes[0], jroutes[0]
    differ = np.flatnonzero(np.any(ids != jids, axis=-1).reshape(-1))
    assert all(jm.reshape(-1)[t] < ROUTER_TOL for t in differ), differ
    return ids.shape[0] * ids.shape[1] if not len(differ) else differ[0]


@pytest.mark.parametrize("pe", ["fp32", "lightpe1", "int8"])
@pytest.mark.parametrize("name", CONFIGS)
def test_moe_apply_matches_jax(name, pe, monkeypatch, record_property):
    cfg, p, x = _layer(name)
    pins = ActPins(monkeypatch, strict=False)
    got, want, routes, jroutes = _both(name, pe, p, x, pins)
    record_property("activation_codes_pinned", pins.pinned)
    assert got.shape == want.shape == x.shape and got.dtype == want.dtype
    n = _compared_tokens(routes, jroutes)
    assert n > x.shape[0] * x.shape[1] // 2
    np.testing.assert_allclose(got.reshape(-1, cfg.d_model)[:n],
                               want.reshape(-1, cfg.d_model)[:n], rtol=0,
                               atol=TOL)
    assert MOE.dropped(routes[0][0], cfg) > 0


@pytest.mark.parametrize("name", CONFIGS)
def test_capacity_and_aux_loss_match_jax(name):
    cfg, p, x = _layer(name)
    for tokens in (1, 4, 40, 72, 520, 3600):
        assert MOE.capacity(tokens, cfg) == JM.capacity(
            tokens, jax_reduced(name))
    want = JM.router_aux_loss(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              jax_reduced(name))
    got = MOE.router_aux_loss(convert.params_from_numpy(p, "cpu"),
                              torch.as_tensor(x), cfg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_expert_weights_are_fake_quantized_one_by_one(monkeypatch):
    """Each expert's weight takes its own per-channel scale, over its own
    rows: the stack quantized as one (E, d, f) tensor (scales over E x d)
    is another function, and the layer built on it leaves the
    reference."""
    rng = np.random.default_rng(0)
    w = torch.as_tensor((rng.standard_normal((4, 16, 8))
                         * (4.0 ** np.arange(4))[:, None, None])
                        .astype(np.float32))
    for pe in ("int8", "lightpe1", "lightpe2"):
        q = preset(pe)
        each = torch.stack([tfq.fake_quant_weight(w[e], q) for e in range(4)])
        assert torch.equal(tfq.fake_quant_experts(w, q), each)
        assert not torch.equal(tfq.fake_quant_weight(w, q), each)
    x = torch.as_tensor(rng.standard_normal((4, 5, 16)).astype(np.float32))
    q = preset("int8")
    assert torch.equal(tfq.fake_quant_expert_acts(x, q), torch.stack(
        [tfq.fake_quant_act(x[e], q) for e in range(4)]))

    cfg, p, x = _layer("deepseek-moe-16b")
    got, want, routes, jroutes = _both("deepseek-moe-16b", "int8", p, x)
    n = _compared_tokens(routes, jroutes)
    assert np.abs(got - want).reshape(-1, cfg.d_model)[:n].max() <= TOL
    monkeypatch.setattr(MOE, "fake_quant_experts", tfq.fake_quant_weight)
    wrong, *_ = _both("deepseek-moe-16b", "int8", p, x)
    assert np.abs(wrong - want).reshape(-1, cfg.d_model)[:n].max() > 100 * TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_twice_is_bitwise_equal(dtype):
    """The combine adds a token's contributions one at a time in expert
    order, with no atomics: two calls give the same bits."""
    cfg, p, x = _layer("deepseek-moe-16b")
    params = convert.params_from_numpy(p, "cpu")
    xt = torch.as_tensor(x).to(dtype)
    first = MOE.moe_apply(params, xt, cfg, preset("lightpe1"))
    assert first.dtype == torch.float32      # out + shared promotes
    assert torch.equal(first, MOE.moe_apply(params, xt, cfg,
                                            preset("lightpe1")))


def test_packed_moe_raises_in_both_packages():
    """``quantize_params`` packs the stacked router and leaves the 4-D
    expert stacks dense; the reference's ``moe_apply`` then fails on the
    packed router (ROADMAP C) and the port raises, naming that failure.
    Both run the dequantized view of the same packed tree."""
    name = "deepseek-moe-16b"
    cfg = reduced(name)
    arrays = T.numpy_params(cfg, 0)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 6))
    jq = jax_quantize(jax.tree.map(jnp.asarray, arrays), "int8",
                      min_size=1 << 8)
    assert "codes__int8" in jq["layers"]["moe"]["router"]
    assert not isinstance(jq["layers"]["moe"]["experts"]["w_up"], dict)
    with pytest.raises(AttributeError, match="astype"):
        JT.forward(jq, jnp.asarray(toks), jax_reduced(name))
    pq = quantize_params(convert.params_from_numpy(arrays, "cpu"), "int8",
                         min_size=1 << 8)
    assert "codes__int8" in pq["layers"]["moe"]["router"]
    with pytest.raises(NotImplementedError, match="AttributeError"):
        T.forward(pq, torch.as_tensor(toks), cfg.replace(dtype="float32"))
    want = JT.forward(jax_dequantize(jq), jnp.asarray(toks),
                      jax_reduced(name).replace(dtype="float32"))
    got = T.forward(dequantize_params(pq), torch.as_tensor(toks),
                    cfg.replace(dtype="float32"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def test_route_cut_holds_the_routing():
    """``check.compare`` with ``router_tol``: a route that differs at a
    near tie stops the request from that step (noted), or every request
    when the runs are coupled, when no capacity is given, or when the
    difference moved another assignment past capacity; a route that
    differs at a wider margin is a problem."""
    def rec(route, margin):
        return {"tokens": [[1, 2, 3]] * 2, "margins": [[1.0] * 3] * 2,
                "top_logits": [[0.0] * 3] * 2,
                "logits": [[[0.0]] * 3] * 2,
                "routes": [[[[[0, 1]]]] * 3, [[[[0, 1]]], [[route]],
                                             [[[0, 1]]]]],
                "route_margins": [[[[0.5]]] * 3, [[[0.5]], [[margin]],
                                                  [[0.5]]]]}
    want, got = rec([0, 1], 1e-6), rec([0, 2], 1e-6)
    problems, notes = check.compare(got, want, 0.1, router_tol=1e-4)
    assert not problems
    assert "a router near tie" in notes[0]
    assert check.route_cut(got, want, 1e-4)[0] == [1, 1]
    roomy = lambda tokens: 8   # noqa: E731
    assert check.route_cut(got, want, 1e-4, capacity=roomy)[0] == [None, 1]
    assert check.route_cut(got, want, 1e-4, coupled=True,
                           capacity=roomy)[0] == [1, 1]
    # capacity 1: request 0 leaving expert 1 at a near tie lets request
    # 1's assignment to it in, so request 1 is cut too
    want["routes"][0][1], got["routes"][0][1] = [[[0, 1]]], [[[0, 2]]]
    want["route_margins"][0][1] = [[1e-6]]
    want["routes"][1][1] = got["routes"][1][1] = [[[1, 3]]]
    assert check.route_cut(got, want, 1e-4, capacity=lambda t: 1)[0] == [1, 1]
    assert check.route_cut(got, want, 1e-4, capacity=roomy)[0] == [1, None]
    assert check.compared_steps(want, want, cuts=[None, 1]) == [3, 1]
    problems, _ = check.compare(rec([0, 2], 1e-6), rec([0, 1], 0.3), 0.1,
                                router_tol=1e-4)
    assert problems and "router margin 0.3" in problems[0]
    assert check.compare(want, want, 0.1, router_tol=1e-4) == ([], [])


@pytest.mark.parametrize("pe", ["fp32", "lightpe1", "int8"])
@pytest.mark.parametrize("name", CONFIGS)
def test_moe_pinned_to_jax_routing_matches_every_token(name, pe,
                                                       monkeypatch,
                                                       record_property):
    """``RoutePins`` with JAX's routing: the port takes JAX's experts
    where its own differ at a JAX router near tie, and nowhere else; then,
    the activation codes at rounding ties pinned too, every token, drops
    included, agrees with JAX within ``TOL``."""
    cfg, p, x = _layer(name)
    with jax_act_log() as jacts:
        _, want, routes, jroutes = _both(name, pe, p, x)
        calls = jacts.drain()
    (ids, _), (jids, _) = routes[0], jroutes[0]
    _compared_tokens(routes, jroutes)        # every flip at a near tie
    acts = ActPins(monkeypatch)
    acts.load(calls)
    with MOE.RoutePins(ROUTER_TOL) as pins, MOE.RouterLog() as log:
        pins.load(jroutes)
        got = MOE.moe_apply(convert.params_from_numpy(p, "cpu"),
                            torch.as_tensor(x), cfg, preset(pe)).numpy()
    assert acts.done()
    record_property("activation_codes_pinned", acts.pinned)
    assert pins.pinned == int(np.any(ids != jids, axis=-1).sum())
    np.testing.assert_array_equal(log.drain()[0][0], jids)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_route_pins_take_the_reference_experts_only_at_near_ties():
    """A token whose reference experts differ at a reference margin below
    the tolerance takes them; one at a wider margin keeps its own; pins
    equal to the layer's own routing change no bit."""
    cfg, p, x = _layer("deepseek-moe-16b")
    params = convert.params_from_numpy(p, "cpu")
    xt, q, k = torch.as_tensor(x), preset("int8"), cfg.moe_topk
    with MOE.RouterLog() as log:
        base = MOE.moe_apply(params, xt, cfg, q)
    (ids, margins), = log.drain()
    with MOE.RoutePins(ROUTER_TOL) as pins:
        pins.load([(ids, np.zeros_like(margins))])
        assert torch.equal(MOE.moe_apply(params, xt, cfg, q), base)
    assert pins.pinned == 0 and not pins.queue
    # the reference: tokens 0 and 1 take their (k+1)-th expert for the k-th
    _, order = MOE._route(xt.reshape(-1, cfg.d_model), params["router"])
    order = order.numpy().reshape(*ids.shape[:2], -1)
    ref_ids = ids.copy()
    for s in (0, 1):
        ref_ids[0, s] = np.sort(np.r_[order[0, s, :k - 1], order[0, s, k]])
    ref_margins = np.ones_like(margins)
    ref_margins[0, 0] = 0.5 * ROUTER_TOL
    with MOE.RoutePins(ROUTER_TOL) as pins, MOE.RouterLog() as log:
        pins.load([(ref_ids, ref_margins)])
        got = MOE.moe_apply(params, xt, cfg, q)
    assert pins.pinned == 1 and pins.masks[0][0, 0] and pins.masks[0].sum() == 1
    (got_ids, _), = log.drain()
    np.testing.assert_array_equal(got_ids[0, 0], ref_ids[0, 0])
    np.testing.assert_array_equal(got_ids[0, 1:], ids[0, 1:])
    np.testing.assert_array_equal(got_ids[1:], ids[1:])
    assert not torch.equal(got[0, 0], base[0, 0])
    with pytest.raises(RuntimeError, match="past the routing"):
        with MOE.RoutePins(ROUTER_TOL):
            MOE.moe_apply(params, xt, cfg, q)


def test_record_pins_each_step_to_the_reference():
    """``check.record(pins=, want=)`` loads each engine step's reference
    routing by slot: a reduced MoE run pinned to its own record moves
    nothing; with one decode route of the reference moved at a near tie,
    that token takes it, the only one pinned in that call."""
    cfg = reduced("deepseek-moe-16b").replace(pe_type="int8",
                                              dtype="float32")
    params = convert.params_from_numpy(T.numpy_params(cfg, check.PARAM_SEED),
                                       "cpu")
    prompts = check.prompts(cfg.vocab)

    def run(want=None):
        eng = ServeEngine(cfg, T, params, check.BATCH_SLOTS, check.MAX_LEN)
        pins = MOE.RoutePins(ROUTER_TOL)
        with MOE.RouterLog() as log, (pins if want else nullcontext()):
            rec = check.record(eng, prompts, 4, lambda t: t.numpy(),
                               router=log, pins=pins if want else None,
                               want=want)
        return rec, pins

    first, _ = run()
    again, pins = run(first)
    assert pins.pinned == 0 and again["routes"] == first["routes"]
    assert again["logits"] == first["logits"]
    want = json.loads(json.dumps(first))
    old = want["routes"][2][1][0][0]
    want["routes"][2][1][0][0] = sorted(
        set(old) ^ {old[-1], next(e for e in range(cfg.moe_experts)
                                  if e not in old)})
    want["route_margins"][2][1][0][0] = 0.0
    moved, pins = run(want)
    layers = len(first["routes"][0][0])      # MoE calls a step
    assert not any(m.any() for m in pins.masks[:layers])
    step1 = pins.masks[layers]
    assert step1[2, 0] and step1.sum() == 1
    assert moved["routes"][2][1][0][0] == want["routes"][2][1][0][0]
    assert moved["routes"][2][0] == first["routes"][2][0]
    assert moved["routes"][1] == first["routes"][1]


def test_moe_reference_format_is_stable():
    """``build_reference`` at the reduced size (one mode, float32) gives
    the committed full-size file's layout, and the port's record of the
    same run agrees with it, routing included."""
    ref = json.loads(REF_PATH.read_text())
    assert ref["size"] == "full" and ref["config"] == "deepseek-moe-16b"
    assert ref["n_layers"] == 3 and ref["router_tol"] == ROUTER_TOL
    assert "--xla_allow_excess_precision=false" in ref["xla_flags"]
    assert sorted(ref["modes"]) == ["fp32", "int8", "lightpe1"]
    assert [len(p) for p in ref["prompts"]] == list(check.PROMPT_LENS)
    # the reference's own init_params tree at the 3-layer full width
    shapes = jax.eval_shape(
        lambda key: JT.init_params(reference_config("full"), key),
        jax.random.PRNGKey(0))
    n_params = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    assert ref["dense_bytes"] == 4 * n_params
    small = build_reference("reduced", modes=(("lightpe1", "float32"),))
    assert small.keys() == ref.keys()
    key = check.mode_key("lightpe1", "float32")
    mode = small["modes"][key]
    assert mode.keys() == ref["modes"]["fp32"].keys()
    assert mode["routing"].keys() == ref["modes"]["fp32"]["routing"].keys()
    for field in mode["run4"]:
        assert [len(x) for x in mode["run4"][field]] == [
            len(x) for x in ref["modes"]["fp32"]["run4"][field]]

    cfg = reduced("deepseek-moe-16b").replace(pe_type="lightpe1",
                                              dtype="float32")
    params = convert.params_from_numpy(T.numpy_params(cfg, check.PARAM_SEED),
                                       "cpu")
    with MOE.RouterLog() as log:
        got = check.record(ServeEngine(cfg, T, params, check.BATCH_SLOTS,
                                       check.MAX_LEN),
                           [np.array(p) for p in small["prompts"]],
                           check.MAX_NEW, lambda t: t.numpy(), router=log)
    problems, _ = check.compare(got, mode["run4"], TOL, coupled=True,
                                router_tol=ROUTER_TOL)
    assert not problems, problems
    assert check.compared_steps(got, mode["run4"], coupled=True) == [
        check.MAX_NEW] * 4

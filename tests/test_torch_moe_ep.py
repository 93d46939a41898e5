"""The port's expert-parallel MoE layer (``moe.moe_apply_ep``, perf
variant ``moe_ep_shard_map``) against the JAX package's.

Reduced DeepSeek-MoE-16B in float32 on a (1, 4) mesh of 4 gloo ranks,
each rank its slice of the sequence and 2 of the 8 experts, the token
payloads exchanged with ``all_to_all_single``, under the float32 and the
int8 payload; the reference ran on 4 virtual devices
(``tests/data/torch_launch_ref.json``, written by
``tests/_torch_launch_ref.py``).  Each shard computes its capacity from
its own tokens, so drops differ from ``moe_apply``'s: the reference's EP
logits sit 2.38 from its ``moe_apply`` ones, and the port's EP is held
to the reference's EP, never to ``moe_apply``.

Tolerance: the port's MoE tolerance, 1e-4 in float32 (``test_torch_moe``).
Router near ties (margin below ``ROUTER_TOL``) take the reference's
experts (``RoutePins``), payload codes one step apart at a rounding tie
the reference's codes (``PayloadPins``); both counted, and a code that
differs away from a tie fails.  Both fallbacks to ``moe_apply`` (no
mesh; a sequence the ``model`` axis does not divide, as at decode) are
bitwise.
"""

import json

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import list_archs
from repro_torch.models import transformer as T

from _torch_act_pins import TIE
from _torch_dist import run_ranks
from _torch_launch_ref import N_DEV, REF_PATH, moe_inputs, unb64
from _torch_moe_ref import ROUTER_TOL

TOL = 1e-4


@pytest.fixture(scope="module")
def ref():
    return json.loads(REF_PATH.read_text())["moe_ep"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = run_ranks(N_DEV, [{"name": "moe_ep", "router_tol": ROUTER_TOL,
                             "payload_tie": TIE}],
                    tmp_path_factory.mktemp("moe_ep"))
    return out["moe_ep"]


@pytest.mark.parametrize("payload", ["float32", "int8"])
def test_ep_on_four_gloo_ranks_matches_the_reference_ep(payload, ref, ranks):
    run = ref["runs"][payload]
    want = unb64(run["logits"], np.float32, run["shape"])
    assert sorted(m["coord"]["model"] for m, _ in ranks) == list(range(N_DEV))
    for meta, arrays in ranks:
        got = arrays[payload]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        pins = meta[payload]
        assert pins["routes_left"] == 0 and pins["payloads_left"] == 0
        assert pins["payload_away"] == 0
        print(f"{payload} rank {meta['coord']['model']}: max abs err "
              f"{np.abs(got - want).max():.3g}; pinned {pins['route_pins']} "
              f"router ties, {pins['payload_pins']} payload codes")


def test_the_reference_file_matches_its_inputs(ref):
    """The reference was written from the inputs these tests rebuild
    (``_torch_launch_ref``'s seeds and shapes): rewrite it with
    ``PYTHONPATH=src:tests python tests/_torch_launch_ref.py`` if not."""
    import _torch_launch_ref as R
    full = json.loads(REF_PATH.read_text())
    cfg, _, tokens = moe_inputs()
    assert ref["config"] == R.MOE_CONFIG and ref["param_seed"] == R.MOE_PARAM_SEED
    np.testing.assert_array_equal(np.array(ref["tokens"]), tokens)
    assert ref["mesh"] == [1, N_DEV] and full["n_devices"] == N_DEV
    gc = full["grad_compress"]
    assert gc["seed"] == R.GC_SEED
    assert [tuple(s) for s in gc["shapes"]] == list(R.GC_SHAPES)
    assert full["sharding"]["mesh"] == list(R.SHARD_MESH)
    assert (full["sharding"]["batch"], full["sharding"]["seq"]) == (
        R.SHARD_BATCH, R.SHARD_SEQ)
    assert set(full["sharding"]["configs"]) == set(list_archs())
    for run in ref["runs"].values():
        assert len(run["routes"]) == cfg.n_layers - cfg.first_dense


def test_every_rank_returns_the_whole_output(ranks):
    for payload in ("float32", "int8"):
        first = ranks[0][1][payload]
        assert all(np.array_equal(a[payload], first) for _, a in ranks)


def test_ep_is_not_moe_apply(ref, ranks):
    """Per-shard capacity drops other assignments than moe_apply's, as in
    the reference (its EP sits far from its moe_apply): the port's EP
    output must differ from the port's moe_apply output by as much."""
    cfg, arrays, tokens = moe_inputs()
    params = convert.params_from_numpy(arrays, "cpu")
    with torch.no_grad():
        base = T.forward(params, torch.from_numpy(tokens).long(),
                         cfg.replace(moe_ep_shard_map=False)).numpy()
    for payload in ("float32", "int8"):
        far = np.abs(ranks[0][1][payload] - base).max()
        want = ref["runs"][payload]["max_abs_diff_from_moe_apply"]
        assert far > 0.1 and abs(far - want) < 1e-3 * max(1.0, want), \
            (far, want)


def test_falls_back_where_the_model_axis_does_not_divide_the_sequence(ranks):
    assert [m["uneven_differing"] for m, _ in ranks] == [0] * N_DEV


def test_falls_back_without_a_mesh(ranks):
    assert [m["no_mesh_differing"] for m, _ in ranks] == [0] * N_DEV
    # and in this process, which has no process group at all
    cfg, arrays, tokens = moe_inputs()
    params = convert.params_from_numpy(arrays, "cpu")
    t = torch.from_numpy(tokens).long()
    with torch.no_grad():
        a = T.forward(params, t, cfg)
        b = T.forward(params, t, cfg.replace(moe_ep_shard_map=False))
    assert torch.equal(a, b)


def test_ep_training_on_two_ranks_matches_moe_apply_in_one_process(
        tmp_path):
    """The EP layer's gradient: reduced DeepSeek-MoE-16B trained 2 AdamW
    steps on a (1, 2) mesh (each rank 4 of the 8 experts and half the
    tokens; a rank's part of the gradient of the tokens, the router and
    the experts summed over the group), with a capacity factor of E / k
    so that no assignment is dropped and the layer computes
    ``moe_apply``'s function; held to ``moe_apply`` trained in this
    process at rtol 1e-5 (float32 sums in another order)."""
    from repro_torch.data import lm_pipeline
    from repro_torch.models import family_module
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import init_state, make_train_step
    from _torch_dist_worker import _flat, ep_train_config
    run = dict(lr=1e-3, steps=2, batch=2, seq=16)
    out = run_ranks(2, [{"name": "ep_train", "mesh": [1, 2], **run}],
                    tmp_path)["ep_train"]
    cfg = ep_train_config().replace(moe_ep_shard_map=False)
    mod = family_module(cfg)
    opt = adamw(warmup_cosine(run["lr"], 20, run["steps"]))
    state = init_state(cfg, mod, opt, torch.Generator().manual_seed(0),
                       device="cpu")
    step = make_train_step(cfg, mod, opt)
    pipe = lm_pipeline(cfg, run["batch"], run["seq"], device="cpu")
    metrics = []
    for _ in range(run["steps"]):
        state, m = step(state, next(pipe))
        metrics.append([m["loss"].item(), m["grad_norm"].item()])
    want = {"/".join(map(str, k)): v.detach().numpy()
            for k, v in _flat(state.params)}
    for meta, arrays in out:
        np.testing.assert_allclose(meta["metrics"], metrics, rtol=1e-5)
        assert set(arrays) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(arrays[k], v, rtol=1e-5, atol=1e-7,
                                       err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_payload_quantizer_matches_the_reference_formula(dtype):
    """``_int8_payload`` against the reference's int8 wire quantizer
    (``src/repro/models/moe.py:178-181``, a closure inside the reference's
    shard_map block, so computed here with the same jnp operations), in
    the payload's own type, zero rows included."""
    import jax.numpy as jnp
    from repro_torch.models.moe import _int8_payload
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 2, 8, 64)).astype(np.float32) * 3
    x[0, 1] = 0.0                                   # unused capacity rows
    jx = jnp.asarray(x, dtype)
    absmax = jnp.max(jnp.abs(jx), axis=-1, keepdims=True)
    jscale = jnp.maximum(absmax, 1e-8) / 127.0
    jq = jnp.clip(jnp.round(jx / jscale), -127, 127).astype(jnp.int8)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    q, scale = _int8_payload(tx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.float().numpy(),
                                  np.asarray(jscale, np.float32))
    assert scale.dtype == tx.dtype

"""The baseline MoE layer's capacity under more than one dp rank, held to
the JAX package's pjit step on 4 devices.

The reference's ``moe_apply`` under pjit sees the global batch: its
capacity is computed over the global tokens and an assignment's place in
its expert is its place in the whole batch, token-major
(``src/repro/models/moe.py:59``, ``:69``).  Each rank of the port holds
its slice of the batch; it all-gathers its per-expert counts over the dp
group and places its assignments after the earlier ranks' (``moe._dispatch``).
Reduced DeepSeek-MoE-16B in float32, capacity factor 1.0 (tokens are
dropped: the reference file states how many), 3 AdamW steps on a global
batch of 8 x 16, on 2 and 4 gloo ranks (``tests/_torch_dist.py``),
against ``tests/data/torch_launch_ref.json``'s ``moe_capacity`` (written
by ``tests/_torch_launch_ref.py``, 4 virtual devices).

Under a quantizing PE type (``moe_capacity_qat``: INT8) every expert's
activation scale is its (C, K) buffer's absmax, over the global batch's
buffer in the reference; each rank of the port holds its slice of that
buffer and takes the max over the dp ranks (``quant.fake_quant_expert_acts``,
``launch.mesh.dp_max``).  A rank's own absmax moves the 8-bit codes: the
first step's gradient norm by 1.2e-3 (2 ranks) and 3.4e-3 (4 ranks)
relative.  Held: the drops; the first step's loss and gradient norm to
the reference at rtol 2e-5; every step, and the routers after, to the
port's own one-rank run at the float32 tolerances below.  Why not every
step to the reference (``tests/_torch_moe_qat_flips.py``): under FP32
numerics the port's one-rank steps are within 5e-7 of the reference's;
under INT8 within 9.6e-6 at the first step and 7.1e-3 after.  The port's
own run with every scale one float32 ulp larger moves by as much (9.7e-6,
then 4.1e-3 and 6.4e-3): of the first step's 794,624 codes, 7 lie within
an ulp of a rounding tie, and AdamW carries a flipped one on.

Tolerances: losses and gradient norms rtol 1e-5, the routers after the
steps atol 1e-5 (float32 across the packages; a different drop moves the
loss by ~1e-2).  The drops must be equal, summed over the ranks.  One dp
rank is the plain trainer's function bit for bit.

Every step held to the reference: the reference file also holds, of the
same INT8 steps, every affine code of the JAX package at a rounding tie
(x / s within ``_torch_act_pins.TIE`` of a half-integer, located by
position in each quantization, found by a fingerprint of its x / s:
``jax_code_log``, ``CodePins``).  The port on one rank with those codes
pinned (4 of them in the 3 steps) equals the reference at every step at
rtol 2e-5 and its routers at ATOL (measured 1.6e-7 and 3e-8; unpinned it
parts by 7.1e-3 after the first step).  A dp rank's tensors are slices of
the reference's (its expert buffers hold its own assignments), which the
pins do not locate: the dp runs stay held to the one-rank port.
"""

import json

import numpy as np
import pytest

from _torch_dist import run_ranks
from _torch_launch_ref import REF_PATH, unb64

RTOL = 1e-5
ATOL = 1e-5


@pytest.fixture(scope="module")
def ref():
    return json.loads(REF_PATH.read_text())["moe_capacity"]


@pytest.fixture(scope="module")
def ref_qat():
    return json.loads(REF_PATH.read_text())["moe_capacity_qat"]


def test_the_reference_run_drops_tokens(ref):
    assert ref["capacity_factor"] == 1.0 and ref["mesh"] == [4, 1]
    assert all(d > 0 for d in ref["drops"]), ref["drops"]
    # no routing decision of the reference sits near a tie the packages'
    # float32 noise could flip
    assert ref["min_router_margin"] > 1e-4


@pytest.mark.parametrize("n", [2, 4])
def test_dp_ranks_match_the_reference_pjit_step(n, ref, tmp_path):
    _held(n, ref, {}, tmp_path)


@pytest.fixture(scope="module")
def one_rank_runs(ref_qat, tmp_path_factory):
    """The QAT run on one dp rank with the plain trainer's beside it, and
    the same run with the reference's codes at ties pinned, in one
    process."""
    out = run_ranks(
        1, [{"name": "moe_capacity", "mesh": [1, 1], "plain": True,
             "pe_type": ref_qat["pe_type"]},
            {"name": "pinned", "kind": "moe_capacity", "mesh": [1, 1],
             "pins": True, "pe_type": ref_qat["pe_type"]}],
        tmp_path_factory.mktemp("one_rank_qat"))
    return out["moe_capacity"][0], out["pinned"][0]


@pytest.fixture(scope="module")
def one_rank_qat(one_rank_runs):
    return one_rank_runs[0]


@pytest.mark.parametrize("n", [2, 4])
def test_qat_dp_ranks_match_the_reference_pjit_step(n, ref_qat, one_rank_qat,
                                                    tmp_path):
    """The experts' activation scales span the dp ranks' buffers."""
    assert ref_qat["pe_type"] == "int8"
    assert ref_qat["min_router_margin"] > 1e-4
    out = run_ranks(n, [{"name": "moe_capacity", "mesh": [n, 1],
                         "pe_type": ref_qat["pe_type"]}],
                    tmp_path)["moe_capacity"]
    drops = np.sum([meta["drops"] for meta, _ in out], axis=0)
    assert drops.tolist() == ref_qat["drops"]
    one, one_params = one_rank_qat
    for meta, params in out:
        got = np.asarray(meta["metrics"])
        np.testing.assert_allclose(got[0], [ref_qat["losses"][0],
                                            ref_qat["grad_norms"][0]],
                                   rtol=2e-5)
        np.testing.assert_allclose(got, one["metrics"], rtol=RTOL)
        np.testing.assert_allclose(params["layers/moe/router"],
                                   one_params["layers/moe/router"],
                                   atol=ATOL, rtol=0)


def _held(n, ref, extra, tmp_path):
    out = run_ranks(n, [{"name": "moe_capacity", "mesh": [n, 1], **extra}],
                    tmp_path)["moe_capacity"]
    drops = np.sum([meta["drops"] for meta, _ in out], axis=0)
    assert drops.tolist() == ref["drops"]
    for meta, params in out:
        got = np.asarray(meta["metrics"])
        np.testing.assert_allclose(got[:, 0], ref["losses"], rtol=RTOL)
        np.testing.assert_allclose(got[:, 1], ref["grad_norms"], rtol=RTOL)
        want = unb64(ref["routers"], np.float32, ref["routers_shape"])
        np.testing.assert_allclose(params["layers/moe/router"], want,
                                   atol=ATOL, rtol=0)


def test_one_dp_rank_is_the_plain_step_bitwise(tmp_path):
    (meta, _), = run_ranks(1, [{"name": "moe_capacity", "mesh": [1, 1],
                                "plain": True}], tmp_path)["moe_capacity"]
    assert meta["plain_differing"] == 0
    assert meta["metrics"] == meta["plain_metrics"]


def test_one_dp_rank_is_the_plain_step_bitwise_under_qat(one_rank_qat):
    """Over one dp rank no collective runs: the plain trainer's step."""
    meta, _ = one_rank_qat
    assert meta["plain_differing"] == 0
    assert meta["metrics"] == meta["plain_metrics"]


def test_qat_one_rank_pinned_at_ties_matches_the_reference_every_step(
        ref_qat, one_rank_runs):
    meta, params = one_rank_runs[1]
    pins = meta["pins"]
    assert pins["unmatched"] == 0 and pins["pinned"] > 0, pins
    assert meta["drops"] == ref_qat["drops"]
    np.testing.assert_allclose(
        meta["metrics"], np.array([ref_qat["losses"],
                                   ref_qat["grad_norms"]]).T, rtol=2e-5)
    want = unb64(ref_qat["routers"], np.float32, ref_qat["routers_shape"])
    np.testing.assert_allclose(params["layers/moe/router"], want, atol=ATOL,
                               rtol=0)

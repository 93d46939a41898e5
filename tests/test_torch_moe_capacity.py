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

Tolerances: losses and gradient norms rtol 1e-5, the routers after the
steps atol 1e-5 (float32 across the packages; a different drop moves the
loss by ~1e-2).  The drops must be equal, summed over the ranks.  One dp
rank is the plain trainer's function bit for bit.
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


def test_the_reference_run_drops_tokens(ref):
    assert ref["capacity_factor"] == 1.0 and ref["mesh"] == [4, 1]
    assert all(d > 0 for d in ref["drops"]), ref["drops"]
    # no routing decision of the reference sits near a tie the packages'
    # float32 noise could flip
    assert ref["min_router_margin"] > 1e-4


@pytest.mark.parametrize("n", [2, 4])
def test_dp_ranks_match_the_reference_pjit_step(n, ref, tmp_path):
    out = run_ranks(n, [{"name": "moe_capacity", "mesh": [n, 1]}],
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

"""The tensor-parallel split of the SSM and hybrid families on gloo ranks,
held to the JAX package's GSPMD runs on the same meshes
(``tests/data/torch_ssm_tp_ref.json``, written by
``tests/_torch_ssm_tp_ref.py`` on 4 host devices) and to the port's own
run on one rank.

Each rank of a ``model`` group computes its heads of RWKV6's time mix
(and its columns of the channel mix), of each Mamba2 block (the
``in_proj`` product gathered, its heads' z / x / dt and all of B / C
taken, the conv on its channels, the scan on its heads, the gated norm's
mean square summed over the group) and of Zamba2's shared attention and
MLP, and its vocabulary rows.  Reduced RWKV6 and Zamba2 in float32, 3
AdamW steps on a global batch of 4 x 32 (``_torch_tp_ref``'s): on (1, 2),
(2, 2) and (1, 4) (where Zamba2's 2 Mamba2 heads do not divide the group
and its blocks stay whole, their weight gradients over the rank's
tokens) under FP32, and on (1, 2) under LightPE-1; serving (a prefill of
8 tokens and 4 decode steps on a float32 cache: RWKV6's ``s`` split over
heads, Zamba2's ``s`` over heads, its conv window over its channels, its
KV cache over its heads) on (1, 2).  The two rank groups run at once.

Tolerances.  The split sums partial products in another order than one
device, as GSPMD does: under FP32 every step's loss and gradient norm
within rtol 1e-5 of the one-rank port and, from the second step, of JAX
plus the spread of JAX's own runs of the same config on the other meshes
(``jax_spread``: AdamW's first step moves each element by about lr times
its gradient's sign, so a near-zero gradient element whose sign the sum
order flips moves the second step's gradient norm; RWKV6's JAX runs on
(1, 2), (2, 2) and (1, 4) differ there by 1.4e-5 relative, Zamba2's by
1.6e-7); the first step within 1e-5 of JAX; the params' change over the
run within 1e-3 (``tp_check.change_gap``); serving logits within 1e-5,
the greedy tokens equal.  Under LightPE-1 an 8-bit activation code
at a round(x / s) tie takes the other code in another sum order, so the
split's codes are pinned at ties to the one-rank port's run
(``_torch_act_pins.SplitActPins``, counted and printed with ``-s``):
then the split is held to the one-rank port at rtol 1e-5 and the change
within 1e-3, and to JAX no farther than the one-rank port is plus 1e-5.

The control: RWKV6 on (1, 2) with the replicated leaves its mixes use for
the rank's heads alone (``mu``, ``wa``, ``wb``, ``w0``, ``u``, ``ln_x``)
taking their gradients unsummed must miss the reference at the first
step's gradient norm.
"""

import concurrent.futures
import json

import numpy as np
import pytest
import torch

import _torch_ssm_tp_ref as R
from _torch_act_pins import port_act_log
from _torch_dist import run_ranks
from repro_torch import convert, tp_check
from repro_torch.launch.mesh import ModelSplit
from repro_torch.launch.sharding import ssm_heads

RTOL, GAP = 1e-5, 1e-3
SERVE_ATOL = 1e-5
TRAIN = {key: (arch, list(mesh), pe) for key, arch, mesh, pe in R.TRAIN}
SERVE = dict(R.SERVE)
CONTROL = "rwkv_1x2"


@pytest.fixture(scope="module")
def ref():
    return json.loads(R.REF_PATH.read_text())


def _task(key, **extra):
    arch, mesh, pe = TRAIN[key]
    return {"name": key, "kind": "tp_train", "arch": arch, "mesh": mesh,
            "pe_type": pe, **extra}


def _one_run(key, log=False):
    """The port's plain run of a case on one rank; with ``log`` its
    activation calls too."""
    arch, _, pe = TRAIN[key]
    cfg = R.config(arch, pe)
    params = convert.params_from_numpy(R.numpy_params(cfg), "cpu")
    with port_act_log() as acts:
        run = tp_check.train_run(cfg, R.STEPS, 0, 0, "cpu", params=params,
                                 batches=R.tp_batches(cfg), count=True)
    return run, acts.calls if log else None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(2 ranks' results, 4 ranks', the one-rank runs): the LightPE-1
    one-rank runs first (their activation logs pin the split's), then the
    two rank groups at once, the other one-rank runs in this process
    meanwhile (one torch thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        work = tmp_path_factory.mktemp("ssm_tp")
        one, two, four = {}, [], []
        for key, (_, mesh, pe) in TRAIN.items():
            extra = {}
            if pe == "lightpe1":
                one[key], calls = _one_run(key, log=True)
                path = work / f"{key}_acts.npz"
                np.savez(path, **{f"{k}{i}": a for i, c in enumerate(calls)
                                  for k, a in zip(("ratio", "codes"), c)})
                extra["pins"] = str(path)
            (two if np.prod(mesh) == 2 else four).append(_task(key, **extra))
        two += [{"name": k, "kind": "tp_serve", "arch": a, "mesh": [1, 2]}
                for k, a in SERVE.items()]
        two.append(_task(CONTROL, name="control", variant="unsummed_leaves",
                         steps=1, count=False))
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            w2 = pool.submit(run_ranks, 2, two, work / "two")
            w4 = pool.submit(run_ranks, 4, four, work / "four")
            for key in TRAIN:
                if key not in one:
                    one[key] = _one_run(key)[0]
            return w2.result(), w4.result(), one
    finally:
        torch.set_num_threads(n)


def jax_spread(ref, arch) -> np.ndarray:
    """(steps, 2): the largest relative difference of each step's loss
    and gradient norm between JAX's FP32 runs of ``arch`` on its
    meshes."""
    rows = [np.array([r["losses"], r["grad_norms"]]).T
            for key, r in ref["train"].items()
            if TRAIN[key][0] == arch and TRAIN[key][2] == "fp32"]
    return np.max([np.abs(a - b) / np.abs(b) for a in rows for b in rows],
                  axis=0)


def _split(key, runs):
    return runs[0 if np.prod(TRAIN[key][1]) == 2 else 1][key]


def _digest(d):
    return {k: v[:R.DIGEST] for k, v in d.items()}


@pytest.mark.parametrize("key", list(TRAIN))
def test_split_training_matches_jax_and_one_rank(key, ref, runs):
    want = ref["train"][key]
    jax_rows = np.array([want["losses"], want["grad_norms"]]).T
    jax_final = {k: R.unb64(v) for k, v in want["final"].items()}
    one = runs[2][key]
    one_rows = np.array(one["rows"])
    start, one_final = _digest(one["start"]), _digest(one["final"])
    pe = TRAIN[key][2]
    split = _split(key, runs)
    for meta, final in split:
        got = np.array(meta["rows"])
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, one_rows, rtol=RTOL)
        assert tp_check.change_gap(start, final, one_final) <= GAP
        if pe == "lightpe1":
            print(f"{key} rank {meta['coord']}: {meta['pinned']} activation "
                  f"codes pinned at ties to the one-rank run")
            assert meta["pins_done"]
            assert np.all(np.abs(got - jax_rows) <= np.abs(one_rows - jax_rows)
                          + RTOL * np.abs(jax_rows))
        else:
            np.testing.assert_allclose(got[0], jax_rows[0], rtol=RTOL)
            tol = RTOL + jax_spread(ref, TRAIN[key][0])
            assert np.all(np.abs(got - jax_rows) <= tol * np.abs(jax_rows)), \
                (got, jax_rows, tol)
            assert tp_check.change_gap(start, final, jax_final) <= GAP
        # each rank computed its part: fewer FLOPs than its dp share of
        # one rank's step, and partial sums met over the group
        n_dp = TRAIN[key][1][0]
        assert meta["flops"] * n_dp < one["flops"], (meta["flops"],
                                                     one["flops"])
        assert meta["collectives"].get("all-reduce", 0) > 0
    # every leaf the same on every rank
    for _, final in split[1:]:
        for k, v in final.items():
            np.testing.assert_array_equal(v, split[0][1][k], err_msg=k)


@pytest.mark.parametrize("key", list(SERVE))
def test_split_serving_matches_jax_and_one_rank(key, ref, runs):
    want = ref["serve"][key]
    jax_logits = R.unb64(want["logits"]).reshape(want["shape"])
    cfg = R.config(SERVE[key])
    params = convert.params_from_numpy(R.numpy_params(cfg), "cpu")
    one = tp_check.serve_run(cfg, torch.from_numpy(R.serve_tokens(cfg)),
                             R.PROMPT, R.CACHE, "cpu",
                             cache_dtype=torch.float32, params=params)
    np.testing.assert_allclose(one["logits"], jax_logits, rtol=0,
                               atol=SERVE_ATOL)
    for _, arrays in runs[0][key]:
        got = arrays["logits"]
        assert got.shape == jax_logits.shape == one["logits"].shape
        np.testing.assert_allclose(got, jax_logits, rtol=0, atol=SERVE_ATOL)
        np.testing.assert_allclose(got, one["logits"], rtol=0,
                                   atol=SERVE_ATOL)
        np.testing.assert_array_equal(arrays["greedy"],
                                      np.argmax(jax_logits, axis=-1))


def test_unsummed_replicated_leaves_miss_the_reference(ref, runs):
    """The control: the mixes' replicated leaves' gradients left each
    rank's part are another function; the first step's gradient norm
    shows it beyond the tolerance."""
    want = ref["train"][CONTROL]
    first = np.array([want["losses"][0], want["grad_norms"][0]])
    for meta, _ in runs[0]["control"]:
        got = np.array(meta["rows"][0])
        assert np.abs(got - first).max() / np.abs(first).max() > RTOL, got


@pytest.mark.parametrize("n_heads,widths,size,want", [
    # RWKV6-1.6B at 16: 2 heads of 64 a rank (its 7,168-column channel mix
    # divides too)
    (32, (7168,), 16, [(2, 2 * r, True) for r in range(16)]),
    # Zamba2-7B at 16: 7 of 112 Mamba2 heads, its 14,576-column in_proj
    # 911 a rank
    (112, (14576,), 16, [(7, 7 * r, True) for r in range(16)]),
    # reduced Zamba2 at 4: 2 heads do not divide, the block whole
    (2, (290,), 4, [(2, 0, False)] * 4),
    # heads that divide, a width that does not: whole
    (4, (6,), 4, [(4, 0, False)] * 4),
])
def test_ssm_heads_of_each_rank(n_heads, widths, size, want):
    got = [tuple(ssm_heads(n_heads, ModelSplit(None, size, r), *widths))
           for r in range(size)]
    assert got == want
    assert ssm_heads(n_heads, None, *widths) == (n_heads, 0, False)

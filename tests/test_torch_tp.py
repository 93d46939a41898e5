"""The tensor-parallel split of the decoder family on gloo ranks, held to
the JAX package's GSPMD runs on the same meshes
(``tests/data/torch_tp_ref.json``, written by ``tests/_torch_tp_ref.py``
on 4 host devices) and to the port's own run on one rank.

Each rank of a ``model`` group computes its attention heads, MLP columns,
vocabulary rows and experts (``transformer.keeps_model_shard``); the
reduced configs in float32, 3 AdamW steps on a global batch of 4 x 32:
Qwen3 on (1, 2) (q and kv split) and (1, 4) (q split, one replicated KV
head a rank), Gemma-3 on (1, 2) (windows, the tied vocabulary-parallel
head), SmolLM on (1, 2) (the attention whole, the MLP and vocabulary
split), DeepSeek-MoE on (2, 2) (experts, FSDP and TP together) under
FP32, LightPE-1 and INT8; serving (a prefill of 8 tokens and 4 decode
steps) on (1, 2); a checkpoint and resume on (1, 2).  One ``run_ranks``
call a world size runs every task of it.

Tolerances.  The split sums the ranks' partial products in another order
than one device, as GSPMD does, so the runs agree to float32 noise:
every step's loss and gradient norm at rtol 1e-5 (FP32; measured at most
2.5e-7 against JAX) and 2e-5 (INT8: an 8-bit code at a rounding tie
moves the first step's gradient norm by 1.0e-5 between sum orders, the
tolerance of ``test_torch_moe_capacity.py``'s first step); the params'
change over the run against the reference's, ``|d - d_ref| / |d_ref|``
a leaf on ``tp_check.param_digest``'s elements, within 1e-3 (measured at
most 5.8e-5 under FP32, 5.0e-4 under INT8).  Under LightPE-1 the port on
one rank already parts from JAX at the first step (loss 1.2e-3, gradient
norm 1.0e-2 relative: a pow2 weight code, an 8-bit activation code or a
routing decision of the flat random router at a tie), so the split is
held to the one-rank port (first step rtol 1e-5, every step 1e-3, the
change within 5e-2: measured 2.3e-6, 1.6e-4 and 2.9e-2) and to JAX no
farther than the one-rank port is plus that.  Serving: logits within
1e-5 (measured 3.7e-6), the greedy tokens equal.  The resume equals the
uninterrupted run bit for bit.

The control: the same DeepSeek INT8 run with every scale that spans the
model group taken over the rank's own slice (the row-split weights'
per-channel scales, the split activations' absmax) must miss the
reference at the first step (it reads 4.5e-5 in the loss and 1.1e-2 in
the gradient norm).
"""

import concurrent.futures
import json

import numpy as np
import pytest
import torch

import _torch_tp_ref as R
from _torch_dist import run_ranks
from repro_torch import convert, tp_check
from repro_torch.launch.sharding import attn_heads
from repro_torch.launch.mesh import ModelSplit
from repro_torch.models import transformer as T

RTOL = {"fp32": 1e-5, "int8": 2e-5}
GAP = 1e-3
QAT_FIRST, QAT_RTOL, QAT_GAP = 1e-5, 1e-3, 5e-2     # LightPE-1 vs one rank
SERVE_ATOL = 1e-5
TRAIN = {key: (arch, list(mesh), pe) for key, arch, mesh, pe in R.TRAIN}
SERVE = {key: (arch, over, quant) for key, arch, over, quant in R.SERVE}


@pytest.fixture(scope="module")
def ref():
    return json.loads(R.REF_PATH.read_text())


def _train_task(key, **extra):
    arch, mesh, pe = TRAIN[key]
    return {"name": key, "kind": "tp_train", "arch": arch, "mesh": mesh,
            "pe_type": pe, **extra}


def _world2(work):
    tasks = [_train_task(k) for k, (_, m, _) in TRAIN.items()
             if np.prod(m) == 2]
    tasks += [{"name": k, "kind": "tp_serve", "arch": a, "mesh": [1, 2],
               "overrides": o, "quant": q} for k, (a, o, q) in SERVE.items()]
    tasks.append({"name": "resume", "kind": "tp_resume", "arch": "qwen3-32b",
                  "mesh": [1, 2], "ckpt_dir": str(work / "ckpt")})
    return run_ranks(2, tasks, work)


def _world4(work):
    tasks = [_train_task(k) for k, (_, m, _) in TRAIN.items()
             if np.prod(m) == 4]
    tasks.append(_train_task("deepseek_2x2_int8", name="control",
                             variant="per_rank_scales", steps=1, count=False))
    return run_ranks(4, tasks, work)


def _one_rank():
    """The port's plain run of each case on one rank (the (1, 1) mesh
    step is the plain trainer bit for bit, ``test_torch_launch``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for key, (arch, _, pe) in TRAIN.items():
            cfg = R.config(arch, pe)
            params = convert.params_from_numpy(
                T.numpy_params(cfg, R.PARAM_SEED), "cpu")
            out[key] = tp_check.train_run(cfg, R.STEPS, 0, 0, "cpu",
                                          params=params,
                                          batches=R.tp_batches(cfg),
                                          count=True)
        return out
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(2 ranks' results, 4 ranks', the one-rank runs): the two rank
    groups run at once, the one-rank runs in this process meanwhile."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        two = pool.submit(_world2, tmp_path_factory.mktemp("tp2"))
        four = pool.submit(_world4, tmp_path_factory.mktemp("tp4"))
        one = _one_rank()
        return two.result(), four.result(), one


@pytest.fixture(scope="module")
def world2(runs):
    return runs[0]


@pytest.fixture(scope="module")
def world4(runs):
    return runs[1]


@pytest.fixture(scope="module")
def one_rank(runs):
    return runs[2]


def _runs(key, world2, world4):
    return (world2 if np.prod(TRAIN[key][1]) == 2 else world4)[key]


def _digest(d):
    return {k: v[:R.DIGEST] for k, v in d.items()}


@pytest.mark.parametrize("key", list(TRAIN))
def test_split_training_matches_jax_and_one_rank(key, ref, world2, world4,
                                                 one_rank):
    want = ref["train"][key]
    jax_rows = np.array([want["losses"], want["grad_norms"]]).T
    jax_final = {k: R.unb64(v) for k, v in want["final"].items()}
    one = one_rank[key]
    one_rows = np.array(one["rows"])
    start, one_final = _digest(one["start"]), _digest(one["final"])
    pe = TRAIN[key][2]
    for meta, final in _runs(key, world2, world4):
        got = np.array(meta["rows"])
        assert np.isfinite(got).all()
        if pe == "lightpe1":
            np.testing.assert_allclose(got[0], one_rows[0], rtol=QAT_FIRST)
            np.testing.assert_allclose(got, one_rows, rtol=QAT_RTOL)
            assert np.all(np.abs(got - jax_rows) <= np.abs(one_rows - jax_rows)
                          + QAT_RTOL * np.abs(jax_rows))
            assert tp_check.change_gap(start, final, one_final) <= QAT_GAP
        else:
            np.testing.assert_allclose(got, jax_rows, rtol=RTOL[pe])
            np.testing.assert_allclose(got, one_rows, rtol=RTOL[pe])
            assert tp_check.change_gap(start, final, jax_final) <= GAP
            assert tp_check.change_gap(start, final, one_final) <= GAP
        # each rank computed its part: fewer FLOPs than its dp share of
        # one rank's step, and partial sums met over the group
        n_dp = TRAIN[key][1][0]
        assert meta["flops"] * n_dp < one["flops"], (meta["flops"],
                                                     one["flops"])
        assert meta["collectives"].get("all-reduce", 0) > 0


@pytest.mark.parametrize("key", list(SERVE))
def test_split_serving_matches_jax_and_one_rank(key, ref, world2):
    arch, over, quant = SERVE[key]
    want = ref["serve"][key]
    jax_logits = R.unb64(want["logits"]).reshape(want["shape"])
    cfg = R.config(arch, "fp32", over)
    params = convert.params_from_numpy(T.numpy_params(cfg, R.PARAM_SEED),
                                       "cpu")
    one = tp_check.serve_run(cfg, torch.from_numpy(R.serve_tokens(cfg)),
                             R.PROMPT, R.CACHE, "cpu", quant=quant,
                             cache_dtype=torch.float32, params=params,
                             pack_min=R.PACK_MIN)
    for _, arrays in world2[key]:
        got = arrays["logits"]
        assert got.shape == jax_logits.shape == one["logits"].shape
        np.testing.assert_allclose(got, jax_logits, rtol=0, atol=SERVE_ATOL)
        np.testing.assert_allclose(got, one["logits"], rtol=0,
                                   atol=SERVE_ATOL)
        np.testing.assert_array_equal(arrays["greedy"],
                                      np.argmax(jax_logits, axis=-1))


def test_resume_on_the_split_equals_the_uninterrupted_run(ref, world2):
    """A checkpoint of the (1, 2) run after its first step, restored onto
    a fresh state on the same mesh and run on: the steps and the final
    params of the uninterrupted run, bit for bit."""
    straight = world2["qwen3_1x2"]
    for (meta, final), (s_meta, s_final) in zip(world2["resume"], straight):
        assert meta["step"] == R.STEPS
        assert meta["rows"] == s_meta["rows"]
        assert set(final) == set(s_final)
        for k, v in final.items():
            np.testing.assert_array_equal(v, s_final[k], err_msg=k)


def test_per_rank_scales_miss_the_reference(ref, world4):
    """The control: scales over the rank's own slice are another function,
    and the first step shows it beyond the tolerance."""
    want = ref["train"]["deepseek_2x2_int8"]
    first = np.array([want["losses"][0], want["grad_norms"][0]])
    for meta, _ in world4["control"]:
        got = np.array(meta["rows"][0])
        assert np.abs(got - first).max() / np.abs(first).max() \
            > RTOL["int8"], got


@pytest.mark.parametrize("n_heads,kv_heads,kv_total,size,want", [
    # q and kv split: the GQA ratio kept
    (64, 8, 8, 2, [(32, 4, 4 * r, True, True) for r in range(2)]),
    # q split over a replicated kv: each rank's 4 q heads read one of 8
    (64, 8, 8, 16, [(4, 1, r // 2, True, False) for r in range(16)]),
    # kv_replicate_to 16 at 16: the cache's heads split, one a rank
    (64, 8, 16, 16, [(4, 1, r, True, False) for r in range(16)]),
    # Gemma-3-1B at 2: 2 q heads a rank over its one KV head
    (4, 1, 1, 2, [(2, 1, 0, True, False)] * 2),
    # nothing split: SmolLM's 9 heads at 2, Gemma-3-1B at 16
    (9, 3, 3, 2, [(9, 3, 0, False, False)] * 2),
    (4, 1, 1, 16, [(4, 1, 0, False, False)] * 16),
])
def test_attention_heads_of_each_rank(n_heads, kv_heads, kv_total, size,
                                      want):
    got = [tuple(attn_heads(n_heads, kv_heads, kv_total,
                            ModelSplit(None, size, r))) for r in range(size)]
    assert got == want
    assert attn_heads(n_heads, kv_heads, kv_total, None) == (
        n_heads, kv_total, 0, False, False)

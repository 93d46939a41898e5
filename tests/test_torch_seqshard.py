"""The sequence-sharded KV cache on gloo ranks, held to the JAX package's
GSPMD runs on the same meshes (``tests/data/torch_seqshard_ref.json``,
written by ``tests/_torch_seqshard_ref.py`` on 4 host devices with the
cache by ``cache_spec(..., seq_shard=True)``), to its one-device runs and
to the port's own run on one rank; and the kernels' slice forms
(``flash_attention_stats``, ``flash_attention_pass2``) against the whole
attention.

Each rank of the cache's sequence group holds its slice of the rows,
writes the step's rows that fall in it and attends over it; the softmax
is combined across the group (``layers.seq_attention``: one pass on a
float32 cache, two with ``round_p`` on a bfloat16 or e4m3 one).  The
cases (reduced configs in float32, a prefill of 8 tokens into a 16-row
cache, then 9 teacher-forced decode steps, the last past the cache's
end): Gemma-3 on (1, 2) (one KV head, its q heads split, windows),
SmolLM on (1, 2) (the attention whole), Qwen3 on (1, 4) (2 KV heads over
4: 4 rows a rank) and Gemma-3 at batch 1 on (2, 2) (the sequence over
("data", "model")), each on a float32, a bfloat16 and an e4m3 cache.  One
``run_ranks`` call a world size runs every case of it.

Tolerances.  Logits within 1e-5 of JAX on a float32 cache (measured at
most 3.6e-6) and 1e-4 on bfloat16 and e4m3 caches, and of the one-rank
port.  On the rounded caches a P code or a cache code at a rounding tie
flips between sum orders, in JAX too (its GSPMD runs part from its
one-device runs by up to 8.6e-4 on the bfloat16 cache), and one flipped
code moves the later layers' inputs beyond a tie; so the port's P codes
(``_torch_act_pins.ProbPins``, the JAX P cut to each rank's keys) and
cache codes (``WritePins``) are pinned to the JAX one-device run's at
ties, every pin counted and printed (``PINNED``: at most 1 P code and 7
cache codes a run); a code that differs away from a tie fails.  The
one-device run is the reference at every step; the GSPMD run before the
last step only, where its partitioned ``dynamic_update_slice`` drops the
write whose start the op clamps (the port clamps on the whole cache as
the op is defined), and on a bfloat16 cache no farther than JAX's own two
runs are apart plus the bound.  The caches: each rank's slice equals the
JAX cache's rows of that slice, bitwise on the rounded caches, within
1e-5 on float32 ones (their K and V are float32 products summed in
another order); greedy tokens equal.
"""

import concurrent.futures
import json

import numpy as np
import pytest
import torch

import _torch_seqshard_ref as R
from _torch_act_pins import ProbPins, WritePins
from _torch_dist import run_ranks
from repro_torch import convert, tp_check
from repro_torch.kernels.flash_attention import (flash_attention_gqa,
                                                 flash_attention_pass2,
                                                 flash_attention_stats, plan)
from repro_torch.kernels.flash_attention.ref import (emulate_attention,
                                                     ref_attention_gqa,
                                                     round_probs)
from repro_torch.launch import op_analysis as OA
from repro_torch.launch.mesh import ThreadGroup
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ATOL = {"float32": 1e-5, "bfloat16": 1e-4, "float8_e4m3fn": 1e-4}
CACHE_ATOL = 1e-5                # float32 caches
RUNS = {f"{key}/{dt}": (arch, list(mesh), batch, dt)
        for key, arch, mesh, batch in R.CASES for dt in R.CACHE_DTYPES}
# [P, cache] codes pinned to JAX's at rounding ties, by run: (one rank,
# [each rank]) (printed: pytest -rP)
PINNED = {}


@pytest.fixture(scope="module")
def ref():
    return json.loads(R.REF_PATH.read_text())


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread a test: the combines run a thread a slice, beside
    other test workers and the rank processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tasks(world: int) -> list:
    return [{"name": key.replace("/", "__"), "kind": "seq_serve",
             "key": key, "arch": arch, "mesh": mesh, "batch": batch,
             "cache_dtype": dt, "pin": dt != "float32"}
            for key, (arch, mesh, batch, dt) in RUNS.items()
            if np.prod(mesh) == world]


def _one_rank(ref) -> dict:
    """The port's plain run of each case on one rank, its P pinned to the
    JAX one-device run's at ties."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for key, (arch, _, batch, dt) in RUNS.items():
            cfg = R.config(arch)
            params = convert.params_from_numpy(
                T.numpy_params(cfg, R.PARAM_SEED), "cpu")
            with pytest.MonkeyPatch.context() as mp:
                if dt != "float32":
                    jax_one = ref["serve"][key]["one"]
                    pins = ProbPins(mp)
                    pins.load(R.unpack_probs(jax_one["probs"]))
                    writes = WritePins(mp, R.cache_writes(jax_one))
                r = tp_check.serve_run(
                    cfg, torch.from_numpy(R.serve_tokens(cfg, batch)),
                    R.PROMPT, R.CACHE, "cpu",
                    cache_dtype=getattr(torch, dt), params=params,
                    keep_cache=True)
            if dt != "float32":
                assert pins.done() and writes.done(), key
                r["pinned"] = [pins.pinned, writes.pinned]
            out[key] = r
        return out
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    """({task name: [(meta, arrays) a rank]} of both worlds, the one-rank
    runs): the two rank groups run at once, the one-rank runs in this
    process meanwhile."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        two = pool.submit(run_ranks, 2, _tasks(2),
                          tmp_path_factory.mktemp("seq2"))
        four = pool.submit(run_ranks, 4, _tasks(4),
                           tmp_path_factory.mktemp("seq4"))
        one = _one_rank(ref)
        return {**two.result(), **four.result()}, one


def _logits(run: dict) -> np.ndarray:
    return R.unb64(run["logits"], run["shape"])


@pytest.mark.parametrize("key", list(RUNS))
def test_seq_sharded_serving_matches_jax_and_one_rank(key, ref, runs):
    arch, mesh, batch, dt = RUNS[key]
    want = ref["serve"][key]
    gspmd, jax_one = _logits(want), _logits(want["one"])
    one = runs[1][key]
    tol = ATOL[dt]
    np.testing.assert_allclose(one["logits"], jax_one, rtol=0, atol=tol)
    size = mesh[0] * mesh[1]
    rows = R.CACHE // size
    jax_cache = {n: R.unb64(want["one"]["cache"][n], want["cache_shape"])
                 for n in ("k", "v")}
    gspmd_gap = np.abs(gspmd[:-1] - jax_one[:-1])
    pinned, gaps = [], []
    ranks = runs[0][key.replace("/", "__")]
    assert len(ranks) == size
    for meta, arrays in ranks:
        got = arrays["logits"]
        assert got.shape == jax_one.shape
        np.testing.assert_allclose(got, jax_one, rtol=0, atol=tol)
        np.testing.assert_allclose(got, one["logits"], rtol=0, atol=tol)
        # the GSPMD run before its dropped write at the last step
        gap = np.abs(got[:-1] - gspmd[:-1])
        if dt == "bfloat16":
            assert np.all(gap <= gspmd_gap + tol), gap.max()
        else:
            assert gap.max() <= tol, gap.max()
        np.testing.assert_array_equal(arrays["greedy"],
                                      np.argmax(jax_one, axis=-1))
        if dt != "float32":
            assert meta["pins_done"]
            pinned.append(meta["pinned"])
        # the rank holds its slice of the rows, and only those
        slot = meta["coord"]["data"] * mesh[1] + meta["coord"]["model"]
        for n in ("k", "v"):
            local = arrays[f"cache/scan/{n}"]
            full = jax_cache[n][:, :, slot * rows:(slot + 1) * rows]
            assert local.shape == full.shape
            if dt == "float32":
                np.testing.assert_allclose(local, full, rtol=0,
                                           atol=CACHE_ATOL)
                continue
            np.testing.assert_array_equal(local, full)
        gaps.append(float(np.abs(got - jax_one).max()))
    PINNED[key] = (one.get("pinned"), pinned)
    print(f"{key}: logits vs JAX {max(gaps):.3g}; [P, cache] codes pinned "
          f"to JAX's at rounding ties: one rank {one.get('pinned')}, each "
          f"rank {pinned}")


# ---------------------------------------------------------------------------
# the slice forms of the kernels' plain versions and emulation
# ---------------------------------------------------------------------------

def _case(dt, d=16, sq=5, seed=0):
    """q (2, sq, 4, d) float32, K and V (2, 64, 2, d) of type ``dt``; row
    0's queries at 20.., row 1's at 3.. (so that most slices lie past
    them)."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((2, sq, 4, d), generator=g)
    k = torch.randn((2, 64, 2, d), generator=g).to(dt)
    v = torch.randn((2, 64, 2, d), generator=g).to(dt)
    return q, k, v, torch.tensor([20, 3], dtype=torch.int32)


def _slices(k, n):
    rows = k.shape[1] // n
    return [(i * rows, k[:, i * rows:(i + 1) * rows]) for i in range(n)]


@pytest.mark.parametrize("n", [2, 4, 16])
@pytest.mark.parametrize("dt", ["float32", "bfloat16", "float8_e4m3fn"])
@pytest.mark.parametrize("mask", [{}, {"window": 9, "softcap": 2.0}])
def test_slices_combine_to_the_whole_attention(n, dt, mask):
    """Each slice's (M, L), and its output where P is not rounded: a row
    that sees no key of the slice has M = -inf, L = 0 and adds 0.  The
    slices combined by ``layers.seq_attention`` (one pass, or the group's
    (M, L) then pass 2) over n slices, a thread a slice standing for the
    ranks (``mesh.ThreadGroup``): every slice gets the whole attention at
    float32 noise."""
    q, k, v, start = _case(getattr(torch, dt))
    want = ref_attention_gqa(q, k, v, start, round_p=True, **mask)
    ks, vs = _slices(k, n), _slices(v, n)
    empty = 0
    for (first, kk), (_, vv) in zip(ks, vs):
        out, st = flash_attention_stats(q, kk, vv, start - first,
                                        round_p=True, **mask)
        none = st[1] == 0
        empty += int(none.sum())
        assert bool(torch.all(st[0][none] == -torch.inf))
        assert bool(torch.all(torch.isfinite(st[0][~none])))
        assert (out is None) == (dt != "float32")
        if out is not None:
            assert bool(torch.all(out[none] == 0))
    assert empty > 0
    group = ThreadGroup(n)
    with concurrent.futures.ThreadPoolExecutor(n) as pool:
        outs = list(pool.map(
            lambda i: L.seq_attention(q, ks[i][1], vs[i][1],
                                      start - ks[i][0], group.member(i),
                                      round_p=True, **mask), range(n)))
    for got in outs:
        assert bool(torch.all(torch.isfinite(got)))
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def _tie_allowance(q, k, v, start, dtype, **mask):
    """Each output element's sum over the keys whose normalized P lies
    within 2^-20 of a rounding midpoint of V's type: one code step times
    |v| (what a P at a tie may move between two sum orders)."""
    from repro_torch.kernels.flash_attention.ref import attention_probs
    probs = attention_probs(q, k, start, **mask)
    step = (round_probs(probs * (1 + 2 ** -20), dtype).float()
            - round_probs(probs * (1 - 2 ** -20), dtype).float())
    b, sq, hq, d = q.shape
    return torch.einsum("bhgqk,bkhd->bqhgd", step, v.float().abs()).reshape(
        b, sq, hq, d)


@pytest.mark.parametrize("d,sq,q_bf16", [(16, 1, False), (64, 20, True),
                                         (256, 33, False)])
@pytest.mark.parametrize("dt", ["float32", "bfloat16", "float8_e4m3fn"])
def test_the_emulation_follows_the_slice_forms(d, sq, q_bf16, dt):
    """``emulate_attention``'s modes 1 and 2 (the kernels' split, mma and
    wgmma arithmetic on a slice whose first row lies past some queries)
    against the plain slice forms: (M, L) and the normalized output at
    float32 noise, pass 2 within that plus one P code step at a rounding
    tie."""
    q, k, v, start = _case(getattr(torch, dt), d=d, sq=sq)
    if q_bf16:
        q = q.to(torch.bfloat16)
    k, v = k[:, 32:48], v[:, 32:48]
    start = start - 32
    p = plan(2, sq, 16, 4, 2, d, q_bf16, 0)
    assert p.variant == {16: "split", 64: "mma", 256: "wgmma"}[d]
    out_e, st_e = emulate_attention(q, k, v, start, p, round_p=True, mode=1)
    out_p, st_p = flash_attention_stats(q, k, v, start, round_p=True)
    assert torch.equal(torch.isinf(st_e[0]), torch.isinf(st_p[0]))
    fin = torch.isfinite(st_p[0])
    torch.testing.assert_close(st_e[0][fin], st_p[0][fin], rtol=0, atol=1e-5)
    torch.testing.assert_close(st_e[1], st_p[1], rtol=1e-5, atol=1e-5)
    assert (out_e is None) == (out_p is None) == (dt != "float32")
    if out_p is not None:
        torch.testing.assert_close(out_e, out_p, rtol=0, atol=1e-5)
    # pass 2 under the slice's own (M, L) where it sees a key
    stats = torch.stack([torch.where(fin, st_p[0], 0.0),
                         torch.where(fin, st_p[1], 1.0)])
    got = emulate_attention(q, k, v, start, p, round_p=True, mode=2,
                            stats=stats)
    want = flash_attention_pass2(q, k, v, start, stats, round_p=True)
    slack = 0.0 if dt == "float32" else _tie_allowance(
        q, k, v, start, getattr(torch, dt))
    assert bool(torch.all((got - want).abs() <= 1e-5 + slack))


def test_the_slice_launches_declare_one_devices_products():
    """On ``meta`` (the dry run): the group's slice launches declare the
    products of one device's launch, one pass (float32 V) or two."""
    q = torch.empty((2, 8, 4, 64), device="meta")
    start = torch.empty(2, dtype=torch.int32, device="meta")
    for dt in (torch.float32, torch.bfloat16):
        k = torch.empty((2, 1024, 2, 64), dtype=dt, device="meta")
        _, whole = OA.analyze(lambda: flash_attention_gqa(
            q, k, k, start, round_p=True))

        def group():
            for i in range(4):
                ks = k[:, i * 256:(i + 1) * 256]
                out, st = flash_attention_stats(q, ks, ks, start,
                                                round_p=True)
                if out is None:
                    flash_attention_pass2(q, ks, ks, start, st, round_p=True)
        _, split = OA.analyze(group)
        assert split["flops"] == whole["flops"]
        two = dt != torch.float32
        assert split["launches"] == {"flash_attention": 8 if two else 4}

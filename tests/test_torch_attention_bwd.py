"""The gradient of the port's attention: the plain backward (autograd of
``ref_attention_gqa``, the backward kernel's plain version) against
``jax.vjp`` of the JAX model's attention, and the backward kernel's
arithmetic (``emulate_attention_bwd``: bf16 parts and the kept part
products, the online row max, sum and D = d / L over chunks and halves,
dP rounded to bfloat16 under ``round_p``, dS, the group sums of dk and
dv in the keys kernel's row parts) against the plain backward, across
the kernels' tile edges.  The kernel itself runs only on the card
(``test_torch_train_gpu.py``, ``chip_smoke.py`` phase 10).

Tolerances: float32 gradients at 2e-6 of the largest gradient (sums of
at most 40 products in another order); bfloat16 gradients as
``tests/_torch_attention_grad_ref.py`` writes them with XLA's excess
precision off: at most 1% of the elements differ (a probability at a
bfloat16 rounding tie, where the packages' exp differ in the last bit,
moves a row of dv), each by at most one bfloat16 ulp (a float32 sum
rounded to bfloat16 from the other side of a tie), by 1e-4 of the
largest for a gradient that cancels to near 0 (dP is rounded to
bfloat16 in both packages, from float32 sums in another order, so a dP
at a tie moves dS by one ulp of dP times P; measured up to 3.6e-5) and,
in dv, by one ulp of that probability times dout."""

import importlib
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (BWD_HEAD_DIMS,
                                                 attention_backward,
                                                 flash_attention,
                                                 flash_attention_gqa)
from repro_torch.kernels.flash_attention.flash_attention import _check_bwd
from repro_torch.kernels.flash_attention.ref import (emulate_attention_bwd,
                                                     ref_attention_gqa,
                                                     ref_attention_gqa_bwd)
from repro_torch.train_check import attention_grad_errors

ROOT = Path(__file__).resolve().parents[1]


def _inputs(rng, b, sq, skv, hq, hkv, d):
    return (rng.standard_normal((b, sq, hq, d), dtype=np.float32),
            rng.standard_normal((b, skv, hkv, d), dtype=np.float32),
            rng.standard_normal((b, skv, hkv, d), dtype=np.float32),
            rng.standard_normal((b, sq, hq, d), dtype=np.float32))


def _close(got, want, dtype, tie=0.0):
    """``tie``: how far one probability rounded to bfloat16 from the other
    side of a tie may move an element (dv only)."""
    got = got.to(torch.float32).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-6 * np.abs(want).max())
        return
    diff = got != want
    assert diff.mean() <= 1e-2, diff.sum()
    assert (np.abs(got - want) <= np.abs(want) * 2.0 ** -7
            + 1e-4 * np.abs(want).max() + tie).all()


JAX_CASES = [(dtype, hq, hkv, s) for dtype in ("float32", "bfloat16")
             for hq, hkv, s in ((6, 2, 37), (8, 2, 33))]
# the backward's new reach: (dtype, hq, hkv, s, head_dim, window, softcap)
# -- Gemma-3's local layers (window, 256), Gemma-2's (window and soft-cap
# 50, 256), Zamba2's shared attention (112), Whisper's reduced 16
JAX_MASK_CASES = [("float32", 4, 1, 37, 256, 8, 0.0),
                  ("bfloat16", 4, 2, 33, 256, 8, 50.0),
                  ("float32", 4, 4, 35, 112, 0, 0.0),
                  ("bfloat16", 4, 4, 29, 16, 0, 5.0)]
# the wgmma instances' tiles: 2 heads, a window and a soft-cap, rows and
# keys past one tile of 64 (held by the emulation's test only)
WGMMA_JAX_EXTRA = [("float32", 2, 1, 70, 256, 20, 30.0),
                   ("bfloat16", 2, 2, 40, 112, 9, 50.0),
                   ("bfloat16", 2, 1, 66, 256, 0, 0.0)]
WGMMA_JAX_CASES = ([c for c in JAX_MASK_CASES if c[4] in (112, 128, 256)]
                   + WGMMA_JAX_EXTRA)


@pytest.fixture(scope="module")
def jax_grads(tmp_path_factory):
    """Each JAX_CASES, JAX_MASK_CASES and WGMMA_JAX_EXTRA case's inputs
    and jax.vjp's results, from one subprocess (XLA's excess precision is
    turned off when JAX starts)."""
    rng = np.random.default_rng(7)
    tmp = tmp_path_factory.mktemp("attn_grad")
    cases, args = {}, []
    every = ([(*c, 64, 0, 0.0) for c in JAX_CASES]
             + [c for c in JAX_MASK_CASES] + WGMMA_JAX_EXTRA)
    for i, (dtype, hq, hkv, s, d, window, softcap) in enumerate(every):
        q, k, v, do = _inputs(rng, 2, s, s, hq, hkv, d)
        src, dst = tmp / f"in{i}.npz", tmp / f"out{i}.npz"
        np.savez(src, q=q, k=k, v=v, dout=do, dtype=dtype, causal=True,
                 scale=1 / np.sqrt(d), window=window, softcap=softcap)
        key = (dtype, hq, hkv, s) if i < len(JAX_CASES) else \
            (dtype, hq, hkv, s, d, window, softcap)
        cases[key] = (q, k, v, do, dst)
        args += [str(src), str(dst)]
    run = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_attention_grad_ref.py"),
         *args], env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    return {key: (*c[:4], np.load(c[4])) for key, c in cases.items()}


@pytest.mark.parametrize("case", JAX_CASES)
def test_plain_backward_matches_jax_vjp(jax_grads, case):
    """Causal, GQA groups 3 and 4, in both types, against jax.vjp of the
    JAX model's attention (group 1 and more shapes: the kernel formulas
    below, and the card's tests)."""
    dtype = case[0]
    q, k, v, do, want = jax_grads[case]
    t = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(t) for x in (q, k, v))
    start = torch.zeros(2, dtype=torch.int32)
    out = ref_attention_gqa(tq, tk, tv, start, True, 0.0, True)
    # bfloat16: a probability at a bf16 rounding tie (the packages' exp
    # differ in the last bit) may round to its neighbour, one ulp of P
    atol = 1e-6 if dtype == "float32" else 2.0 ** -8 * np.abs(v).max()
    np.testing.assert_allclose(out.numpy(), want["out"], rtol=0, atol=atol)
    grads = ref_attention_gqa_bwd(tq, tk, tv, start, torch.from_numpy(do),
                                  True, 0.0, True)
    for g, name in zip(grads, ("dq", "dk", "dv")):
        assert g.dtype == t
        # a P at a tie (dv = P^T dout): one ulp of P (<= 2^-8) times dout
        _close(g, want[name], dtype,
               2.0 ** -8 * np.abs(do).max() if name == "dv" else 0.0)


@pytest.mark.parametrize("case", JAX_MASK_CASES)
def test_plain_backward_matches_jax_vjp_with_windows_and_caps(jax_grads,
                                                              case):
    """The sliding window, the logit soft-cap and head_dims 16 / 112 /
    256, against jax.vjp of the JAX model's attention with the same mask
    and cap, at the tolerances above."""
    dtype, _, _, _, _, window, softcap = case
    q, k, v, do, want = jax_grads[case]
    t = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(t) for x in (q, k, v))
    start = torch.zeros(2, dtype=torch.int32)
    out = ref_attention_gqa(tq, tk, tv, start, True, 0.0, True, window,
                            softcap)
    atol = 1e-6 if dtype == "float32" else 2.0 ** -8 * np.abs(v).max()
    np.testing.assert_allclose(out.numpy(), want["out"], rtol=0, atol=atol)
    grads = ref_attention_gqa_bwd(tq, tk, tv, start, torch.from_numpy(do),
                                  True, 0.0, True, window, softcap)
    for g, name in zip(grads, ("dq", "dk", "dv")):
        assert g.dtype == t
        _close(g, want[name], dtype,
               2.0 ** -8 * np.abs(do).max() if name == "dv" else 0.0)


@pytest.mark.parametrize("case", WGMMA_JAX_CASES)
def test_wgmma_emulation_matches_jax_vjp(jax_grads, case):
    """The wgmma backward's arithmetic (``emulate_attention_bwd`` at head
    dims 112 and 256: tiles of 64 rows and keys, products chained slab by
    slab) against jax.vjp of the JAX model's attention with the same
    window and soft-cap: float32 within 2e-5 of the largest gradient (the
    card's phase 10.1 tolerance), bfloat16 at the tolerances above."""
    dtype, _, _, _, d, window, softcap = case
    q, k, v, do, want = jax_grads[case]
    t = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(t) for x in (q, k, v))
    start = torch.zeros(2, dtype=torch.int32)
    got = emulate_attention_bwd(tq, tk, tv, start, torch.from_numpy(do), True,
                                0.0, True, window, softcap)
    for g, name in zip(got, ("dq", "dk", "dv")):
        assert g.dtype == t
        if dtype == "float32":
            w = want[name]
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=2e-5 * np.abs(w).max())
        else:
            _close(g, want[name], dtype,
                   2.0 ** -8 * np.abs(do).max() if name == "dv" else 0.0)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("d", [112, 128, 256])
def test_wgmma_backward_plan_fits_the_card(d, bf16):
    """The wgmma backward's plan (``bwd_wgmma_plan``): each ring stage
    holds its slabs and pieces, both kernels' shared memory fits a block
    (232,448 bytes on an H100), the slabs are the emulation's and the
    tiles are the emulation's 64 rows and keys in one part; the keys
    kernel's cluster is a power of two up to 8, and splits a key tile only
    while the tiles leave more than half the SMs idle."""
    from repro_torch.kernels.flash_attention import (bwd_key_splits,
                                                     bwd_wgmma_plan)
    F = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    from repro_torch.kernels.flash_attention.ref import (
        BWD_CHUNK, BWD_KEY_PARTS, BWD_ROW_SPLIT, BWD_ROW_TILE,
        BWD_WGMMA_DP_SLAB, BWD_WGMMA_SLAB, bwd_dp_tail)
    p = bwd_wgmma_plan(d, bf16)
    ring = 2 * F.BWD_STAGES * F.BWD_STAGE_BYTES
    assert max(*p.s_stage_bytes, *p.piece_bytes) <= F.BWD_STAGE_BYTES
    assert max(p.rows_smem, p.keys_smem) <= F.SMEM_LIMIT
    assert 2 * 64 * d * 4 <= ring     # the key split's partial sums
    dtype = torch.bfloat16 if bf16 else torch.float32
    assert (p.s_slab, p.dp_slab, p.dp_tail) == (
        BWD_WGMMA_SLAB[dtype], BWD_WGMMA_DP_SLAB, bwd_dp_tail(d, dtype))
    # the rows kernel's warpgroups bring in as many slabs a chunk
    ns0, ns1 = -(-d // p.s_slab), -(-d // p.dp_slab)
    assert not bf16 or ns0 + p.dp_tail == ns1 - p.dp_tail
    assert p.s_slab % 16 == 0 and p.dp_slab % 16 == 0
    assert d % 16 == 0 and p.dq_split % 64 == 0
    assert (BWD_CHUNK[d], BWD_KEY_PARTS[d], BWD_ROW_TILE[d],
            BWD_ROW_SPLIT[d]) == (64, 1, 64, 1)
    # Gemma-3-1B's 2 x 1024 keys (32 tiles of one KV head): 4 a cluster;
    # Gemma-2-9B's and Zamba2-7B's tiles fill the card alone
    assert [bwd_key_splits(*s) for s in ((2, 1, 1024), (1, 8, 4608),
                                          (2, 32, 512), (1, 1, 64))] == \
        [4, 1, 1, 8]


CASES = [  # (b, sq, skv, hq, hkv, d, q_start, causal)
    (2, 37, 37, 6, 2, 64, (0, 0), True),
    (2, 17, 40, 6, 2, 64, (0, 23), True),
    (1, 33, 33, 4, 1, 128, (0,), True),
    (3, 9, 9, 3, 3, 64, (0, 0, 0), True),
    (1, 20, 29, 8, 2, 128, (0,), False),
    # the kernels' tile edges: 64 rows and 64 keys (32 at head_dim 128)
    (1, 63, 63, 3, 1, 64, (0,), True),
    (1, 64, 64, 3, 1, 64, (0,), True),
    (1, 65, 65, 3, 1, 64, (0,), True),
    (1, 129, 129, 2, 1, 64, (0,), True),
    (1, 65, 65, 2, 1, 128, (0,), True),
    # a single key: dq and dk exactly 0 (the bound is 0 of a 0 gradient)
    (2, 1, 1, 9, 3, 64, (0, 0), True),
    # offsets past a chunk of keys, and every key visible across chunks
    (2, 30, 100, 4, 2, 64, (70, 5), True),
    (1, 65, 129, 3, 1, 64, (0,), False),
]


@pytest.mark.parametrize("round_p", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_kernel_formulas_match_the_plain_backward(rng, case, dtype, round_p):
    b, sq, skv, hq, hkv, d, start, causal = case
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs(rng, b, sq, skv, hq, hkv, d))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    qs = torch.tensor(start, dtype=torch.int32)
    want = ref_attention_gqa_bwd(q, k, v, qs, do, causal, 0.0, round_p)
    got = emulate_attention_bwd(q, k, v, qs, do, causal, 0.0, round_p)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype
        g, w = g.float(), w.float()
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=0,
                                       atol=2e-6 * w.abs().max().item())
        else:   # one bf16 ulp, from float32 sums in another order
            assert ((g - w).abs() <= w.abs() * 2.0 ** -7
                    + 1e-6 * w.abs().max()).all()
            assert (g != w).float().mean() <= 2e-2


# (b, sq, skv, hq, hkv, d, q_start, window, softcap): the wide instances'
# tile edges (64 rows and 64 keys a tile at head_dims 112 and 256),
# windows narrower than a chunk and across several, soft-caps, with and
# without a window
MASK_CASES = [
    (1, 33, 33, 4, 1, 256, (0,), 0, 0.0),
    (1, 40, 40, 2, 1, 256, (0,), 8, 0.0),
    (2, 17, 50, 4, 2, 256, (0, 33), 20, 50.0),
    (1, 65, 65, 4, 4, 112, (0,), 0, 0.0),
    (1, 70, 90, 2, 1, 112, (20,), 40, 30.0),
    (2, 65, 65, 2, 1, 16, (0, 0), 16, 0.0),
    (1, 129, 129, 2, 1, 32, (0,), 0, 5.0),
    (1, 130, 130, 3, 1, 64, (0,), 33, 50.0),
    (1, 65, 65, 2, 1, 128, (0,), 40, 50.0),
]


@pytest.mark.parametrize("round_p", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MASK_CASES)
def test_kernel_formulas_match_the_plain_backward_with_masks(rng, case,
                                                             dtype, round_p):
    """``emulate_attention_bwd`` with the window, the soft-cap and the
    head_dims 16 / 32 / 112 / 256 against the plain backward: float32 at
    the unmasked cases' 2e-6; bfloat16 at the card's tolerance
    (``train_check.attention_grad_errors``, phase 10.1's): a dP at a
    bfloat16 rounding tie, rounded from float32 sums in another order,
    moves dS by one ulp of dP times P (at head_dim 112, 1.3e-3 of the
    largest dq)."""
    b, sq, skv, hq, hkv, d, start, window, softcap = case
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs(rng, b, sq, skv, hq, hkv, d))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    qs = torch.tensor(start, dtype=torch.int32)
    args = (q, k, v, qs, do, True, 0.0, round_p, window, softcap)
    want = ref_attention_gqa_bwd(*args)
    got = emulate_attention_bwd(*args)
    assert all(g.dtype == w.dtype == dtype for g, w in zip(got, want))
    if dtype == torch.float32:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0,
                                       atol=2e-6 * w.abs().max().item())
    else:
        err = attention_grad_errors(got, want, do)
        assert err["ok"], err
        assert all((g != w).float().mean() <= 2e-2 for g, w in zip(got, want))


def test_d_needs_the_rounded_dp(rng):
    """With round_p and a bfloat16 V, D = rowsum(P dP) with dP rounded to
    bfloat16 is what autograd computes; rowsum(dout * out), FA-2's
    textbook D, is not."""
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs(rng, 1, 64, 64, 3, 1, 64))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    qs = torch.zeros(1, dtype=torch.int32)
    want = ref_attention_gqa_bwd(q, k, v, qs, do, True, 0.0, True)[0].float()
    out = ref_attention_gqa(q, k, v, qs, True, 0.0, True)
    qf = q.float().reshape(1, 64, 1, 3, 64)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) / 8.0
    ok = torch.arange(64)[None, :] <= torch.arange(64)[:, None]
    p = torch.softmax(torch.where(ok, s, -torch.inf), -1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do.reshape(1, 64, 1, 3, 64),
                      v.float())
    d_fa2 = (do * out).sum(-1).reshape(1, 64, 1, 3).permute(0, 2, 3, 1)
    ds = p * (dp - d_fa2[..., None]) / 8.0
    textbook = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()).reshape(
        1, 64, 3, 64).bfloat16().float()
    assert (textbook != want).float().mean() > 0.05
    emulated = emulate_attention_bwd(q, k, v, qs, do, True, 0.0, True)[0]
    assert (emulated.float() != want).float().mean() < 0.02


def test_cpu_autograd_is_the_plain_version_and_launches_nothing(rng):
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs(rng, 2, 12, 12, 6, 2, 64))
    qs = torch.zeros(2, dtype=torch.int32)
    before = (flash_attention.launches, flash_attention.backward_launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention_gqa(*leaves, qs, round_p=True).backward(do)
    want = ref_attention_gqa_bwd(q, k, v, qs, do, True, 0.0, True)
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)
    got = attention_backward(q, k, v, qs, do, round_p=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (flash_attention.launches,
            flash_attention.backward_launches) == before


def test_backward_refuses_what_its_kernel_does_not_take():
    """Still refused: mixed types, float16, a head_dim the forward does
    not take, a window without the causal mask.  Taken: every head_dim
    of the forward, windows and soft-caps."""
    f32 = torch.zeros(1, 4, 3, 64)
    _check_bwd(f32, f32[:, :, :1], f32[:, :, :1])
    with pytest.raises(ValueError, match="one type"):
        _check_bwd(f32, f32[:, :, :1].bfloat16(), f32[:, :, :1].bfloat16())
    with pytest.raises(ValueError, match="head_dim"):
        odd = torch.zeros(1, 4, 3, 48)
        _check_bwd(odd, odd, odd)
    with pytest.raises(ValueError, match="one type"):
        h = torch.zeros(1, 4, 3, 64, dtype=torch.float16)
        _check_bwd(h, h, h)
    with pytest.raises(ValueError, match="causal"):
        _check_bwd(f32, f32, f32, causal=False, window=8)
    for d in (16, 32, 112, 256):
        x = torch.zeros(1, 4, 2, d)
        _check_bwd(x, x, x, True, 512, 50.0)
    assert BWD_HEAD_DIMS == (16, 32, 64, 112, 128, 256)


def _load(path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("bf16, issued, want", [
    (False, False, 30), (True, False, 13), (False, True, 54), (True, True, 21)])
def test_part_products_of_the_backward_bounds(bf16, issued, want):
    """``chip_smoke.py``'s count of bf16 part products a (pair, column):
    the gradient's 5 products with 6 of 9 kept (30 in float32; 13 in
    bfloat16: q.k 1, dout.v 3, dq 3, dk 3, dv 3 with P rounded) bound the
    kernel; the kernel issues q.k and dout.v three times each."""
    smoke = _load(ROOT / "chip_smoke.py")
    assert smoke.bwd_part_products(bf16, issued) == want


@pytest.mark.parametrize("q_bf16, per_pair", [(False, 12), (True, 7)])
def test_part_products_of_the_forward_bounds(q_bf16, per_pair):
    """``chip_smoke.py``'s forward attention bound (phases 5 and 11.1):
    each visible (query head, key) pair's q . k and P V as kept bf16 part
    products (6 for two float32 operands, 1 for bfloat16 q on K rounded
    to it); bytes of q, the float32 out and the keys the rows see."""
    smoke = _load(ROOT / "chip_smoke.py")
    assert [smoke.kept_part_products(a, b) for a, b in
            ((3, 3), (3, 1), (1, 3), (1, 1))] == [6, 3, 3, 1]
    b, hq, hkv, d = 2, 4, 1, 256
    rows = [(max(0, i - 7), i + 1) for i in range(20)]     # window 8
    bound, by, nbytes, half = smoke.attention_bound(b, hq, hkv, d, rows,
                                                    q_bf16, layers=3)
    visible = sum(hi - lo for lo, hi in rows)
    assert half == 3 * 2 * b * hq * d * visible
    assert nbytes == 3 * (b * 20 * hq * d * ((2 if q_bf16 else 4) + 4)
                          + 2 * 4 * b * 20 * hkv * d)
    assert bound == pytest.approx(max(
        nbytes / smoke.H100_BYTES_PER_S,
        half * per_pair / smoke.H100_BF16_FLOPS) * 1e3)
    assert by == "bytes"


def test_probe_lines_cover_every_phase_of_the_wgmma_kernels():
    """The wgmma backward's ``// PROBE`` lines: 7 phases of its rows
    kernel and 6 of its keys kernel (the first warpgroup's view), each
    kernel's start and dump, and a name for every phase."""
    bench = _load(ROOT / "benchmarks" / "torch_fa_bwd.py")
    src = bench.kernel_source(ROOT / "src", "flash_attention_bwd_wgmma")
    probed = bench.probed_source(src)
    assert "// PROBE" not in probed
    assert probed.count("PROBE(") == 1 + 7 + 6
    assert probed.count("clock64() - t0_") == 2
    assert [len(n) for n in bench.PHASES["flash_attention_bwd_wgmma"]] == \
        [7, 6]


def test_probe_lines_cover_every_phase_of_both_kernels():
    """``benchmarks/torch_fa_bwd.py --probe`` turns the kernel source's
    ``// PROBE`` comment lines into clock reads: 10 phases of the rows
    kernel, 6 of the keys kernel, each kernel's start and dump."""
    bench = _load(ROOT / "benchmarks" / "torch_fa_bwd.py")
    src = (ROOT / "src" / "repro_torch" / "csrc"
           / "flash_attention_bwd.cu").read_text()
    probed = bench.probed_source(src)
    assert "// PROBE" not in probed
    assert probed.count("PROBE(") == 1 + 10 + 6     # the macro, the calls
    assert probed.count("clock64() - t0_") == 2

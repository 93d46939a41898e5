"""The port's CUDA kernels on the card, against their plain versions.

Needs a CUDA card and nvcc: every test is marked ``gpu`` and skips
without a card.  Imports no JAX, so it runs on a machine without it:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.fake_quant import fake_quant
from repro_torch.kernels.fake_quant.ref import (ref_fake_quant_affine,
                                                ref_fake_quant_pow2)
from repro_torch.quant import fake_quant as tfq, preset

ATOL = 1e-6
SHAPES = [(256, 256), (300, 190), (512, 640), (8, 128), (1, 129),
          (4608, 512)]
MODES = [("affine", 4), ("affine", 8), ("affine", 16), ("pow2", 8)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _weight(shape, device, seed=0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor((rng.normal(size=shape) * 0.1).astype(np.float32),
                           device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", SHAPES)
@pytest.mark.parametrize("mode,bits", MODES)
def test_kernel_matches_plain(card, k, n, mode, bits):
    """Bit-identical (both use IEEE division and CUDA's log2f/exp2f), so
    within 1e-6 too; one launch per call."""
    w = _weight((k, n), card)
    s = (tfq.affine_scale(w, bits, axis=0)[0] if mode == "affine"
         else tfq.pow2_emax(w, axis=0)[0])
    before = fake_quant.launches
    got = fake_quant(w, s, mode=mode, bits=bits)
    assert fake_quant.launches == before + 1
    want = (ref_fake_quant_affine(w, s, bits) if mode == "affine"
            else ref_fake_quant_pow2(w, s))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


def _scale(w, mode, bits, per_tensor=False):
    axis = None if per_tensor else 0
    s = (tfq.affine_scale(w, bits, axis) if mode == "affine"
         else tfq.pow2_emax(w, axis))
    return s.reshape(1) if per_tensor else s[0]


def _plain(w, s, mode, bits):
    return (ref_fake_quant_affine(w, s, bits) if mode == "affine"
            else ref_fake_quant_pow2(w, s))


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", SHAPES)
@pytest.mark.parametrize("mode,bits", MODES)
@pytest.mark.parametrize("per_tensor", [False, True])
def test_kernel_matches_plain_bf16(card, k, n, mode, bits, per_tensor):
    """bfloat16 weights or activations (N(0, 3^2), the scale of the
    model's residual stream), per-channel and per-tensor scales: 0
    differing elements from the plain version, which rounds to bfloat16
    after every torch op."""
    w = (_weight((k, n), card, seed=k + n) * 30).to(torch.bfloat16)
    s = _scale(w, mode, bits, per_tensor)
    assert s.dtype == torch.bfloat16
    before = fake_quant.launches
    got = fake_quant(w, s, mode=mode, bits=bits)
    assert fake_quant.launches == before + 1
    want = _plain(w, s, mode, bits)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert int((got != want).sum()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,bits", MODES)
def test_group_matches_plain(card, dtype, mode, bits):
    """One launch over ragged shapes, views off 16 bytes (a scalar head;
    the output at the same offset), a tensor shorter than its head, and a
    per-tensor scale: each output equals the plain version's."""
    from repro_torch.kernels.fake_quant import fake_quant_group
    flat = _weight((1 << 16,), card, seed=9).to(dtype)
    ws = [_weight(s, card, seed=i).to(dtype) for i, s in
          enumerate([(27, 64), (300, 190), (1, 129), (4608, 512)])]
    ws += [flat[1:1 + 190 * 33].view(190, 33),       # off 16 bytes
           flat[1:3].view(1, 2)]                      # all of it head
    assert ws[-2].data_ptr() % 16 and ws[-1].data_ptr() % 16
    scales = [_scale(w, mode, bits, per_tensor=(i == 1))
              for i, w in enumerate(ws)]
    before = fake_quant.launches
    got = fake_quant_group(ws, scales, mode=mode, bits=bits)
    assert fake_quant.launches == before + 1
    torch.cuda.synchronize()
    for g, w, s in zip(got, ws, scales):
        assert g.shape == w.shape and g.dtype == dtype
        assert g.data_ptr() % 16 == w.data_ptr() % 16
        assert int((g != _plain(w, s, mode, bits)).sum()) == 0


# SmolLM-135M's QAT path: the projection weights and the tied head in
# float32 with a scale a column, the activations of decode (4 rows) and
# prefill (4 x 130 rows) with one scale, in both types.  1536 and 49152
# columns pass a block's vector stride (1024 float32, 2048 bfloat16
# elements), so the kernel's column counter wraps within a thread.
SMOLLM_WEIGHTS = [(576, 576), (576, 192), (576, 1536), (1536, 576),
                  (576, 49152)]
SMOLLM_ACTS = [(4, 576), (4, 1536), (520, 576), (520, 1536)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,bits", MODES)
def test_kernel_matches_plain_at_smollm_shapes(card, dtype, mode, bits):
    """Each tensor alone and all of them in one group: 0 differing
    elements."""
    from repro_torch.kernels.fake_quant import fake_quant_group
    ws = [_weight(s, card, seed=i) for i, s in enumerate(SMOLLM_WEIGHTS)
          ] if dtype == torch.float32 else []
    acts = [(_weight(s, card, seed=10 + i) * 30).to(dtype)
            for i, s in enumerate(SMOLLM_ACTS)]
    scales = ([_scale(w, mode, bits) for w in ws]
              + [_scale(a, mode, bits, per_tensor=True) for a in acts])
    ts = ws + acts
    single = [fake_quant(t, s, mode=mode, bits=bits)
              for t, s in zip(ts, scales)]
    before = fake_quant.launches
    grouped = fake_quant_group(ts, scales, mode=mode, bits=bits)
    assert fake_quant.launches == before + 1
    torch.cuda.synchronize()
    for a, b, t, s in zip(single, grouped, ts, scales):
        want = _plain(t, s, mode, bits)
        assert int((a != want).sum()) == 0, tuple(t.shape)
        assert int((b != want).sum()) == 0, tuple(t.shape)


@pytest.mark.gpu
def test_group_past_group_max_launches_twice(card):
    from repro_torch.kernels.fake_quant import GROUP_MAX, fake_quant_group
    ws = [_weight((5, 7 + i), card, seed=i) for i in range(GROUP_MAX + 6)]
    scales = [_scale(w, "affine", 8) for w in ws]
    before = fake_quant.launches
    got = fake_quant_group(ws, scales, mode="affine", bits=8)
    assert fake_quant.launches == before + 2
    torch.cuda.synchronize()
    for g, w, s in zip(got, ws, scales):
        assert torch.equal(g, _plain(w, s, "affine", 8))


@pytest.mark.gpu
@pytest.mark.parametrize("pe", ["int16", "lightpe1", "lightpe2", "int8"])
def test_fake_quant_weights_on_card_groups_the_launches(card, pe):
    """The list form equals the per-weight form bit for bit, in one launch
    (two for LightPE-2)."""
    ws = [_weight(s, card, seed=i) for i, s in
          enumerate([(3, 3, 16, 24), (576, 128), (512, 10)])]
    want = [tfq.fake_quant_weight(w, preset(pe)) for w in ws]
    before = fake_quant.launches
    got = tfq.fake_quant_weights(ws, preset(pe))
    assert fake_quant.launches - before == (2 if pe == "lightpe2" else 1)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("pe", ["int16", "lightpe1", "lightpe2", "int8"])
def test_fake_quant_weight_on_card_matches_cpu(card, pe):
    """The QAT numerics on the card (kernel) and on the CPU (plain
    version) agree on a conv weight, per-channel."""
    w = _weight((3, 3, 64, 128), card, seed=5)
    got = tfq.fake_quant_weight(w, preset(pe)).cpu()
    want = tfq.fake_quant_weight(w.cpu(), preset(pe))
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


@pytest.mark.gpu
def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    w = torch.ones(8, 4, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        fake_quant(w.T, torch.ones(8, device=card))
    with pytest.raises(ValueError, match="float32"):
        fake_quant(w.double(), torch.ones(4, device=card))
    with pytest.raises(ValueError, match="shape"):
        fake_quant(w, torch.ones(5, device=card))
    assert fake_quant(w[:0], torch.ones(4, device=card)).shape == (0, 4)
    # bfloat16 is taken, with a scale of its type
    wb = w.to(torch.bfloat16)
    out = fake_quant(wb, torch.ones(4, device=card, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16 and torch.equal(out, wb)
    with pytest.raises(ValueError, match="scale"):
        fake_quant(wb, torch.ones(4, device=card))


# ---------------------------------------------------------------------------
# quant_matmul
# ---------------------------------------------------------------------------

# SmolLM-135M's projections (K, N) at every M bucket of the GEMV (1-4,
# 5-8, 9-16) and the tensor-core product (17 and more); ragged and
# unaligned shapes (N = 65, 129, 190 give rows off 16-byte boundaries).
QMM_SMOLLM_KN = [(576, 576), (576, 192), (576, 1536), (1536, 576)]
QMM_CASES = [(m, k, n) for k, n in QMM_SMOLLM_KN
             for m in (1, 4, 8, 16, 17, 64, 65, 520)] + [
    (37, 300, 190), (1, 512, 129), (200, 254, 64), (16, 64, 64), (17, 64, 65),
    (4, 300, 190), (4, 254, 65), (520, 254, 129), (16, 300, 129),
    (65, 576, 190)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", QMM_CASES)
@pytest.mark.parametrize("mode", ["int4", "pow2", "int8"])
@pytest.mark.parametrize("x_type", [torch.float32, torch.bfloat16])
def test_quant_matmul_matches_plain(card, m, k, n, mode, x_type):
    """rtol 1e-5 / atol 1e-4 (tests/test_kernels.py:45): IEEE float32 sums
    in another order; bfloat16 x is widened exactly, so it is held as
    tightly.  One launch per call."""
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.kernels.quant_matmul.ref import ref_quant_matmul
    from repro_torch.quant.pack import QUANTIZE
    codes, scale = QUANTIZE[mode](_weight((k, n), card, seed=m + n) * 0.8)
    x = (_weight((m, k), card, seed=k) * 10).to(x_type)
    before = quant_matmul.launches
    got = quant_matmul(x, codes, scale, mode=mode)
    assert quant_matmul.launches == before + 1
    want = ref_quant_matmul(x, codes, scale, mode)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 130])
@pytest.mark.parametrize("mode", ["int4", "pow2", "int8"])
def test_quant_matmul_layer_view_off_16_bytes(card, m, mode):
    """A layer's view into stacked codes, as the model indexes them, can
    start off a 16-byte boundary: the kernel takes narrower loads and gives
    the plain version's result."""
    from repro_torch.kernels.quant_matmul import launch_plan, quant_matmul
    from repro_torch.kernels.quant_matmul.ref import ref_quant_matmul
    from repro_torch.quant.pack import QUANTIZE
    k, n = 574, 72     # a layer of 287 x 72 packed bytes: 20664 = 8 mod 16
    codes, scale = QUANTIZE[mode](_weight((3, k, n), card, seed=7))
    assert codes.is_contiguous()
    x = _weight((m, k), card, seed=8) * 10
    for i in range(3):
        view = codes[i]
        p = launch_plan(x, view, mode)
        if view.data_ptr() % 16:
            assert p.vec != 16
        got = quant_matmul(x, view, scale[i], mode=mode)
        want = ref_quant_matmul(x, view, scale[i], mode)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(4, 576, 192), (4, 1536, 576),
                                   (520, 576, 192), (520, 576, 1536),
                                   (17, 1536, 576)])
@pytest.mark.parametrize("mode", ["int4", "pow2", "int8"])
@pytest.mark.parametrize("x_type", [torch.float32, torch.bfloat16])
def test_quant_matmul_is_bitwise_deterministic(card, m, k, n, mode, x_type):
    """Two calls on the same inputs give the same bits: the split-K sums
    meet in a fixed order, with no atomics."""
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.quant.pack import QUANTIZE
    codes, scale = QUANTIZE[mode](_weight((k, n), card, seed=9))
    x = (_weight((m, k), card, seed=10) * 10).to(x_type)
    first = quant_matmul(x, codes, scale, mode=mode)
    second = quant_matmul(x, codes, scale, mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_quant_matmul_refuses_what_the_kernel_does_not_take(card):
    from repro_torch.kernels.quant_matmul import quant_matmul
    codes = torch.zeros(8, 4, dtype=torch.uint8, device=card)
    scale = torch.ones(4, device=card)
    x = torch.ones(3, 16, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        quant_matmul(torch.ones(16, 3, device=card).T, codes, scale)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        quant_matmul(x.half(), codes, scale)
    with pytest.raises(ValueError, match="uint8"):
        quant_matmul(x, codes.to(torch.int8), scale, mode="pow2")
    with pytest.raises(ValueError, match="K=16"):
        quant_matmul(torch.ones(3, 15, device=card), codes, scale)
    with pytest.raises(ValueError, match="contiguous"):
        quant_matmul(x, codes, scale.cpu())
    assert quant_matmul(x[:0], codes, scale).shape == (0, 4)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

# (b, sq, skv, hq, hkv, d, start): SmolLM-135M's prefill and decode (GQA
# 9/3, head_dim 64, a 256-row cache) at decode offsets that cross the
# cluster's split boundaries, each Sq the decode plan takes (1 and 2 for
# G = 3), and ragged shapes.
FA_CASES = [(4, 130, 256, 9, 3, 64, 0)] + [
    (4, sq, 256, 9, 3, 64, start) for sq in (1, 2)
    for start in (0, 1, 63, 135, 254)] + [
    (4, 1, 256, 9, 3, 64, 255), (2, 33, 70, 4, 1, 32, 5),
    (1, 64, 64, 2, 2, 16, 0), (2, 40, 80, 4, 2, 128, 17),
    (3, 1, 4096, 16, 1, 128, 3000), (2, 9, 300, 6, 2, 32, 200)]
# (q type, K/V type, round_p): the float32 serving path, bfloat16 q with
# the engine's float32 cache (round_p on and off: the same function), and
# bfloat16 K/V, as the model without a cache takes them.
FA_TYPES = [(torch.float32, torch.float32, False),
            (torch.float32, torch.float32, True),
            (torch.bfloat16, torch.float32, False),
            (torch.bfloat16, torch.float32, True),
            (torch.bfloat16, torch.bfloat16, False),
            (torch.bfloat16, torch.bfloat16, True),
            (torch.float32, torch.bfloat16, True)]
FA_TOL = 2e-5   # tests/test_kernels.py:122


def _fa_inputs(card, b, sq, skv, hq, hkv, d, start, q_type, kv_type):
    gen = torch.Generator(device=card).manual_seed(skv + sq)
    q = torch.randn((b, sq, hq, d), generator=gen, device=card).to(q_type)
    k = torch.randn((b, skv, hkv, d), generator=gen, device=card).to(kv_type)
    v = torch.randn((b, skv, hkv, d), generator=gen, device=card).to(kv_type)
    st = torch.full((b,), start, dtype=torch.int32, device=card)
    return q, k, v, st


def _bf16_p_slack(q, k, v, st, causal):
    """What bf16 P may move an output by: with round_p and bfloat16 V the
    kernel and the plain version both round each probability to bf16,
    after float32 sums in another order, so a probability within a few
    1e-7 of a bf16 rounding boundary may round the other way in one of
    them.  Per output element: the sum over the probabilities within 4e-6
    (relative) of a boundary, computed in float64, of the bf16 step there
    times |v|.  Zero for every other probability."""
    from repro_torch.kernels.flash_attention.ref import _visible
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.double().reshape(b, sq, hkv, hq // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                          k.to(q.dtype).double()) * d ** -0.5
    if causal:
        ok = _visible(st, sq, skv, q.device)
        logits = torch.where(ok[:, None, None], logits, -torch.inf)
    p = torch.softmax(logits, dim=-1)
    step = ((p * (1 + 4e-6)).to(torch.bfloat16).double()
            - (p * (1 - 4e-6)).to(torch.bfloat16).double()).abs()
    slack = torch.einsum("bhgqk,bkhd->bqhgd", step, v.double().abs())
    return slack.reshape(b, sq, hq, d).float()


def _fa_held(got, want, slack=None):
    """2e-5 (tests/test_kernels.py:122): float32 sums in another order;
    plus ``slack`` (``_bf16_p_slack``) where both round P to bf16."""
    torch.cuda.synchronize()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    if slack is None:
        torch.testing.assert_close(got, want, rtol=FA_TOL, atol=FA_TOL)
        return
    err = (got - want).abs()
    bad = err > FA_TOL + FA_TOL * want.abs() + slack
    assert not bool(bad.any()), (float(err.max()), int(bad.sum()))


@pytest.mark.gpu
@pytest.mark.parametrize("q_type,kv_type,round_p", FA_TYPES)
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,start", FA_CASES)
def test_flash_attention_matches_plain(card, b, sq, skv, hq, hkv, d, start,
                                       q_type, kv_type, round_p):
    """The plan's kernel against the plain version on the same tensors,
    causal and not: 2e-5 (tests/test_kernels.py:122), float32 sums in
    another order (with bf16 P, plus ``_bf16_p_slack``).  One launch per
    call."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_gqa)
    from repro_torch.kernels.flash_attention.ref import ref_attention_gqa
    q, k, v, st = _fa_inputs(card, b, sq, skv, hq, hkv, d, start, q_type,
                             kv_type)
    for causal in (True, False):
        before = flash_attention.launches
        got = flash_attention_gqa(q, k, v, st, causal=causal, round_p=round_p)
        assert flash_attention.launches == before + 1
        slack = (_bf16_p_slack(q, k, v, st, causal)
                 if round_p and kv_type == torch.bfloat16 else None)
        _fa_held(got, ref_attention_gqa(q, k, v, st, causal=causal,
                                        round_p=round_p), slack)


@pytest.mark.gpu
@pytest.mark.parametrize("q_type,kv_type,round_p", FA_TYPES)
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,start", [
    (4, 1, 256, 9, 3, 64, 135), (4, 2, 256, 9, 3, 64, 63),
    (4, 130, 256, 9, 3, 64, 0), (3, 1, 4096, 16, 1, 128, 3000)])
def test_flash_attention_is_bitwise_deterministic(card, b, sq, skv, hq, hkv,
                                                  d, start, q_type, kv_type,
                                                  round_p):
    """Two calls on the same inputs give the same bits: the split-KV
    partials meet in a fixed order, with no atomics."""
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    q, k, v, st = _fa_inputs(card, b, sq, skv, hq, hkv, d, start, q_type,
                             kv_type)
    first = flash_attention_gqa(q, k, v, st, round_p=round_p)
    second = flash_attention_gqa(q, k, v, st, round_p=round_p)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("q_type", [torch.float32, torch.bfloat16])
def test_flash_attention_strided_and_unaligned_views(card, q_type):
    """(B, S, H, D) views without a copy: a layer of a stacked cache, a
    cache row slice and a view whose rows sit off a 16-byte boundary
    (the kernel then takes element loads of K and V)."""
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    from repro_torch.kernels.flash_attention.ref import ref_attention_gqa
    gen = torch.Generator(device=card).manual_seed(1)
    stack = torch.randn((2, 3, 2, 90, 3, 66), generator=gen, device=card)
    k, v = stack[0, 1, :, 5:, :, 1:65], stack[1, 1, :, 5:, :, 1:65]
    assert k.data_ptr() % 16 and k.stride(3) == 1
    for sq, start in ((1, 40), (30, 0)):
        q = torch.randn((2, sq, 9, 64), generator=gen,
                        device=card).to(q_type)
        st = torch.full((2,), start, dtype=torch.int32, device=card)
        _fa_held(flash_attention_gqa(q, k, v, st),
                 ref_attention_gqa(q, k, v, st))


@pytest.mark.gpu
def test_flash_attention_one_head_bh_and_bf16(card):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bh)
    from repro_torch.kernels.flash_attention.ref import ref_flash_attention
    gen = torch.Generator(device=card).manual_seed(0)
    q, k, v = (torch.randn((2, 3, 100, 32), generator=gen, device=card)
               for _ in range(3))
    got = flash_attention_bh(q, k, v)
    for i in range(2):
        for j in range(3):
            torch.testing.assert_close(
                got[i, j], ref_flash_attention(q[i, j], k[i, j], v[i, j]),
                rtol=2e-5, atol=2e-5)
    qb, kb, vb = (t[0, 0].to(torch.bfloat16) for t in (q, k, v))
    torch.testing.assert_close(flash_attention(qb, kb, vb),
                               ref_flash_attention(qb, kb, vb), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.gpu
def test_flash_attention_refuses_what_the_kernel_does_not_take(card):
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    q = torch.zeros(1, 4, 6, 64, device=card)
    kv = torch.zeros(1, 8, 3, 64, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_gqa(q[..., :48], kv[..., :48], kv[..., :48])
    with pytest.raises(ValueError, match="one type"):
        flash_attention_gqa(q, kv.to(torch.bfloat16), kv)
    with pytest.raises(ValueError, match="int32"):
        flash_attention_gqa(q, kv, kv, torch.zeros(1, dtype=torch.int64,
                                                   device=card))
    with pytest.raises(ValueError, match="contiguous last axis"):
        flash_attention_gqa(q, kv.transpose(2, 3).contiguous()
                            .transpose(2, 3), kv)


# ---------------------------------------------------------------------------
# the serving slice
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("pe", ["lightpe1", "int8", "int4"])
def test_packed_model_on_card_matches_cpu(card, pe):
    """Reduced SmolLM in float32, packed: prefill and two decode steps on
    the card (both kernels) and on the CPU (their plain versions)."""
    from repro_torch import convert
    from repro_torch.configs import reduced
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.models import transformer as T
    from repro_torch.serve import quantize_params
    cfg = reduced("smollm-135m").replace(dtype="float32")
    arrays = T.numpy_params(cfg, seed=0)
    runs = {}
    for dev in ("cpu", card):
        params = quantize_params(convert.params_from_numpy(arrays, dev), pe,
                                 min_size=1 << 8)
        cache = T.init_cache(cfg, 2, 32, torch.float32, device=dev)
        toks = torch.arange(14, device=dev).reshape(2, 7) * 17 % cfg.vocab
        before = (quant_matmul.launches, flash_attention.launches)
        out = [T.prefill(params, toks, cfg, cache)[0]]
        for step in range(2):
            out.append(T.decode_step(params, toks[:, step:step + 1], cfg,
                                     cache)[0])
        runs[str(dev)] = [o.cpu() for o in out]
        if dev == card:
            per_step = cfg.n_layers
            assert quant_matmul.launches - before[0] == 3 * 7 * per_step
            assert flash_attention.launches - before[1] == 3 * per_step
    for a, b in zip(runs["cpu"], runs[str(card)]):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("pe", ["int16", "lightpe1", "lightpe2", "int8"])
def test_qat_model_on_card_matches_cpu_bf16(card, pe):
    """Reduced SmolLM under QAT numerics in the config's bfloat16 (the
    activations reach fake_quant in bfloat16): the forward on the card
    equals the CPU's within the serving tests' bfloat16 tolerance, and
    launches the kernel twice a projection."""
    from repro_torch import convert
    from repro_torch.configs import reduced
    from repro_torch.models import transformer as T
    cfg = reduced("smollm-135m").replace(pe_type=pe)
    assert cfg.dtype == "bfloat16"
    arrays = T.numpy_params(cfg, seed=0)
    toks = torch.arange(18).reshape(2, 9) * 17 % cfg.vocab
    want = T.forward(convert.params_from_numpy(arrays, "cpu"), toks, cfg)
    before = fake_quant.launches
    got = T.forward(convert.params_from_numpy(arrays, card), toks.to(card),
                    cfg)
    projections = cfg.n_layers * 7 + 1
    assert fake_quant.launches - before == projections * (
        3 if pe == "lightpe2" else 2)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=2e-2)

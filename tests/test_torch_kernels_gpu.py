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
    """Bit-identical in pow2 (both use CUDA's log2f/exp2f), within 1e-6
    in affine; one launch per call."""
    w = _weight((k, n), card)
    s = (tfq.affine_scale(w, bits, axis=0)[0] if mode == "affine"
         else tfq.pow2_emax(w, axis=0)[0])
    before = fake_quant.launches
    got = fake_quant(w, s, mode=mode, bits=bits)
    assert fake_quant.launches == before + 1
    want = (ref_fake_quant_affine(w, s, bits) if mode == "affine"
            else ref_fake_quant_pow2(w, s))
    torch.cuda.synchronize()
    if mode == "pow2":
        assert torch.equal(got, want)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


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

@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,start", [
    (4, 130, 256, 9, 3, 64, 0), (4, 1, 256, 9, 3, 64, 0),
    (4, 1, 256, 9, 3, 64, 63), (4, 1, 256, 9, 3, 64, 255),
    (2, 33, 70, 4, 1, 32, 5), (1, 64, 64, 2, 2, 16, 0),
    (2, 40, 80, 4, 2, 128, 17)])
def test_flash_attention_matches_plain(card, b, sq, skv, hq, hkv, d, start):
    """2e-5 (tests/test_kernels.py:122): float32 sums in another order."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_gqa)
    from repro_torch.kernels.flash_attention.ref import ref_attention_gqa
    gen = torch.Generator(device=card).manual_seed(skv)
    q = torch.randn((b, sq, hq, d), generator=gen, device=card)
    k = torch.randn((b, skv, hkv, d), generator=gen, device=card)
    v = torch.randn((b, skv, hkv, d), generator=gen, device=card)
    st = torch.full((b,), start, dtype=torch.int32, device=card)
    before = flash_attention.launches
    got = flash_attention_gqa(q, k, v, st)
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(got, ref_attention_gqa(q, k, v, st),
                               rtol=2e-5, atol=2e-5)
    got = flash_attention_gqa(q, k, v, st, causal=False)
    torch.testing.assert_close(
        got, ref_attention_gqa(q, k, v, st, causal=False), rtol=2e-5,
        atol=2e-5)


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

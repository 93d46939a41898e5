"""The SSM and hybrid slice on the card: the ``flash_attention`` kernel at
head_dim 112 (Zamba2-7B's shared attention) against its plain version,
``quant_matmul`` under a bfloat16 cast against its plain version, and
the reduced RWKV6 and Zamba2 models (dense and on packed codes) on the
card against the CPU, with their kernel launches counted.

Needs a CUDA card and nvcc: every test is marked ``gpu`` and skips
without a card.  Imports no JAX:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_ssm_gpu.py
"""

import pytest
import torch

FA_TOL = 2e-5   # tests/test_kernels.py:122
# quant_matmul under a cast: one bfloat16 step (float32 sums in another
# order before the rounding), and near zero, where a sum cancels, the
# float32 kernels' absolute tolerance (tests/test_kernels.py:45)
CAST_RTOL, CAST_ATOL = 2.0 ** -7, 1e-4
# the reduced models on the card against the CPU, float32: the two differ
# in the order of float32 sums only
MODEL_TOL = 1e-4

# (b, sq, skv, hq, hkv, start): Zamba2-7B's prefill and decode on the
# engine's 256-row cache, and small ragged shapes (GQA, key splits)
FA_CASES = [(4, 130, 256, 32, 32, 0), (4, 1, 256, 32, 32, 130),
            (4, 1, 256, 32, 32, 141), (2, 2, 300, 8, 2, 133),
            (2, 70, 90, 4, 2, 10), (1, 17, 40, 6, 3, 23)]
FA_TYPES = [(torch.float32, torch.float32, False),
            (torch.float32, torch.float32, True),
            (torch.bfloat16, torch.float32, True),
            (torch.bfloat16, torch.bfloat16, False)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("q_type,kv_type,round_p", FA_TYPES)
@pytest.mark.parametrize("b,sq,skv,hq,hkv,start", FA_CASES)
def test_kernel_at_112_matches_plain(card, b, sq, skv, hq, hkv, start,
                                     q_type, kv_type, round_p):
    """One launch a call, within 2e-5 of the plain version, two calls
    bitwise equal, at head_dim 112 in both of the kernel's plans."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_gqa)
    from repro_torch.kernels.flash_attention.ref import ref_attention_gqa
    gen = torch.Generator(device=card).manual_seed(skv + sq)
    q = torch.randn((b, sq, hq, 112), generator=gen, device=card).to(q_type)
    k, v = (torch.randn((b, skv, hkv, 112), generator=gen,
                        device=card).to(kv_type) for _ in range(2))
    st = torch.full((b,), start, dtype=torch.int32, device=card)
    before = flash_attention.launches
    got = flash_attention_gqa(q, k, v, st, round_p=round_p)
    again = flash_attention_gqa(q, k, v, st, round_p=round_p)
    assert flash_attention.launches - before == 2
    want = ref_attention_gqa(q, k, v, st, round_p=round_p)
    assert torch.equal(got, again)
    assert float((got - want).abs().max()) <= FA_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(1, 64, 290), (4, 3584, 256),
                                   (16, 256, 96), (17, 254, 64),
                                   (520, 64, 290), (130, 512, 129)])
@pytest.mark.parametrize("mode", ["int4", "pow2", "int8"])
def test_quant_matmul_cast_matches_plain(card, mode, m, k, n):
    """Under a bfloat16 cast (x and each dequantized weight rounded to
    bfloat16, a bfloat16 result) the GEMV and the tensor-core product
    agree with the plain version within one bfloat16 step (1e-4 near
    zero); two calls bitwise equal."""
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.kernels.quant_matmul.ref import ref_quant_matmul
    from repro_torch.quant.pack import QUANTIZE
    gen = torch.Generator(device=card).manual_seed(m + k + n)
    w = torch.randn((k, n), generator=gen, device=card) * 0.08
    x = torch.randn((m, k), generator=gen, device=card)
    codes, scale = QUANTIZE[mode](w)
    got = quant_matmul(x, codes, scale, mode=mode, cast=torch.bfloat16)
    again = quant_matmul(x, codes, scale, mode=mode, cast=torch.bfloat16)
    want = ref_quant_matmul(x, codes, scale, mode, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= CAST_RTOL * want.float().abs() + CAST_ATOL).all())


def _serve(mod, cfg, params, device):
    from repro_torch.serve import ServeEngine, check
    eng = ServeEngine(cfg, mod, params, 4, 64)
    prompts = check.prompts(cfg.vocab, (5, 12, 30, 31))
    return check.record(eng, prompts, 6, lambda t: t.float().cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("pe", [None, "lightpe1", "int8"])
@pytest.mark.parametrize("name", ["rwkv6-1.6b", "zamba2-7b"])
def test_reduced_model_on_card_matches_cpu(card, name, pe):
    """The reduced model served in float32 on the card (dense weights, or
    packed as LightPE-1 / INT8 codes at a floor that packs every
    projection) against the same run on the CPU within 1e-4; the card's
    launches counted: one ``quant_matmul`` a packed projection a step,
    one ``flash_attention`` a group (Zamba2)."""
    from repro_torch import convert
    from repro_torch.configs import reduced
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.models import family_module
    from repro_torch.models.hybrid import _group_shape
    from repro_torch.serve import check, quantize_params
    cfg = reduced(name).replace(dtype="float32")
    mod = family_module(cfg)
    arrays = mod.numpy_params(cfg, 0)
    runs, counts = [], None
    for device in ("cpu", card):
        params = convert.params_from_numpy(arrays, device)
        if pe is not None:
            params = quantize_params(params, pe, min_size=1 << 14)
        quant_matmul.launches = flash_attention.launches = 0
        runs.append(_serve(mod, cfg, params, device))
        counts = (quant_matmul.launches, flash_attention.launches)
    problems, _ = check.compare(runs[1], runs[0], MODEL_TOL)
    assert not problems, problems
    n_packed = 0 if pe is None else (2 * cfg.n_layers + 1
                                     if cfg.family == "ssm"
                                     else _group_shape(cfg)[2] + 1)
    groups = 0 if cfg.family == "ssm" else _group_shape(cfg)[1]
    assert counts == (6 * n_packed, 6 * groups)


@pytest.mark.gpu
def test_zamba_trains_only_where_the_backward_runs(card):
    """The attention's backward kernel takes head_dim 64 / 128: training
    Zamba2-7B's shared attention (112) on the card raises, naming the
    head_dim (ROADMAP A item 4)."""
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    q = torch.randn((1, 8, 2, 112), device=card, requires_grad=True)
    k, v = (torch.randn((1, 8, 2, 112), device=card) for _ in range(2))
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_gqa(q, k, v)
    assert q.grad is None

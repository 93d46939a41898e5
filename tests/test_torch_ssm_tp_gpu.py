"""The kernels of the SSM and hybrid families' tensor-parallel split at a
pod16x16 rank's local shapes, on the card, against their plain versions:
``flash_attention`` forward and backward on Zamba2-7B's shared attention
with 2 q and 2 KV heads of 112 a rank (float32 q, K, V and P: the unified
attention's), and ``fake_quant`` on a rank's LightPE-1 shards of the
products of RWKV6-1.6B and Zamba2-7B.

Needs a CUDA card and nvcc: every test is marked ``gpu`` and skips
without a card.  Imports no JAX:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_ssm_tp_gpu.py
"""

import math

import pytest
import torch

FA_TOL = 2e-5   # tests/test_kernels.py:122

# (b, sq, skv, hq, hkv, d, start): decode_32k's 8 rows a device over
# 32,768 keys (the split kernel), a cut of prefill_32k's last queries (the
# wgmma kernel for a float32 q at 112), a prompt from 0
FORWARD = [(8, 1, 32768, 2, 2, 112, 32767),
           (2, 512, 4096, 2, 2, 112, 3584),
           (2, 300, 300, 2, 2, 112, 0)]
# (b, s, hq, hkv, d): train_4k's microbatch a rank, cut to 1,024 rows
BACKWARD = [(2, 1024, 2, 2, 112)]
# a rank's shards at 16: RWKV6's tm/wr, tm/wo, cm/wk, cm/wv; Zamba2's
# in_proj, out_proj, the shared block's wq and w_down
SHARDS = [(2048, 128), (128, 2048), (2048, 448), (448, 2048), (3584, 911),
          (448, 3584), (3584, 224), (896, 3584)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,start", FORWARD)
def test_forward_at_a_ranks_heads(card, b, sq, skv, hq, hkv, d, start):
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    from repro_torch.kernels.flash_attention.ref import ref_attention_gqa
    gen = torch.Generator(device=card).manual_seed(20)
    q, k, v = (torch.randn((b, n, h, d), generator=gen, device=card)
               for n, h in ((sq, hq), (skv, hkv), (skv, hkv)))
    st = torch.full((b,), start, dtype=torch.int32, device=card)
    got = flash_attention_gqa(q, k, v, st)
    assert torch.equal(got, flash_attention_gqa(q, k, v, st))
    want = ref_attention_gqa(q, k, v, st)
    assert float((got - want).abs().max()) <= FA_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,hq,hkv,d", BACKWARD)
def test_backward_at_a_ranks_heads(card, b, s, hq, hkv, d):
    from repro_torch.kernels.flash_attention import attention_backward
    from repro_torch.kernels.flash_attention.ref import ref_attention_gqa_bwd
    from repro_torch.train_check import attention_grad_errors
    gen = torch.Generator(device=card).manual_seed(21)
    q, k, v, dout = (torch.randn((b, s, h, d), generator=gen, device=card)
                     for h in (hq, hkv, hkv, hq))
    st = torch.zeros(b, dtype=torch.int32, device=card)
    got = attention_backward(q, k, v, st, dout)
    assert all(torch.equal(a, c) for a, c in
               zip(got, attention_backward(q, k, v, st, dout)))
    held = attention_grad_errors(got, ref_attention_gqa_bwd(
        q, k, v, st, dout), dout)
    assert held["ok"], held


@pytest.mark.gpu
def test_fake_quant_on_a_ranks_shards(card, monkeypatch):
    """One grouped launch, every element equal to the plain version's on
    the same tensors on the card."""
    import sys
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.quant import fake_quant as FQ
    from repro_torch.quant.qconfig import preset
    gen = torch.Generator(device=card).manual_seed(22)
    ws = [torch.randn(shape, generator=gen, device=card)
          / math.sqrt(shape[0]) for shape in SHARDS]
    qcfg = preset("lightpe1")
    before = fake_quant.launches
    got = FQ.fake_quant_weights(ws, qcfg)
    assert fake_quant.launches - before == 1
    plain = sys.modules[fake_quant.__module__]._plain
    monkeypatch.setattr(FQ, "fake_quant_group", lambda xs, scales, *, mode,
                        bits=8: [plain(x, sc, mode, bits)
                                 for x, sc in zip(xs, scales)])
    for a, c in zip(got, FQ.fake_quant_weights(ws, qcfg)):
        assert torch.equal(a, c)

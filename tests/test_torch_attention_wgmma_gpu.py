"""The wgmma attention kernels on the card (``csrc/flash_attention_wgmma.cu``,
the forward's prefill at head_dims 112 / 128 with a float32 q and 256;
``csrc/flash_attention_bwd_wgmma.cu``, the backward at 112 / 128 / 256):
each against its plain version, two calls with the same bits, the
one-logit invariant of the backward (the keys kernel's logits have the
rows kernel's bits), and the wrapper's shared-memory plan against the
kernels' own.

Needs a CUDA card and nvcc: every test is marked ``gpu`` and skips
without a card.  Imports no JAX:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_attention_wgmma_gpu.py
"""

import ctypes

import pytest
import torch

from repro_torch import train_check
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (attention_backward,
                                                 bwd_wgmma_plan,
                                                 flash_attention,
                                                 flash_attention_gqa, plan,
                                                 wgmma_smem)
from repro_torch.kernels.flash_attention.ref import (ref_attention_gqa,
                                                     ref_attention_gqa_bwd)

FA_TOL = 2e-5    # tests/test_kernels.py:122, the forward's


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _randn(card, shape, dtype, g):
    return torch.randn(shape, generator=g, device=card).to(dtype)


# (b, sq, skv, hq, hkv, d, start, window, softcap, q type, kv type): tiles
# of 64 rows and chunks of 64 keys cut raggedly, a window inside a chunk
# and across several, the soft-cap, keys split across a cluster (few
# tiles), a bfloat16 cache (two passes with round_p)
FWD_SHAPES = [
    (2, 100, 100, 4, 2, 112, 0, 0, 0.0, "float32", "float32"),
    (2, 100, 130, 4, 2, 128, 30, 0, 0.0, "float32", "float32"),
    (2, 200, 200, 4, 1, 256, 0, 64, 0.0, "bfloat16", "float32"),
    (1, 300, 300, 2, 1, 256, 0, 128, 50.0, "float32", "float32"),
    (1, 40, 1024, 2, 1, 256, 984, 0, 0.0, "float32", "float32"),
    (2, 70, 70, 4, 2, 112, 0, 9, 30.0, "float32", "bfloat16"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", FWD_SHAPES)
def test_forward_wgmma_matches_plain(card, shape):
    """Float32 P (no rounding): within ``FA_TOL`` of the plain version,
    one launch a call counted as a wgmma launch, two calls with the same
    bits."""
    b, sq, skv, hq, hkv, d, start, window, softcap, qt, kt = shape
    g = torch.Generator(device=card).manual_seed(d + sq)
    q = _randn(card, (b, sq, hq, d), getattr(torch, qt), g)
    k, v = (_randn(card, (b, skv, hkv, d), getattr(torch, kt), g)
            for _ in range(2))
    st = torch.full((b,), start, dtype=torch.int32, device=card)
    assert plan(b, sq, skv, hq, hkv, d, qt == "bfloat16",
                window).variant == "wgmma"
    kw = dict(window=window, softcap=softcap)
    before = (flash_attention.launches, flash_attention.wgmma_launches)
    got = flash_attention_gqa(q, k, v, st, **kw)
    again = flash_attention_gqa(q, k, v, st, **kw)
    assert (flash_attention.launches, flash_attention.wgmma_launches) == (
        before[0] + 2, before[1] + 2)
    torch.cuda.synchronize()
    want = ref_attention_gqa(q, k, v, st, True, 0.0, False, window, softcap)
    assert float((got - want).abs().max()) <= FA_TOL
    assert torch.equal(got, again)


# (b, s, hq, hkv, start, window, softcap): ragged tiles, a window across
# chunks, the soft-cap, an offset start
BWD_SHAPES = [(2, 100, 4, 2, 0, 0, 0.0), (1, 130, 4, 1, 0, 48, 30.0),
              (2, 70, 8, 2, 20, 40, 0.0)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [112, 128, 256])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_backward_wgmma_matches_plain(card, shape, d, dtype):
    """Phase 10.1's tolerances (``attention_grad_errors``), one backward
    launch a call counted as a wgmma launch, two calls with the same
    bits."""
    b, s, hq, hkv, start, window, softcap = shape
    g = torch.Generator(device=card).manual_seed(d + s)
    q = _randn(card, (b, s, hq, d), dtype, g)
    k, v = (_randn(card, (b, s + start, hkv, d), dtype, g) for _ in range(2))
    do = _randn(card, (b, s, hq, d), torch.float32, g)
    st = torch.full((b,), start, dtype=torch.int32, device=card)
    kw = dict(round_p=True, window=window, softcap=softcap)
    before = flash_attention.backward_wgmma_launches
    got = attention_backward(q, k, v, st, do, **kw)
    again = attention_backward(q, k, v, st, do, **kw)
    assert flash_attention.backward_wgmma_launches == before + 2
    torch.cuda.synchronize()
    want = ref_attention_gqa_bwd(q, k, v, st, do, True, 0.0, True, window,
                                 softcap)
    err = train_check.attention_grad_errors(got, want, do)
    assert err["ok"], err
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [112, 128, 256])
def test_one_logit_invariant(card, d, dtype, softcap):
    """A window of 1: every row sees one key, so P = 1 and dS = 0 exactly
    wherever the keys kernel's logit has the rows kernel's bits (the
    wgmma products forming S the same way in both): dq and dk are 0."""
    g = torch.Generator(device=card).manual_seed(d)
    q = _randn(card, (2, 300, 4, d), dtype, g)
    k, v = (_randn(card, (2, 300, 2, d), dtype, g) for _ in range(2))
    do = _randn(card, (2, 300, 4, d), torch.float32, g)
    st = torch.zeros(2, dtype=torch.int32, device=card)
    dq, dk, dv = attention_backward(q, k, v, st, do, round_p=True, window=1,
                                    softcap=softcap)
    torch.cuda.synchronize()
    assert int((dq != 0).sum()) == 0 and int((dk != 0).sum()) == 0
    assert int((dv != 0).sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("d", [112, 128, 256])
def test_plans_state_the_kernels_shared_memory(card, d):
    """``wgmma_smem`` and ``bwd_wgmma_plan`` restate the kernels' ``Cfg``:
    the C entries report the same bytes."""
    fwd = _build.load("flash_attention_wgmma").flash_attention_wgmma_smem
    bwd = _build.load(
        "flash_attention_bwd_wgmma").flash_attention_bwd_wgmma_smem
    fwd.argtypes = [ctypes.c_int]
    bwd.argtypes = [ctypes.c_int] * 3
    assert fwd(d) == wgmma_smem(d)
    for bf16 in (0, 1):
        p = bwd_wgmma_plan(d, bool(bf16))
        assert (bwd(d, bf16, 0), bwd(d, bf16, 1)) == (p.rows_smem,
                                                      p.keys_smem)

"""Training every family on the card: the flash attention backward kernel
at every head_dim the forward takes (16, 32, 112 and 256 beside 64 and
128), with sliding windows and logit soft-caps, against its plain
version and its emulation, two calls with the same bits; and RWKV6 and
Whisper, which train through the port's other kernels, for a few steps
on the card against the same steps on the kernels' plain versions.

Needs a CUDA card and nvcc: every test is marked ``gpu`` and skips
without a card.  Imports no JAX, so it runs on a machine without it:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_families_gpu.py
"""

import pytest
import torch

from repro_torch import train_check
from repro_torch.kernels.flash_attention import (attention_backward,
                                                 flash_attention,
                                                 flash_attention_gqa)
from repro_torch.kernels.flash_attention.ref import (emulate_attention_bwd,
                                                     ref_attention_gqa_bwd)

NEW_DIMS = (16, 32, 112, 256)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(card, b, sq, skv, hq, hkv, d, dtype, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=card).to(t)
            for shape, t in (((b, sq, hq, d), dtype), ((b, skv, hkv, d), dtype),
                             ((b, skv, hkv, d), dtype),
                             ((b, sq, hq, d), torch.float32))]


# (b, sq, skv, hq, hkv, start, window, softcap): ragged S across the tiles
# of every instance (64 / 32 / 16 rows, chunks of 64 / 32 / 16 keys, key
# blocks of 64 / 32), a window shorter than a tile and one across
# several, an offset start, the soft-cap with and without a window
SHAPES = [(2, 1, 1, 4, 2, 0, 0, 0.0), (2, 17, 17, 4, 4, 0, 0, 0.0),
          (1, 100, 100, 8, 2, 0, 0, 0.0), (2, 33, 70, 4, 1, 37, 0, 0.0),
          (1, 129, 129, 4, 1, 0, 8, 0.0), (2, 65, 65, 2, 2, 0, 40, 50.0),
          (1, 200, 230, 8, 2, 30, 77, 0.0), (1, 150, 150, 4, 4, 0, 0, 30.0)]


@pytest.mark.gpu
@pytest.mark.parametrize("round_p", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", NEW_DIMS)
@pytest.mark.parametrize("shape", SHAPES)
def test_new_instances_match_plain(card, shape, d, dtype, round_p):
    """Each new instance at ``train_check.attention_grad_errors``'
    tolerance (phase 10.1's); one count a call; two calls, same bits."""
    b, sq, skv, hq, hkv, start, window, softcap = shape
    q, k, v, do = _inputs(card, b, sq, skv, hq, hkv, d, dtype)
    st = torch.full((b,), start, dtype=torch.int32, device=card)
    kw = dict(round_p=round_p, window=window, softcap=softcap)
    before = flash_attention.backward_launches
    got = attention_backward(q, k, v, st, do, **kw)
    again = attention_backward(q, k, v, st, do, **kw)
    assert flash_attention.backward_launches == before + 2
    torch.cuda.synchronize()
    want = ref_attention_gqa_bwd(q, k, v, st, do, True, 0.0, round_p, window,
                                 softcap)
    assert all(g.dtype == dtype for g in got)
    err = train_check.attention_grad_errors(got, want, do)
    assert err["ok"], err
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("d", (16, 64, 112, 128, 256))
@pytest.mark.parametrize("b,sq,skv,hq,hkv,start,window,softcap",
                         [(2, 129, 129, 9, 3, 0, 0, 50.0),
                          (1, 200, 230, 8, 2, 30, 40, 0.0),
                          (1, 160, 160, 4, 1, 0, 24, 50.0)])
def test_backward_kernel_matches_its_emulation(card, b, sq, skv, hq, hkv,
                                               start, window, softcap, d):
    """Float32: the kernel against ``emulate_attention_bwd`` (the same
    parts, chunks, key parts and 16-deep steps, the soft-cap's derivative
    in autograd's order) within 2e-6 of the largest gradient."""
    q, k, v, do = _inputs(card, b, sq, skv, hq, hkv, d, torch.float32,
                          seed=11)
    st = torch.full((b,), start, dtype=torch.int32, device=card)
    got = attention_backward(q, k, v, st, do, round_p=True, window=window,
                             softcap=softcap)
    want = emulate_attention_bwd(q, k, v, st, do, True, 0.0, True, window,
                                 softcap)
    for g, w in zip(got, want):
        top = w.abs().max().item()
        assert (g - w).abs().max().item() <= 2e-6 * top


@pytest.mark.gpu
@pytest.mark.parametrize("d", NEW_DIMS)
def test_without_causal_mask(card, d):
    """Every key visible to every query (Whisper's encoder and
    cross-attention)."""
    q, k, v, do = _inputs(card, 2, 50, 77, 4, 2, d, torch.float32, seed=9)
    st = torch.zeros(2, dtype=torch.int32, device=card)
    got = attention_backward(q, k, v, st, do, causal=False, round_p=True)
    want = ref_attention_gqa_bwd(q, k, v, st, do, False, 0.0, True)
    err = train_check.attention_grad_errors(got, want, do)
    assert err["ok"], err


@pytest.mark.gpu
@pytest.mark.parametrize("d,window,softcap", [(256, 512, 0.0),
                                              (256, 0, 50.0), (112, 0, 0.0)])
def test_autograd_runs_the_kernels_with_windows_and_caps(card, d, window,
                                                         softcap):
    """Gemma's local / Gemma-2's capped / Zamba2's attention through
    ``flash_attention_gqa``'s autograd: one forward and one backward
    launch, the backward kernel's gradients."""
    q, k, v, do = _inputs(card, 1, 600, 600, 4, 1, d, torch.float32, seed=5)
    st = torch.zeros(1, dtype=torch.int32, device=card)
    kw = dict(round_p=True, window=window, softcap=softcap)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    f0, b0 = flash_attention.launches, flash_attention.backward_launches
    flash_attention_gqa(*leaves, st, **kw).backward(do)
    assert (flash_attention.launches, flash_attention.backward_launches) \
        == (f0 + 1, b0 + 1)
    want = attention_backward(q.detach(), k.detach(), v.detach(), st, do,
                              **kw)
    assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want))


@pytest.mark.gpu
def test_window_without_causal_is_refused(card):
    x = torch.zeros(1, 4, 2, 64, device=card, requires_grad=True)
    with pytest.raises(ValueError, match="causal"):
        flash_attention_gqa(x, x, x, causal=False, window=8)
    with pytest.raises(ValueError, match="head_dim"):
        y = torch.zeros(1, 4, 2, 48, device=card, requires_grad=True)
        flash_attention_gqa(y, y, y)


def _smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.gpu
@pytest.mark.parametrize("arch,cut", [("rwkv6-1.6b", dict(n_layers=4)),
                                      ("whisper-medium",
                                       dict(n_layers=4, enc_layers=4,
                                            dec_layers=4))])
def test_rwkv_and_whisper_train_on_the_card(card, arch, cut):
    """RWKV6-1.6B (its chunk scan in plain torch, ``fake_quant`` on every
    projection) and Whisper-medium (the attention's backward at head_dim
    64, bidirectional, causal and cross) at full width, depth cut, under
    LightPE-1: three AdamW steps on the kernels, with their launches
    counted, within ``chip_smoke.TRAIN_LM_RTOL`` of the same steps on the
    kernels' plain versions, the losses finite and falling nowhere to
    NaN."""
    from repro_torch.configs import get
    from repro_torch.train_check import compare
    smoke = _smoke()
    cfg = get(arch).replace(pe_type="lightpe1", **cut)
    calls = smoke._family_attention_calls(cfg)
    f0, b0 = flash_attention.launches, flash_attention.backward_launches
    rows, _, _ = smoke._family_steps(torch, card, cfg, 2, 128, 3, False)
    assert (flash_attention.launches - f0,
            flash_attention.backward_launches - b0) == (6 * calls, 3 * calls)
    plain, _, _ = smoke._family_steps(torch, card, cfg, 2, 128, 3, True)
    held = compare(rows, plain, smoke.TRAIN_LM_RTOL)
    assert held["ok"], (rows, plain, held)
    assert all(x == x for r in rows for x in r)

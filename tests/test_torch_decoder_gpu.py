"""The decoder family's additions on the card: the ``flash_attention``
kernel with a sliding window, a logit soft-cap and head_dim 256 against
its plain version, and the reduced Gemma / MoE models on the card against
the CPU.

Needs a CUDA card and nvcc: every test is marked ``gpu`` and skips
without a card.  Imports no JAX:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_decoder_gpu.py
"""

import numpy as np
import pytest
import torch

FA_TOL = 2e-5   # tests/test_kernels.py:122

# (b, sq, skv, hq, hkv, d, start, window, softcap): Gemma-3-1B (4/1
# heads, head_dim 256, window 512) at decode past the window and at a
# prefill longer than it; Gemma-2-9B (16/8 heads, head_dim 256, window
# 4096, soft-cap 50) at decode and prefill past its window; small shapes
# whose window cuts a cluster's split and an mma chunk, with and without a
# soft-cap, at head_dims the mma kernel takes.
WIN_CASES = [
    (4, 1, 1024, 4, 1, 256, 905, 512, 0.0),
    (2, 300, 1024, 4, 1, 256, 600, 512, 0.0),
    (1, 1, 4608, 16, 8, 256, 4600, 4096, 50.0),
    (1, 40, 4608, 16, 8, 256, 4500, 4096, 50.0),
    (2, 1, 300, 9, 3, 64, 250, 40, 0.0),
    (2, 2, 300, 9, 3, 64, 133, 7, 20.0),
    (2, 130, 300, 9, 3, 64, 30, 77, 0.0),
    (2, 70, 200, 4, 2, 128, 100, 33, 30.0),
    (1, 96, 96, 2, 1, 32, 0, 1, 5.0),
]
WIN_TYPES = [(torch.float32, torch.float32, True),
             (torch.bfloat16, torch.float32, True),
             (torch.bfloat16, torch.bfloat16, False)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(card, b, sq, skv, hq, hkv, d, start, q_type, kv_type):
    gen = torch.Generator(device=card).manual_seed(skv + sq + d)
    q = torch.randn((b, sq, hq, d), generator=gen, device=card).to(q_type)
    k = torch.randn((b, skv, hkv, d), generator=gen, device=card).to(kv_type)
    v = torch.randn((b, skv, hkv, d), generator=gen, device=card).to(kv_type)
    st = torch.full((b,), start, dtype=torch.int32, device=card)
    return q, k, v, st


@pytest.mark.gpu
@pytest.mark.parametrize("q_type,kv_type,round_p", WIN_TYPES)
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,start,window,softcap", WIN_CASES)
def test_windowed_kernel_matches_plain(card, b, sq, skv, hq, hkv, d, start,
                                       window, softcap, q_type, kv_type,
                                       round_p):
    """The plan's kernel with a window and a soft-cap against the plain
    version on the same tensors: 2e-5 (tests/test_kernels.py:122); the
    bfloat16 K/V case runs without round_p, whose bf16 P may round the
    other way at a boundary (the kernels' tests hold that apart).  One
    launch a call; two calls give the same bits."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_gqa)
    from repro_torch.kernels.flash_attention.ref import ref_attention_gqa
    q, k, v, st = _inputs(card, b, sq, skv, hq, hkv, d, start, q_type,
                          kv_type)
    scale = 1.0 / 16.0 if d == 256 and softcap else 0.0
    before = flash_attention.launches
    got = flash_attention_gqa(q, k, v, st, round_p=round_p, scale=scale,
                              window=window, softcap=softcap)
    again = flash_attention_gqa(q, k, v, st, round_p=round_p, scale=scale,
                                window=window, softcap=softcap)
    assert flash_attention.launches == before + 2
    want = ref_attention_gqa(q, k, v, st, round_p=round_p, scale=scale,
                             window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=FA_TOL, atol=FA_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("q_type", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,start", [(1, 700), (2, 311), (130, 0)])
def test_head_dim_256_global(card, sq, start, q_type):
    """head_dim 256 without a window (Gemma's global layers) on the
    engine's float32 cache."""
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    from repro_torch.kernels.flash_attention.ref import ref_attention_gqa
    q, k, v, st = _inputs(card, 4, sq, 1024, 4, 1, 256, start, q_type,
                          torch.float32)
    torch.testing.assert_close(
        flash_attention_gqa(q, k, v, st, round_p=True),
        ref_attention_gqa(q, k, v, st, round_p=True), rtol=FA_TOL,
        atol=FA_TOL)


@pytest.mark.gpu
def test_window_and_softcap_refused_by_the_backward(card):
    """The backward kernels compute the window and the soft-cap since the
    backward took them: the autograd path and ``attention_backward``
    launch the kernel for both and match the plain version; a window
    without the causal mask is still refused."""
    from repro_torch import train_check
    from repro_torch.kernels.flash_attention import (attention_backward,
                                                     flash_attention,
                                                     flash_attention_gqa)
    from repro_torch.kernels.flash_attention.ref import ref_attention_gqa_bwd
    q, k, v, st = _inputs(card, 1, 8, 8, 2, 1, 64, 0, torch.float32,
                          torch.float32)
    do = torch.ones_like(q)
    for kw in (dict(window=4), dict(softcap=30.0)):
        before = flash_attention.backward_launches
        leaf = q.detach().requires_grad_()
        flash_attention_gqa(leaf, k, v, st, **kw).backward(do)
        got = attention_backward(q, k, v, st, do, **kw)
        assert flash_attention.backward_launches == before + 2
        want = ref_attention_gqa_bwd(q, k, v, st, do, True, 0.0, False,
                                     kw.get("window", 0),
                                     kw.get("softcap", 0.0))
        assert train_check.attention_grad_errors(got, want, do)["ok"]
        assert torch.equal(leaf.grad, got[0])
    with pytest.raises(ValueError, match="causal"):
        attention_backward(q, k, v, st, do, causal=False, window=4)


def _model_run(cfg, params, tokens, dtype, device):
    from repro_torch.models import transformer as T
    run = cfg.replace(dtype=dtype)
    cache = T.init_cache(run, tokens.shape[0], 24, torch.float32,
                         device=device)
    outs = []
    logits, cache = T.prefill(params, tokens[:, :-3], run, cache)
    outs.append(logits.float().cpu())
    for i in range(3):
        logits, cache = T.decode_step(params, tokens[:, -3 + i:][:, :1], run,
                                      cache)
        outs.append(logits.float().cpu())
    return torch.cat(outs, dim=1)


# card against CPU, both under FP32 numerics and under LightPE-1: float32
# sums in another order (1e-4).  Under LightPE-1 an 8-bit activation code
# at a round(x / s) tie flips when x is summed in another order, and one
# flip early in a run moves its logits by up to ~0.1
# (benchmarks/torch_qat_sensitivity.py); so the card's run takes the CPU's
# code at each such tie (``_ActCodes``), and a code that differs anywhere
# else fails
CARD_TOL = 1e-4
TIE = 1e-3      # |x / s| this close to a half-integer: a rounding tie


class _ActCodes:
    """Every activation fake-quant call of a run (``layers.qdense``'s and
    the MoE experts' buffers), in call order.  ``start("record")``: keep
    each call's x / s and codes round(x / s) (the CPU's run);
    ``start("pin")``: where a call's code differs from the recorded one's
    at a rounding tie (both x / s within ``TIE`` of the same
    half-integer), take the recorded code, counted in ``pinned``; a code
    that differs anywhere else fails."""

    def __init__(self, monkeypatch):
        from repro_torch.models import layers as L
        from repro_torch.models import moe as MOE
        self.calls, self.mode, self.n, self.pinned = [], None, 0, 0
        monkeypatch.setattr(L, "fake_quant_act",
                            self._wrap(L.fake_quant_act, False))
        monkeypatch.setattr(MOE, "fake_quant_expert_acts",
                            self._wrap(MOE.fake_quant_expert_acts, True))

    def start(self, mode):
        self.mode, self.n = mode, 0

    def _wrap(self, fn, expert):
        from repro_torch.quant.fake_quant import affine_scale

        def act(x, qcfg):
            out = fn(x, qcfg)
            if qcfg.act_scheme == "none" or not qcfg.quantize_acts:
                return out
            x = x.detach()
            s = (torch.stack([affine_scale(xe, qcfg.act_bits)
                              for xe in x.unbind(0)]).reshape(
                                  -1, *[1] * (x.ndim - 1))
                 if expert else affine_scale(x, qcfg.act_bits))
            ratio = x / s
            codes = torch.round(ratio)
            if self.mode == "record":
                self.calls.append((ratio.cpu(), codes.cpu()))
                return out
            want_ratio, want = (t.to(x.device) for t in self.calls[self.n])
            self.n += 1
            differ = codes != want
            if not bool(differ.any()):
                return out
            mag = ratio.abs()
            tie = (((mag - mag.floor() - 0.5).abs() < TIE)
                   & ((ratio - want_ratio).abs() < TIE))
            assert bool(tie[differ].all()), (
                f"activation call {self.n - 1}: codes differ away from a "
                f"rounding tie at x / s = {ratio[differ & ~tie][:4]} "
                f"(CPU {want_ratio[differ & ~tie][:4]})")
            self.pinned += int(differ.sum())
            return torch.where(differ, want * s, out)
        return act


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["gemma3-1b", "gemma2-9b",
                                  "deepseek-moe-16b"])
@pytest.mark.parametrize("pe", ["fp32", "lightpe1"])
def test_reduced_model_on_card_matches_cpu(card, name, pe, monkeypatch,
                                           record_property):
    """Reduced models in float32 on dense weights (the window shorter
    than the sequence; MoE with shared experts and a leading dense
    layer): prefill and three decode steps on the card (the kernels) and
    on the CPU (their plain versions), within ``CARD_TOL``, the card's
    activation codes at rounding ties pinned to the CPU's; the card's run
    twice, bitwise equal; under LightPE-1 exactly two ``fake_quant``
    launches a projection a step, an MoE layer's experts sharing each."""
    from repro_torch import convert
    from repro_torch.configs import reduced
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.models import transformer as T
    cfg = reduced(name).replace(pe_type=pe)
    arrays = T.numpy_params(cfg, 0)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(2, 20)))
    codes = _ActCodes(monkeypatch)
    codes.start("record")
    want = _model_run(cfg, convert.params_from_numpy(arrays, "cpu"), tokens,
                      "float32", "cpu")
    params = convert.params_from_numpy(arrays, card)
    before = fake_quant.launches
    codes.start("pin")
    got = _model_run(cfg, params, tokens.to(card), "float32", card)
    assert codes.n == len(codes.calls)
    # 7 projections a dense layer; 4 attention + 3 routed + 3 shared an
    # MoE layer; the head
    moe = cfg.n_layers - cfg.first_dense if cfg.moe_experts else 0
    projections = 7 * (cfg.n_layers - moe) + 10 * moe + 1
    assert fake_quant.launches - before == (0 if pe == "fp32"
                                            else 4 * 2 * projections)
    pinned = codes.pinned
    record_property("activation_codes_pinned", pinned)
    codes.start("pin")
    again = _model_run(cfg, params, tokens.to(card), "float32", card)
    assert torch.equal(got, again)
    torch.testing.assert_close(
        got, want, rtol=0, atol=CARD_TOL,
        msg=lambda m: f"{m} ({pinned} activation codes pinned at ties)")

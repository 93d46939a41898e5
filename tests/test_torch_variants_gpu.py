"""Phase 12's paths on the card: the ``flash_attention`` kernel with no
mask and Skv != Sq (Whisper's encoder and cross-attention), with float32
P under a window (block-local) and causal (chunked flash prefill),
against its plain version; the reduced models' perf variants and the
reduced Whisper on the card against the CPU (the plain versions).

Needs a CUDA card and nvcc: every test is marked ``gpu`` and skips
without a card.  Imports no JAX:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_variants_gpu.py

Tolerances: the kernel against its plain version 2e-5
(tests/test_kernels.py:122); the reduced float32 models card against CPU
1e-4 (float32 sums in another order, as the decoder's card tests).
"""

import numpy as np
import pytest
import torch

FA_TOL = 2e-5
CARD_TOL = 1e-4

# (b, sq, skv, hq, hkv, d, causal, window): Whisper-medium's encoder, its
# cross-attention at prefill (8 rows) and decode (1 row) over 1500 keys;
# block-local Gemma-3 (window 512, head_dim 256, G 4); SmolLM's flash
# prefill; ragged non-causal shapes
SHAPES = [(2, 1500, 1500, 16, 16, 64, False, 0),
          (4, 8, 1500, 16, 16, 64, False, 0),
          (4, 1, 1500, 16, 16, 64, False, 0),
          (1, 1024, 1024, 4, 1, 256, True, 512),
          (2, 2048, 2048, 9, 3, 64, True, 0),
          (2, 37, 300, 4, 2, 64, False, 0),
          (1, 130, 70, 2, 2, 32, False, 0)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,window", SHAPES)
def test_kernel_matches_plain_on_the_new_paths(card, b, sq, skv, hq, hkv, d,
                                               causal, window):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_gqa)
    from repro_torch.kernels.flash_attention.ref import ref_attention_gqa
    gen = torch.Generator(device=card).manual_seed(sq + skv + d)
    q = torch.randn((b, sq, hq, d), generator=gen, device=card)
    k = torch.randn((b, skv, hkv, d), generator=gen, device=card)
    v = torch.randn((b, skv, hkv, d), generator=gen, device=card)
    st = torch.zeros(b, dtype=torch.int32, device=card)
    before = flash_attention.launches
    got = flash_attention_gqa(q, k, v, st, causal=causal, window=window)
    again = flash_attention_gqa(q, k, v, st, causal=causal, window=window)
    assert flash_attention.launches - before == 2
    assert torch.equal(got, again)
    want = ref_attention_gqa(q, k, v, st, causal, window=window)
    torch.testing.assert_close(got, want, rtol=0, atol=FA_TOL)


def _model_pair(name, card, **knobs):
    from repro_torch import convert
    from repro_torch.configs import reduced
    from repro_torch.models import transformer as T
    cfg = reduced(name).replace(dtype="float32", **knobs)
    arrays = T.numpy_params(cfg, 0)
    return (cfg, convert.params_from_numpy(arrays, "cpu"),
            convert.params_from_numpy(arrays, card))


@pytest.mark.gpu
@pytest.mark.parametrize("name,knobs", [
    ("gemma3-1b", dict(attn_block_local=True)),
    ("gemma2-9b", dict(attn_block_local=True)),
    ("smollm-135m", dict(attn_flash=True)),
    ("qwen3-32b", dict(attn_flash=True)),
    ("deepseek-moe-16b", dict(moe_ep_shard_map=True))])
def test_reduced_variant_forward_on_card_matches_cpu(card, name, knobs):
    """One ``flash_attention`` launch a layer on the card; the logits
    within ``CARD_TOL`` of the CPU's (at 64 tokens: 4 blocks of the
    reduced windows)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import transformer as T
    cfg, cpu, dev = _model_pair(name, card, **knobs)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(2, 64)))
    want = T.forward(cpu, toks, cfg)
    before = flash_attention.launches
    got = T.forward(dev, toks.to(card), cfg)
    assert flash_attention.launches - before == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=CARD_TOL)


@pytest.mark.gpu
def test_kv_replicated_decode_on_card_matches_cpu(card):
    from repro_torch.models import transformer as T
    cfg, cpu, dev = _model_pair("qwen3-32b", card, kv_replicate_to=4)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, size=(2, 12)))
    outs = []
    for params, device in ((cpu, "cpu"), (dev, card)):
        cache = T.init_cache(cfg, 2, 16, torch.float32, device=device)
        assert cache["scan"]["k"].shape[-2] == 4
        t = toks.to(device)
        logits, cache = T.prefill(params, t[:, :8], cfg, cache)
        steps = [logits]
        for i in range(8, 12):
            logits, cache = T.decode_step(params, t[:, i:i + 1], cfg, cache)
            steps.append(logits)
        outs.append(torch.cat(steps, 1).cpu())
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=CARD_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
def test_reduced_whisper_on_card_matches_cpu(card, packed):
    """Encode, prefill and 3 decode steps, float32 (dense, or INT8 codes
    through ``quant_matmul``): 3 ``flash_attention`` launches a decoder
    layer's prefill (self, cross) plus one an encoder layer, 2 a decoder
    layer's decode step."""
    from repro_torch import convert
    from repro_torch.configs import reduced
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import encdec
    from repro_torch.serve import quantize_params
    cfg = reduced("whisper-medium").replace(dtype="float32")
    arrays = encdec.numpy_params(cfg, 0)
    rng = np.random.default_rng(3)
    frames = torch.as_tensor(rng.standard_normal((2, 40, cfg.d_model),
                                                 dtype=np.float32))
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(2, 8)))
    outs = []
    for device in ("cpu", card):
        params = convert.params_from_numpy(arrays, device)
        if packed:
            params = quantize_params(params, "int8", min_size=1 << 10)
        cache = encdec.init_cache(cfg, 2, 16, torch.float32, device=device)
        before = flash_attention.launches
        logits, cache, enc = encdec.prefill(
            params, {"frames": frames.to(device),
                     "tokens": toks[:, :5].to(device)}, cfg, cache)
        if device != "cpu":
            assert flash_attention.launches - before == \
                cfg.enc_layers + 2 * cfg.dec_layers
        steps = [logits]
        for i in range(5, 8):
            logits, cache = encdec.decode_step(
                params, toks[:, i:i + 1].to(device), enc, cfg, cache)
            steps.append(logits)
        if device != "cpu":
            assert flash_attention.launches - before == \
                cfg.enc_layers + 2 * cfg.dec_layers + 3 * 2 * cfg.dec_layers
        outs.append(torch.cat(steps, 1).cpu())
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=CARD_TOL)

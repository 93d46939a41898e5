"""Training on the card: the flash attention backward kernel against its
plain version, the gradients a training step gives the attention's
weights on the card against the same step on the CPU, and the card's
exact resume.

Needs a CUDA card and nvcc: every test is marked ``gpu`` and skips
without a card.  Imports no JAX, so it runs on a machine without it:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_gpu.py
"""

import pytest
import torch

from repro_torch import convert, train_check
from repro_torch.configs import get
from repro_torch.data import lm_pipeline
from repro_torch.kernels.flash_attention import (attention_backward,
                                                 flash_attention,
                                                 flash_attention_gqa)
from repro_torch.kernels.flash_attention.ref import (emulate_attention_bwd,
                                                     ref_attention_gqa_bwd)
from repro_torch.models import family_module, transformer
from repro_torch.optim import adamw, tree_leaves, warmup_cosine
from repro_torch.train import TrainState, fit, init_state, make_train_step
from repro_torch.train import resume


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


@pytest.mark.gpu
@pytest.mark.parametrize("round_p", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (9, 3), (8, 2)])
@pytest.mark.parametrize("b,sq,skv,start", [(2, 1, 1, 0), (2, 17, 17, 0),
                                            (1, 100, 100, 0), (3, 255, 255, 0),
                                            (2, 33, 70, 37), (1, 63, 63, 0),
                                            (1, 65, 65, 0), (2, 129, 129, 0),
                                            (1, 1024, 1024, 0)])
def test_backward_kernel_matches_plain(card, b, sq, skv, start, hq, hkv, d,
                                       dtype, round_p):
    """Ragged S (across the kernels' 64-row and 64-key tiles, 32 keys a
    chunk at head_dim 128, and one long row), GQA groups 1 / 3 / 4,
    head_dim 64 / 128, both types, at ``train_check.attention_grad_errors``'
    tolerance; one count a call."""
    q, k, v, do = _inputs(card, b, sq, skv, hq, hkv, d, dtype)
    st = torch.tensor([start] * b, dtype=torch.int32, device=card)
    before = flash_attention.backward_launches
    got = attention_backward(q, k, v, st, do, round_p=round_p)
    assert flash_attention.backward_launches == before + 1
    torch.cuda.synchronize()
    want = ref_attention_gqa_bwd(q, k, v, st, do, True, 0.0, round_p)
    assert all(g.dtype == dtype for g in got)
    err = train_check.attention_grad_errors(got, want, do)
    assert err["ok"], err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d", [(2, 20, 29, 8, 2, 128),
                                              (1, 64, 130, 9, 3, 64)])
def test_backward_kernel_without_causal_mask(card, b, sq, skv, hq, hkv, d,
                                             dtype):
    """Every key visible to every query (the kernel's causal=False)."""
    q, k, v, do = _inputs(card, b, sq, skv, hq, hkv, d, dtype, seed=9)
    st = torch.zeros(b, dtype=torch.int32, device=card)
    got = attention_backward(q, k, v, st, do, causal=False, round_p=True)
    want = ref_attention_gqa_bwd(q, k, v, st, do, False, 0.0, True)
    err = train_check.attention_grad_errors(got, want, do)
    assert err["ok"], err


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,start,causal",
                         [(2, 129, 129, 9, 3, 64, 0, True),
                          (16, 256, 256, 9, 3, 64, 0, True),
                          (1, 200, 230, 8, 2, 128, 30, True),
                          (2, 100, 100, 9, 3, 64, 0, False)])
def test_backward_kernel_matches_its_emulation(card, b, sq, skv, hq, hkv, d,
                                               start, causal):
    """Float32: the kernel against ``emulate_attention_bwd`` on the same
    bf16 parts and kept part products, chunks, halves and 16-deep steps,
    within 2e-6 of the largest gradient (the sums inside a step and across
    a chunk's lanes run in the tensor cores' order), ten times tighter than
    the plain version's 2e-5."""
    q, k, v, do = _inputs(card, b, sq, skv, hq, hkv, d, torch.float32, seed=11)
    st = torch.full((b,), start, dtype=torch.int32, device=card)
    got = attention_backward(q, k, v, st, do, causal=causal, round_p=True)
    want = emulate_attention_bwd(q, k, v, st, do, causal, 0.0, True)
    for g, w in zip(got, want):
        top = w.abs().max().item()
        assert (g - w).abs().max().item() <= 2e-6 * top


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_is_deterministic(card, dtype):
    """No floating-point atomics: two calls give the same bits."""
    q, k, v, do = _inputs(card, 16, 256, 256, 9, 3, 64, dtype, seed=3)
    st = torch.zeros(16, dtype=torch.int32, device=card)
    a = attention_backward(q, k, v, st, do, round_p=True)
    b = attention_backward(q, k, v, st, do, round_p=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_autograd_runs_the_kernels(card):
    q, k, v, do = _inputs(card, 2, 40, 40, 6, 2, 64, torch.float32, seed=5)
    st = torch.zeros(2, dtype=torch.int32, device=card)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    f0, b0 = flash_attention.launches, flash_attention.backward_launches
    flash_attention_gqa(*leaves, st, round_p=True).backward(do)
    assert (flash_attention.launches, flash_attention.backward_launches) \
        == (f0 + 1, b0 + 1)
    want = attention_backward(q.detach(), k.detach(), v.detach(), st, do,
                              round_p=True)
    assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want))
    with torch.no_grad():       # serving: the forward alone
        flash_attention_gqa(*leaves, st, round_p=True)
    assert flash_attention.backward_launches == b0 + 2
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.zeros(1, 4, 2, 48, device=card, requires_grad=True)
        flash_attention_gqa(x, x, x)


def _two_layers(pe, dtype="float32"):
    return get("smollm-135m").replace(n_layers=2, pe_type=pe, dtype=dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("pe", ["fp32", "lightpe1"])
def test_train_step_gives_attention_weights_the_cpu_gradients(card, pe):
    """The parent's fault: on the card the attention's output had no
    autograd history, so wq, wk, wv got no gradient.  Full width (two
    layers, float32 compute), the same step on the card and the CPU:
    every attention weight's gradient within 1e-3 of its largest (float32
    sums in other orders; LightPE-1's 8-bit codes may flip at a
    boundary, 2e-2)."""
    cfg = _two_layers(pe)
    mod = family_module(cfg)
    arrays = transformer.numpy_params(cfg, 0)
    batch = train_check.lm_batch(cfg.vocab, 0, 2, 64)
    grads = {}
    for dev in ("cpu", card):
        params = convert.params_from_numpy(arrays, dev)
        leaves = [params["layers"]["attn"][n] for n in ("wq", "wk", "wv")]
        for t in leaves:
            t.requires_grad_(True)
        loss = mod.loss_fn(params, convert.params_from_numpy(batch, dev), cfg)
        grads[str(dev)] = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
    tol = 1e-3 if pe == "fp32" else 2e-2
    for g_card, g_cpu in zip(grads["cuda"], grads["cpu"]):
        top = g_cpu.abs().max().item()
        assert top > 0
        assert (g_card - g_cpu).abs().max().item() <= tol * top


@pytest.mark.gpu
def test_exact_resume_on_the_card(card, tmp_path):
    """5 steps, a checkpoint, a restore and 5 more equal 10 steps bit for
    bit on the card (full width, two layers, LightPE-1, bfloat16)."""
    cfg = _two_layers("lightpe1", "bfloat16")
    mod = family_module(cfg)
    opt = adamw(warmup_cosine(1e-3, 5, 100))
    step = make_train_step(cfg, mod, opt)

    def fresh():
        return init_state(cfg, mod, opt,
                          torch.Generator(device=card).manual_seed(0),
                          device=card)

    quiet = lambda _msg: None  # noqa: E731
    a = fit(fresh(), step, lm_pipeline(cfg, 4, 64, device=card), 10,
            log_fn=quiet)
    fit(fresh(), step, lm_pipeline(cfg, 4, 64, device=card), 5,
        ckpt_dir=str(tmp_path), ckpt_every=5, log_fn=quiet)
    pipe = lm_pipeline(cfg, 4, 64, device=card)
    b = resume(cfg, mod, opt, str(tmp_path), pipe, device=card)
    assert isinstance(b, TrainState) and int(b.step) == 5
    b = fit(b, step, pipe, 10, log_fn=quiet)
    for x, y in zip(tree_leaves(a.params) + tree_leaves(a.opt_state),
                    tree_leaves(b.params) + tree_leaves(b.opt_state)):
        assert torch.equal(x, y)

"""Hold the port's training steps to the JAX package's.

``chip_smoke.py`` (phase 10) and ``tests/_torch_train_ref.py``, which
writes ``tests/data/torch_train_ref.json`` from the JAX package, run the
same short runs on the same numpy inputs and record the loss and the
global gradient norm (before clipping) of every step:

* LM: SmolLM-135M (full width; the CPU tests use the reduced config)
  from ``transformer.numpy_params(cfg, PARAM_SEED)``, ``LM_BATCH`` x
  ``LM_SEQ`` numpy tokens a step (``lm_batch``), ``LM_STEPS`` AdamW steps
  (``warmup_cosine(*LM_SCHEDULE)``, clip 1.0), under each of
  ``LM_PE_TYPES``;
* CNN: ResNet-``CNN_DEPTH`` from ``cnn.numpy_resnet(CNN_DEPTH, 10,
  PARAM_SEED)``, ``CNN_BATCH`` numpy images a step (``image_batch_np``),
  ``CNN_STEPS`` SGD-Nesterov steps (``paper_step_decay(*CNN_SCHEDULE)``,
  weight decay 5e-4, no clipping), under each of ``CNN_PE_TYPES``.

``compare`` holds one run's rows to another's at a relative tolerance,
and ``attention_grad_errors`` the backward kernel's gradients to the
plain version's.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

PARAM_SEED = 0
DATA_SEED = 1234
LM_PE_TYPES = ("fp32", "lightpe1")
LM_BATCH, LM_SEQ, LM_STEPS = 4, 128, 3
LM_SCHEDULE = (3e-4, 20, 200)          # warmup_cosine(base, warmup, total)
LM_CLIP = 1.0
CNN_PE_TYPES = ("fp32", "int16", "lightpe1", "lightpe2")
CNN_DEPTH, CNN_BATCH, CNN_STEPS = 8, 64, 3
CNN_SCHEDULE = (0.05, 100)             # paper_step_decay(base, steps/epoch)
CNN_WEIGHT_DECAY = 5e-4


def lm_batch(vocab: int, step: int, batch: int = LM_BATCH,
             seq: int = LM_SEQ) -> dict:
    """Uniform random tokens of step ``step`` (numpy, int32); labels are
    the next tokens."""
    rng = np.random.default_rng([DATA_SEED, step])
    toks = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def image_batch_np(step: int, batch: int = CNN_BATCH) -> dict:
    """A CIFAR-like batch made with numpy (the synthetic set's 10 class
    templates at 32x32, shifts of up to 3 pixels, flips, Gaussian noise
    0.6)."""
    from repro_torch.data.synthetic import _class_templates
    rng = np.random.default_rng([DATA_SEED + 1, step])
    labels = rng.integers(0, 10, batch).astype(np.int32)
    imgs = _class_templates(10, 32)[labels]
    shift = rng.integers(-3, 4, (batch, 2))
    imgs = np.stack([np.roll(im, tuple(s), axis=(0, 1))
                     for im, s in zip(imgs, shift)])
    flip = rng.random(batch) < 0.5
    imgs = np.where(flip[:, None, None, None], imgs[:, :, ::-1], imgs)
    imgs = imgs + np.float32(0.6) * rng.standard_normal(
        imgs.shape, dtype=np.float32)
    return {"images": imgs.astype(np.float32), "labels": labels}


@contextlib.contextmanager
def detached_attention():
    """The model's attention without a gradient (its output detached), as
    the port's model was before the backward kernel: the control that
    must fail against the reference."""
    from repro_torch.models import transformer

    real = transformer.flash_attention_gqa

    def detached(*args, **kwargs):
        with torch.no_grad():
            return real(*args, **kwargs)

    transformer.flash_attention_gqa = detached
    try:
        yield
    finally:
        transformer.flash_attention_gqa = real


def run_lm(cfg, pe_type: str, device, compute_dtype=None,
           batch: int = LM_BATCH, seq: int = LM_SEQ) -> list:
    """[[loss, grad_norm], ...] of ``LM_STEPS`` port train steps
    (``make_train_step``) of ``cfg`` under ``pe_type`` on ``lm_batch``'s
    batch x seq tokens; with ``compute_dtype`` (a torch type) inside
    ``layers.compute_dtype`` (the reference's ``mixed_precision``
    variant)."""
    from repro_torch import convert
    from repro_torch.models import family_module
    from repro_torch.models.layers import compute_dtype as cast_to
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import TrainState, make_train_step

    cfg = cfg.replace(pe_type=pe_type)
    mod = family_module(cfg)
    opt = adamw(warmup_cosine(*LM_SCHEDULE))
    params = convert.params_from_numpy(mod.numpy_params(cfg, PARAM_SEED),
                                       device)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=device))
    step = make_train_step(cfg, mod, opt, n_micro=1, clip_norm=LM_CLIP)
    rows = []
    for i in range(LM_STEPS):
        batch_i = convert.params_from_numpy(
            lm_batch(cfg.vocab, i, batch, seq), device)
        with cast_to(compute_dtype):
            state, m = step(state, batch_i)
        rows.append([m["loss"].item(), m["grad_norm"].item()])
    return rows


def run_cnn(pe_type: str, device) -> list:
    """[[loss, grad_norm], ...] of ``CNN_STEPS`` port CNN steps (the
    loss's gradients and the SGD-Nesterov update) under ``pe_type``."""
    from repro_torch import convert
    from repro_torch.models import cnn
    from repro_torch.optim import (global_norm, paper_step_decay,
                                   sgd_nesterov, tree_leaves, tree_unflatten)

    params = convert.params_from_numpy(
        cnn.numpy_resnet(CNN_DEPTH, 10, PARAM_SEED), device)
    opt = sgd_nesterov(paper_step_decay(*CNN_SCHEDULE),
                       weight_decay=CNN_WEIGHT_DECAY)
    ostate = opt.init(params)
    rows = []
    for i in range(CNN_STEPS):
        b = convert.params_from_numpy(image_batch_np(i), device)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = cnn.cnn_loss(cnn.resnet_apply, params, b, pe_type)
        grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
        gnorm = global_norm(grads)
        params, ostate = opt.update(grads, ostate, params)
        rows.append([loss.item(), gnorm.item()])
    return rows


def attention_grad_errors(got, want, dout) -> dict:
    """The backward kernel's (dq, dk, dv) against the plain version's on
    the same inputs: float32 within 2e-5 of the largest gradient (float32
    sums of up to a few thousand terms in another order); bfloat16 within
    one bfloat16 ulp of each element plus 2^-9 of the largest (the float32
    sums round to bfloat16 from either side of a tie, and a probability
    or a dP at a bfloat16 tie moves a row), and dv by one ulp of P times
    dout more.  Returns {ok, max_abs_err}."""
    ok, worst = True, 0.0
    bf16 = got[0].dtype == torch.bfloat16
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.to(torch.float32), w.to(torch.float32)
        err = (g - w).abs()
        top = w.abs().max().item()
        if not bf16:
            bound = torch.full_like(w, 2e-5 * top)
        else:
            bound = w.abs() * 2.0 ** -7 + 2.0 ** -9 * top
            if name == "dv":
                bound = bound + 2.0 ** -8 * dout.abs().max().item()
        ok = ok and bool((err <= bound).all())
        worst = max(worst, err.max().item())
    return dict(ok=ok, max_abs_err=worst)


def compare(got, ref, rtol: float) -> dict:
    """The largest relative differences of loss and grad norm over the
    steps, and whether both are within ``rtol``."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        return dict(ok=False, loss_rel=float("inf"), gnorm_rel=float("inf"))
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30)
    loss_rel, gnorm_rel = float(rel[:, 0].max()), float(rel[:, 1].max())
    return dict(ok=bool(max(loss_rel, gnorm_rel) <= rtol),
                loss_rel=loss_rel, gnorm_rel=gnorm_rel)

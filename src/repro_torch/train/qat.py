"""The QAT training drivers of ``examples/torch_train_qat.py`` (the port
of ``examples/train_qat.py``), as functions:

  run_lm  -- SmolLM-135M (full width, or the reduced config) trained
             under a PE type's QAT numerics on the synthetic token
             stream, with AdamW, warmup-cosine and checkpoint/restart;
  run_cnn -- the paper's Figs. 5-6 experiment: a CIFAR ResNet trained on
             the CIFAR-like set under FP32, INT16, LightPE-1 and
             LightPE-2 (SGD-Nesterov, Sec. IV-B), each with its top-1 on
             a held-out set beside the normalized hardware efficiency of
             that PE type's best design for ResNet-20/CIFAR-10, written
             as the table ``AccuracySurrogate.load_qat_results`` reads.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.configs import get, reduced
from repro_torch.core import (PAPER_WORKLOADS, enumerate_space,
                              evaluate_space, normalized_report)
from repro_torch.data import cifar_pipeline, lm_pipeline
from repro_torch.data.synthetic import eval_image_set
from repro_torch.device import resolve_device, stage
from repro_torch.models import cnn, family_module
from repro_torch.optim import (adamw, paper_step_decay, sgd_nesterov,
                               tree_leaves, tree_unflatten, warmup_cosine)
from repro_torch.train.trainer import fit, init_state, make_train_step

CNN_PE_TYPES = ("fp32", "int16", "lightpe1", "lightpe2")


def run_lm(size: str = "full", pe_type: str | None = None, steps: int = 200,
           batch: int = 16, seq: int = 256, n_micro: int = 1,
           lr: float = 3e-4, ckpt_dir: str | None = None, seed: int = 0,
           device=None):
    """Train SmolLM-135M (``size`` "full" or "reduced") for ``steps``
    steps; returns the final TrainState."""
    device = resolve_device(device)
    cfg = (get if size == "full" else reduced)("smollm-135m")
    if pe_type:
        cfg = cfg.replace(pe_type=pe_type)
    mod = family_module(cfg)
    opt = adamw(warmup_cosine(lr, 20, steps))
    state = init_state(cfg, mod, opt,
                       torch.Generator(device=device).manual_seed(seed),
                       device=device)
    n_params = sum(x.numel() for x in tree_leaves(state.params))
    print(f"training {cfg.name} ({n_params / 1e6:.1f}M params) "
          f"pe_type={cfg.pe_type} for {steps} steps on {device}")
    step = make_train_step(cfg, mod, opt, n_micro=n_micro)
    pipe = lm_pipeline(cfg, global_batch=batch, seq=seq, seed=seed,
                       device=device)
    return fit(state, step, pipe, steps=steps, ckpt_dir=ckpt_dir,
               ckpt_every=100, log_every=20)


def make_cnn_step(opt, pe_type: str):
    """step(params, opt_state, batch) -> (params, opt_state, loss): the
    loss's gradients, then the optimizer's in-place update (no clipping,
    as the reference's CNN step)."""
    def step(params, ostate, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        loss, _acc = cnn.cnn_loss(cnn.resnet_apply, params, batch, pe_type)
        grads = torch.autograd.grad(loss, leaves)
        params, ostate = opt.update(tree_unflatten(params, grads), ostate,
                                    params)
        return params, ostate, loss.detach()

    return step


def top1(params, images, labels, pe_type: str) -> float:
    """ResNet top-1 accuracy on a held-out set."""
    with torch.no_grad():
        logits = cnn.resnet_apply(params, images, pe_type)
    return float(torch.mean((torch.argmax(logits, -1)
                             == labels.to(torch.int64)).to(torch.float32)))


def run_cnn(steps: int = 300, depth: int = 8, trials: int = 2,
            out: str | None = "results/torch_qat_pareto.json",
            device=None) -> dict:
    """The Figs. 5-6 table: {pe_type: {top1_mean, top1_std,
    norm_perf_per_area, norm_energy, trials}}, written to ``out`` (when
    given) in the schema both packages' ``load_qat_results`` read."""
    device = resolve_device(device)
    space = enumerate_space(max_points=2000, seed=0, device=device)
    res = evaluate_space(space, PAPER_WORKLOADS["resnet20-cifar10"](
        device=device))
    rep = normalized_report(res, space)
    ev = eval_image_set(0, 512, 10)
    images, _ = stage(ev["images"], device)
    labels, _ = stage(ev["labels"], device)

    table = {}
    for pe in CNN_PE_TYPES:
        accs = []
        for trial in range(trials):
            gen = torch.Generator(device=device).manual_seed(trial)
            params = cnn.resnet_init(gen, depth=depth, n_classes=10,
                                     device=device)
            opt = sgd_nesterov(paper_step_decay(0.05, steps // 3),
                               weight_decay=5e-4)
            ostate = opt.init(params)
            step = make_cnn_step(opt, pe)
            pipe = cifar_pipeline(64, 10, seed=trial, device=device)
            for _ in range(steps):
                params, ostate, _loss = step(params, ostate, next(pipe))
            accs.append(top1(params, images, labels, pe))
        table[pe] = dict(
            top1_mean=float(np.mean(accs)), top1_std=float(np.std(accs)),
            norm_perf_per_area=rep[pe]["norm_perf_per_area"],
            norm_energy=rep[pe]["norm_energy"], trials=trials)
        print(f"{pe:9s} top1={table[pe]['top1_mean']:.3f}"
              f"±{table[pe]['top1_std']:.3f} "
              f"ppa={table[pe]['norm_perf_per_area']:.2f}x "
              f"energy={table[pe]['norm_energy']:.3f}x")
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(table, f, indent=1)
        print(f"wrote {out}")
    return table

"""Per-layer recomputation in training (``models.layers.remat``), where the
reference rematerializes with ``jax.checkpoint``: the transformer's
stacked layers (and the grouped backbone's periods and local layers),
Whisper's encoder and decoder layers, the hybrid's groups and RWKV's
layers.

Per family, the loss and every gradient are bitwise equal with the
helper and with the helper patched to the identity; training FLOPs then
equal the reference's gradient FLOPs (SmolLM-135M reduced at 2 x 64:
60,555,264, ``tests/data/torch_dryrun_ref.json``); the recomputation runs
under the forward's mixed-precision and mesh contexts even on another
thread, as autograd may run it on the card.
"""

import json
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced
from repro_torch.launch import op_analysis as OA
from repro_torch.models import family_module
from repro_torch.models import layers as L
from repro_torch.optim import tree_leaves

from _torch_dryrun_ref import REF_PATH

CASES = [("smollm-135m", {}), ("deepseek-moe-16b", {}),
         ("qwen2-vl-72b", {}), ("rwkv6-1.6b", {}), ("zamba2-7b", {}),
         ("whisper-medium", {}),
         ("gemma3-1b", {"attn_block_local": True})]


def _batch(cfg, b=2, s=64):
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)))
    if cfg.family == "encdec":
        frames = torch.as_tensor(rng.standard_normal((b, s, cfg.d_model),
                                                     dtype=np.float32))
        return {"frames": frames, "tokens": toks[:, :16],
                "labels": toks[:, 1:17]}
    return {"tokens": toks, "labels": torch.roll(toks, -1, 1)}


def _grads(cfg, params, batch):
    mod = family_module(cfg)
    leaves = tree_leaves(params)
    loss = mod.loss_fn(params, batch, cfg)
    return loss, torch.autograd.grad(loss, leaves, allow_unused=True)


def _same(a, b):
    (la, ga), (lb, gb) = a, b
    assert torch.equal(la, lb)
    for x, y in zip(ga, gb):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x, y)


@pytest.mark.parametrize("arch,knobs", CASES, ids=[c[0] for c in CASES])
def test_recomputation_leaves_loss_and_gradients_bitwise(arch, knobs,
                                                         monkeypatch):
    cfg = reduced(arch).replace(**knobs)
    params = family_module(cfg).init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    batch = _batch(cfg)
    calls = []
    inner = torch.utils.checkpoint.checkpoint

    def counted(*a, **k):
        calls.append(1)
        return inner(*a, **k)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counted)
    with_remat = _grads(cfg, params, batch)
    assert calls, "no layer was rematerialized"
    monkeypatch.setattr(L, "remat", lambda fn, *args: fn(*args))
    _same(with_remat, _grads(cfg, params, batch))


def test_no_recomputation_without_a_gradient(monkeypatch):
    cfg = reduced("smollm-135m")
    mod = family_module(cfg)
    params = mod.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **k: pytest.fail("checkpointed"))
    mod.loss_fn(params, _batch(cfg), cfg)          # no param needs a grad
    for p in tree_leaves(params):
        p.requires_grad_(True)
    with torch.no_grad():
        mod.loss_fn(params, _batch(cfg), cfg)


def test_training_flops_equal_the_references_gradient():
    """SmolLM-135M reduced, batch 2 x 64: the forward, the recomputed
    layers and the backward count the reference's jax.grad FLOPs (the
    port without recomputation counts 3 x the forward, 49,545,216)."""
    ref = json.loads(REF_PATH.read_text())["reduced"]["smollm-135m"]
    cfg = reduced("smollm-135m")
    params = family_module(cfg).init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    _, rep = OA.analyze(_grads, cfg, params, _batch(cfg))
    assert rep["flops"] == ref["train_r"]["flops"] == 60_555_264


def test_recomputation_on_another_thread_keeps_the_contexts():
    """The backward on a thread of its own (as autograd runs it for the
    card) recomputes under the forward's compute type and mesh context:
    the gradients are those of the backward on the forward's thread."""
    cfg = reduced("smollm-135m")
    params = family_module(cfg).init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    batch = _batch(cfg)

    def loss():
        with L.compute_dtype(torch.bfloat16), \
                L.activation_sharding(("data",), 1):
            return family_module(cfg).loss_fn(params, batch, cfg)

    here = torch.autograd.grad(loss(), leaves, allow_unused=True)
    out = {}
    lost = loss()
    t = threading.Thread(target=lambda: out.update(g=torch.autograd.grad(
        lost, leaves, allow_unused=True)))
    t.start()
    t.join()
    _same((lost, out["g"]), (lost, here))

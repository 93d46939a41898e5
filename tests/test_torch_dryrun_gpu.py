"""The dry run's counts on the card: what ``op_analysis`` counts of a step
on CUDA tensors equals what it counts of the same step on ``meta``, and
the recomputation of each layer leaves the card's gradients bitwise
unchanged.

Needs a CUDA card: every test is marked ``gpu`` and skips without one.
No JAX here: ``tests/test_torch_dryrun.py`` holds the counts to the JAX
package's.

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_dryrun_gpu.py
"""

import gc

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import reduced
from repro_torch.kernels.fake_quant import fake_quant_group
from repro_torch.kernels.flash_attention import (attention_backward,
                                                 flash_attention_gqa)
from repro_torch.kernels.quant_matmul import quant_matmul
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.launch import op_analysis as OA
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models import family_module
from repro_torch.models import layers as L
from repro_torch.optim import tree_leaves

pytestmark = pytest.mark.gpu
KEYS = ("flops", "bytes_out", "collectives", "launches")
BAND = 0.10          # temporary bytes against max_memory_allocated's growth


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def nccl(card, tmp_path):
    if dist.is_initialized():
        dist.destroy_process_group()
    M.init_process_group(card, 0, 1, store=dist.FileStore(
        str(tmp_path / "store"), 1), timeout_s=120)
    yield M.make_mesh((1, 1), ("data", "model"), card)
    if dist.is_initialized():
        dist.destroy_process_group()


def _declared(fn, *tensors):
    """(the card's report, the meta report) of fn on the tensors and on
    their meta stand-ins."""
    _, card = OA.analyze(fn, *tensors)
    _, meta = OA.analyze(fn, *[t.to("meta") for t in tensors])
    return card, meta


def test_kernels_declare_alike_on_the_card_and_on_meta(card):
    g = torch.Generator(device=card).manual_seed(0)
    ws = [torch.randn(300, 190, device=card, generator=g),
          torch.randn(7, 64, device=card, generator=g)]
    ss = [torch.rand(190, device=card) + 0.1, torch.rand(64, device=card)]
    a, b = _declared(lambda *t: fake_quant_group(t[:2], t[2:]), *ws, *ss)
    assert {k: a[k] for k in KEYS} == {k: b[k] for k in KEYS}
    x = torch.randn(17, 128, device=card, generator=g)
    w = torch.randint(0, 255, (64, 48), dtype=torch.uint8, device=card)
    s = torch.rand(48, device=card)
    a, b = _declared(lambda *t: quant_matmul(*t, mode="int4"), x, w, s)
    assert {k: a[k] for k in KEYS} == {k: b[k] for k in KEYS}
    q = torch.randn(2, 40, 6, 64, device=card, generator=g)
    kv = torch.randn(2, 40, 2, 64, device=card, generator=g)
    st = torch.zeros(2, dtype=torch.int32, device=card)
    a, b = _declared(lambda *t: flash_attention_gqa(*t, round_p=True),
                     q, kv, kv, st)
    assert {k: a[k] for k in KEYS} == {k: b[k] for k in KEYS}
    a, b = _declared(lambda *t: attention_backward(*t, round_p=True),
                     q, kv, kv, st, q)
    assert {k: a[k] for k in KEYS} == {k: b[k] for k in KEYS}


def _cell(device, mesh, cfg):
    return D.train_cell(cfg, ShapeSpec("t", 64, 4, "train"), mesh, device)


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-moe-16b"])
def test_a_train_step_counts_alike_on_the_card_and_on_meta(card, nccl, arch):
    """Reduced, head_dim 64 (the backward kernel's), on a (1, 1) mesh."""
    cfg = reduced(arch).replace(head_dim=64, pe_type="lightpe1")
    step, args = _cell(card, nccl, cfg)
    # a first step allocates what a process allocates once (cuBLAS's
    # workspace); then the cache is emptied, as chip_smoke's 15.1 does
    step(*args)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    _, on_card = OA.analyze(step, *args)
    torch.cuda.synchronize()
    growth = torch.cuda.max_memory_allocated() - before
    step, args = _cell(torch.device("meta"), D.start_mesh((1, 1)), cfg)
    _, on_meta = OA.analyze(step, *args)
    assert {k: on_card[k] for k in KEYS} == {k: on_meta[k] for k in KEYS}
    temp = on_card["memory"]["temp_size_in_bytes"]
    assert temp == on_meta["memory"]["temp_size_in_bytes"]
    assert abs(temp - growth) <= BAND * growth


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-moe-16b"])
def test_recomputation_is_bitwise_on_the_card(card, arch, monkeypatch):
    cfg = reduced(arch).replace(head_dim=64, pe_type="lightpe1")
    mod = family_module(cfg)
    params = mod.init_params(cfg, torch.Generator(device=card).manual_seed(0),
                             device=card)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    toks = torch.randint(0, cfg.vocab, (2, 64), device=card)
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}

    def grads():
        loss = mod.loss_fn(params, batch, cfg)
        return [loss] + list(torch.autograd.grad(loss, leaves,
                                                 allow_unused=True))

    with_remat = grads()
    monkeypatch.setattr(L, "remat", lambda fn, *a: fn(*a))
    without = grads()
    for a, b in zip(with_remat, without):
        assert (a is None and b is None) or torch.equal(a, b)

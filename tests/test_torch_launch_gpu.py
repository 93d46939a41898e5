"""The launch layer on the card: an NCCL process group of one rank (a
``FileStore`` in a temporary directory), the (1, 1) mesh step bitwise
equal to the plain step, the int8 error-feedback all-reduce's contract,
the EP MoE layer on one rank against ``moe_apply``, and the train CLI at
its default device.

Needs a CUDA card: every test is marked ``gpu`` and skips without one.
No JAX here: the CPU tests hold the port to the JAX package.

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_launch_gpu.py
"""

import datetime

import pytest
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.configs import reduced
from repro_torch.data import lm_pipeline
from repro_torch.launch import mesh as M
from repro_torch.models import family_module, transformer
from repro_torch.models import layers as L
from repro_torch.optim import adamw, tree_leaves, warmup_cosine
from repro_torch.optim.grad_compress import (compressed_psum_mean, quantize,
                                             shared_scale)
from repro_torch.train import (init_state, jit_train_step, make_train_step,
                               shard_state, state_shardings_for)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL and the kernels have no CPU mode")
    store = dist.FileStore(str(tmp_path_factory.mktemp("nccl") / "store"), 1)
    M.init_process_group("cuda", 0, 1, store=store, timeout_s=120)
    try:
        yield M.make_mesh((1, 1), ("data", "model"), "cuda")
    finally:
        dist.destroy_process_group()


def test_the_group_is_nccl(mesh):
    assert dist.get_backend() == "nccl"
    assert M.axis_sizes(mesh) == {"data": 1, "model": 1}


def test_compressed_allreduce_contract_over_nccl(mesh):
    g = torch.randn(4096, generator=torch.Generator(device="cuda")
                    .manual_seed(0), device="cuda")
    err = torch.zeros_like(g)
    mean, new_err = compressed_psum_mean(g, err, mesh, ("data",), 1)
    scale = shared_scale(g.abs().max())
    assert torch.equal(mean, quantize(g, scale).float() * scale)
    assert float((mean - g).abs().max()) <= float(scale) / 2
    assert torch.equal(new_err, g - mean)


def test_mesh_step_equals_the_plain_step_bitwise(mesh):
    # head_dim 64: the attention backward's kernel has no 16
    cfg = reduced("smollm-135m").replace(pe_type="lightpe1", head_dim=64)
    mod = family_module(cfg)

    def run(on_mesh):
        opt = adamw(warmup_cosine(3e-4, 20, 3))
        state = init_state(cfg, mod, opt, torch.Generator(device="cuda")
                           .manual_seed(0), device="cuda")
        step = make_train_step(cfg, mod, opt)
        pipe = lm_pipeline(cfg, 4, 64, device="cuda",
                           mesh=mesh if on_mesh else None)
        if on_mesh:
            sh = state_shardings_for(cfg, mod, mesh, opt)
            state, step = shard_state(state, sh), jit_train_step(step, sh,
                                                                 mesh)
        for _ in range(2):
            state, _m = step(state, next(pipe))
        return tree_leaves(state.params) + tree_leaves(state.opt_state)

    for a, b in zip(run(False), run(True)):
        assert torch.equal(a, b)


def test_ep_on_one_rank_matches_moe_apply(mesh):
    cfg = reduced("deepseek-moe-16b").replace(dtype="float32")
    params = convert.params_from_numpy(transformer.numpy_params(cfg, 0),
                                       "cuda")
    tokens = torch.randint(0, cfg.vocab, (2, 16), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    with torch.no_grad():
        base = transformer.forward(params, tokens, cfg)
        for int8 in (False, True):
            c = cfg.replace(moe_ep_shard_map=True, moe_ep_int8_payload=int8)
            with L.activation_sharding(("data",), 1, mesh=mesh):
                got = transformer.forward(params, tokens, c)
            err = float((got - base).abs().max())
            assert err <= (1e-5 if not int8 else 0.125), (int8, err)
            if int8:
                assert err > 0       # the payload was quantized


def test_train_cli_defaults_to_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.launch import train as cli
    # full width: the reduced head_dim of 16 has no attention backward
    state = cli.main(["--arch", "smollm-135m", "--steps", "2", "--batch",
                      "2", "--seq", "64"])
    assert state.step.device.type == "cuda" and int(state.step) == 2
    assert all(p.device.type == "cuda" for p in tree_leaves(state.params))

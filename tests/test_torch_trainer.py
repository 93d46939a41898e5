"""The port's trainer (``repro_torch.train``) against the JAX package's,
and its fault tolerance: train steps on reduced SmolLM-135M under FP32
and LightPE-1 with one and two microbatches, the mirrors of
``tests/test_system.py::TestTraining``, an exact resume (bitwise on the
CPU), and training checkpoints that cross between the packages.

Tolerances against the reference (same numpy params and tokens), per
compute type.  float32: the loss at 1e-5 and the gradient norm at 1e-4
relative, each parameter within 0.1 lr of the reference's (measured:
1e-7, 1.5e-5 and 0.032 lr; LightPE-1's 8-bit activation codes flip at a
boundary now and then).  bfloat16, the config's: the in-process
reference keeps XLA's excess precision (bf16 intermediates in float32)
where the port rounds, and a bf16 rounding or an 8-bit code that flips
moves gradients by up to a few percent of the largest: the loss at 5e-4
and the gradient norm at 5e-3 relative (measured 1.2e-4 and 2.9e-3);
AdamW moves a parameter by about lr a step (m/sqrt(v) is +-1 on the
first), so a gradient near 0 can move it the other way: each parameter
within 2 lr a step of the reference's, and the median within 2e-2 lr
(measured 0.007)."""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jax_ckpt
from repro.configs import reduced as jax_reduced
from repro.models import family_module as jax_family
from repro.optim import adamw as jax_adamw
from repro.optim import sgd_nesterov as jax_sgd
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro.optim import constant as jax_constant
from repro.train import TrainState as JaxTrainState
from repro.train import make_train_step as jax_make_train_step
from repro_torch import convert, train_check
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import reduced
from repro_torch.data import lm_pipeline
from repro_torch.models import cnn, family_module, transformer
from repro_torch.optim import (adamw, constant, sgd_nesterov, tree_leaves,
                               warmup_cosine)
from repro_torch.train import (TrainState, Watchdog, fit, init_state,
                               make_train_step, resume)

SCHEDULE = (3e-4, 20, 200)
BATCH, SEQ = 4, 32


def _noop(_msg):
    pass


def _jax_state(arrays, opt):
    params = jax.tree.map(jnp.asarray, arrays)
    return JaxTrainState(params, opt.init(params), jnp.zeros((), jnp.int32))


def _port_state(arrays, opt):
    params = convert.params_from_numpy(arrays, "cpu")
    return TrainState(params, opt.init(params),
                      torch.zeros((), dtype=torch.int32))


TOL = {"float32": dict(loss=1e-5, gnorm=1e-4),
       "bfloat16": dict(loss=5e-4, gnorm=5e-3)}


@pytest.mark.parametrize("pe,n_micro,dtype", [
    ("fp32", 1, "bfloat16"), ("fp32", 2, "bfloat16"),
    ("lightpe1", 1, "bfloat16"), ("lightpe1", 2, "bfloat16"),
    ("fp32", 2, "float32"), ("lightpe1", 1, "float32")])
def test_train_steps_match_the_reference(pe, n_micro, dtype):
    cfg = reduced("smollm-135m").replace(pe_type=pe, dtype=dtype)
    jcfg = jax_reduced("smollm-135m").replace(pe_type=pe, dtype=dtype)
    arrays = transformer.numpy_params(cfg, 0)
    jopt = jax_adamw(jax_warmup_cosine(*SCHEDULE))
    opt = adamw(warmup_cosine(*SCHEDULE))
    jstate, state = _jax_state(arrays, jopt), _port_state(arrays, opt)
    jstep = jax.jit(jax_make_train_step(jcfg, jax_family(jcfg), jopt,
                                        n_micro=n_micro))
    step = make_train_step(cfg, family_module(cfg), opt, n_micro=n_micro)
    lr_sum = 0.0
    for i in range(2):
        batch = train_check.lm_batch(cfg.vocab, i, BATCH, SEQ)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, convert.params_from_numpy(batch, "cpu"))
        assert int(m["step"]) == int(jm["step"]) == i + 1
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=TOL[dtype]["loss"])
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]),
                                   rtol=TOL[dtype]["gnorm"])
        lr_sum += float(warmup_cosine(*SCHEDULE)(i + 1))
        got = np.concatenate([p.detach().numpy().ravel()
                              for p in tree_leaves(state.params)])
        want = np.concatenate([np.asarray(p).ravel()
                               for p in jax.tree.leaves(jstate.params)])
        err = np.abs(got - want) / lr_sum
        if dtype == "float32":
            assert err.max() <= 0.1
        else:
            assert err.max() <= 2.02 and np.median(err) <= 2e-2
    assert state.opt_state["step"].dtype == torch.int32
    assert int(state.step) == 2


def test_loss_decreases():
    """The mirror of TestTraining.test_loss_decreases."""
    cfg = reduced("smollm-135m")
    mod = family_module(cfg)
    opt = adamw(warmup_cosine(2e-3, 10, 300))
    state = init_state(cfg, mod, opt, torch.Generator().manual_seed(0),
                       device="cpu")
    step = make_train_step(cfg, mod, opt, n_micro=2)
    pipe = lm_pipeline(cfg, global_batch=8, seq=64, device="cpu")
    losses = []
    for _ in range(60):
        state, m = step(state, next(pipe))
        losses.append(m["loss"].item())
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.3


def test_microbatching_equivalent():
    """The mirror of TestTraining.test_microbatching_equivalent: n_micro=1
    and n_micro=4 give the same update (mean gradients)."""
    cfg = reduced("smollm-135m")
    mod = family_module(cfg)
    opt = adamw(warmup_cosine(1e-3, 1, 100))
    s1 = init_state(cfg, mod, opt, torch.Generator().manual_seed(0),
                    device="cpu")
    s4 = init_state(cfg, mod, opt, torch.Generator().manual_seed(0),
                    device="cpu")
    batch = next(lm_pipeline(cfg, global_batch=8, seq=32, device="cpu"))
    s1, m1 = make_train_step(cfg, mod, opt, n_micro=1)(s1, batch)
    s4, m4 = make_train_step(cfg, mod, opt, n_micro=4)(s4, batch)
    d = max((a - b).abs().max().item() for a, b in
            zip(tree_leaves(s1.params), tree_leaves(s4.params)))
    assert d < 5e-5
    assert m1["loss"].item() == pytest.approx(m4["loss"].item(), rel=1e-3)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, mod, opt, n_micro=3)(s1, batch)


def _equal_states(a, b):
    for x, y in zip(tree_leaves(a.params) + tree_leaves(a.opt_state),
                    tree_leaves(b.params) + tree_leaves(b.opt_state)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert int(a.step) == int(b.step)


def test_checkpoint_restart_exact(tmp_path):
    """10 steps straight equal 5 steps, a checkpoint, a restore and 5
    more, bit for bit (the reference's own version of this test misses
    atol 1e-6)."""
    cfg = reduced("smollm-135m")
    mod = family_module(cfg)
    opt = adamw(warmup_cosine(1e-3, 5, 100))
    step = make_train_step(cfg, mod, opt, n_micro=1)

    def fresh():
        return init_state(cfg, mod, opt, torch.Generator().manual_seed(0),
                          device="cpu")

    state_a = fit(fresh(), step, lm_pipeline(cfg, 4, 32, device="cpu"), 10,
                  log_fn=_noop)
    state_b = fit(fresh(), step, lm_pipeline(cfg, 4, 32, device="cpu"), 5,
                  ckpt_dir=str(tmp_path), ckpt_every=5, log_fn=_noop)
    del state_b  # crash
    pipe_b2 = lm_pipeline(cfg, 4, 32, device="cpu")
    state_b2 = resume(cfg, mod, opt, str(tmp_path), pipe_b2, device="cpu")
    assert int(state_b2.step) == 5 and pipe_b2.state.step == 5
    state_b2 = fit(state_b2, step, pipe_b2, 10, log_fn=_noop)
    _equal_states(state_a, state_b2)
    assert resume(cfg, mod, opt, str(tmp_path / "none"), device="cpu") is None


def _cnn_state(seed=1):
    """A ResNet-8 (lists of blocks) with an SGD state, after one step."""
    arrays = cnn.numpy_resnet(8, 10, seed)
    opt = sgd_nesterov(constant(0.1))
    params = convert.params_from_numpy(arrays, "cpu")
    ostate = opt.init(params)
    grads = convert.params_from_numpy(cnn.numpy_resnet(8, 10, seed + 1),
                                      "cpu")
    params, ostate = opt.update(grads, ostate, params)
    return params, ostate


@pytest.mark.parametrize("model", ["lm_adamw", "cnn_sgd"])
def test_checkpoints_cross_between_packages(tmp_path, model):
    if model == "lm_adamw":
        cfg = reduced("smollm-135m")
        opt = adamw(constant(1e-3))
        state = _port_state(transformer.numpy_params(cfg, 0), opt)
        state, _ = make_train_step(cfg, family_module(cfg), opt)(
            state, convert.params_from_numpy(
                train_check.lm_batch(cfg.vocab, 0, 2, 8), "cpu"))
        params, ostate = state.params, state.opt_state
        jopt = jax_adamw(jax_constant(1e-3))
    else:
        params, ostate = _cnn_state()
        jopt = jax_sgd(jax_constant(0.1))
    extra = {"pipeline": {"step": 7, "seed": 0}, "step": 7}
    # port -> JAX
    ckpt.save(str(tmp_path / "a"), 7, params, ostate, extra=extra)
    jparams = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.float32),
                           jax.tree.map(lambda t: t.detach().numpy(), params,
                                        is_leaf=torch.is_tensor))
    jp, jo, jextra = jax_ckpt.restore(str(tmp_path / "a"), 7, jparams,
                                      jopt.init(jparams))
    assert jextra == extra
    for a, b in zip(tree_leaves(params), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    for a, b in zip(tree_leaves(ostate), jax.tree.leaves(jo)):
        assert np.asarray(b).dtype == a.numpy().dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # JAX -> port
    jax_ckpt.save(str(tmp_path / "b"), 9, jp, jo, extra=extra)
    tp, to, textra = ckpt.restore(str(tmp_path / "b"), 9, params, ostate,
                                  device="cpu")
    assert textra == extra and ckpt.latest_step(str(tmp_path / "b")) == 9
    for a, b in zip(tree_leaves(tp) + tree_leaves(to),
                    tree_leaves(params) + tree_leaves(ostate)):
        assert a.dtype == b.dtype and torch.equal(a, b.detach())
    assert isinstance(tp["blocks"] if "blocks" in tp else [], list)
    # the layout: <dir>/step_<n>/{manifest.json, params/, opt/}
    names = sorted(os.listdir(tmp_path / "a" / "step_7"))
    assert names == ["manifest.json", "opt", "params"]
    assert "step.npy" in os.listdir(tmp_path / "a" / "step_7" / "opt")


def test_keep_k_garbage_collection(tmp_path):
    params = {"w": torch.ones(3)}
    for s in range(1, 6):
        ckpt.save(str(tmp_path), s, params, keep=2)
    assert ckpt.all_steps(str(tmp_path)) == [4, 5]
    assert not [n for n in os.listdir(tmp_path) if n.startswith("tmp.")]
    ckpt.save(str(tmp_path), 5, {"w": torch.zeros(3)}, keep=2)
    p, o, e = ckpt.restore(str(tmp_path), 5, params, device="cpu")
    assert torch.equal(p["w"], torch.zeros(3)) and o is None and e == {}


def test_fit_logs_the_previous_step_and_checkpoints_on_sigterm(tmp_path):
    cfg = reduced("smollm-135m")
    mod = family_module(cfg)
    opt = adamw(warmup_cosine(1e-3, 5, 100))
    inner = make_train_step(cfg, mod, opt)
    calls = []

    def step(state, batch):
        calls.append(int(state.step))
        if len(calls) == 3:       # a preemption notice during step 3
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        return inner(state, batch)

    before = signal.getsignal(signal.SIGTERM)
    log = []
    state = fit(init_state(cfg, mod, opt, torch.Generator().manual_seed(0),
                           device="cpu"), step,
                lm_pipeline(cfg, 4, 16, device="cpu"), 10,
                ckpt_dir=str(tmp_path), ckpt_every=100, log_every=2,
                log_fn=log.append)
    assert calls == [0, 1, 2] and int(state.step) == 3
    assert ckpt.all_steps(str(tmp_path)) == [3]
    assert log[0].startswith("step      2 ")     # step 2's metrics at i = 2
    assert log[1] == "[preempt] checkpointed at step 3, exiting"
    assert log[2].startswith("final step 3 loss ")
    assert signal.getsignal(signal.SIGTERM) == before
    _, _, extra = ckpt.restore(str(tmp_path), 3, state.params, device="cpu")
    assert extra == {"pipeline": {"step": 3, "seed": 0}, "step": 3}


def test_watchdog_flags_slow_steps():
    w = Watchdog(factor=3.0)
    assert not any(w.observe(1.0) for _ in range(6))
    assert w.observe(3.5) and not w.observe(2.9)
    assert w.flagged == 1


def test_train_state_from_numpy_keeps_the_reference_layout():
    jopt = jax_adamw(jax_warmup_cosine(*SCHEDULE))
    arrays = cnn.numpy_resnet(8, 10, 0)
    js = _jax_state(arrays, jopt)
    state = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, js.params),
        jax.tree.map(np.asarray, js.opt_state), int(js.step), "cpu")
    assert isinstance(state.params["blocks"], list)
    assert sorted(state.opt_state) == ["mu", "nu", "step"]
    assert state.opt_state["step"].dtype == torch.int32
    assert state.step.dtype == torch.int32 and int(state.step) == 0

"""Training the families whose attention gradient needs the backward
kernel's windows, soft-caps and head_dims 16 / 32 / 112 / 256 (Gemma-3,
Gemma-2, Zamba2), on the CPU through the kernels' plain versions, held
to the JAX package.

- The loss and its gradient with respect to every parameter (Gemma-2 at
  head_dim 256 with its window and soft-caps, Zamba2 at 112), in float32
  under the FP32 preset, against ``jax.value_and_grad`` of the
  reference's ``loss_fn`` on the same weights and batch (as
  ``test_torch_ssm.py`` holds RWKV6 / Zamba2 at head_dim 16): the loss
  within 1e-5 relative, each gradient within 1e-4 of its largest
  element (float32 sums in another order; measured up to 2.2e-5, on
  Gemma-2's soft-capped final logits).
- ``LM_STEPS`` AdamW steps of ``train_check.run_lm`` against
  ``tests/data/torch_train_families_ref.json`` (the JAX package's steps,
  written by ``tests/_torch_train_families_ref.py``; no JAX runs for
  them here), loss and gradient norm within 1e-5 relative (measured up
  to 2.1e-6).  ``chip_smoke.py`` phase 16.4 holds the card's steps to the
  same file.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_families_ref import (BATCH, CASES, PE_TYPES, REF_PATH,
                                       SEQ, config)
from repro_torch import convert, train_check
from repro_torch.configs import reduced
from repro_torch.models import family_module

STEP_RTOL = 1e-5


@pytest.fixture(scope="module")
def ref():
    return json.loads(REF_PATH.read_text())


@pytest.fixture(autouse=True)
def _one_thread():
    """The reduced models' products are tiny: one thread runs them 5-50
    times faster than a pool contending with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_reference_format_is_stable(ref):
    assert "--xla_allow_excess_precision=false" in ref["xla_flags"]
    assert ref["lm"] == dict(batch=BATCH, seq=SEQ,
                             steps=train_check.LM_STEPS,
                             schedule=list(train_check.LM_SCHEDULE),
                             clip=train_check.LM_CLIP,
                             param_seed=train_check.PARAM_SEED,
                             data_seed=train_check.DATA_SEED)
    assert sorted(ref["cases"]) == sorted(CASES)
    for name, case in ref["cases"].items():
        cfg = config(name, reduced)
        assert (case["config"], case["overrides"]) == CASES[name]
        assert (case["head_dim"], case["window"], case["softcap"]) == \
            (cfg.head_dim, cfg.window, cfg.attn_softcap)
        assert sorted(case["runs"]) == sorted(PE_TYPES)
        for rows in case["runs"].values():
            assert np.asarray(rows).shape == (train_check.LM_STEPS, 2)
            assert np.isfinite(rows).all()
    # the cases reach the backward's new instances and masks
    assert {c["head_dim"] for c in ref["cases"].values()} == {32, 112, 256}
    assert any(c["softcap"] > 0 and c["window"] > 0
               for c in ref["cases"].values())


@pytest.mark.parametrize("name", list(CASES))
def test_port_steps_match_the_reference(name, ref):
    cfg = config(name, reduced)
    for pe in PE_TYPES:
        rows = train_check.run_lm(cfg, pe, "cpu", batch=BATCH, seq=SEQ)
        got = train_check.compare(rows, ref["cases"][name]["runs"][pe],
                                  STEP_RTOL)
        assert got["ok"], (pe, got)


@pytest.mark.parametrize("name", ["gemma2-9b/hd256", "zamba2-7b/hd112"])
def test_loss_and_gradients_match_jax(name):
    from repro.configs import reduced as jax_reduced
    from repro.models import family_module as jax_family
    cfg, jcfg = config(name, reduced), config(name, jax_reduced)
    arrays = family_module(cfg).numpy_params(cfg, 0)
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, cfg.vocab, (2, 24)) for k in
             ("tokens", "labels")}
    jloss, jgrads = jax.value_and_grad(jax_family(jcfg).loss_fn)(
        jax.tree.map(jnp.asarray, arrays),
        jax.tree.map(jnp.asarray, batch), jcfg)
    params = convert.params_from_numpy(arrays, "cpu")
    for leaf in jax.tree.leaves(params):
        leaf.requires_grad_(True)
    loss = family_module(cfg).loss_fn(
        params, {k: torch.as_tensor(v) for k, v in batch.items()}, cfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.grad.numpy(), params))[0]
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(got) == len(want)
    for (path, g_), (_, w_) in zip(got, want):
        w_ = np.asarray(w_)
        scale = max(float(np.abs(w_).max()), 1e-30)
        np.testing.assert_allclose(g_, w_, rtol=0, atol=1e-4 * scale,
                                   err_msg=jax.tree_util.keystr(path))

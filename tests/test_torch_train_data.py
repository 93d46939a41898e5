"""The port's synthetic data, pipeline, schedules and optimizers
(``repro_torch.data``, ``repro_torch.optim``) against the JAX package's.

The data streams are the port's own (``jax.random`` is not reproduced):
the templates are held bitwise, the streams to their structure and to
determinism in (seed, step).  The schedules and optimizers get the same
numpy params and gradients as the reference and are held over several
steps at float32 rounding (rtol 2e-6: the formulas are the reference's,
term for term; XLA's and torch's ``pow`` / ``cos`` may differ in the
last bit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as jax_synthetic
from repro import optim as jax_optim
from repro_torch import convert
from repro_torch.configs import reduced
from repro_torch.data import DataPipeline, cifar_pipeline, lm_pipeline
from repro_torch.data import synthetic
from repro_torch.optim import (adamw, clip_by_global_norm, constant,
                               global_norm, paper_step_decay, sgd_nesterov,
                               tree_leaves, tree_map, tree_unflatten,
                               warmup_cosine)

RTOL = 2e-6


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_classes,hw", [(10, 32), (100, 32), (10, 16)])
def test_class_templates_equal_the_reference_bitwise(n_classes, hw):
    ours = synthetic._class_templates(n_classes, hw)
    ref = jax_synthetic._class_templates(n_classes, hw)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


def test_token_stream_has_its_bigram_structure():
    b = synthetic.token_batch(3, 7, 16, 128, 512)
    toks, labels = b["tokens"], b["labels"]
    assert toks.shape == labels.shape == (16, 128)
    assert toks.dtype == labels.dtype == torch.int32
    assert int(toks.min()) >= 0 and int(toks.max()) < 512
    # labels are the next tokens of one stream
    assert torch.equal(toks[:, 1:], labels[:, :-1])
    # with probability 0.7 the next token is perm[current]
    perm = synthetic._bigram_perm(3, 512)
    follows = (perm[toks.long()] == labels.long()).float().mean().item()
    assert 0.65 < follows < 0.8
    # the zipfian draws favour low ids
    z = synthetic.token_batch(3, 7, 64, 256, 512, bigram_frac=0.0)["tokens"]
    assert (z < 16).float().mean().item() > 0.3


def test_streams_are_deterministic_in_seed_and_step():
    a = synthetic.token_batch(0, 5, 4, 32, 256)
    assert all(torch.equal(a[k], synthetic.token_batch(0, 5, 4, 32, 256)[k])
               for k in a)
    assert not torch.equal(a["tokens"],
                           synthetic.token_batch(0, 6, 4, 32, 256)["tokens"])
    assert not torch.equal(a["tokens"],
                           synthetic.token_batch(1, 5, 4, 32, 256)["tokens"])
    i = synthetic.image_batch(2, 3, 8)
    j = synthetic.image_batch(2, 3, 8)
    assert torch.equal(i["images"], j["images"])
    assert torch.equal(i["labels"], j["labels"])


def test_image_batch_is_templates_shifted_flipped_and_noised():
    b = synthetic.image_batch(0, 0, 96, noise=0.0)
    imgs, labels = b["images"], b["labels"]
    assert imgs.shape == (96, 32, 32, 3) and imgs.dtype == torch.float32
    assert labels.dtype == torch.int32
    t = synthetic._class_templates(10, 32)
    hits = set()
    for im, c in zip(imgs.numpy(), labels.numpy()):
        found = None
        for flip in (False, True):
            src = t[c][:, ::-1] if flip else t[c]
            for dy in range(-3, 4):
                for dx in range(-3, 4):
                    if found is None and np.array_equal(
                            im, np.roll(src, (dy, dx), (0, 1))):
                        found = (flip, dy, dx)
        assert found is not None
        hits.add(found)
    assert len(hits) > 30                  # shifts and flips both vary
    noisy = synthetic.image_batch(0, 0, 96)["images"]
    assert abs(float((noisy - imgs).std()) - 0.6) < 0.01
    ev = synthetic.eval_image_set(0, 64)
    assert torch.equal(ev["images"], synthetic.eval_image_set(0, 64)["images"])


def test_pipeline_prefetches_and_its_state_round_trips():
    cfg = reduced("smollm-135m")
    a = lm_pipeline(cfg, 4, 16, seed=3, device="cpu")
    first = next(a)
    assert len(a._queue) == 1 and a.state.step == 1      # prefetch 2
    next(a), next(a)
    sd = a.state_dict()
    assert sd == {"step": 3, "seed": 3}
    b = lm_pipeline(cfg, 4, 16, device="cpu")
    b.load_state_dict(sd)
    for _ in range(2):
        x, y = next(a), next(b)
        assert all(torch.equal(x[k], y[k]) for k in x)
    c = lm_pipeline(cfg, 4, 16, seed=3, device="cpu")
    assert torch.equal(next(c)["tokens"], first["tokens"])
    # the stream is token_batch's at seed * 1000003 + process 0
    want = synthetic.token_batch(3 * 1000003, 0, 4, 16, cfg.vocab)
    assert torch.equal(first["tokens"], want["tokens"])
    img = next(cifar_pipeline(8, seed=2, device="cpu"))
    assert torch.equal(img["images"],
                       synthetic.image_batch(2, 0, 8)["images"])
    p = DataPipeline(lambda s, i: {"x": np.full(2, i)}, device="cpu",
                     prefetch=0)
    assert [int(next(p)["x"][0]) for _ in range(3)] == [0, 1, 2]


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

SCHEDULES = {
    "paper_step_decay": ((0.1, 7, (2, 4, 6), 5.0), 60),
    "paper_step_decay_default": ((), 200_000),
    "warmup_cosine": ((3e-4, 20, 200, 0.1), 260),
    "warmup_cosine_short": ((2e-3, 1, 3), 8),
    "constant": ((0.05,), 5),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_the_reference(name):
    args, n = SCHEDULES[name]
    fn = name.removesuffix("_default").removesuffix("_short")
    ours = getattr(__import__("repro_torch.optim", fromlist=[fn]), fn)(*args)
    ref = getattr(jax_optim, fn)(*args)
    steps = np.unique(np.linspace(0, n, 97).astype(np.int32))
    got = np.array([float(ours(torch.tensor(int(s), dtype=torch.int32)))
                    for s in steps], np.float32)
    want = np.array([float(ref(jnp.asarray(s, jnp.int32))) for s in steps],
                    np.float32)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert ours(torch.tensor(3)).dtype == torch.float32


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _tree(rng):
    return {"b": {"w": rng.standard_normal((5, 3), dtype=np.float32),
                  "s": np.ones((3,), np.float32)},
            "blocks": [{"c": rng.standard_normal((2, 2, 3, 4),
                                                 dtype=np.float32)},
                       {"c": rng.standard_normal((4,), dtype=np.float32)}],
            "a": rng.standard_normal((7,), dtype=np.float32)}


def test_tree_helpers_follow_jax_leaf_order(rng):
    t = _tree(rng)
    ours = tree_leaves(convert.params_from_numpy(t, "cpu"))
    ref = jax.tree.leaves(t)
    assert len(ours) == len(ref)
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(ours, ref))
    back = tree_unflatten(t, ours)
    assert list(back) == list(t) and isinstance(back["blocks"], list)
    assert np.array_equal(back["blocks"][0]["c"].numpy(), t["blocks"][0]["c"])
    doubled = tree_map(lambda x, y: x + y, t, t)
    assert np.array_equal(doubled["a"], 2 * t["a"])


OPTIMIZERS = {
    "sgd_nesterov": lambda m: m.sgd_nesterov(m.paper_step_decay(0.05, 2)),
    "sgd_nesterov_wd0": lambda m: m.sgd_nesterov(m.constant(0.1), 0.8, 0.0),
    "adamw": lambda m: m.adamw(m.warmup_cosine(3e-4, 2, 10)),
    "adamw_wd": lambda m: m.adamw(m.warmup_cosine(1e-2, 1, 5), b1=0.8,
                                  b2=0.99, eps=1e-6, weight_decay=0.3),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizers_match_the_reference_over_steps(rng, name):
    import repro_torch.optim as port_optim
    params = _tree(rng)
    grads = [jax.tree.map(lambda x: rng.standard_normal(
        x.shape, dtype=np.float32) * np.float32(0.1), params)
        for _ in range(5)]
    ref_opt = OPTIMIZERS[name](jax_optim)
    jp = jax.tree.map(jnp.asarray, params)
    js = ref_opt.init(jp)
    opt = OPTIMIZERS[name](port_optim)
    tp = convert.params_from_numpy(params, "cpu")
    ts = opt.init(tp)
    assert sorted(ts) == sorted(js)
    for g in grads:
        jp, js = ref_opt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp2, ts = opt.update(convert.params_from_numpy(g, "cpu"), ts, tp)
        assert tp2 is tp                     # updated in place
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=1e-7)
    for key in ("mu", "nu"):
        if key in js:
            for a, b in zip(tree_leaves(ts[key]), jax.tree.leaves(js[key])):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=RTOL, atol=1e-9)
    assert int(ts["step"]) == int(js["step"]) == 5
    assert ts["step"].dtype == torch.int32


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_the_reference(rng, max_norm):
    g = _tree(rng)
    ref, ref_norm = jax_optim.clip_by_global_norm(
        jax.tree.map(jnp.asarray, g), max_norm)
    ours, norm = clip_by_global_norm(convert.params_from_numpy(g, "cpu"),
                                     max_norm)
    np.testing.assert_allclose(float(norm), float(ref_norm), rtol=1e-6)
    assert float(global_norm(convert.params_from_numpy(g, "cpu"))) == \
        float(norm)
    for a, b in zip(tree_leaves(ours), jax.tree.leaves(ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-9)

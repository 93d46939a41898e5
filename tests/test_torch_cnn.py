"""The port's CNNs (``repro_torch.models.cnn``) against the JAX
package's on the same numpy weights and images: convolutions with XLA's
``"SAME"`` padding (stride 2 included), ``groupnorm``, ResNet-8 under
every PE type, and ``cnn_loss`` with its gradients.

Tolerances: float32 convolutions sum in another order than XLA's, so
FP32 logits agree to ~1e-6 relative (held at 1e-4 absolute on logits of
~0.1-1).  Under quantized numerics a value within rounding of a code
boundary may take the neighbouring code in one package (the activation
scale spans the batch; a pow2 weight at a log2 half-integer, see
``_torch_helpers.log2_ties``), which moves a logit by up to a code step
through the rest of the net: held at 2e-3 absolute, and the argmax
equal.  Gradients: 1e-4 of the largest gradient in FP32, 3e-2 under
LightPE-1 (a flipped code moves the STE's forward value)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cnn as jax_cnn
from repro_torch import convert, train_check
from repro_torch.models import cnn
from repro_torch.quant.qconfig import preset

PE_TYPES = ("fp32", "int16", "lightpe1", "lightpe2")
LOGIT_ATOL = {"fp32": 1e-4, "int16": 2e-3, "lightpe1": 2e-3,
              "lightpe2": 2e-3}


@pytest.fixture(scope="module")
def resnet8():
    arrays = cnn.numpy_resnet(8, 10, seed=3)
    return arrays, jax.tree.map(jnp.asarray, arrays), \
        convert.params_from_numpy(arrays, "cpu")


@pytest.fixture(scope="module")
def images():
    return train_check.image_batch_np(0, batch=8)


@pytest.mark.parametrize("n,k,s,want", [(32, 3, 2, (0, 1)), (32, 3, 1, (1, 1)),
                                         (32, 1, 2, (0, 0)), (16, 1, 1, (0, 0)),
                                         (7, 3, 2, (1, 1)), (8, 2, 2, (0, 0))])
def test_same_pads_are_xla_s(n, k, s, want):
    assert cnn.same_pads(n, k, s) == want


@pytest.mark.parametrize("k,stride,hw", [(3, 2, 32), (3, 1, 32), (1, 2, 32),
                                         (3, 2, 15), (1, 1, 8)])
def test_qconv_matches_xla_same_padding(rng, k, stride, hw):
    x = rng.standard_normal((2, hw, hw, 5), dtype=np.float32)
    w = rng.standard_normal((k, k, 5, 6), dtype=np.float32)
    want = jax_cnn.qconv(jnp.asarray(x), jnp.asarray(w), preset("fp32"),
                         stride)
    got = cnn.qconv(torch.from_numpy(x), torch.from_numpy(w), preset("fp32"),
                    stride)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_groupnorm_uses_the_biased_variance(rng):
    for c in (4, 16, 64):
        x = rng.standard_normal((2, 5, 5, c), dtype=np.float32) * 3 + 1
        s = rng.standard_normal(c, dtype=np.float32)
        b = rng.standard_normal(c, dtype=np.float32)
        want = jax_cnn.groupnorm(jnp.asarray(x), jnp.asarray(s),
                                 jnp.asarray(b))
        got = cnn.groupnorm(*(torch.from_numpy(a) for a in (x, s, b)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=2e-6)


def test_init_shapes_match_the_reference():
    ours = cnn.resnet_init(torch.Generator().manual_seed(0), depth=8,
                           device="cpu")
    ref = jax.eval_shape(lambda k: jax_cnn.resnet_init(k, depth=8),
                         jax.random.PRNGKey(0))
    assert jax.tree.structure(jax.tree.map(lambda x: 0, ref)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, cnn.numpy_resnet(8)))
    assert [tuple(a.shape) for a in jax.tree.leaves(
        jax.tree.map(lambda t: t.numpy(), ours))] == \
        [a.shape for a in jax.tree.leaves(ref)]
    assert [b.get("sc") is not None for b in ours["blocks"]] == \
        [("sc" in b) for b in ref["blocks"]]
    v = cnn.vgg16_init(torch.Generator().manual_seed(0), device="cpu")
    vr = jax.eval_shape(jax_cnn.vgg16_init, jax.random.PRNGKey(0))
    assert [tuple(c.shape) for c in v["convs"]] == \
        [c.shape for c in vr["convs"]]
    assert tuple(v["fc1"].shape) == vr["fc1"].shape
    w = cnn.conv_init(torch.Generator().manual_seed(1), 64, 64, 3,
                      device="cpu")
    assert abs(float(w.std()) - 1 / np.sqrt(576)) < 2e-3


@pytest.mark.parametrize("pe", PE_TYPES)
def test_resnet8_matches_the_reference(resnet8, images, pe):
    _, jp, tp = resnet8
    want = np.asarray(jax.jit(jax_cnn.resnet_apply, static_argnums=2)(
        jp, jnp.asarray(images["images"]), pe))
    got = cnn.resnet_apply(tp, torch.from_numpy(images["images"]), pe)
    assert got.shape == want.shape == (8, 10)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=LOGIT_ATOL[pe])
    assert (got.argmax(-1).numpy() == want.argmax(-1)).all()


@pytest.mark.parametrize("pe", ["fp32", "lightpe1"])
def test_cnn_loss_and_grads_match_value_and_grad(resnet8, images, pe):
    _, jp, tp = resnet8
    batch = {k: jnp.asarray(v) for k, v in images.items()}
    (loss, acc), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_cnn.cnn_loss(jax_cnn.resnet_apply, p, batch, pe),
        has_aux=True))(jp)
    leaves = [t.detach().clone().requires_grad_() for t in
              jax.tree.leaves(jax.tree.map(lambda t: t, tp,
                                           is_leaf=torch.is_tensor))]
    params = jax.tree.unflatten(jax.tree.structure(jp), leaves)
    tb = convert.params_from_numpy(images, "cpu")
    tloss, tacc = cnn.cnn_loss(cnn.resnet_apply, params, tb, pe)
    tgrads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    assert float(tacc) == float(acc)
    tol = 1e-4 if pe == "fp32" else 3e-2
    top = max(float(jnp.max(jnp.abs(g))) for g in jax.tree.leaves(grads))
    for g, w in zip(tgrads, jax.tree.leaves(grads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=tol * top)

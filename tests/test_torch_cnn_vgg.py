"""The port's VGG-16 (``repro_torch.models.cnn.vgg16_apply``) against the
JAX package's on the same weights and two 32x32 images (the five 2x2
pools need 32x32), under every PE type.

Tolerances: 1e-4 absolute in FP32 and 2e-3 in INT16, as in
``test_torch_cnn.py``.  Under LightPE-1 / LightPE-2 every one of the 13
convs reads its input as 8-bit codes of a per-tensor scale: an
activation within float32 rounding of a code boundary (the packages sum
the convolutions in another order) takes the neighbouring code, a step
of ~1/127 of the layer's absmax, and 13 such layers move the random
net's logits (~0.01-0.5) by up to ~1e-2 (measured 9.5e-3; the pow2
weight codes differ in 3 of 14.7M weights, at log2 ties).  Held at
2e-2 absolute, with the argmax equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cnn as jax_cnn
from repro_torch import convert, train_check
from repro_torch.models import cnn

ATOL = {"fp32": 1e-4, "int16": 2e-3, "lightpe1": 2e-2, "lightpe2": 2e-2}


@pytest.fixture(scope="module")
def vgg():
    ref = jax_cnn.vgg16_init(jax.random.PRNGKey(1))
    arrays = jax.tree.map(np.asarray, ref)
    return ref, convert.params_from_numpy(arrays, "cpu")


@pytest.mark.parametrize("pe", ["fp32", "int16", "lightpe1", "lightpe2"])
def test_vgg16_matches_the_reference(vgg, pe):
    jp, tp = vgg
    x = train_check.image_batch_np(1, batch=2)["images"]
    want = np.asarray(jax.jit(jax_cnn.vgg16_apply, static_argnums=2)(
        jp, jnp.asarray(x), pe))
    got = cnn.vgg16_apply(tp, torch.from_numpy(x), pe).detach().numpy()
    assert got.shape == want.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL[pe])
    assert (got.argmax(-1) == want.argmax(-1)).all()

"""repro_torch's fake quantization against repro's: the plain version of
the fused kernel against the Pallas kernel (interpret mode) and its
oracle, and the QAT numerics against repro.quant.fake_quant.

Values agree within 1e-6, as the reference's own tests hold them, except
that a pow2 code may differ by one where log2|w| lies within two float32
ulps of a half-integer (see ``_torch_helpers.log2_ties``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fake_quant import fake_quant_any as jax_fake_quant_any
from repro.kernels.fake_quant.ref import (ref_fake_quant_affine as jref_affine,
                                          ref_fake_quant_pow2 as jref_pow2)
from repro.quant import fake_quant as jfq, qconfig as jq
from repro_torch.kernels.fake_quant import fake_quant, fake_quant_any
from repro_torch.kernels.fake_quant.ref import (ref_fake_quant_affine,
                                                ref_fake_quant_pow2)
from repro_torch.quant import fake_quant as tfq, qconfig as tq

from _torch_helpers import assert_pow2_close

ATOL = 1e-6
SHAPES = [(256, 256), (300, 190), (512, 640), (8, 128)]


def _weight(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * 0.1).astype(np.float32)


def _scales(w, mode, bits=8):
    if mode == "affine":
        return (np.asarray(jfq.affine_scale(jnp.asarray(w), bits, axis=0)[0]),
                tfq.affine_scale(torch.as_tensor(w), bits, axis=0)[0])
    return (np.asarray(jfq.pow2_emax(jnp.asarray(w), axis=0)[0]),
            tfq.pow2_emax(torch.as_tensor(w), axis=0)[0])


@pytest.mark.parametrize("k,n", SHAPES)
@pytest.mark.parametrize("mode", ["affine", "pow2"])
def test_plain_vs_pallas_kernel(k, n, mode):
    """The reference test's own inputs (rng seed 0, N(0, 0.1^2))."""
    w = _weight((k, n))
    jscale, tscale = _scales(w, mode)
    np.testing.assert_array_equal(tscale.numpy(), jscale)
    want = np.asarray(jax_fake_quant_any(jnp.asarray(w), jnp.asarray(jscale),
                                         mode=mode, bits=8, interpret=True))
    got = fake_quant_any(torch.as_tensor(w), tscale, mode=mode, bits=8).numpy()
    if mode == "affine":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=ATOL)
    else:
        assert assert_pow2_close(got, want, w) <= 2


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("k,n", SHAPES)
def test_plain_vs_oracle_affine_bits(k, n, bits):
    w = _weight((k, n), seed=bits)
    jscale, tscale = _scales(w, "affine", bits)
    np.testing.assert_array_equal(tscale.numpy(), jscale)
    want = np.asarray(jref_affine(jnp.asarray(w), jnp.asarray(jscale), bits))
    got = ref_fake_quant_affine(torch.as_tensor(w), tscale, bits).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.array_equal(fake_quant(torch.as_tensor(w), tscale, bits=bits,
                                     mode="affine").numpy(), got)


@pytest.mark.parametrize("k,n", SHAPES)
def test_plain_vs_oracle_pow2(k, n):
    w = _weight((k, n), seed=7)
    jscale, tscale = _scales(w, "pow2")
    np.testing.assert_array_equal(tscale.numpy(), jscale)
    want = np.asarray(jref_pow2(jnp.asarray(w), jnp.asarray(jscale)))
    got = ref_fake_quant_pow2(torch.as_tensor(w), tscale).numpy()
    assert assert_pow2_close(got, want, w) <= 2
    nz = got[got != 0]
    np.testing.assert_array_equal(np.log2(np.abs(nz)),
                                  np.round(np.log2(np.abs(nz))))


@pytest.mark.parametrize("pe", tq.PE_TYPES)
@pytest.mark.parametrize("shape", [(96, 40), (3, 3, 16, 24), (40,)])
@pytest.mark.parametrize("per_channel", [True, False])
def test_fake_quant_weight_presets(pe, shape, per_channel):
    w = _weight(shape, seed=len(shape))
    jcfg = dataclasses.replace(jq.preset(pe), per_channel=per_channel)
    tcfg = dataclasses.replace(tq.preset(pe), per_channel=per_channel)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    want = np.asarray(jfq.fake_quant_weight(jnp.asarray(w), jcfg))
    got = tfq.fake_quant_weight(torch.as_tensor(w), tcfg).numpy()
    assert got.shape == want.shape
    if tcfg.weight_scheme in ("none", "affine"):
        np.testing.assert_allclose(got, want, atol=ATOL)
    else:
        # pow2x2 rounds the input and then its residual
        axis = tuple(range(w.ndim - 1)) if per_channel else None
        e_max = jfq.pow2_emax(jnp.asarray(w), axis)
        q1 = np.asarray(jfq.pow2_round(jnp.asarray(w), e_max - 7, e_max))
        assert assert_pow2_close(got, want, w, residual=w - q1) <= 2


@pytest.mark.parametrize("pe", ["int16", "lightpe1", "lightpe2", "int8"])
def test_activation_quant_and_ste_gradient(pe):
    x = torch.as_tensor(_weight((16, 48), seed=3), dtype=torch.float32)
    want = np.asarray(jfq.fake_quant_act(jnp.asarray(x.numpy()),
                                         jq.preset(pe)))
    np.testing.assert_allclose(tfq.fake_quant_act(x, tq.preset(pe)).numpy(),
                               want, atol=ATOL)
    w = torch.as_tensor(_weight((3, 3, 8, 16), seed=4)).requires_grad_()
    (tfq.fake_quant_weight(w, tq.preset(pe)) * 3.0).sum().backward()
    np.testing.assert_array_equal(w.grad.numpy(), np.full(w.shape, 3.0))


def test_ste_keeps_the_reference_expression():
    """x + (q - x) is not bitwise q in float32: the port keeps it."""
    w = torch.as_tensor(_weight((64, 64), seed=9))
    s = tfq.affine_scale(w, 8, axis=(0,))
    q = tfq.affine_quantize(w, s, 8) * s
    out = tfq.affine_fake_quant(w, 8, axis=(0,))
    assert torch.equal(out, w + (q - w))


def test_wrapper_contract():
    w, s = torch.ones(4, 3), torch.ones(3)
    before = fake_quant.launches
    fake_quant(w, s)
    assert fake_quant.launches == before  # the CPU takes the plain version
    with pytest.raises(ValueError, match="unknown mode"):
        fake_quant(w, s, mode="pow3")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fake_quant(w.to("meta"), s.to("meta"))
    with pytest.raises(ValueError, match="neither"):
        tfq.pow2_round(w, torch.zeros(2))

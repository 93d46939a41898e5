"""The port's weight packing (``repro_torch.quant.pack``) against the JAX
package's ``repro.quant.pack``: int4/int8 codes and scales bit-exact,
pow2 codes equal except where log2|w| sits at a half-integer (ROADMAP C),
dequantized values within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant import pack as JP
from repro_torch.quant import pack as P

from _torch_helpers import log2_ties

SHAPES = [(64, 32), (300, 190), (2, 1), (576, 192)]
# tests/test_quant.py::test_int4_shapes draws k in 4..80 (even), n in 1..40
INT4_SHAPES = [(2 * k, n) for k, n in zip(
    np.random.default_rng(7).integers(2, 41, 15),
    np.random.default_rng(8).integers(1, 41, 15))]


def _jax(name):
    """The JAX package's function, compiled once per shape (eager JAX
    compiles every operation for every new shape).  Only for dequantizing:
    under jit XLA divides by a scale as a multiply by its reciprocal, so
    the codes are the eager (served) ones."""
    return jax.jit(getattr(JP, name))


def _w(shape, seed=0):
    return (np.random.default_rng(seed).normal(size=shape) * 0.08
            ).astype(np.float32)


def test_nibble_roundtrip_and_layout(rng):
    codes = rng.integers(0, 16, size=(6, 10)).astype(np.uint8)
    packed = P.pack_nibbles(torch.as_tensor(codes))
    assert packed.dtype == torch.uint8 and packed.shape == (6, 5)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(JP.pack_nibbles(jnp.asarray(codes))))
    np.testing.assert_array_equal(P.unpack_nibbles(packed).numpy(), codes)
    with pytest.raises(ValueError, match="odd"):
        P.pack_nibbles(torch.zeros(3, 5, dtype=torch.uint8))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", ["int4", "int8"])
def test_affine_codes_bit_exact(shape, mode):
    w = _w(shape)
    codes, scale = P.QUANTIZE[mode](torch.as_tensor(w))
    jcodes, jscale = getattr(JP, f"quantize_{mode}")(jnp.asarray(w))
    assert codes.dtype == {"int4": torch.uint8, "int8": torch.int8}[mode]
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


def _pow2_codes_agree(codes, e_max, jcodes, je_max, w):
    """Codes equal except at log2 ties of the weight; a column whose e_max
    differs must have its absmax at a tie (then all its codes move)."""
    cols = np.asarray(je_max) != e_max
    absmax = np.abs(w).max(axis=0)
    assert np.all(log2_ties(absmax[cols])), "e_max differs away from a tie"
    got = P.unpack_nibbles(torch.as_tensor(codes.T)).numpy().T
    want = np.asarray(JP.unpack_nibbles(jnp.asarray(np.asarray(jcodes).T))).T
    off = (got != want) & ~cols[None, :]
    assert np.all(log2_ties(w[off])), (
        f"{int(np.sum(off & ~log2_ties(w)))} codes differ away from a tie")
    return int(off.sum()) + int(cols.sum())


@pytest.mark.parametrize("shape", SHAPES)
def test_pow2_codes_equal_except_at_ties(shape):
    w = _w(shape, seed=3)
    codes, e_max = P.quantize_pow2(torch.as_tensor(w))
    jcodes, je_max = JP.quantize_pow2(jnp.asarray(w))
    assert codes.dtype == torch.uint8
    assert codes.shape == (shape[0] // 2, shape[1])
    _pow2_codes_agree(codes.numpy(), e_max.numpy(), jcodes, je_max, w)


def test_stacked_weights_pack_layer_by_layer():
    """A (L, K, N) stack packs to the stack of each layer's codes."""
    w = _w((3, 64, 48), seed=4)
    for mode in ("int4", "pow2", "int8"):
        codes, scale = P.QUANTIZE[mode](torch.as_tensor(w))
        for i in range(3):
            ci, si = P.QUANTIZE[mode](torch.as_tensor(w[i]))
            assert torch.equal(codes[i], ci) and torch.equal(scale[i], si)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", ["int4", "pow2", "int8"])
def test_dequantize_matches_jax(shape, mode):
    """The JAX package's own codes, dequantized by both packages."""
    jcodes, jscale = getattr(JP, f"quantize_{mode}")(jnp.asarray(_w(shape)))
    want = _jax(f"dequantize_{mode}")(jcodes, jscale)
    got = P.DEQUANTIZE[mode](torch.as_tensor(np.array(jcodes)),
                             torch.as_tensor(np.array(jscale)))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("k,n", INT4_SHAPES)
def test_int4_shapes(k, n):
    w = _w((k, n), seed=int(k * 100 + n))
    packed, scale = P.quantize_int4(torch.as_tensor(w))
    assert packed.shape == (k // 2, n) and scale.shape == (n,)
    deq = P.dequantize_int4(packed, scale)
    assert deq.shape == (k, n)
    # within half a step of the weight, as the reference's round trip
    assert float((deq - torch.as_tensor(w)).abs().max()) <= (
        float(scale.max()) / 2 + 1e-6)

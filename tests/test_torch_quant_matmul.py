"""The plain version of the port's ``quant_matmul`` kernel (what its
wrapper computes on a CPU tensor) against the JAX package's Pallas kernel
in interpret mode, on the JAX package's own packed codes, at the
reference test's shapes and tolerances (``tests/test_kernels.py``:
rtol 1e-5 / atol 1e-4 for float32 x, 0.15 for bfloat16 x)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quant_matmul import quant_matmul as jax_qmm
from repro.kernels.quant_matmul import quant_matmul_any as jax_qmm_any
from repro.quant import pack as JP
from repro_torch.kernels.quant_matmul import quant_matmul, quant_matmul_any
from repro_torch.kernels.quant_matmul.ref import ref_quant_matmul

MKN_ALIGNED = [(128, 256, 128), (256, 512, 256), (128, 512, 384)]
MKN_RAGGED = [(37, 300, 190), (1, 512, 129), (200, 254, 64)]
MODES = ["int4", "pow2", "int8"]


def _case(m, k, n, mode, seed=0):
    """x and the JAX package's codes for W ~ N(0, 0.08^2), as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.08).astype(np.float32)
    codes, scale = getattr(JP, f"quantize_{mode}")(jnp.asarray(w))
    return x, np.array(codes), np.array(scale, np.float32)


def _port(x, codes, scale, mode, fn=quant_matmul):
    before = quant_matmul.launches
    y = fn(torch.as_tensor(x), torch.as_tensor(codes),
           torch.as_tensor(scale), mode=mode)
    assert quant_matmul.launches == before   # a CPU tensor launches nothing
    return y


@pytest.mark.parametrize("m,k,n", MKN_ALIGNED)
@pytest.mark.parametrize("mode", MODES)
def test_aligned_vs_pallas(m, k, n, mode):
    x, codes, scale = _case(m, k, n, mode)
    want = jax_qmm(jnp.asarray(x), jnp.asarray(codes), jnp.asarray(scale),
                   mode=mode, bm=128, bn=128, bk=256, interpret=True)
    got = _port(x, codes, scale, mode)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("m,k,n", MKN_RAGGED)
@pytest.mark.parametrize("mode", MODES)
def test_ragged_vs_pallas_any(m, k, n, mode):
    x, codes, scale = _case(m, k, n, mode, seed=1)
    want = jax_qmm_any(jnp.asarray(x), jnp.asarray(codes), jnp.asarray(scale),
                       mode=mode, interpret=True)
    got = _port(x, codes, scale, mode, fn=quant_matmul_any)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_bf16_x(mode):
    """bfloat16 x is widened exactly: the plain version equals the float32
    product of the widened x; the Pallas kernel agrees within 0.15."""
    x, codes, scale = _case(128, 256, 128, mode, seed=2)
    xb = torch.as_tensor(x).to(torch.bfloat16)
    got = quant_matmul(xb, torch.as_tensor(codes), torch.as_tensor(scale),
                       mode=mode)
    wide = ref_quant_matmul(xb.float(), torch.as_tensor(codes),
                            torch.as_tensor(scale), mode)
    assert torch.equal(got, wide)
    want = jax_qmm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(codes),
                   jnp.asarray(scale), mode=mode, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0.15,
                               atol=0.15)


def test_wrapper_refuses_bad_codes():
    x = torch.ones(4, 8)
    with pytest.raises(ValueError, match="uint8"):
        quant_matmul(x, torch.zeros(4, 3, dtype=torch.int8), torch.ones(3),
                     mode="int4")
    with pytest.raises(ValueError, match="K=8"):
        quant_matmul(x, torch.zeros(8, 3, dtype=torch.uint8), torch.ones(3),
                     mode="pow2")
    with pytest.raises(ValueError, match="scale"):
        quant_matmul(x, torch.zeros(8, 3, dtype=torch.int8), torch.ones(4),
                     mode="int8")
    with pytest.raises(ValueError, match="unknown mode"):
        quant_matmul(x, torch.zeros(4, 3, dtype=torch.uint8), torch.ones(3),
                     mode="int2")

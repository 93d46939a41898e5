"""Why bfloat16 pow2 rounding is not held to the JAX package: on the CPU,
the reference's bfloat16 ``log2`` and ``exp2`` (XLA's) are not correctly
rounded, so its bfloat16 ``pow2_round`` differs from the port's plain
version, whose torch ``log2`` and ``exp2`` are.

Input: a (256, 576) bfloat16 tensor, N(0, 3^2) from numpy's
``default_rng(5)``, and the port's per-channel e_max, given to both
packages (``pow2_emax`` takes a log2 too).  The counts are JAX's on the
CPU as installed with this repo; a JAX whose bfloat16 log2/exp2 round
correctly fails here, and then bfloat16 pow2 can be held to the JAX
package like float32.  The model never takes this path (its pow2 weights
are float32); ``test_torch_fake_quant.py`` holds the port's bfloat16 pow2
to signed powers of two inside each channel's window instead.
"""

import jax.numpy as jnp
import numpy as np
import torch

from repro.quant import fake_quant as jfq
from repro_torch.kernels.fake_quant.ref import ref_fake_quant_pow2
from repro_torch.quant import fake_quant as tfq


def test_reference_bf16_log2_exp2_and_pow2_round_counts():
    x = torch.as_tensor(np.random.default_rng(5).normal(size=(256, 576))
                        .astype(np.float32) * 3.0).to(torch.bfloat16)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    n = x.numel()
    assert n == 147_456

    # torch's bfloat16 log2 is log2 in float64 rounded once to bfloat16
    mag = x.abs().clamp_min(1e-12)
    exact = torch.as_tensor(np.log2(mag.double().numpy())).to(torch.bfloat16)
    assert torch.equal(torch.log2(mag), exact)
    xla = torch.as_tensor(np.array(
        jnp.log2(jnp.maximum(jnp.abs(jx), 1e-12)).astype(jnp.float32)))
    assert int((xla != exact.float()).sum()) == 63_205           # 42.9%
    assert int((torch.round(xla) != torch.round(exact.float())).sum()) == 642

    # exp2 of bfloat16 integers: torch's are the powers of two, XLA's
    # mostly not (exp2(2) = 3.984375)
    ints = np.arange(-20, 10)
    assert torch.equal(
        torch.exp2(torch.as_tensor(ints, dtype=torch.bfloat16)).float(),
        torch.as_tensor(2.0 ** ints).float())
    powers = np.asarray(jnp.exp2(jnp.asarray(ints, jnp.bfloat16))
                        .astype(jnp.float32))
    assert int((powers != 2.0 ** ints).sum()) == 23
    assert float(powers[list(ints).index(2)]) == 3.984375

    # so pow2_round differs in 31.6% of the elements, by up to 4.0
    e_max = tfq.pow2_emax(x, axis=0)[0]
    je = jnp.asarray(e_max.float().numpy()).astype(jnp.bfloat16)
    mine = ref_fake_quant_pow2(x, e_max).float().numpy()
    theirs = np.asarray(jfq.pow2_round(jx, je - 7, je).astype(jnp.float32))
    assert int((mine != theirs).sum()) == 46_661
    assert float(np.abs(mine - theirs).max()) == 4.0

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


# ---------------------------------------------------------------------------
# the card kernels' arithmetic and launch plan, on the CPU
# ---------------------------------------------------------------------------

import repro_torch.kernels.quant_matmul as mod  # noqa: E402
from repro_torch.kernels.quant_matmul.ref import (code_values,  # noqa: E402
                                                  emulate_mma, split_bf16x3)

SMOLLM_KN = [(576, 576), (576, 192), (576, 1536), (1536, 576)]


def test_split_bf16x3_is_exact():
    """hi + mid + lo == x in float64 over exponents 2^-60..2^60, each part
    a bf16 value, and |mid|, |lo| within half an ulp of the part before."""
    rng = np.random.default_rng(0)
    x = (rng.uniform(1, 2, 200_000) * np.exp2(rng.integers(-60, 61, 200_000))
         * rng.choice([-1, 1], 200_000)).astype(np.float32)
    hi, mid, lo = split_bf16x3(torch.as_tensor(x))
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = (hi.double() + mid.double() + lo.double()).numpy()
    np.testing.assert_array_equal(total, x.astype(np.float64))
    assert bool((mid.double().abs() <= hi.double().abs() * 2.0 ** -8).all())
    assert bool((lo.double().abs() <= mid.double().abs() * 2.0 ** -8).all())


@pytest.mark.parametrize("mode", MODES)
def test_every_code_value_is_exact_in_bf16(mode):
    if mode == "int8":
        codes = torch.arange(-128, 128, dtype=torch.int8).reshape(256, 1)
    else:   # every pair of nibbles: rows 2r (low) and 2r + 1 (high)
        codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
        codes = codes.reshape(256, 1)
    vals = code_values(codes, mode)
    want = {"int8": set(range(-128, 128)), "int4": set(range(-8, 8)),
            "pow2": {s * 2 ** i for s in (-1, 1) for i in range(8)}}[mode]
    assert {int(v) for v in vals.flatten().tolist()} == want
    assert torch.equal(vals.to(torch.bfloat16).to(torch.float32), vals)


def _emulated_vs_pallas(m, k, n, mode, seed):
    x, codes, scale = _case(m, k, n, mode, seed=seed)
    want = jax_qmm_any(jnp.asarray(x), jnp.asarray(codes), jnp.asarray(scale),
                       mode=mode, interpret=True)
    got = emulate_mma(torch.as_tensor(x), torch.as_tensor(codes),
                      torch.as_tensor(scale), mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("k,n", SMOLLM_KN)
@pytest.mark.parametrize("mode", MODES)
def test_mma_arithmetic_vs_pallas_smollm(k, n, mode):
    """The prefill kernel's three-part bf16 arithmetic against the Pallas
    kernel (interpret mode) at SmolLM-135M's projection shapes, small M."""
    _emulated_vs_pallas(8, k, n, mode, seed=k + n)


@pytest.mark.parametrize("m,k,n", MKN_RAGGED)
@pytest.mark.parametrize("mode", MODES)
def test_mma_arithmetic_vs_pallas_ragged(m, k, n, mode):
    _emulated_vs_pallas(m, k, n, mode, seed=3)


@pytest.mark.parametrize("mode", MODES)
def test_mma_arithmetic_bf16_x_is_one_pass(mode):
    """bfloat16 x needs one pass: the emulation equals the plain version
    on the widened x up to the order of the float32 sums."""
    x, codes, scale = _case(64, 576, 192, mode, seed=4)
    xb = torch.as_tensor(x).to(torch.bfloat16)
    got = emulate_mma(xb, torch.as_tensor(codes), torch.as_tensor(scale), mode)
    want = ref_quant_matmul(xb, torch.as_tensor(codes), torch.as_tensor(scale),
                            mode)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


PLAN_SHAPES = SMOLLM_KN + [(300, 190), (512, 129), (254, 64), (8192, 4096),
                           (64, 65), (2, 1)]


@pytest.mark.parametrize("m", [1, 4, 16, 17, 520])
@pytest.mark.parametrize("k,n", PLAN_SHAPES)
@pytest.mark.parametrize("mode", MODES)
def test_launch_plan_covers_each_output_once(m, k, n, mode):
    """Every unit of work of the plan, by the kernels' index formulas,
    covers [0, M) x [0, K) x [0, N) exactly once, at every alignment of
    the codes; the GEMV keeps at most 4 code loads in flight a thread
    where 8 splits allow it, and a cluster has at most 8 blocks."""
    for align in (16, 8, 4, 2, 1):
        if n % align:
            continue
        p = mod.plan(m, k, n, mode, code_align=align, x_align=align == 16)
        assert p.variant == ("gemv" if m <= 16 else "mma")
        assert 1 <= p.splits <= 8
        for axis, size in zip(mod.plan_ranges(p, m, k, n, mode), (m, k, n)):
            idx = [i for r in axis for i in r]
            assert sorted(idx) == list(range(size)), (p, size)
        if p.variant == "gemv":
            assert n % p.vec == 0 and p.vec in (16, 8, 4, 1)
            rows = k if mode == "int8" else k // 2
            tk = mod.GEMV_THREADS // p.tile
            if p.splits < 8:
                assert -(-p.span // tk) <= mod.GEMV_LOADS
        else:
            assert p.vec == (16 if align == 16 else 0)


def test_launch_plan_at_smollm_decode_and_prefill():
    """The plans the serving path launches: 16-byte code loads at decode,
    cp.async tiles at prefill, K split across a cluster until there are
    about three blocks an SM (keeping 3 K tiles a split)."""
    for k, n in SMOLLM_KN:
        d = mod.plan(4, k, n, "pow2")
        assert (d.variant, d.vec) == ("gemv", 16)
        p = mod.plan(520, k, n, "pow2")
        assert (p.variant, p.vec, p.tile) == ("mma", 16, 64)
        assert p.span >= 3 and p.grid[0] * p.grid[1] == 9 * -(-n // 64)
    assert [mod.plan(520, k, n, "pow2").splits for k, n in SMOLLM_KN] == [
        5, 6, 2, 5]
    assert mod.plan(520, 64, 64, "pow2").splits == 1


def test_launch_plan_follows_the_tensors_alignment():
    """A layer's view into stacked codes may start off a 16-byte boundary:
    the plan then takes narrower loads of the same kernels."""
    stack = torch.zeros(3, 5, 24, dtype=torch.uint8)   # 120 bytes a layer
    x = torch.zeros(4, 10)
    base = stack.data_ptr()
    for i in range(3):
        want = mod.alignment(base + i * 120, 24)
        assert mod.launch_plan(x, stack[i], "pow2").vec == min(
            16, want if want != 2 else 1)
    assert mod.alignment(0, 24) == 8 and mod.alignment(8, 16) == 8
    assert mod.alignment(3, 16) == 1
    assert mod.launch_plan(torch.zeros(32, 10), stack[0], "pow2").vec == 0

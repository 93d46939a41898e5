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
    # meta (the dry run): the card's checks and allocations, no launch
    out = fake_quant(w.to("meta"), s.to("meta"))
    assert out.device.type == "meta" and out.shape == w.shape
    assert fake_quant.launches == before
    with pytest.raises(ValueError, match="one device"):
        fake_quant_group([w, w.to("meta")], [s, s.to("meta")])
    with pytest.raises(ValueError, match="neither"):
        tfq.pow2_round(w, torch.zeros(2))


# ---------------------------------------------------------------------------
# the grouped launch: its plan, and the list forms
# ---------------------------------------------------------------------------

from repro_torch.kernels.fake_quant import (GROUP_MAX, block_ranges,  # noqa: E402
                                            fake_quant_group, head, plan, span)
from repro_torch.kernels.fake_quant.fake_quant import (THREADS,  # noqa: E402
                                                       UNROLL)

VGG16_SHAPES = [(27, 64), (576, 64), (576, 128), (1152, 128), (1152, 256),
                (2304, 256), (2304, 256), (2304, 512)] + [(4608, 512)] * 5 \
    + [(512, 512), (512, 10)]


def _covered(numels, heads, elem, addresses):
    """Hold a plan to its tensors: every element of every tensor written by
    exactly one block, each block on one tensor, vectors 16-byte aligned;
    returns the launches."""
    launches = plan(numels, heads, elem)
    vec = 16 // elem
    seen = {t: np.zeros(n, np.int64) for t, n in enumerate(numels)}
    for parts in launches:
        assert 1 <= len(parts) <= GROUP_MAX
        nxt = 0
        for p in parts:
            assert p.first_block == nxt and p.blocks >= 1
            nxt += p.blocks
            blocks = block_ranges(p, numels[p.tensor], elem)
            assert len(blocks) == p.blocks
            for j, ranges in enumerate(blocks):
                for lo, hi, kind in ranges:
                    assert 0 <= lo < hi <= numels[p.tensor]
                    seen[p.tensor][lo:hi] += 1
                    if kind == "vector":
                        assert (addresses[p.tensor] + lo * elem) % 16 == 0
                        assert (hi - lo) % vec == 0
                        assert hi - lo <= span(elem)
                    else:
                        assert hi - lo < vec
                        assert lo == 0 or lo >= p.head
                        if lo == 0 and p.head:
                            assert j == 0 and hi == p.head
    for t, n in enumerate(numels):
        assert np.array_equal(seen[t], np.ones(n, np.int64)), t
    return launches


@pytest.mark.parametrize("elem", [4, 2])
def test_plan_covers_vgg16_in_one_launch(elem):
    numels = [k * n for k, n in VGG16_SHAPES]
    addresses = [512 * i for i in range(len(numels))]
    launches = _covered(numels, [0] * len(numels), elem, addresses)
    assert len(launches) == 1 and len(launches[0]) == 15
    step = span(elem)
    assert sum(p.blocks for p in launches[0]) == sum(-(-n // step)
                                                    for n in numels)


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_covers_ragged_unaligned_tensors(elem, seed):
    """Sizes around a span's edges, bases off 16 bytes (a scalar head) and
    tensors shorter than their head; every element once."""
    rng = np.random.default_rng(seed)
    step = span(elem)
    numels = [1, 2, 3, 7, step - 1, step, step + 1, 2 * step + 5] + list(
        rng.integers(1, 5 * step, size=12))
    addresses = [int(a) * elem for a in rng.integers(0, 64, size=len(numels))]
    heads = [head(a, elem, n) for a, n in zip(addresses, numels)]
    assert any(h for h in heads)
    _covered(numels, heads, elem, addresses)


def test_plan_chunks_past_group_max_and_skips_empty_tensors():
    numels = [100] * (2 * GROUP_MAX + 3) + [0]
    launches = _covered(numels, [0] * len(numels), 4, [0] * len(numels))
    assert [len(p) for p in launches] == [GROUP_MAX, GROUP_MAX, 3]
    assert [p[0].first_block for p in launches] == [0, 0, 0]
    assert launches[-1][-1].tensor == len(numels) - 2   # the empty one: none
    assert plan([0, 0], [0, 0], 4) == ()
    with pytest.raises(ValueError, match="at most"):
        plan([2 ** 31], [0], 4)



def _vector_columns(start, n_vec, cols, vec):
    """The columns csrc/fake_quant.cu's ``run_span`` gives the elements of
    a block's vectors, by its own arithmetic: thread t's first column is
    one 32-bit modulo, then advanced a vector at a time by
    (THREADS * vec) % cols with one wrap, and within a vector an element
    at a time with a wrap.  Returns them in element order (-1: no
    element)."""
    out = np.full(THREADS * UNROLL * vec, -1, np.int64)
    t = np.arange(THREADS)
    col = (start + t * vec) % cols
    step = (THREADS * vec) % cols
    for u in range(UNROLL):
        i = t + u * THREADS
        c = col.copy()
        for k in range(vec):
            out[i * vec + k] = np.where(i < n_vec, c, -1)
            c = np.where(c + 1 == cols, 0, c + 1)
        col = col + step
        col = np.where(col >= cols, col - cols, col)
    return out[:n_vec * vec]


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("cols", [1, 3, 10, 129, 576, 1024, 1536, 2048,
                                  49152])
def test_kernel_column_counter_is_the_modulo(elem, cols):
    """The kernel's wrapped column counter equals element % cols in every
    block, for column counts below, at and past the vector stride of a
    block (1024 float32 or 2048 bfloat16 elements): SmolLM-135M's MLP
    width 1536 and tied head 49152 among them, with and without a scalar
    head."""
    vec = 16 // elem
    for h in (0, vec - 1):
        numel = cols * max(3, -(-3 * span(elem) // cols))
        for parts in plan([numel], [h], elem):
            for p in parts:
                for j, ranges in enumerate(block_ranges(p, numel, elem)):
                    for lo, hi, kind in ranges:
                        if kind != "vector":
                            continue
                        got = _vector_columns(lo, (hi - lo) // vec, cols,
                                              vec)
                        assert np.array_equal(got, np.arange(lo, hi) % cols)


def test_head_is_the_distance_to_16_bytes():
    assert head(0, 4, 100) == 0 and head(8, 4, 100) == 2
    assert head(4, 4, 100) == 3 and head(2, 2, 100) == 7
    assert head(6, 2, 3) == 3          # shorter than its head: all scalar
    assert span(4) == span(2) // 2 == 2048


@pytest.mark.parametrize("mode,bits", [("affine", 8), ("affine", 16),
                                       ("pow2", 8)])
def test_group_equals_per_tensor(mode, bits):
    """The list form is the per-tensor form, tensor by tensor, with
    per-channel and per-tensor scales."""
    ws = [torch.as_tensor(_weight(s, seed=i)) for i, s in
          enumerate([(40, 24), (7, 3), (1, 129), (64, 64)])]
    if mode == "affine":
        scales = [tfq.affine_scale(w, bits, axis=0)[0] for w in ws]
    else:
        scales = [tfq.pow2_emax(w, axis=0)[0] for w in ws]
    scales[1] = scales[1][:1]          # one value for the whole tensor
    got = fake_quant_group(ws, scales, mode=mode, bits=bits)
    for g, w, s in zip(got, ws, scales):
        assert torch.equal(g, fake_quant(w, s, mode=mode, bits=bits))
    # one value is that value in every column
    assert torch.equal(got[1], fake_quant(ws[1], scales[1].expand(3),
                                          mode=mode, bits=bits))
    assert fake_quant_group([], [], mode=mode) == []
    with pytest.raises(ValueError, match="scales"):
        fake_quant_group(ws, scales[:2], mode=mode, bits=bits)


@pytest.mark.parametrize("pe", tq.PE_TYPES)
@pytest.mark.parametrize("per_channel", [True, False])
def test_fake_quant_weights_equals_per_weight(pe, per_channel, monkeypatch):
    """``fake_quant_weights`` is ``[fake_quant_weight(w) ...]`` bit for
    bit, in one kernel pass a group (two for LightPE-2's pow2x2)."""
    cfg = dataclasses.replace(tq.preset(pe), per_channel=per_channel)
    ws = [torch.as_tensor(_weight(s, seed=i)) for i, s in
          enumerate([(3, 3, 16, 24), (96, 40), (40,), (27, 64)])]
    want = [tfq.fake_quant_weight(w, cfg) for w in ws]
    passes = []
    real = tfq.fake_quant_group

    def spy(xs, scales, **kw):
        passes.append(len(xs))
        return real(xs, scales, **kw)

    monkeypatch.setattr(tfq, "fake_quant_group", spy)
    got = tfq.fake_quant_weights(ws, cfg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
    expected = {"none": [], "affine": [4], "pow2": [4], "pow2x2": [4, 4]}
    assert passes == expected[cfg.weight_scheme]


# ---------------------------------------------------------------------------
# bfloat16
# ---------------------------------------------------------------------------

def _bf16_pair(shape, seed):
    """The same bfloat16 values in both packages."""
    x = torch.as_tensor(np.random.default_rng(seed).normal(size=shape)
                        .astype(np.float32) * 3.0).to(torch.bfloat16)
    return x, jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("axis", [None, (0,)])
def test_plain_bf16_affine_equals_jax_bitwise(bits, axis):
    """Activations reach the kernel in bfloat16 (the model's compute type):
    the plain version rounds to bfloat16 where the JAX package does, so
    the two are equal bit for bit, per tensor and per channel."""
    x, jx = _bf16_pair((256, 576), seed=bits)
    got = tfq.affine_fake_quant(x, bits, axis)
    want = jfq.affine_fake_quant(jx, bits, axis)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    scale = tfq.affine_scale(x, bits, axis)
    np.testing.assert_array_equal(
        scale.float().numpy(),
        np.asarray(jfq.affine_scale(jx, bits, axis).astype(jnp.float32)))


@pytest.mark.parametrize("shape", [(256, 576), (300, 190)])
def test_plain_bf16_pow2_is_signed_powers_of_two_in_the_window(shape):
    """bfloat16 pow2 is not held to the JAX package: XLA's CPU log2 on
    bfloat16 is not correctly rounded (it differs from the correctly
    rounded value in about half of all inputs by one bfloat16 ulp, e.g.
    log2 0.70703125 gives -0.50390625, not -0.5), which flips round() at
    the codes near a half-integer.  So the plain version is held to what
    the function is: every output is 0 (where w is 0) or sign(w) 2^e with
    an integer e inside the channel's window [e_max - 7, e_max], and the
    nearest such code in log2 where w lies inside the window."""
    x, _ = _bf16_pair(shape, seed=5)
    x[0, :3] = 0.0
    e_max = tfq.pow2_emax(x, axis=0)[0]
    assert e_max.dtype == torch.bfloat16
    got = ref_fake_quant_pow2(x, e_max).float()
    xf, top = x.float(), e_max.float()[None, :]
    assert torch.equal(got[0, :3], torch.zeros(3))
    nz = got != 0
    assert torch.equal(nz, xf != 0)
    assert torch.equal(torch.sign(got), torch.sign(xf))
    e = torch.log2(got.abs()[nz])
    assert torch.equal(e, torch.round(e))
    full = torch.log2(got.abs().clamp_min(1e-30))
    assert bool(((full <= top) & (full >= top - 7))[nz].all())
    inside = nz & (torch.log2(xf.abs()) > top - 6.5) & (
        torch.log2(xf.abs()) < top + 0.5)
    assert bool(((full - torch.log2(xf.abs())).abs() <= 0.5 + 2 ** -6)[inside]
                .all())

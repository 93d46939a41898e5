"""The port's CUDA kernels on the card, against their plain versions.

Needs a CUDA card and nvcc: every test is marked ``gpu`` and skips
without a card.  Imports no JAX, so it runs on a machine without it:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.fake_quant import fake_quant
from repro_torch.kernels.fake_quant.ref import (ref_fake_quant_affine,
                                                ref_fake_quant_pow2)
from repro_torch.quant import fake_quant as tfq, preset

ATOL = 1e-6
SHAPES = [(256, 256), (300, 190), (512, 640), (8, 128), (1, 129),
          (4608, 512)]
MODES = [("affine", 4), ("affine", 8), ("affine", 16), ("pow2", 8)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _weight(shape, device, seed=0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor((rng.normal(size=shape) * 0.1).astype(np.float32),
                           device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", SHAPES)
@pytest.mark.parametrize("mode,bits", MODES)
def test_kernel_matches_plain(card, k, n, mode, bits):
    """Bit-identical in pow2 (both use CUDA's log2f/exp2f), within 1e-6
    in affine; one launch per call."""
    w = _weight((k, n), card)
    s = (tfq.affine_scale(w, bits, axis=0)[0] if mode == "affine"
         else tfq.pow2_emax(w, axis=0)[0])
    before = fake_quant.launches
    got = fake_quant(w, s, mode=mode, bits=bits)
    assert fake_quant.launches == before + 1
    want = (ref_fake_quant_affine(w, s, bits) if mode == "affine"
            else ref_fake_quant_pow2(w, s))
    torch.cuda.synchronize()
    if mode == "pow2":
        assert torch.equal(got, want)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("pe", ["int16", "lightpe1", "lightpe2", "int8"])
def test_fake_quant_weight_on_card_matches_cpu(card, pe):
    """The QAT numerics on the card (kernel) and on the CPU (plain
    version) agree on a conv weight, per-channel."""
    w = _weight((3, 3, 64, 128), card, seed=5)
    got = tfq.fake_quant_weight(w, preset(pe)).cpu()
    want = tfq.fake_quant_weight(w.cpu(), preset(pe))
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


@pytest.mark.gpu
def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    w = torch.ones(8, 4, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        fake_quant(w.T, torch.ones(8, device=card))
    with pytest.raises(ValueError, match="float32"):
        fake_quant(w.double(), torch.ones(4, device=card))
    with pytest.raises(ValueError, match="shape"):
        fake_quant(w, torch.ones(5, device=card))
    assert fake_quant(w[:0], torch.ones(4, device=card)).shape == (0, 4)

"""The port's transformer under the QAT numerics of every quantizing PE
type (``cfg.pe_type``: fake-quantized float32 weights and activations in
the compute type) against the JAX model, on reduced SmolLM-135M with the
same numpy weights (``convert.params_from_numpy``), in bfloat16 and
float32; and ``ServeEngine`` on those dense weights against the JAX
engine.

In the model, bfloat16 reaches ``fake_quant`` only as activations
(affine, one scale a tensor): the residual stream is bfloat16, while the
weights, pow2 ones included, and the MLP's hidden (a bfloat16 x float32
product) are float32.

Tolerances are the serving tests' (``test_torch_serve.LOGIT_TOL``):
float32 1e-4 (the order of float32 sums; the INT16 weight scales also
divide by 32767 where XLA multiplies by its reciprocal, an ulp apart);
bfloat16 2e-2, since inside this process XLA keeps some bfloat16
intermediates in float32 (its default excess precision) where the port
rounds at every place the source rounds, and an activation code then
moves by one step at a rounding tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as jax_reduced
from repro.models import transformer as JT
from repro.serve import ServeEngine as JaxEngine
from repro_torch import convert
from repro_torch.configs import reduced
from repro_torch.models import transformer as T
from repro_torch.quant import fake_quant as tfq
from repro_torch.serve import ServeEngine, check

LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
QAT_PE_TYPES = ("int16", "lightpe1", "lightpe2", "int8")

_jax_forward = jax.jit(JT.forward, static_argnums=2)


@pytest.fixture(scope="module")
def weights():
    arrays = T.numpy_params(reduced("smollm-135m"), seed=0)
    return dict(jax=jax.tree.map(jnp.asarray, arrays),
                port=convert.params_from_numpy(arrays, "cpu"))


def _configs(pe, dtype):
    return (jax_reduced("smollm-135m").replace(pe_type=pe, dtype=dtype),
            reduced("smollm-135m").replace(pe_type=pe, dtype=dtype))


def _tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("pe", QAT_PE_TYPES)
def test_qat_forward_matches_jax(weights, pe, dtype):
    jcfg, cfg = _configs(pe, dtype)
    toks = _tokens(2, 9, cfg.vocab)
    want = np.asarray(_jax_forward(weights["jax"], jnp.asarray(toks), jcfg))
    got = T.forward(weights["port"], torch.as_tensor(toks), cfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=LOGIT_TOL[dtype])
    # the quantization is not a no-op: fp32 numerics give other logits
    plain = T.forward(weights["port"], torch.as_tensor(toks),
                      cfg.replace(pe_type="fp32"))
    assert not torch.equal(plain, got)


@pytest.mark.parametrize("pe", QAT_PE_TYPES)
def test_qat_forward_sends_bf16_activations_to_the_kernel(weights, pe,
                                                          monkeypatch):
    """The path that failed on the card: per forward of the 2-layer model,
    13 bfloat16 activation passes (q/k/v/o, up and gate a layer, and the
    head), each with one scale; everything else float32."""
    calls = []
    real = tfq.fake_quant_group

    def spy(xs, scales, **kw):
        calls.extend((x.dtype, s.numel() == 1, kw["mode"])
                     for x, s in zip(xs, scales))
        return real(xs, scales, **kw)

    monkeypatch.setattr(tfq, "fake_quant_group", spy)
    _, cfg = _configs(pe, "bfloat16")
    T.forward(weights["port"], torch.as_tensor(_tokens(2, 9, cfg.vocab)), cfg)
    bf16 = [c for c in calls if c[0] == torch.bfloat16]
    assert len(bf16) == 13
    assert all(per_tensor and mode == "affine" for _, per_tensor, mode in bf16)
    weight_passes = {"int16": 15, "lightpe1": 15, "lightpe2": 30, "int8": 15}
    assert len(calls) - len(bf16) == weight_passes[pe] + 2   # + w_down's x


def test_qat_engine_matches_jax(weights):
    """Prefill and decode through ``ServeEngine`` on dense weights under
    LightPE-1 numerics in bfloat16 (2 requests in 2 slots), recorded and
    compared as the serving smoke does (``serve.check``): tokens equal up
    to a step whose reference top-2 margin is below the tolerance, logits
    within it.  The activation scale is one for the whole batch, so a
    token that differs in one request moves every request's logits after
    it: the comparison is ``coupled``."""
    jcfg, cfg = _configs("lightpe1", "bfloat16")
    prompts = [_tokens(1, n, cfg.vocab, seed=n)[0] for n in (5, 9)]

    def record(engine_cls, c, mod, params, to_numpy):
        return check.record(engine_cls(c, mod, params, batch_slots=2,
                                       max_len=32), prompts, 4, to_numpy)

    want = record(JaxEngine, jcfg, JT, weights["jax"], np.asarray)
    got = record(ServeEngine, cfg, T, weights["port"],
                 lambda t: t.float().numpy())
    problems, notes = check.compare(got, want, LOGIT_TOL["bfloat16"],
                                    coupled=True)
    assert not problems, problems
    assert [len(t) for t in got["tokens"]] == [4, 4]
    assert [t[0] for t in got["tokens"]] == [t[0] for t in want["tokens"]]

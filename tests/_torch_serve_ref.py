"""The JAX package's serving run that the port's serving smoke is held to.

``build_reference`` draws SmolLM-135M's params with numpy
(``repro_torch.models.transformer.numpy_params``), packs them with the
JAX package's ``quantize_params`` as ``lightpe1`` and as ``int8``, serves
the smoke's prompts through the JAX package's ``ServeEngine`` (4 prompts
in 4 slots, then 6 in 4 for slot reuse), in the config's bfloat16 and
again in float32, and records every step with
``repro_torch.serve.check.record``.  Under ``qat_modes`` it serves the
4 prompts again on the dense weights under the QAT numerics of a PE type
(``cfg.pe_type``: fake-quantized weights and activations), for every
quantizing PE type in bfloat16 and for LightPE-1 in float32.  ``tests/data/torch_serve_ref.json``
holds its full-size result, which ``chip_smoke.py`` holds the port to on
a machine without JAX; ``tests/test_torch_serve.py`` rebuilds it at the
reduced size to keep the format honest.

  PYTHONPATH=src python tests/_torch_serve_ref.py   # rewrite the file

Run as a script it turns off XLA's excess precision before JAX starts, so
that bf16 is rounded at exactly the places the model's source rounds it
(the port does the same); with XLA's default the logits move by a few
1e-3 (3.6e-3 at the reduced size), more than the card's float32 sums do.
"""

import json
import os
import time
from pathlib import Path

import numpy as np

REF_PATH = Path(__file__).resolve().parent / "data" / "torch_serve_ref.json"
PE_TYPES = ("lightpe1", "int8")
# the config's bfloat16, and float32, which separates the algorithm from
# bf16 rounding: over 30 layers the bf16 model turns float32 differences
# in the order of a sum into logits ~0.04 apart, the float32 one keeps
# them ~5e-6 apart
DTYPES = ("bfloat16", "float32")
# (pe_type, dtype) of the runs on dense weights under QAT numerics
QAT_MODES = (("int16", "bfloat16"), ("lightpe1", "bfloat16"),
             ("lightpe2", "bfloat16"), ("int8", "bfloat16"),
             ("lightpe1", "float32"))
NO_EXCESS_PRECISION = "--xla_allow_excess_precision=false"


def build_reference(size: str = "full", pe_types=PE_TYPES,
                    dtypes=DTYPES, qat_modes=QAT_MODES) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.configs import get, reduced
    from repro.models import family_module
    from repro.serve import ServeEngine, packed_bytes, quantize_params
    from repro_torch.models.transformer import numpy_params
    from repro_torch.serve import check

    cfg = (get if size == "full" else reduced)("smollm-135m")
    mod = family_module(cfg)
    arrays = numpy_params(cfg, check.PARAM_SEED)
    params = jax.tree.map(jnp.asarray, arrays)
    prompts = check.prompts(cfg.vocab, check.PROMPT_LENS)
    reuse = check.prompts(cfg.vocab, check.REUSE_LENS, check.PROMPT_SEED + 1)
    out = dict(
        config=cfg.name, size=size,
        xla_flags=os.environ.get("XLA_FLAGS", ""),
        batch_slots=check.BATCH_SLOTS, max_len=check.MAX_LEN,
        max_new=check.MAX_NEW, reuse_max_new=check.REUSE_MAX_NEW,
        min_size=check.MIN_SIZE, param_seed=check.PARAM_SEED,
        prompts=[p.tolist() for p in prompts],
        reuse_prompts=[p.tolist() for p in reuse],
        dense_bytes=int(sum(a.nbytes for a in jax.tree.leaves(arrays))),
        modes={})
    for pe in pe_types:
        packed = quantize_params(params, pe, min_size=check.MIN_SIZE)
        for dtype in dtypes:
            run_cfg = cfg.replace(dtype=dtype)

            def engine():
                return ServeEngine(run_cfg, mod, packed, check.BATCH_SLOTS,
                                   check.MAX_LEN)

            runs = dict(
                pe_type=pe, dtype=dtype,
                packed_bytes=int(packed_bytes(packed)),
                run4=check.record(engine(), prompts, check.MAX_NEW,
                                  np.asarray))
            if dtype == cfg.dtype:
                runs["run6"] = check.record(engine(), reuse,
                                            check.REUSE_MAX_NEW, np.asarray)
            out["modes"][check.mode_key(pe, dtype)] = runs
    out["qat_modes"] = {}
    for pe, dtype in qat_modes:
        run_cfg = cfg.replace(pe_type=pe, dtype=dtype)
        out["qat_modes"][check.mode_key(pe, dtype)] = dict(
            pe_type=pe, dtype=dtype,
            run4=check.record(ServeEngine(run_cfg, mod, params,
                                          check.BATCH_SLOTS, check.MAX_LEN),
                              prompts, check.MAX_NEW, np.asarray))
    return out


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = " ".join(
        filter(None, [os.environ.get("XLA_FLAGS"), NO_EXCESS_PRECISION]))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    t0 = time.perf_counter()
    ref = build_reference("full")
    REF_PATH.parent.mkdir(parents=True, exist_ok=True)
    REF_PATH.write_text(json.dumps(ref) + "\n")
    print(f"wrote {REF_PATH} in {time.perf_counter() - t0:.1f} s")

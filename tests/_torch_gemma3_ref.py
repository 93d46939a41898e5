"""The JAX package's Gemma-3-1B serving runs that ``chip_smoke.py`` phase
11.2 holds the port to.

``build_reference`` draws Gemma-3-1B's params with numpy
(``repro_torch.models.transformer.numpy_params``, seed 0), packs them with
the JAX package's ``quantize_params`` as ``lightpe1`` and as ``int8``,
serves 4 prompts of 64, 300, 700 and 900 tokens in 4 slots with a
1024-row cache and 12 new tokens each through the JAX package's
``ServeEngine`` (the padded prompt crosses the 512-token window of every
local layer; decode runs at positions 900-911), in the config's bfloat16
(both packings) and in float32 (LightPE-1), and records every step with
``repro_torch.serve.check.record``.  It also keeps the JAX package's
LightPE-1 codes at every weight whose log2 lies within 2 float32 ulps of a
half-integer (``pow2_ties``: there XLA's CPU ``log2`` and the card's
``log2f`` may round to the neighbouring code, ROADMAP C), and its e_max at
every column whose absmax does; the smoke puts those codes into its own
packing (``serve.check.pin_pow2_codes``) so that the served comparison
runs on the reference's codes.  ``tests/data/torch_gemma3_ref.json``
holds the full-size result; ``tests/test_torch_decoder.py`` rebuilds it
at the reduced size to keep the format honest.

  PYTHONPATH=src:tests python tests/_torch_gemma3_ref.py   # rewrite the file

Run as a script it turns off XLA's excess precision before JAX starts
(as ``_torch_serve_ref.py`` does), so that bfloat16 is rounded where the
model's source rounds it.  At full size it takes about 10 GB and a few
minutes of CPU.
"""

import json
import os
import time
from pathlib import Path

import numpy as np

REF_PATH = Path(__file__).resolve().parent / "data" / "torch_gemma3_ref.json"
CONFIG = "gemma3-1b"
# (pe_type, dtype) of the runs on packed weights
MODES = (("lightpe1", "bfloat16"), ("int8", "bfloat16"),
         ("lightpe1", "float32"))
NO_EXCESS_PRECISION = "--xla_allow_excess_precision=false"


def pow2_ties(arrays, packed, path: str = "") -> dict:
    """{"codes": [[leaf path, layer (-1: a 2-D leaf), k, n, code]],
    "e_max": [[leaf path, layer, n, e_max]]}: the packed tree's pow2 code
    at each weight w[k, n] at a log2 tie (``_torch_helpers.log2_ties``),
    and the e_max of each column whose absmax is at one."""
    from _torch_helpers import log2_ties
    out = {"codes": [], "e_max": []}
    if isinstance(packed, dict) and "codes__pow2" in packed:
        w = np.asarray(arrays)
        codes = np.asarray(packed["codes__pow2"])
        e_max = np.asarray(packed["scale"])
        stacked = w.ndim == 3
        if not stacked:
            w, codes, e_max = w[None], codes[None], e_max[None]
        for layer in range(w.shape[0]):
            at = -1 if not stacked else layer
            for k, n in np.argwhere(log2_ties(w[layer])).tolist():
                code = (int(codes[layer, k // 2, n]) >> (4 * (k % 2))) & 0xF
                out["codes"].append([path, at, k, n, code])
            for n in np.flatnonzero(
                    log2_ties(np.abs(w[layer]).max(axis=0))).tolist():
                out["e_max"].append([path, at, n, float(e_max[layer, n])])
    elif isinstance(packed, dict):
        for key, sub in packed.items():
            more = pow2_ties(arrays[key], sub, f"{path}/{key}" if path
                             else key)
            out["codes"] += more["codes"]
            out["e_max"] += more["e_max"]
    return out


def build_reference(size: str = "full", modes=MODES) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.configs import get, reduced
    from repro.models import family_module
    from repro.serve import ServeEngine, packed_bytes, quantize_params
    from repro_torch.models.transformer import numpy_params
    from repro_torch.serve import check

    cfg = (get if size == "full" else reduced)(CONFIG)
    mod = family_module(cfg)
    arrays = numpy_params(cfg, check.PARAM_SEED)
    dense_bytes = int(sum(a.nbytes for a in jax.tree.leaves(arrays)))
    params = jax.tree.map(jnp.asarray, arrays)
    packs = {"lightpe1": quantize_params(params, "lightpe1",
                                         min_size=check.MIN_SIZE)}
    ties = pow2_ties(arrays, packs["lightpe1"])
    del arrays
    prompts = check.prompts(cfg.vocab, check.GEMMA_PROMPT_LENS)
    out = dict(
        config=cfg.name, size=size,
        xla_flags=os.environ.get("XLA_FLAGS", ""),
        batch_slots=check.BATCH_SLOTS, max_len=check.GEMMA_MAX_LEN,
        max_new=check.MAX_NEW, min_size=check.MIN_SIZE,
        param_seed=check.PARAM_SEED,
        prompts=[p.tolist() for p in prompts], dense_bytes=dense_bytes,
        pow2_ties=ties, modes={})
    for pe, dtype in modes:
        if pe not in packs:
            packs[pe] = quantize_params(params, pe, min_size=check.MIN_SIZE)
        engine = ServeEngine(cfg.replace(dtype=dtype), mod, packs[pe],
                             check.BATCH_SLOTS, check.GEMMA_MAX_LEN)
        out["modes"][check.mode_key(pe, dtype)] = dict(
            pe_type=pe, dtype=dtype,
            packed_bytes=int(packed_bytes(packs[pe])),
            run4=check.record(engine, prompts, check.MAX_NEW, np.asarray))
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

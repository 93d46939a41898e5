"""The JAX package's RWKV6-1.6B and Zamba2-7B serving runs that
``chip_smoke.py`` phase 13 holds the port to.

``build_reference`` draws each model's params with numpy (the port's
``rwkv.numpy_params`` / ``hybrid.numpy_params``, seed 0) at full width
with the depth cut (RWKV6-1.6B: 4 of 24 layers, 2 GB of float32 weights;
Zamba2-7B: 13 of 81 layers, two groups of 6 (so both shared blocks) and
a tail of 1, 6.6 GB: no full-size configuration runs on the CPU that
writes the file), and serves the serving smoke's 4 prompts (8-130
tokens, 4 slots, 12 new tokens) on those dense float32 weights through
the JAX package's ``ServeEngine`` in bfloat16 under the FP32 preset and
the QAT numerics of LightPE-1 and INT8 (at full width the reference
cannot serve either model on packed codes, ROADMAP C).  It also serves
both reduced configs on LightPE-1 and INT8 codes (``quantize_params`` at
its default floor: RWKV packs ``layers/cm/wk``, ``layers/cm/wv`` and the
head, Zamba2 ``tail/mamba/in_proj`` and the head), with the LightPE-1
codes at log2 ties kept (``pow2_ties``).  Every step is recorded with
``repro_torch.serve.check.record``.  ``tests/data/torch_ssm_ref.json``
holds the full-size result; ``tests/test_torch_ssm.py`` rebuilds it at
the reduced size to keep the format honest.

  PYTHONPATH=src:tests python tests/_torch_ssm_ref.py   # rewrite the file

Run as a script it turns off XLA's excess precision before JAX starts
(as ``_torch_serve_ref.py`` does).  At full size it takes about 12 GB and
some minutes of CPU.

``--reduced OUT.json`` writes the same file at the reduced size (the
CPU test of its format).  ``--cases OUT.pkl`` writes instead the JAX
side of the CPU tests' model
comparisons (``run_case``): each reduced model of ``CASES`` on the
decoder tests' token seeds, ``forward``, ``prefill`` and ``decode_step``,
with the activation codes and the bfloat16 roundings (at
``_torch_act_pins.SSM_ROUND_SITES``) that the port pins at ties.
"""

import json
import os
import time
from pathlib import Path

import numpy as np

REF_PATH = Path(__file__).resolve().parent / "data" / "torch_ssm_ref.json"
# full width, depth cut to this many layers
CUT_LAYERS = {"rwkv6-1.6b": 4, "zamba2-7b": 13}
# (pe_type, dtype) of the runs on the dense float32 weights, and on codes
DENSE_MODES = (("fp32", "bfloat16"), ("lightpe1", "bfloat16"),
               ("int8", "bfloat16"))
PACKED_MODES = (("lightpe1", "bfloat16"), ("int8", "bfloat16"))
PACK_MIN_SIZE = 1 << 14          # quantize_params' default floor
NO_EXCESS_PRECISION = "--xla_allow_excess_precision=false"


def reference_config(name: str, size: str):
    from repro.configs import get, reduced
    if size == "full":
        return get(name).replace(n_layers=CUT_LAYERS[name])
    return reduced(name)


def _numpy_params(cfg):
    from repro_torch.configs import get
    from repro_torch.models import family_module
    from repro_torch.serve import check
    mod = family_module(get(cfg.name))
    return mod.numpy_params(cfg, check.PARAM_SEED)


def _header(cfg, size, arrays, prompts) -> dict:
    import jax
    from repro_torch.serve import check
    return dict(config=cfg.name, size=size, n_layers=cfg.n_layers,
                xla_flags=os.environ.get("XLA_FLAGS", ""),
                batch_slots=check.BATCH_SLOTS, max_len=check.MAX_LEN,
                max_new=check.MAX_NEW, param_seed=check.PARAM_SEED,
                prompts=[p.tolist() for p in prompts],
                dense_bytes=int(sum(a.nbytes
                                    for a in jax.tree.leaves(arrays))),
                modes={})


def dense_runs(name: str, size: str, modes=DENSE_MODES) -> dict:
    """``name`` at ``size`` ("full": full width, depth cut) on its dense
    float32 weights, served under each of ``modes``."""
    import jax
    import jax.numpy as jnp
    from repro.models import family_module
    from repro.serve import ServeEngine
    from repro_torch.serve import check

    cfg = reference_config(name, size)
    mod = family_module(cfg)
    arrays = _numpy_params(cfg)
    prompts = check.prompts(cfg.vocab, check.PROMPT_LENS)
    out = _header(cfg, size, arrays, prompts)
    params = jax.tree.map(jnp.asarray, arrays)
    del arrays
    for pe, dtype in modes:
        engine = ServeEngine(cfg.replace(pe_type=pe, dtype=dtype), mod,
                             params, check.BATCH_SLOTS, check.MAX_LEN)
        out["modes"][check.mode_key(pe, dtype)] = dict(
            pe_type=pe, dtype=dtype,
            run4=check.record(engine, prompts, check.MAX_NEW, np.asarray))
        del engine
    return out


def packed_runs(name: str, modes=PACKED_MODES) -> dict:
    """The reduced ``name`` packed by the JAX package's
    ``quantize_params`` as each PE type of ``modes`` and served so."""
    import jax
    import jax.numpy as jnp
    from repro.models import family_module
    from repro.serve import ServeEngine, packed_bytes, quantize_params
    from repro_torch.serve import check
    from _torch_gemma3_ref import pow2_ties

    cfg = reference_config(name, "reduced")
    mod = family_module(cfg)
    arrays = _numpy_params(cfg)
    prompts = check.prompts(cfg.vocab, check.PROMPT_LENS)
    out = _header(cfg, "reduced", arrays, prompts)
    out["min_size"] = PACK_MIN_SIZE
    params = jax.tree.map(jnp.asarray, arrays)
    for pe, dtype in modes:
        packed = quantize_params(params, pe, min_size=PACK_MIN_SIZE)
        if pe == "lightpe1":
            out["pow2_ties"] = pow2_ties(arrays, packed)
        engine = ServeEngine(cfg.replace(dtype=dtype), mod, packed,
                             check.BATCH_SLOTS, check.MAX_LEN)
        out["modes"][check.mode_key(pe, dtype)] = dict(
            pe_type=pe, dtype=dtype,
            packed_bytes=int(packed_bytes(packed)),
            packed_leaves=check.packed_leaves(packed),
            run4=check.record(engine, prompts, check.MAX_NEW, np.asarray))
    return out


CASES = [(name, pe, dtype) for name in CUT_LAYERS
         for pe in ("fp32", "lightpe1") for dtype in ("float32", "bfloat16")]
TOKEN_SEEDS = (0, 1, 2, 3)


def run_case(name: str, pe: str, dtype: str, acts, rounds) -> dict:
    """{seed: runs} of one reduced model and numerics, as
    ``_torch_decoder_ref.run_case`` records a decoder's: ``forward`` on 2
    x 20 tokens; ``prefill`` of the first 17 into a 24-row cache and 3
    ``decode_step``s; each pass's activation log (``acts``, an open
    ``jax_act_log``) and rounding log (``rounds``, an open
    ``jax_round_log(SSM_ROUND_SITES)``)."""
    import jax
    import jax.numpy as jnp
    from repro.models import family_module
    from _torch_decoder_ref import BATCH, MAX_LEN, PROMPT, SEQ, tokens

    cfg = reference_config(name, "reduced").replace(pe_type=pe, dtype=dtype)
    mod = family_module(cfg)
    params = jax.tree.map(jnp.asarray, _numpy_params(cfg))
    forward = jax.jit(mod.forward, static_argnums=2)
    prefill = jax.jit(mod.prefill, static_argnums=2)
    decode = jax.jit(mod.decode_step, static_argnums=2)
    runs = {}
    for seed in TOKEN_SEEDS:
        toks = jnp.asarray(tokens(cfg.vocab, seed))
        out = {"forward": np.asarray(forward(params, toks, cfg), np.float32)}
        out["forward_acts"] = acts.drain()
        out["forward_rounds"] = {k: v.drain() for k, v in rounds.items()}
        cache = mod.init_cache(cfg, BATCH, MAX_LEN, jnp.float32)
        logits, cache = prefill(params, toks[:, :PROMPT], cfg, cache)
        steps = [np.asarray(logits, np.float32)]
        for i in range(PROMPT, SEQ):
            logits, cache = decode(params, toks[:, i:i + 1], cfg, cache)
            steps.append(np.asarray(logits, np.float32))
        out["steps"] = np.concatenate(steps, axis=1)
        out["step_acts"] = acts.drain()
        out["step_rounds"] = {k: v.drain() for k, v in rounds.items()}
        runs[seed] = out
    return runs


def build_reference(size: str = "full") -> dict:
    return {"dense": {name: dense_runs(name, size) for name in CUT_LAYERS},
            "packed": {name: packed_runs(name) for name in CUT_LAYERS}}


if __name__ == "__main__":
    import sys
    os.environ["XLA_FLAGS"] = " ".join(
        filter(None, [os.environ.get("XLA_FLAGS"), NO_EXCESS_PRECISION]))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if sys.argv[1:2] == ["--cases"]:
        import pickle
        from _torch_act_pins import (SSM_ROUND_SITES, jax_act_log,
                                     jax_round_log)
        with jax_act_log() as acts, jax_round_log(SSM_ROUND_SITES) as rounds:
            result = {case: run_case(*case, acts, rounds) for case in CASES}
        with open(sys.argv[2], "wb") as f:
            pickle.dump(result, f)
        sys.exit(0)
    size, path = ("reduced", Path(sys.argv[2])) \
        if sys.argv[1:2] == ["--reduced"] else ("full", REF_PATH)
    t0 = time.perf_counter()
    ref = build_reference(size)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(ref) + "\n")
    print(f"wrote {path} in {time.perf_counter() - t0:.1f} s")

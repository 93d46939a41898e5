"""The JAX package's training steps of the families whose attention
gradient needs the backward kernel's windows, soft-caps and head_dims
16 / 32 / 112 / 256: the reduced Gemma-3-1B (window 8, head_dim 32, and
at head_dim 256), Gemma-2-9B at head_dim 256 (window 8, attention
soft-cap 50, final soft-cap 30) and Zamba2-7B at head_dim 112 (its
shared attention).

``build_reference`` runs ``repro_torch.train_check``'s LM run with the
JAX package for each ``CASES`` entry (in float32, the FP32 preset): params
from the port's ``numpy_params`` (each family's), ``LM_STEPS`` AdamW
steps of ``repro.train.make_train_step`` (warmup-cosine, clip 1.0, one
microbatch) on ``train_check.lm_batch``'s numpy tokens (``BATCH`` x
``SEQ``: every local layer's window of 8 is active), each step's loss
and gradient norm.
``tests/test_torch_train_families.py`` holds the port's CPU runs to
``tests/data/torch_train_families_ref.json``, and ``chip_smoke.py`` (phase
16.4) the card's, on a machine without JAX:

  PYTHONPATH=src:tests python tests/_torch_train_families_ref.py

Run as a script it turns off XLA's excess precision before JAX starts,
so that bfloat16 is rounded where the model's source rounds it, as the
port does (~20 s here).
"""

import json
import os
import time
from pathlib import Path

REF_PATH = (Path(__file__).resolve().parent / "data"
            / "torch_train_families_ref.json")
NO_EXCESS_PRECISION = "--xla_allow_excess_precision=false"
# name: (config, overrides of its reduced form)
CASES = {
    "gemma3-1b": ("gemma3-1b", {}),
    "gemma3-1b/hd256": ("gemma3-1b", {"head_dim": 256}),
    "gemma2-9b/hd256": ("gemma2-9b", {"head_dim": 256}),
    "zamba2-7b/hd112": ("zamba2-7b", {"head_dim": 112}),
}
# the FP32 preset only: under QAT numerics an 8-bit activation code or a
# pow2 weight code at a tie, which float32 sums in another order flip,
# moves a reduced model's steps by up to 1.3e-2 between the packages,
# more than the kernels are held to
PE_TYPES = ("fp32",)
BATCH, SEQ = 2, 64


def config(name: str, reduced):
    """The reduced config of case ``name`` (from ``reduced``: the port's
    or the JAX package's) with its overrides, in float32."""
    arch, overrides = CASES[name]
    return reduced(arch).replace(dtype="float32", **overrides)


def build_reference(names=None, pe_types=PE_TYPES) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced as jax_reduced
    from repro.models import family_module as jax_family
    from repro.optim import adamw, warmup_cosine
    from repro.train import TrainState, make_train_step
    from repro_torch import train_check as tc
    from repro_torch.configs import reduced
    from repro_torch.models import family_module

    out = dict(xla_flags=os.environ.get("XLA_FLAGS", ""),
               lm=dict(batch=BATCH, seq=SEQ, steps=tc.LM_STEPS,
                       schedule=list(tc.LM_SCHEDULE), clip=tc.LM_CLIP,
                       param_seed=tc.PARAM_SEED, data_seed=tc.DATA_SEED),
               cases={}, seconds={})
    for name in names or CASES:
        cfg = config(name, reduced)
        arrays = family_module(cfg).numpy_params(cfg, tc.PARAM_SEED)
        runs = {}
        for pe in pe_types:
            t0 = time.perf_counter()
            jcfg = config(name, jax_reduced).replace(pe_type=pe)
            opt = adamw(warmup_cosine(*tc.LM_SCHEDULE))
            params = jax.tree.map(jnp.asarray, arrays)
            state = TrainState(params, opt.init(params),
                               jnp.zeros((), jnp.int32))
            step = jax.jit(make_train_step(jcfg, jax_family(jcfg), opt,
                                           n_micro=1, clip_norm=tc.LM_CLIP))
            rows = []
            for i in range(tc.LM_STEPS):
                batch = {k: jnp.asarray(v) for k, v in
                         tc.lm_batch(cfg.vocab, i, BATCH, SEQ).items()}
                state, m = step(state, batch)
                rows.append([float(m["loss"]), float(m["grad_norm"])])
            runs[pe] = rows
            out["seconds"][f"{name}/{pe}"] = time.perf_counter() - t0
        arch, overrides = CASES[name]
        out["cases"][name] = dict(
            config=arch, overrides=overrides, head_dim=cfg.head_dim,
            window=cfg.window, softcap=cfg.attn_softcap, dtype=cfg.dtype,
            runs=runs)
    return out


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = " ".join(
        filter(None, [os.environ.get("XLA_FLAGS"), NO_EXCESS_PRECISION]))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    t0 = time.perf_counter()
    ref = build_reference()
    REF_PATH.write_text(json.dumps(ref, indent=1) + "\n")
    print(f"wrote {REF_PATH} in {time.perf_counter() - t0:.1f} s")
    for name, case in ref["cases"].items():
        print(name, json.dumps(case["runs"]))

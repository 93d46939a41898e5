"""The JAX package's DeepSeek-MoE-16B serving runs that ``chip_smoke.py``
phase 11.3 holds the port to, and the JAX side of the port's routing
record (``jax_router_log``).

``build_reference`` draws DeepSeek-MoE-16B's params at full width with
its depth cut to 3 layers (the leading dense layer and 2 MoE layers:
full depth in float32 is 65.6 GB, and the reference cannot serve the MoE
packed, ROADMAP C) with numpy (``numpy_params``, seed 0), and serves the
serving smoke's 4 prompts (8-130 tokens, 4 slots, 12 new tokens) on
those dense float32 weights through the JAX package's ``ServeEngine`` in
bfloat16 under the FP32 preset and under the QAT numerics of LightPE-1
and INT8, recording every step with ``repro_torch.serve.check.record``,
the routing of every MoE layer included.  Each run also counts its
router near ties (margins below ``ROUTER_TOL``) and the assignments
dropped past capacity.  ``tests/data/torch_moe_ref.json`` holds the
full-size result; ``tests/test_torch_moe.py`` rebuilds it at the reduced
size to keep the format honest.

  PYTHONPATH=src:tests python tests/_torch_moe_ref.py   # rewrite the file

Run as a script it turns off XLA's excess precision before JAX starts
(as ``_torch_serve_ref.py`` does).  At full size it takes about 15 GB
and a few minutes of CPU.
"""

import contextlib
import json
import os
import time
from pathlib import Path

import numpy as np

REF_PATH = Path(__file__).resolve().parent / "data" / "torch_moe_ref.json"
CONFIG = "deepseek-moe-16b"
FULL_LAYERS = 3            # 1 dense + 2 MoE
# (pe_type, dtype) of the runs on the dense float32 weights
MODES = (("fp32", "bfloat16"), ("lightpe1", "bfloat16"),
         ("int8", "bfloat16"))
# a router margin (k-th over (k+1)-th probability) below this is a near
# tie, which float32 sums in another order may flip: at full width in
# bfloat16 the port's margins of tokens routed alike sit up to 4.7e-4
# (FP32 preset) and 1.5e-3 (INT8) from the reference's at the first MoE
# layer, on the CPU as on the card (benchmarks/torch_router_noise.py)
ROUTER_TOL = 5e-3
NO_EXCESS_PRECISION = "--xla_allow_excess_precision=false"


class _Log:
    def __init__(self):
        self.calls = []

    def drain(self):
        calls, self.calls = self.calls, []
        return calls


@contextlib.contextmanager
def jax_router_log():
    """While open, every call of the JAX package's ``moe_apply`` (under jit
    too) reports its routing to the host: (ids (B, S, k) in increasing
    expert id, margin (B, S)), what ``repro_torch.models.moe.RouterLog``
    records on the port's side.  The JAX package is not edited: its
    module attribute is wrapped and put back."""
    import jax
    import jax.numpy as jnp
    from repro.models import moe as JM

    log = _Log()
    inner = JM.moe_apply

    def logged(p, x, cfg, qcfg):
        b, s, d = x.shape
        k, e = cfg.moe_topk, cfg.moe_experts
        logits = (x.reshape(b * s, d).astype(jnp.float32)
                  @ p["router"].astype(jnp.float32))
        probs = jax.nn.softmax(logits, axis=-1)
        vals, ids = jax.lax.top_k(probs, min(k + 1, e))
        margin = (vals[:, k - 1] - vals[:, k] if k < e
                  else jnp.full((b * s,), jnp.inf, jnp.float32))
        ids = jnp.sort(ids[:, :k], axis=-1)

        def host(i, m):
            log.calls.append((np.asarray(i).reshape(b, s, k),
                              np.asarray(m).reshape(b, s)))

        jax.debug.callback(host, ids, margin, ordered=True)
        return inner(p, x, cfg, qcfg)

    JM.moe_apply = logged
    try:
        yield log
    finally:
        JM.moe_apply = inner


def reference_config(size: str):
    from repro.configs import get, reduced
    if size == "full":
        return get(CONFIG).replace(n_layers=FULL_LAYERS)
    return reduced(CONFIG)


def route_stats(run: dict, cfg) -> dict:
    """Near ties (margins below ROUTER_TOL) and dropped assignments of a
    recorded run, over its requests, steps and MoE layers; drops per step
    from the batch's routes (the requests run in lockstep)."""
    from repro_torch.models.moe import dropped
    margins = [m for req in run["route_margins"] for step in req
               for layer in step for m in layer]
    drops = []
    for t in range(len(run["routes"][0])):
        layers = len(run["routes"][0][t])
        drops.append([dropped(np.array([req[t][layer]
                                        for req in run["routes"]]), cfg)
                      for layer in range(layers)])
    return dict(near_ties=int(np.sum(np.asarray(margins) < ROUTER_TOL)),
                margins=len(margins), min_margin=float(np.min(margins)),
                dropped=drops)


def build_reference(size: str = "full", modes=MODES) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.models import family_module
    from repro_torch.models.transformer import numpy_params
    from repro_torch.serve import check
    from repro.serve import ServeEngine

    cfg = reference_config(size)
    mod = family_module(cfg)
    arrays = numpy_params(cfg, check.PARAM_SEED)
    dense_bytes = int(sum(a.nbytes for a in jax.tree.leaves(arrays)))
    params = jax.tree.map(jnp.asarray, arrays)
    del arrays
    prompts = check.prompts(cfg.vocab, check.PROMPT_LENS)
    out = dict(
        config=cfg.name, size=size, n_layers=cfg.n_layers,
        xla_flags=os.environ.get("XLA_FLAGS", ""),
        batch_slots=check.BATCH_SLOTS, max_len=check.MAX_LEN,
        max_new=check.MAX_NEW, param_seed=check.PARAM_SEED,
        router_tol=ROUTER_TOL, prompts=[p.tolist() for p in prompts],
        dense_bytes=dense_bytes, modes={})
    for pe, dtype in modes:
        run_cfg = cfg.replace(pe_type=pe, dtype=dtype)
        with jax_router_log() as log:
            engine = ServeEngine(run_cfg, mod, params, check.BATCH_SLOTS,
                                 check.MAX_LEN)
            run = check.record(engine, prompts, check.MAX_NEW, np.asarray,
                               router=log)
        out["modes"][check.mode_key(pe, dtype)] = dict(
            pe_type=pe, dtype=dtype, run4=run, routing=route_stats(run, cfg))
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

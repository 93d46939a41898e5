"""The JAX package's training steps that the port's training is held to.

``build_reference`` runs ``repro_torch.train_check``'s runs with the JAX
package: SmolLM-135M (params from
``repro_torch.models.transformer.numpy_params``) for ``LM_STEPS`` AdamW
steps of ``repro.train.make_train_step`` on numpy tokens under FP32 and
LightPE-1, and ResNet-8 (``repro_torch.models.cnn.numpy_resnet``) for
``CNN_STEPS`` SGD-Nesterov steps on numpy images under FP32, INT16,
LightPE-1 and LightPE-2, and records each step's loss and gradient norm.
``tests/data/torch_train_ref.json`` holds the full-width result, which
``chip_smoke.py`` (phase 10) holds the port to on a machine without JAX;
``tests/test_torch_train_qat.py`` rebuilds it at the reduced size to keep
the format honest and holds the port's CPU run to it.

  PYTHONPATH=src:tests python tests/_torch_train_ref.py   # rewrite the file

Run as a script it turns off XLA's excess precision before JAX starts, so
that bfloat16 is rounded where the model's source rounds it, as the port
does.
"""

import json
import os
import time
from pathlib import Path

REF_PATH = Path(__file__).resolve().parent / "data" / "torch_train_ref.json"
NO_EXCESS_PRECISION = "--xla_allow_excess_precision=false"


def build_reference(size: str = "full", lm_pe_types=None,
                    cnn_pe_types=None) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get, reduced
    from repro.models import cnn, family_module
    from repro.optim import (adamw, paper_step_decay, sgd_nesterov,
                             warmup_cosine)
    from repro.train import TrainState, make_train_step
    from repro_torch import train_check as tc
    from repro_torch.models.cnn import numpy_resnet
    from repro_torch.models.transformer import numpy_params

    cfg = (get if size == "full" else reduced)("smollm-135m")
    out = dict(
        config=cfg.name, size=size,
        xla_flags=os.environ.get("XLA_FLAGS", ""),
        lm=dict(batch=tc.LM_BATCH, seq=tc.LM_SEQ, steps=tc.LM_STEPS,
                schedule=list(tc.LM_SCHEDULE), clip=tc.LM_CLIP,
                param_seed=tc.PARAM_SEED, data_seed=tc.DATA_SEED, runs={}),
        cnn=dict(depth=tc.CNN_DEPTH, batch=tc.CNN_BATCH, steps=tc.CNN_STEPS,
                 schedule=list(tc.CNN_SCHEDULE),
                 weight_decay=tc.CNN_WEIGHT_DECAY, runs={}),
        seconds={})
    arrays = numpy_params(cfg, tc.PARAM_SEED)
    for pe in lm_pe_types or tc.LM_PE_TYPES:
        t0 = time.perf_counter()
        run_cfg = cfg.replace(pe_type=pe)
        mod = family_module(run_cfg)
        opt = adamw(warmup_cosine(*tc.LM_SCHEDULE))
        params = jax.tree.map(jnp.asarray, arrays)
        state = TrainState(params, opt.init(params),
                           jnp.zeros((), jnp.int32))
        step = jax.jit(make_train_step(run_cfg, mod, opt, n_micro=1,
                                       clip_norm=tc.LM_CLIP))
        rows = []
        for i in range(tc.LM_STEPS):
            batch = {k: jnp.asarray(v) for k, v in
                     tc.lm_batch(cfg.vocab, i).items()}
            state, m = step(state, batch)
            rows.append([float(m["loss"]), float(m["grad_norm"])])
        out["lm"]["runs"][pe] = rows
        out["seconds"][f"lm/{pe}"] = time.perf_counter() - t0

    cnn_arrays = numpy_resnet(tc.CNN_DEPTH, 10, tc.PARAM_SEED)
    for pe in cnn_pe_types or tc.CNN_PE_TYPES:
        t0 = time.perf_counter()
        opt = sgd_nesterov(paper_step_decay(*tc.CNN_SCHEDULE),
                           weight_decay=tc.CNN_WEIGHT_DECAY)

        def train_step(params, ostate, batch, pe=pe, opt=opt):
            (loss, _acc), grads = jax.value_and_grad(
                lambda p: cnn.cnn_loss(cnn.resnet_apply, p, batch, pe),
                has_aux=True)(params)
            gnorm = jnp.sqrt(sum(jnp.sum(jnp.square(g))
                                 for g in jax.tree.leaves(grads)))
            params, ostate = opt.update(grads, ostate, params)
            return params, ostate, loss, gnorm

        step = jax.jit(train_step)
        params = jax.tree.map(jnp.asarray, cnn_arrays)
        ostate = opt.init(params)
        rows = []
        for i in range(tc.CNN_STEPS):
            batch = {k: jnp.asarray(v)
                     for k, v in tc.image_batch_np(i).items()}
            params, ostate, loss, gnorm = step(params, ostate, batch)
            rows.append([float(loss), float(gnorm)])
        out["cnn"]["runs"][pe] = rows
        out["seconds"][f"cnn/{pe}"] = time.perf_counter() - t0
    return out


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = " ".join(
        filter(None, [os.environ.get("XLA_FLAGS"), NO_EXCESS_PRECISION]))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    t0 = time.perf_counter()
    ref = build_reference("full")
    REF_PATH.write_text(json.dumps(ref, indent=1) + "\n")
    print(f"wrote {REF_PATH} in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(ref['lm']['runs'])} {json.dumps(ref['cnn']['runs'])}")

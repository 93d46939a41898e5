#!/usr/bin/env python3
"""How far the port's DeepSeek-MoE-16B runs sit from the JAX package's,
on the weights and prompts of ``tests/data/torch_moe_ref.json`` (full
width, 3 layers, bfloat16): the router margins, and with ``--serve`` the
served logits.

Without ``--serve`` it runs, for each of the file's modes, the port's
prefill of the serving prompts (left-padded as ``ServeEngine`` pads them)
under a ``models.moe.RouterLog`` and prints, per MoE layer, how many
tokens are routed as the reference routes them and the largest
difference of their router margin (the k-th over the (k+1)-th
probability) from the reference's.  At the first MoE layer no routing
difference feeds the input, so that difference is the two packages'
numeric noise, which a near-tie tolerance
(``tests/_torch_moe_ref.ROUTER_TOL``) must exceed.

With ``--serve`` it serves the file's prompts as ``chip_smoke.py`` phase
11.3 does (``ServeEngine``, the reference's experts pinned at its router
near ties by ``models.moe.RoutePins``) and prints, per mode, the largest
logit difference from the reference over the steps compared
(``serve.check``), the steps compared and the tokens pinned.  On the CPU
(``--device cpu``: the kernels' plain versions, other float32 sum
orders) that is the noise between two correct runs, which the smoke's
logit tolerance must exceed.  ``--stack-as-one`` is its control: every
expert weight stack fake-quantized as one (E, d, f) tensor, one scale a
column over all experts, a wrong function the tolerance must refuse.

  PYTHONPATH=src python benchmarks/torch_router_noise.py [--device cpu]
      [--serve [--stack-as-one]] [--out <json>]

On the CPU it needs about 14 GB and a minute (``--serve``: about 20 GB
and a few minutes).
"""

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import get
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T

REF = Path(__file__).resolve().parents[1] / "tests" / "data" / \
    "torch_moe_ref.json"


def margins(ref, cfg, params, device):
    prompts = ref["prompts"]
    toks = np.zeros((len(prompts), max(len(p) for p in prompts)), np.int64)
    for i, p in enumerate(prompts):
        toks[i, -len(p):] = p
    toks = torch.as_tensor(toks, device=device)
    out = {}
    for key, mode in ref["modes"].items():
        run = cfg.replace(pe_type=mode["pe_type"], dtype=mode["dtype"])
        cache = T.init_cache(run, len(prompts), ref["max_len"], torch.float32,
                             device=device)
        with MOE.RouterLog() as log:
            T.prefill(params, toks, run, cache)
        want = mode["run4"]
        rows = []
        for layer, (ids, margin) in enumerate(log.drain()):
            ref_ids = np.array([r[0][layer] for r in want["routes"]])
            ref_margin = np.array([r[0][layer] for r in want["route_margins"]])
            alike = np.all(ids == ref_ids, axis=-1)
            noise = float(np.abs(margin - ref_margin)[alike].max())
            rows.append(dict(layer=layer, alike=int(alike.sum()),
                             tokens=int(alike.size), margin_noise=noise))
            print(f"{key} MoE layer {layer}: {alike.sum()} of {alike.size} "
                  f"prefill tokens routed as the reference routes them; "
                  f"their margins within {noise:.3g} of the reference's")
        out[key] = rows
    return out


def served(ref, cfg, params):
    from repro_torch.serve import ServeEngine, check

    prompts = [np.array(p) for p in ref["prompts"]]
    out = {}
    for key, mode in ref["modes"].items():
        run = cfg.replace(pe_type=mode["pe_type"], dtype=mode["dtype"])
        eng = ServeEngine(run, T, params, ref["batch_slots"], ref["max_len"])
        pins = MOE.RoutePins(ref["router_tol"])
        want = mode["run4"]
        with MOE.RouterLog() as log, pins:
            rec = check.record(eng, prompts, ref["max_new"],
                               lambda t: t.float().cpu().numpy(), router=log,
                               pins=pins, want=want)
        coupled = mode["pe_type"] != "fp32"
        cuts, problems, _ = check.route_cut(
            rec, want, ref["router_tol"], coupled,
            lambda tokens: MOE.capacity(tokens, cfg))
        steps = check.compared_steps(rec, want, coupled, cuts)
        err = check.max_logit_err(rec, want, coupled, cuts)
        out[key] = dict(max_logit_err=err, steps_compared=steps,
                        pinned=pins.pinned, route_problems=len(problems))
        print(f"{key}: max logit err {err:.4g} over steps {steps} of "
              f"{ref['max_new']}; {pins.pinned} tokens pinned; "
              f"{len(problems)} routing differences at a margin >= "
              f"{ref['router_tol']}")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--stack-as-one", action="store_true")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    ref = json.loads(REF.read_text())
    cfg = get(ref["config"]).replace(n_layers=ref["n_layers"])
    params = convert.params_from_numpy(T.numpy_params(cfg, ref["param_seed"]),
                                       args.device)
    if args.stack_as_one:
        from repro_torch.quant.fake_quant import fake_quant_weight
        MOE.fake_quant_experts = fake_quant_weight
    result = {"device": str(args.device), "stack_as_one": args.stack_as_one}
    if args.serve:
        result["served"] = served(ref, cfg, params)
    else:
        result["router_noise"] = margins(ref, cfg, params, args.device)
    if str(args.device).startswith("cuda"):
        import subprocess
        result["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    print(json.dumps(result))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()

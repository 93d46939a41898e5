"""How far the port's RWKV6-1.6B and Zamba2-7B serving runs sit from the
JAX package's, and how far the reference's own runs sit from each other.

  python3 benchmarks/torch_ssm_noise.py [--device cpu] [--out JSON]

Serves each model of ``tests/data/torch_ssm_ref.json`` at its cut depth
(full width, the reference's numpy weights) on the given device (default
the card; ``cpu`` takes the kernels' plain versions), the serving smoke's
4 prompts in 4 slots, 12 new tokens, in bfloat16 under the FP32 preset
and the QAT numerics of LightPE-1 and INT8, and prints for each run the
largest logit difference from the reference's run over the steps both
fed the same tokens (QAT runs coupled across the batch, as
``chip_smoke.py`` phase 13 compares them).  Beside it, the reference's
own runs against each other (LightPE-1 against INT8, each against the
FP32 preset): the distances a served check must tell apart.  Two correct
runs of the QAT model differ where float32 sums in another order flip a
bfloat16 rounding and 8-bit activation codes carry the flip on, which is
what the first number measures on the CPU (another sum order than XLA's,
no kernel involved).  Takes about 4 minutes on 8 CPU cores.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
REF = ROOT / "tests" / "data" / "torch_ssm_ref.json"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.configs import get
    from repro_torch.device import resolve_device
    from repro_torch.models import family_module
    from repro_torch.serve import ServeEngine, check

    dev = resolve_device(args.device)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else f"cpu, {torch.get_num_threads()} threads")
    print(f"device: {where}")
    ref = json.loads(REF.read_text())["dense"]
    rows = []
    for name, r in ref.items():
        cfg = get(name).replace(n_layers=r["n_layers"])
        mod = family_module(cfg)
        params = convert.params_from_numpy(
            mod.numpy_params(cfg, r["param_seed"]), dev)
        prompts = [np.array(p) for p in r["prompts"]]
        for key, m in r["modes"].items():
            run = cfg.replace(pe_type=m["pe_type"], dtype=m["dtype"])
            eng = ServeEngine(run, mod, params, r["batch_slots"],
                              r["max_len"])
            rec = check.record(eng, prompts, r["max_new"],
                               lambda t: t.float().cpu().numpy())
            coupled = m["pe_type"] != "fp32"
            err = check.max_logit_err(rec, m["run4"], coupled)
            steps = check.compared_steps(rec, m["run4"], coupled)
            rows.append(dict(config=name, mode=key, device=where,
                             max_logit_err=err, steps_compared=steps))
            print(f"{name} {key}: port against the reference {err:.4f} "
                  f"(steps compared {steps})")
        for a, b in (("lightpe1", "int8"), ("lightpe1", "fp32"),
                     ("int8", "fp32")):
            ra, rb = r["modes"][a]["run4"], r["modes"][b]["run4"]
            err = check.max_logit_err(ra, rb, True)
            rows.append(dict(config=name, mode=f"{a} vs {b}",
                             device="reference file", max_logit_err=err))
            print(f"{name}: the reference's {a} run against its {b} run "
                  f"{err:.4f}")
        del params
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1) + "\n")


if __name__ == "__main__":
    main()

"""How far a last-bit change of the activations moves the logits of the
model under QAT numerics, on the card.

  python3 benchmarks/torch_qat_sensitivity.py [--out results/torch/qat_sensitivity.json]

SmolLM-135M at full width on its numpy-drawn dense weights (the serving
reference's seed), the serving smoke's 4 prompts left-padded into one
batch as ``ServeEngine`` pads a prefill, in float32: the logits of the
last position (a) as they are and (b) with every other element of the
embedded tokens, where the residual stream starts, moved up by one
float32 ulp, under fp32 numerics (no fake quantization) and under each
quantizing PE type.
Also the activation codes that differ between (a) and (b) at the first
fake-quantized activation (layer 0's input to wq), out of all of them,
and (a) run twice (the card gives the same bits).

A last-bit difference is what another order of float32 sums gives, so
(b) - (a) is the scale at which two correct runs of the QAT model (the
card's and the JAX package's on the CPU) can differ: an activation code
at a round(x / s) tie flips by one step of absmax / qmax, and the layers
after it carry that on.  Prints one line per PE type and writes them, with
the card's name and power limit, to ``--out``.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PE_TYPES = ("fp32", "int16", "lightpe1", "lightpe2", "int8")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=ROOT / "results" / "torch"
                    / "qat_sensitivity.json")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_qat_sensitivity needs a CUDA card")
    from repro_torch import convert
    from repro_torch.configs import get
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.quant.fake_quant import affine_quantize, affine_scale
    from repro_torch.serve import check

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda")
    cfg = get("smollm-135m").replace(dtype="float32")
    params = convert.params_from_numpy(T.numpy_params(cfg, check.PARAM_SEED),
                                       dev)
    prompts = check.prompts(cfg.vocab)
    toks = np.zeros((len(prompts), max(len(p) for p in prompts)), np.int64)
    for i, p in enumerate(prompts):
        toks[i, -len(p):] = p
    toks = torch.as_tensor(toks, device=dev)
    embed, act = T._embed, L.fake_quant_act

    def nudged(p, t, c):
        x = embed(p, t, c)
        up = torch.nextafter(x, torch.full_like(x, float("inf")))
        every_other = torch.arange(x.numel(), device=x.device) % 2 == 0
        return torch.where(every_other.view(x.shape), up, x)

    def run(pe, nudge):
        first = []

        def record(x, qcfg):
            if not first:   # the integer codes, not the STE's sum
                bits = qcfg.act_bits
                first.append(affine_quantize(x, affine_scale(x, bits), bits))
            return act(x, qcfg)

        T._embed = nudged if nudge else embed
        L.fake_quant_act = record
        try:
            logits = T.forward(params, toks, cfg.replace(pe_type=pe))[:, -1]
        finally:
            T._embed, L.fake_quant_act = embed, act
        return logits, (first[0] if first else None)

    rows = []
    for pe in PE_TYPES:
        (a, qa), (b, qb) = run(pe, False), run(pe, True)
        again = run(pe, False)[0]
        row = dict(pe_type=pe, dtype="float32",
                   max_logit_diff=float((a - b).abs().max()),
                   repeat_equal=bool(torch.equal(a, again)),
                   first_act_codes_differing=(None if qa is None else
                                              int((qa != qb).sum())),
                   first_act_codes=None if qa is None else qa.numel())
        rows.append(row)
        print(f"{pe}: max |logit (b) - logit (a)| = {row['max_logit_diff']:.4g}"
              f"; first activation's codes differing: "
              f"{row['first_act_codes_differing']} of {row['first_act_codes']}"
              f"; (a) twice bitwise equal: {row['repeat_equal']}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(card=card, rows=rows), indent=1))


if __name__ == "__main__":
    main()

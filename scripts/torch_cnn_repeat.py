"""Repeats of one trial of the Figs. 5-6 run on the card: ResNet-8 from
one seed, trained ``--steps`` steps under each PE type, ``--runs`` times
with cuDNN's convolutions deterministic and again with its default
algorithms.  Each run prints its top-1 on the held-out set, a hash of
its trained params and its time:

  PYTHONPATH=src python scripts/torch_cnn_repeat.py --out <json> \\
      [--steps 150] [--runs 3]

One seed gives one table only where every run of a PE type reads one
hash.
"""

import argparse
import hashlib
import json
import subprocess
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    from repro_torch.data.synthetic import eval_image_set
    from repro_torch.device import stage
    from repro_torch.optim import tree_leaves
    from repro_torch.train import qat

    dev = torch.device("cuda")
    ev = eval_image_set(0, 512, 10)
    images, _ = stage(ev["images"], dev)
    labels, _ = stage(ev["labels"], dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = dict(card=card.strip(), torch=torch.__version__,
               cudnn=torch.backends.cudnn.version(), steps=args.steps,
               runs=[])
    print(out["card"], out["torch"], out["cudnn"], flush=True)
    for det in (True, False):
        torch.backends.cudnn.deterministic = det
        for pe in qat.CNN_PE_TYPES:
            for rep in range(args.runs):
                t0 = time.perf_counter()
                params = qat.train_cnn(pe, args.steps, device=dev)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                h = hashlib.sha256()
                for p in tree_leaves(params):
                    h.update(p.detach().cpu().numpy().tobytes())
                row = dict(deterministic=det, pe=pe, run=rep,
                           top1=qat.top1(params, images, labels, pe),
                           params_sha256=h.hexdigest()[:16],
                           seconds=seconds)
                print(json.dumps(row), flush=True)
                out["runs"].append(row)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()

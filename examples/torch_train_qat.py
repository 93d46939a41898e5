"""End-to-end QAT training on the PyTorch/CUDA port (the counterpart of
examples/train_qat.py, same flags and defaults).

Two modes:

  --mode lm     (default) train SmolLM-135M at full width (or --reduced
                for CPU speed) for a few hundred steps on the synthetic
                token stream, under any QADAM PE type, with
                checkpoint/restart (--ckpt-dir);
  --mode cnn    the paper's Figs. 5-6 experiment: train a CIFAR ResNet on
                the CIFAR-like set under each PE type and write the
                accuracy x hardware-efficiency table
                (results/torch_qat_pareto.json; the JAX example's
                results/qat_pareto.json is left alone).

  PYTHONPATH=src python examples/torch_train_qat.py --mode lm \
      --pe-type lightpe1 --steps 200
  PYTHONPATH=src python examples/torch_train_qat.py --mode lm --reduced \
      --device cpu --steps 50
  PYTHONPATH=src python examples/torch_train_qat.py --mode cnn --steps 300

Without --device it runs on the CUDA card (and raises without one).
"""

import argparse

from repro_torch.train import qat


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="lm", choices=("lm", "cnn"))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--pe-type", default=None)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--trials", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)
    if args.mode == "lm":
        qat.run_lm("reduced" if args.reduced else "full", args.pe_type,
                   args.steps, args.batch, args.seq, args.n_micro, args.lr,
                   args.ckpt_dir, args.seed, args.device)
    else:
        qat.run_cnn(args.steps, args.depth, args.trials,
                    device=args.device)


if __name__ == "__main__":
    main()

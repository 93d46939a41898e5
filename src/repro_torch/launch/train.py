"""Training launcher CLI (port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 200 --batch 32 --seq 512 [--reduced] [--pe-type lightpe1] \\
      [--ckpt-dir /tmp/run1] [--resume] [--device cpu]

It runs on the card unless ``--device cpu`` says otherwise.  Under
``torchrun --nproc-per-node N`` (``WORLD_SIZE`` > 1) it builds a
("data", "model") mesh of the ranks, as the reference's launcher does of
its devices (``model`` the largest of 1, 2, 4, 8, 16 that divides both
the ranks and the heads), and runs the mesh step
(``trainer.jit_train_step``): sharded params and optimizer state, each
rank its slice of the batch, the gradients averaged over ``data``.  In
one process it runs the plain trainer.  ``main(argv)`` returns the final
state (this rank's shards on a mesh).
"""

from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from repro_torch.configs import get as get_cfg, reduced as get_reduced, list_archs
from repro_torch.data import lm_pipeline
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as M
from repro_torch.models import family_module
from repro_torch.optim import adamw, sgd_nesterov, warmup_cosine
from repro_torch.train import trainer


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--pe-type", default=None,
                    help="QADAM PE type for QAT numerics "
                         "(fp32|int16|lightpe1|lightpe2|int8)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=("adamw", "sgd_nesterov"))
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; cpu runs "
                         "the kernels' plain versions)")
    return ap


def model_parallel(n_ranks: int, cfg) -> int:
    """The reference's ``model`` axis size for ``n_ranks`` devices."""
    if not cfg.n_heads:
        return 1
    return max(d for d in (1, 2, 4, 8, 16)
               if n_ranks % d == 0 and cfg.n_heads % d == 0)


def _join_ranks(device) -> bool:
    """Initialize the process group from ``torchrun``'s environment when
    it asks for more than one rank and none exists; True if this call
    made it."""
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    M.init_process_group(device, int(os.environ["RANK"]),
                         int(os.environ["WORLD_SIZE"]), init_method="env://")
    return True


def main(argv=None):
    args = parser().parse_args(argv)
    cfg = get_reduced(args.arch) if args.reduced else get_cfg(args.arch)
    if args.pe_type:
        cfg = cfg.replace(pe_type=args.pe_type)
    mod = family_module(cfg)
    device = resolve_device(args.device)
    owned = _join_ranks(device)
    try:
        return _train(args, cfg, mod, device)
    finally:
        if owned:
            dist.destroy_process_group()


def _train(args, cfg, mod, device):
    n_ranks = dist.get_world_size() if dist.is_initialized() else 1
    mesh = None
    if n_ranks > 1:
        model_par = model_parallel(n_ranks, cfg)
        mesh = M.make_mesh((n_ranks // model_par, model_par),
                           ("data", "model"), device)

    sched = warmup_cosine(args.lr, 20, args.steps)
    opt = {"adamw": adamw, "sgd_nesterov": sgd_nesterov}[args.optimizer](sched)
    step_fn = trainer.make_train_step(cfg, mod, opt, n_micro=args.n_micro)
    pipe = lm_pipeline(cfg, args.batch, args.seq, seed=args.seed,
                       device=device, mesh=mesh)
    shardings = (trainer.state_shardings_for(cfg, mod, mesh, opt)
                 if mesh is not None else None)

    state = None
    if args.resume and args.ckpt_dir:
        state = trainer.resume(cfg, mod, opt, args.ckpt_dir, pipe,
                               device=device, mesh=mesh)
    if state is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        state = trainer.init_state(cfg, mod, opt, gen, device=device)
        if mesh is not None:
            state = trainer.shard_state(state, shardings)

    if mesh is not None:     # the step enters the mesh context itself
        step_fn = trainer.jit_train_step(step_fn, shardings, mesh)
    return trainer.fit(state, step_fn, pipe, steps=args.steps,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       shardings=shardings)


if __name__ == "__main__":
    main()

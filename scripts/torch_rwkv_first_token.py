"""How far RWKV6's first-step gradient moves under a nudge of its
embedding, and the heads that make it move.

At a sequence's first token the time mix's state is empty, so a head's
output is c v, with c the scalar sum over the head's channels of
r u k; the per-head norm (``ln_x``) divides it by |c| rms(v), so the
gradient reaching r, k and u through c grows as 1 / |c|.  This script
draws seed-0 params as ``tp_check.train_run`` does, takes one batch of
``lm_pipeline``, and prints:

  * each layer's |c| a head at t = 0 (the smallest, its head and batch
    row, and the median);
  * the loss and the global gradient norm at those params, and again
    with the embedding scaled by 1 +/- ``--nudge`` (default one unit in
    the last place of the compute type), each leaf's gradient change
    relative to its norm (the largest few).

On the card (the default device; RWKV6-1.6B at full width, 4 layers, as
``chip_smoke.py`` 20.1 trains it):

  PYTHONPATH=src python scripts/torch_rwkv_first_token.py --out <json>

On the CPU, cut to size:

  PYTHONPATH=src python scripts/torch_rwkv_first_token.py --device cpu \\
      --layers 2 --vocab 2048 --pe-type fp32 --dtype float32 --out <json>
"""

import argparse
import json

import numpy as np
import torch


def first_token_c(mod, params, tokens, cfg) -> list:
    """[(B, H) |c| at t = 0] a layer, from the time mix's own r, k, u."""
    from repro_torch.models import ssm_common as SSM
    got = []
    scan = SSM.chunked_linear_attention

    def spy(r, k, v, lw, u, **kw):
        got.append((r[:, 0] * u[None] * k[:, 0]).sum(-1).abs()
                   .float().cpu().numpy())
        return scan(r, k, v, lw, u, **kw)

    SSM.chunked_linear_attention = spy
    try:
        with torch.no_grad():
            mod.forward(params, tokens, cfg)
    finally:
        SSM.chunked_linear_attention = scan
    return got


def gradients(mod, params, batch, cfg):
    """(loss, {path: gradient}) at ``params``."""
    from repro_torch.launch.sharding import map_with_path
    leaves = []
    map_with_path(lambda p, x: leaves.append((p, x)), params)
    for _, x in leaves:
        x.requires_grad_(True)
    loss = mod.loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, [x for _, x in leaves])
    for _, x in leaves:
        x.requires_grad_(False)
    return float(loss.detach()), {p: g.double()
                                  for (p, _), g in zip(leaves, grads)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--pe-type", default="lightpe1")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--nudge", type=float, default=0.0)
    args = ap.parse_args(argv)

    from repro_torch.configs import get
    from repro_torch.data import lm_pipeline
    from repro_torch.device import resolve_device
    from repro_torch.models import family_module
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import init_state
    from repro_torch.train_check import LM_SCHEDULE

    device = resolve_device(args.device)
    over = dict(n_layers=args.layers, pe_type=args.pe_type, dtype=args.dtype)
    if args.vocab:
        over["vocab"] = args.vocab
    cfg = get("rwkv6-1.6b").replace(**over)
    mod = family_module(cfg)
    nudge = args.nudge or float(torch.finfo(getattr(torch, cfg.dtype)).eps)
    batch = next(lm_pipeline(cfg, args.batch, args.seq, device=device))

    def params():
        gen = (torch.Generator(device=device) if device.type == "cuda"
               else torch.Generator()).manual_seed(0)
        return init_state(cfg, mod, adamw(warmup_cosine(*LM_SCHEDULE)), gen,
                          device=device).params

    p0 = params()
    heads = []
    for i, c in enumerate(first_token_c(mod, p0, batch["tokens"], cfg)):
        at = np.unravel_index(int(c.argmin()), c.shape)
        heads.append(dict(layer=i, min=float(c.min()), head=int(at[1]),
                          row=int(at[0]), median=float(np.median(c))))
    loss0, g0 = gradients(mod, p0, batch, cfg)
    del p0
    norm0 = float(torch.sqrt(sum(g.square().sum() for g in g0.values())))
    runs = [dict(nudge=0.0, loss=loss0, grad_norm=norm0)]
    for sign in (1.0, -1.0):
        p = params()
        with torch.no_grad():
            p["embed"].mul_(1 + sign * nudge)
        loss, g = gradients(mod, p, batch, cfg)
        del p
        moved = {k: float((g[k] - g0[k]).norm() / g0[k].norm())
                 for k in g0 if float(g0[k].norm())}
        runs.append(dict(
            nudge=sign * nudge, loss=loss,
            grad_norm=float(torch.sqrt(sum(x.square().sum()
                                           for x in g.values()))),
            leaves_moved=dict(sorted(moved.items(),
                                     key=lambda kv: -kv[1])[:6])))
    out = dict(config=over, batch=args.batch, seq=args.seq,
               device=str(device), first_token_c=heads, runs=runs)
    if device.type == "cuda":
        import subprocess
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0]
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

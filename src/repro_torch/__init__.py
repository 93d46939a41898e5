"""QADAM in PyTorch for CUDA: the port of the JAX package ``repro``.

The port mirrors ``repro``'s layout (``core``, ``quant``, ``kernels``)
so each module has an obvious counterpart, imports neither ``jax`` nor
anything of ``repro``, and runs on the CUDA card unless a creator is
given ``device="cpu"`` (see ``repro_torch.device``).  The Pallas kernels
of the JAX package become hand-written CUDA kernels under ``csrc/``;
everything else is eager torch.

Float32 matrix products stay full float32: the surrogate's ridge normal
equations are poorly conditioned, and in TF32 the degree chosen by
cross-validation can change.  cuDNN's convolutions are deterministic,
as XLA's are: the CNN's QAT step (Figs. 5-6) adds its weight gradients
in one order, so one seed gives one table on the card.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True

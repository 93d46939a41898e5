"""Chunked linear attention shared by RWKV6 and Mamba2 (SSD) (port of
``repro.models.ssm_common``).

Both recurrences are instances of

    o_i = r_i . S_{i-1} + (r_i . (u ⊙ k_i)) v_i
    S_i = diag(w_i) S_{i-1} + k_i ⊗ v_i

(RWKV6: per-channel decay w, bonus u; Mamba2: per-head scalar decay a
with r pre-scaled by a and u = 1).  A prompt runs in chunks of C tokens:
matrix products inside a chunk, and the (dk, dv) state carried across the
chunks by a loop.  Within a chunk (1-indexed positions, P_i = prod_{m<=i}
w_m):

    r~_i = r_i ⊙ P_{i-1}          k~_j = k_j / P_j
    A_ij = r~_i . k~_j  (j < i)   A_ii = r_i . (u ⊙ k_i)
    o    = A @ V + r~ @ S0
    S_C  = P_C ⊙ (S0 + K~^T V)

The JAX package computes every product here with XLA einsums, outside
any Pallas kernel, so the port keeps them as ``torch.matmul``.  The
in-chunk cumulative log-decay is summed position by position, left to
right, as XLA's CPU cumsum sums it: its factors reach e^60, so one ulp of
the sum is about 4e-6 relative in r~ and k~, and a parallel scan (torch's
``cumsum`` on the card) would add that on the card alone.
"""

from __future__ import annotations

import torch

# Per-step log-decay clamp: with chunk C = 16 the worst-case in-chunk
# factor is exp(16 * 3.75) = e^60, representable in float32.
LOG_DECAY_MIN = -3.75
DEFAULT_CHUNK = 16


def _cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive cumulative sum along ``dim``, added left to right."""
    parts = list(x.unbind(dim))
    for i in range(1, len(parts)):
        parts[i] = parts[i - 1] + parts[i]
    return torch.stack(parts, dim)


def chunked_linear_attention(r, k, v, log_w, u=None, chunk=DEFAULT_CHUNK,
                             initial_state=None):
    """r, k: (B, S, H, dk); v: (B, S, H, dv); log_w: (B, S, H, dk) in
    (-inf, 0].  u: (H, dk) bonus for the diagonal (RWKV) or None (diagonal
    weight 1).  Returns (o (B, S, H, dv) in v's type, final state (B, H,
    dk, dv) float32).  The chunk shrinks by halves until it divides S, as
    in the reference (a 130-token prompt runs in 65 chunks of 2)."""
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    while s % chunk != 0:
        chunk //= 2
    chunk = max(chunk, 1)
    n = s // chunk
    f32 = torch.float32

    def resh(x):   # (n, B, H, C, d)
        return x.to(f32).reshape(b, n, chunk, h, x.shape[-1]) \
            .permute(1, 0, 3, 2, 4)

    r_, k_, v_ = resh(r), resh(k), resh(v)
    lw = torch.clamp(resh(log_w), LOG_DECAY_MIN, 0.0)

    lw_inc = _cumsum(lw, -2)                        # inclusive
    lw_exc = lw_inc - lw                            # exclusive
    r_t = r_ * torch.exp(lw_exc)                    # r~
    k_t = k_ * torch.exp(-lw_inc)                   # k~
    p_c = torch.exp(lw_inc[..., -1:, :])            # (n, B, H, 1, dk)

    mask = torch.tril(torch.ones((chunk, chunk), dtype=f32,
                                 device=r.device), diagonal=-1)
    a_intra = torch.matmul(r_t, k_t.transpose(-1, -2)) * mask
    if u is None:
        diag = torch.sum(r_ * k_, dim=-1)
    else:
        diag = torch.sum(r_ * u.to(f32)[:, None, :] * k_, dim=-1)
    a = a_intra + torch.eye(chunk, dtype=f32, device=r.device) \
        * diag[..., None]

    o_intra = torch.matmul(a, v_)
    kv = torch.matmul(k_t.transpose(-1, -2), v_)    # (n, B, H, dk, dv)

    if initial_state is None:
        state = torch.zeros((b, h, dk, dv), dtype=f32, device=r.device)
    else:
        state = initial_state.to(f32)
    outs = []
    for c in range(n):
        outs.append(o_intra[c] + torch.matmul(r_t[c], state))
        state = p_c[c][..., 0, :, None] * (state + kv[c])
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, s, h, dv)
    return o.to(v.dtype), state


def single_step(r, k, v, log_w, u=None, state=None):
    """One decode step.  r, k: (B, H, dk); v: (B, H, dv); log_w: (B, H,
    dk).  Returns (o (B, H, dv) in v's type, new state (B, H, dk, dv))."""
    f32 = torch.float32
    b, h, dk = r.shape
    dv = v.shape[-1]
    if state is None:
        state = torch.zeros((b, h, dk, dv), dtype=f32, device=r.device)
    r_, k_, v_ = r.to(f32), k.to(f32), v.to(f32)
    w = torch.exp(torch.clamp(log_w.to(f32), LOG_DECAY_MIN, 0.0))
    uk = k_ if u is None else k_ * u.to(f32)[None]
    o = torch.matmul(r_[..., None, :], state)[..., 0, :] \
        + torch.sum(r_ * uk, dim=-1)[..., None] * v_
    new_state = w[..., None] * state + k_[..., :, None] * v_[..., None, :]
    return o.to(v.dtype), new_state

"""Deterministic synthetic datasets (port of ``repro.data.synthetic``;
nothing is downloaded).

Two generators, both stateless functions of (seed, step), so the
pipeline's state checkpoints as one integer and a restart reproduces the
exact stream:

  * token_batch -- LM streams with learnable structure: a zipfian unigram
    mixed with a hidden fixed bigram permutation, so the cross entropy
    has headroom below the unigram entropy and training curves bend.
  * image_batch -- CIFAR-like 32x32x3 class-conditional images: per-class
    procedural sinusoid templates (``_class_templates``, numpy, the
    reference's bit for bit), shifted by up to 3 pixels, flipped, and
    noised; separable enough to train small CNNs in minutes, hard enough
    that quantization gaps show (the paper's Figs. 5-6 orderings).

The batches are made on the host from a ``torch.Generator`` seeded from
(seed, step), so the stream does not depend on the device; the pipeline
stages them to the card.  ``jax.random`` (threefry) is not reproduced:
the distributions are the reference's, the streams are the port's own.
Tests that compare the packages make their batches with numpy and feed
the same arrays to both.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _generator(*words: int) -> torch.Generator:
    """A CPU generator seeded from ``words`` (mixed by numpy's
    SeedSequence, so nearby seeds and steps give unrelated streams)."""
    seed = np.random.SeedSequence([int(w) for w in words]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed) & ((1 << 63) - 1))


# ---------------------------------------------------------------------------
# LM token streams
# ---------------------------------------------------------------------------

def _zipf_probs(vocab: int, alpha: float = 1.1) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    return (p / p.sum()).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _bigram_perm(seed: int, vocab: int) -> torch.Tensor:
    """The hidden bigram table of ``seed``: a fixed permutation of the
    vocabulary (read-only)."""
    return torch.randperm(vocab, generator=_generator(seed, 999))


def token_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
                bigram_frac: float = 0.7) -> dict:
    """{'tokens': (B, S) int32, 'labels': (B, S) int32} on the host.

    labels[t] = tokens[t + 1] (next-token prediction); the stream mixes
    zipfian draws with a fixed permutation bigram: with probability
    ``bigram_frac`` the next token is perm[current].
    """
    g = _generator(seed, step)
    probs = torch.from_numpy(_zipf_probs(vocab))
    perm = _bigram_perm(seed, vocab)
    zipf = torch.multinomial(probs, batch * (seq + 1), replacement=True,
                             generator=g).reshape(batch, seq + 1)
    use_bigram = torch.rand((batch, seq + 1), generator=g) < bigram_frac
    first = torch.multinomial(probs, batch, replacement=True, generator=g)
    toks = torch.empty((batch, seq + 1), dtype=torch.int64)
    toks[:, 0] = first
    cur = first
    for t in range(1, seq + 1):          # the reference's scan
        cur = torch.where(use_bigram[:, t - 1], perm[cur], zipf[:, t - 1])
        toks[:, t] = cur
    toks = toks.to(torch.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ---------------------------------------------------------------------------
# CIFAR-like images
# ---------------------------------------------------------------------------

def _class_templates(n_classes: int, hw: int = 32) -> np.ndarray:
    """(C, hw, hw, 3) smooth per-class patterns, deterministic."""
    rng = np.random.default_rng(20220513)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float64) / hw
    temps = []
    for c in range(n_classes):
        f1, f2 = rng.uniform(1, 5, 2)
        ph1, ph2 = rng.uniform(0, 2 * np.pi, 2)
        ang = rng.uniform(0, np.pi)
        u = np.cos(ang) * xx + np.sin(ang) * yy
        chans = []
        for ch in range(3):
            phc = rng.uniform(0, 2 * np.pi)
            chans.append(np.sin(2 * np.pi * f1 * u + ph1 + phc)
                         + 0.5 * np.cos(2 * np.pi * f2 * yy + ph2 + phc))
        temps.append(np.stack(chans, -1))
    t = np.stack(temps)
    return (t / np.abs(t).max()).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _templates(n_classes: int, hw: int) -> torch.Tensor:
    """``_class_templates`` as a (read-only) host tensor."""
    return torch.from_numpy(_class_templates(n_classes, hw))


def image_batch(seed: int, step: int, batch: int, n_classes: int = 10,
                hw: int = 32, noise: float = 0.6,
                augment: bool = True) -> dict:
    """{'images': (B, hw, hw, 3) float32 NHWC, 'labels': (B,) int32} on
    the host."""
    templates = _templates(n_classes, hw)
    g = _generator(seed, step)
    labels = torch.randint(0, n_classes, (batch,), generator=g)
    imgs = templates[labels]
    if augment:
        # random shifts (translation, as jnp.roll) and horizontal flips
        shift = torch.randint(-3, 4, (batch, 2), generator=g)
        ar = torch.arange(hw)
        rows = (ar[None, :] - shift[:, :1]) % hw           # (B, hw)
        cols = (ar[None, :] - shift[:, 1:]) % hw
        bi = torch.arange(batch)[:, None, None]
        imgs = imgs[bi, rows[:, :, None], cols[:, None, :]]
        flip = torch.rand((batch,), generator=g) < 0.5
        imgs = torch.where(flip[:, None, None, None], imgs.flip(2), imgs)
    imgs = imgs + noise * torch.randn(imgs.shape, generator=g)
    return {"images": imgs.to(torch.float32),
            "labels": labels.to(torch.int32)}


def eval_image_set(seed: int, n: int, n_classes: int = 10, hw: int = 32,
                   noise: float = 0.6) -> dict:
    """Fixed held-out set (no augmentation)."""
    return image_batch(seed + 10_000_019, 0, n, n_classes, hw, noise,
                       augment=False)

"""Synthetic dataset surrogates (numpy; the port's own copy of
``repro.data.synthetic``, so the same seed yields equal arrays).
Class-conditional Gaussian-mixture images at the original
resolutions/class counts so non-IID partitioning, label-flipping, and
classifier learning behave like the real benchmarks; a Markov-ish token
stream for the language models."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class ImageDataset:
    x: np.ndarray          # (N, H, W, C) float32 in [0,1]-ish
    y: np.ndarray          # (N,) int64
    n_classes: int
    name: str


def _class_conditional_images(rng: np.random.Generator, n: int,
                              shape: Tuple[int, int, int], n_classes: int,
                              n_prototypes: int = 3, noise: float = 0.35
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """Each class = a mixture of smooth low-frequency prototypes + noise.
    Learnable by a small CNN but far from trivially separable."""
    h, w, c = shape
    y = rng.integers(0, n_classes, size=n)
    # low-frequency prototypes: random coefficients over a coarse grid,
    # upsampled by repetition
    coarse = 4
    protos = rng.normal(0, 1, size=(n_classes, n_prototypes, coarse, coarse, c))
    reps_h, reps_w = h // coarse + 1, w // coarse + 1
    protos_full = np.repeat(np.repeat(protos, reps_h, axis=2), reps_w, axis=3)
    protos_full = protos_full[:, :, :h, :w, :]
    which = rng.integers(0, n_prototypes, size=n)
    x = protos_full[y, which] + noise * rng.normal(0, 1, size=(n, h, w, c))
    x = (x - x.min()) / (x.max() - x.min() + 1e-9)
    return x.astype(np.float32), y.astype(np.int64)


def make_cifar10_like(n: int = 12000, seed: int = 0) -> ImageDataset:
    rng = np.random.default_rng(seed)
    x, y = _class_conditional_images(rng, n, (32, 32, 3), 10)
    return ImageDataset(x, y, 10, "synth-cifar10")


def make_femnist_like(n: int = 16000, seed: int = 0) -> ImageDataset:
    rng = np.random.default_rng(seed)
    x, y = _class_conditional_images(rng, n, (28, 28, 1), 62)
    return ImageDataset(x, y, 62, "synth-femnist")


def make_token_stream(n_tokens: int, vocab: int, seed: int = 0,
                      order: int = 2) -> np.ndarray:
    """Markov-ish synthetic token stream so an LM has learnable structure."""
    rng = np.random.default_rng(seed)
    # sparse bigram transition structure over a reduced state space
    n_states = min(vocab, 256)
    trans = rng.integers(0, n_states, size=(n_states, 8))
    toks = np.empty(n_tokens, np.int32)
    s = 0
    for i in range(n_tokens):
        s = int(trans[s, rng.integers(0, 8)])
        toks[i] = s if rng.random() > 0.05 else int(rng.integers(0, vocab))
    return toks

"""Synthetic data (port of ``repro.data.synthetic``): the container has no
datasets.

Deterministic, seedable generators, drawn from numpy generators exactly as
the reference draws them, so the port's batches equal the reference's:

* :class:`TokenStream`: token streams with Zipfian unigram structure and a
  sparse Markov bigram structure (a language model has something to learn);
* :class:`GaussianMixtureLatents`: continuous latent sequences for the
  diffusion objective, a mixture of anisotropic Gaussians in embedding
  space with known moments;
* :func:`frontend_features`: the stub audio frames (whisper-base) and
  image patches (paligemma-3b) that stand in for the modality frontends.

Loaders yield numpy batches; the trainer moves them to the device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    kind: str = "lm"  # lm | diffusion
    d_model: int = 0  # diffusion mode
    num_modes: int = 8


class TokenStream:
    """Zipf unigrams modulated by a random sparse Markov chain."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        # each token strongly predicts a handful of successors
        self.succ = rng.integers(0, v, size=(v, 4))

    def batches(self) -> Iterator[dict]:
        """Endless {"tokens": (batch, seq) int32} batches."""
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed + 1)
        v = cfg.vocab_size
        while True:
            toks = np.empty((cfg.batch_size, cfg.seq_len), np.int32)
            cur = rng.choice(v, size=cfg.batch_size, p=self.unigram)
            toks[:, 0] = cur
            for t in range(1, cfg.seq_len):
                use_markov = rng.random(cfg.batch_size) < 0.7
                pick = self.succ[cur, rng.integers(0, 4, cfg.batch_size)]
                fresh = rng.choice(v, size=cfg.batch_size, p=self.unigram)
                cur = np.where(use_markov, pick, fresh).astype(np.int32)
                toks[:, t] = cur
            yield {"tokens": toks}


class GaussianMixtureLatents:
    """Mixture-of-Gaussians targets in R^(S x D) for diffusion training.
    Known first and second moments let benchmarks score generated samples
    without FID (moment errors and mode coverage)."""

    def __init__(self, cfg: DataConfig):
        if cfg.d_model <= 0:
            raise ValueError("GaussianMixtureLatents needs d_model > 0")
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        k, d = cfg.num_modes, cfg.d_model
        self.means = rng.normal(0, 1.0, size=(k, d)).astype(np.float32)
        self.scales = (0.15 + 0.2 * rng.random((k, d))).astype(np.float32)

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        cfg = self.cfg
        comp = rng.integers(0, cfg.num_modes, size=(n, cfg.seq_len))
        eps = rng.normal(size=(n, cfg.seq_len, cfg.d_model)).astype(np.float32)
        return self.means[comp] + self.scales[comp] * eps

    def batches(self) -> Iterator[dict]:
        """Endless {"latents": (batch, seq, d_model) float32} batches."""
        rng = np.random.default_rng(self.cfg.seed + 1)
        while True:
            yield {"latents": self.sample(rng, self.cfg.batch_size)}

    def moments(self) -> tuple[np.ndarray, np.ndarray]:
        """The mixture's analytic per-dimension mean and variance."""
        mu = self.means.mean(0)
        second = (self.means**2 + self.scales**2).mean(0)
        return mu, second - mu**2


def frontend_features(
    rng: np.random.Generator, batch: int, positions: int, dim: int
) -> np.ndarray:
    """Stub modality features: smooth low-rank signals, not white noise.
    (batch, positions, dim) float32, drawn from ``rng`` exactly as the
    reference draws them."""
    basis = rng.normal(size=(16, dim)).astype(np.float32)
    coef = rng.normal(size=(batch, positions, 16)).astype(np.float32)
    t = np.linspace(0, 1, positions, dtype=np.float32)[None, :, None]
    return np.tanh(coef @ basis * 0.3 + np.sin(8 * np.pi * t))


def make_loader(cfg: DataConfig):
    """The loader of ``cfg.kind``: a :class:`TokenStream` (lm) or a
    :class:`GaussianMixtureLatents` (diffusion)."""
    if cfg.kind == "lm":
        return TokenStream(cfg)
    if cfg.kind == "diffusion":
        return GaussianMixtureLatents(cfg)
    raise ValueError(f"unknown data kind {cfg.kind!r}")

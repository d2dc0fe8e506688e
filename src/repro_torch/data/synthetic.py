"""Synthetic inputs (port of ``repro.data.synthetic``, in part).

Only the modality stub is ported so far: :func:`frontend_features` draws
the frame embeddings (whisper-base) and image-patch embeddings
(paligemma-3b) that stand in for the audio and vision frontends.  The
token and latent streams of the reference's training data wait for the
training slice (ROADMAP, queue 'modules to port', item 'Training and
data').
"""

from __future__ import annotations

import numpy as np


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

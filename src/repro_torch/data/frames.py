"""Frame embeddings for training the encoder-decoder (whisper): the
stubbed conv frontend's output ``[B, encoder_seq, d_model]`` float32.

The port's copy of the JAX training driver's per-step draw
(``repro/launch/train.py``): a generator seeded with the step alone (not
the run's seed), standard normal in float64, rounded to float32.  Every
batch is a pure function of its step, so a resumed run draws the frames
an uninterrupted one would.
"""
from __future__ import annotations

import numpy as np


def step_frames(step: int, batch: int, encoder_seq: int, d_model: int) -> np.ndarray:
    """The frames of training step ``step``, bit-equal to the reference
    driver's: ``[batch, encoder_seq, d_model]`` float32."""
    return np.random.default_rng(step).standard_normal(
        (batch, encoder_seq, d_model)).astype(np.float32)

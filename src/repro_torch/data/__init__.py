"""Synthetic bigram token pipeline (:mod:`repro_torch.data.pipeline`) and
the encoder-decoder's training frames (:mod:`repro_torch.data.frames`)."""
from repro_torch.data.frames import step_frames
from repro_torch.data.pipeline import SyntheticLM, make_batch_iterator

__all__ = ["SyntheticLM", "make_batch_iterator", "step_frames"]

"""Synthetic bigram token pipeline (:mod:`repro_torch.data.pipeline`)."""
from repro_torch.data.pipeline import SyntheticLM, make_batch_iterator

__all__ = ["SyntheticLM", "make_batch_iterator"]

"""Sharded, digest-verified checkpoints (:mod:`repro_torch.checkpoint.store`),
loadable by the JAX package and from it."""
from repro_torch.checkpoint.store import (CheckpointManager, load_checkpoint,
                                          save_checkpoint)

__all__ = ["CheckpointManager", "load_checkpoint", "save_checkpoint"]

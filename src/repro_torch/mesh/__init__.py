"""The device-buffer registry of the port (:mod:`repro_torch.mesh.buffers`).

Every compiled SpMV plan stages its tensors into a registry namespace,
so resident plan memory is accounted and a plan cache can release it
explicitly.  The multi-process launcher, topology discovery and scaling
harness of the JAX package's ``mesh`` are not ported yet.
"""
from repro_torch.mesh.buffers import (BufferNamespace, BufferRegistry,
                                      default_registry)

__all__ = ["BufferNamespace", "BufferRegistry", "default_registry"]

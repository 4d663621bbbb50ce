"""Production meshes, by shape: the port's counterpart of
``repro/launch/mesh.py``.

The reference builds a jax ``Mesh`` over the devices present.  The port
runs one program on one card and never shards it, so a production mesh
here is its shape alone (:class:`ProductionMesh`): the axis names and
sizes the sharding specs (:mod:`repro_torch.models.partitioning`), the
activation specs (:mod:`repro_torch.models.actsharding`) and the dry
run's per-device budgets read.  Nothing here touches the card at import.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple


def _square_factor(n: int) -> Tuple[int, int]:
    """Most-square ``(data, model)`` factorization of ``n`` devices."""
    d = int(math.isqrt(n))
    while n % d:
        d -= 1
    return (d, n // d)


def production_mesh_shape(n_devices: int, *, multi_pod: bool = False,
                          n_pods: int = 2) -> Tuple[int, ...]:
    """Mesh shape for ``n_devices``: the most-square ``(data, model)``
    factorization (256 devices -> ``(16, 16)``), under a leading ``pod``
    axis of ``n_pods`` when ``multi_pod``.  Raises a ``ValueError``
    naming the device count when no layout exists."""
    if n_devices < 1:
        raise ValueError(
            f"cannot derive a production mesh from {n_devices} devices")
    if multi_pod:
        if n_pods < 2:
            raise ValueError(f"multi_pod needs n_pods >= 2, got {n_pods}")
        if n_devices % n_pods:
            raise ValueError(
                f"cannot derive a multi-pod mesh from {n_devices} devices: "
                f"not divisible by {n_pods} pods")
        return (n_pods,) + _square_factor(n_devices // n_pods)
    return _square_factor(n_devices)


def mesh_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data", "model") if multi_pod else ("data", "model")


@dataclasses.dataclass(frozen=True)
class ProductionMesh:
    """A mesh's shape: ``axis_names`` and ``sizes`` in order, and
    ``.shape`` as a dict of axis name -> size, as a jax mesh's."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def _world_size() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_production_mesh(*, multi_pod: bool = False,
                         n_devices: Optional[int] = None,
                         n_pods: Optional[int] = None) -> ProductionMesh:
    """The production mesh over the cards present, by shape.

    ``n_devices`` defaults to ``torch.cuda.device_count()`` (raises
    without a card) and ``n_pods`` to the ``torch.distributed`` world size
    when a group is up with more than one process, else 2.  Pass either to
    pin a fleet: the dry run pins its 256- and 512-chip cells."""
    if n_devices is None:
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device to derive a production mesh from; "
                               "pass n_devices= to pin one")
        n_devices = torch.cuda.device_count()
    if n_pods is None:
        world = _world_size()
        n_pods = world if world > 1 else 2
    shape = production_mesh_shape(n_devices, multi_pod=multi_pod, n_pods=n_pods)
    return ProductionMesh(mesh_axes(multi_pod), shape)


def dp_size(mesh) -> int:
    size = mesh.shape.get("data", 1)
    size *= mesh.shape.get("pod", 1)
    return size

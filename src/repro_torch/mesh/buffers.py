"""Persistent device-buffer registry.

:class:`BufferRegistry` / :class:`BufferNamespace` keep named plan
tensors resident on the device across solves, with an explicit
lifecycle and eviction stats.  A namespace speaks the dict protocol, so
it is a compiled plan's staging cache (``_Staged._tensors`` in
:mod:`repro_torch.core.spmv_torch`): the first use stages each host
array once, every later use (and every hot value swap, which writes
into the staged tensor in place) reuses the resident tensor.  Evicting
a plan (the serve ``PlanCache`` LRU, an elastic ``rebuild``, the compile
cache's LRU) releases its namespace, so the device memory is accounted
and freed, not left to the collector.
"""
from __future__ import annotations

import weakref
from typing import Dict, Optional

__all__ = ["BufferNamespace", "BufferRegistry", "default_registry"]


def _nbytes(obj) -> int:
    """Bytes of a tensor (``.nbytes``) or of a tuple of tensors."""
    if isinstance(obj, (tuple, list)):
        return sum(_nbytes(o) for o in obj)
    return int(getattr(obj, "nbytes", 0))


class BufferNamespace:
    """One plan's named device buffers (dict protocol).

    Lifecycle: tensors enter via ``__setitem__`` (counted as ``staged``),
    are read back by every program via ``__getitem__`` (``reused``),
    leave individually via ``pop`` or wholesale via ``release()`` (plan
    eviction / elastic rebuild).  Byte counts are ``tensor.nbytes``.
    """

    def __init__(self, registry: "BufferRegistry", label: str):
        self._registry = registry
        self.label = label
        self._bufs: Dict[object, object] = {}
        self._nbytes: Dict[object, int] = {}
        self.released = False

    def __contains__(self, name) -> bool:
        return name in self._bufs

    def __getitem__(self, name):
        self._registry.stats["reused"] += 1
        return self._bufs[name]

    def __setitem__(self, name, arr) -> None:
        if name in self._bufs:
            self.pop(name)
        nb = _nbytes(arr)
        self._bufs[name] = arr
        self._nbytes[name] = nb
        st = self._registry.stats
        st["staged"] += 1
        st["staged_bytes"] += nb

    def pop(self, name, default=None):
        if name not in self._bufs:
            return default
        arr = self._bufs.pop(name)
        nb = self._nbytes.pop(name)
        st = self._registry.stats
        st["evicted"] += 1
        st["evicted_bytes"] += nb
        return arr

    def __len__(self) -> int:
        return len(self._bufs)

    def keys(self):
        return self._bufs.keys()

    def resident_bytes(self) -> int:
        return sum(self._nbytes.values())

    def release(self) -> int:
        """Drop every buffer in the namespace; returns bytes released.
        Idempotent: a plan may be released through several paths."""
        nb = self.resident_bytes()
        for name in list(self._bufs):
            self.pop(name)
        if not self.released:
            self.released = True
            self._registry.stats["namespaces_released"] += 1
        return nb


class BufferRegistry:
    """Process-wide accounting over every live :class:`BufferNamespace`.

    The registry holds its namespaces weakly and never holds a buffer:
    namespaces own them, so a plan that is garbage-collected frees its
    device memory with it.
    """

    def __init__(self, name: str = "default"):
        self.name = name
        self._namespaces: "weakref.WeakSet[BufferNamespace]" = weakref.WeakSet()
        self.stats: Dict[str, int] = {
            "staged": 0, "staged_bytes": 0,
            "reused": 0,
            "evicted": 0, "evicted_bytes": 0,
            "namespaces_created": 0, "namespaces_released": 0,
        }

    def namespace(self, label: str = "plan") -> BufferNamespace:
        ns = BufferNamespace(self, label)
        self._namespaces.add(ns)
        self.stats["namespaces_created"] += 1
        return ns

    def live_namespaces(self) -> int:
        return sum(1 for ns in self._namespaces if not ns.released)

    def resident_bytes(self) -> int:
        return sum(ns.resident_bytes() for ns in self._namespaces)

    def report(self) -> Dict[str, object]:
        return dict(self.stats, name=self.name,
                    live_namespaces=self.live_namespaces(),
                    resident_bytes=self.resident_bytes())


_DEFAULT: Optional[BufferRegistry] = None


def default_registry() -> BufferRegistry:
    """The process-wide registry every compiled plan stages into (tests
    may construct private registries)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = BufferRegistry()
    return _DEFAULT

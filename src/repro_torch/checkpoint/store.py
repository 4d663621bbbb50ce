"""Sharded checkpoints with manifest, async save, and restore to a device.

Layout per step:  <dir>/step_<n>/
    manifest.json      tree structure, shapes, dtypes, shard digests
    shard_<k>.npz      leaf arrays (chunked so no single file balloons)
    _COMMITTED         written LAST: a crash mid-save never corrupts restore

The layout is the JAX package's, byte for byte in its manifest: each
checkpoint loads in either package.  The manifest records a sha256
digest per shard file, verified on every load: the ``_COMMITTED``
marker proves the save finished, the digests prove the bytes read back
are the bytes written; a changed shard raises
:class:`repro_torch.core.integrity.IntegrityError` naming it.

Trees are nested dicts, lists and tuples; a dict's leaves are visited
in sorted key order (the order of ``jax.tree_util``), so leaf names and
their order match the reference's.  ``None`` holds no leaf.  Leaves are
numpy arrays, scalars or torch tensors (saved through ``.cpu()``);
bfloat16 is stored as its uint16 bits, since npz has no bfloat16.
Arrays are stored unsharded per leaf, so a restore onto another layout
or device (``device=``) is a plain copy.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.integrity import IntegrityError

Pytree = Any


def _file_digest(path: pathlib.Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _flatten_with_names(tree: Pytree) -> List[Tuple[str, Any]]:
    """``(name, leaf)`` in the reference's order: dict keys sorted, list
    and tuple entries by index, path parts joined with ``/``."""
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            out.append(("/".join(str(p) for p in path), node))

    walk(tree, ())
    return out


def _unflatten(target: Pytree, leaves) -> Pytree:
    """``target``'s structure with its leaves taken in order from the
    iterator ``leaves`` (dicts come back in sorted key order)."""
    if target is None:
        return None
    if isinstance(target, dict):
        return {k: _unflatten(target[k], leaves) for k in sorted(target)}
    if isinstance(target, (list, tuple)):
        return type(target)(_unflatten(v, leaves) for v in target)
    return next(leaves)


def _host(leaf):
    """A host snapshot of one leaf: numpy, or a CPU bfloat16 tensor."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(leaf)


def _stored(leaf) -> Tuple[np.ndarray, str]:
    """The array written to the shard and its logical dtype name."""
    if isinstance(leaf, torch.Tensor):
        leaf = _host(leaf)
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = np.asarray(leaf)
    logical = str(arr.dtype)
    if logical == "bfloat16":          # an ml_dtypes array: bit-store
        arr = arr.view(np.uint16)
    return arr, logical


def save_checkpoint(directory: str, step: int, tree: Pytree,
                    extra: Optional[Dict] = None,
                    shard_mb: int = 512,
                    on_before_commit: Optional[Callable[[], None]] = None) -> str:
    """Write one committed checkpoint step.

    ``on_before_commit`` runs after every shard and the manifest are on
    disk but BEFORE the ``_COMMITTED`` marker, the crash window the
    marker protects against.  Fault harnesses
    (:mod:`repro_torch.serve.faultplan`) raise from it to produce a
    deterministic torn save; restore then falls back to the previous
    committed step.
    """
    path = pathlib.Path(directory) / f"step_{step:08d}"
    path.mkdir(parents=True, exist_ok=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": [], "shards": 0}
    shard, shard_bytes, shard_id = {}, 0, 0
    limit = shard_mb * 1_000_000
    digests: Dict[str, str] = {}

    def flush():
        nonlocal shard, shard_bytes, shard_id
        if shard:
            fname = f"shard_{shard_id}.npz"
            np.savez(path / fname, **shard)
            digests[fname] = _file_digest(path / fname)
            shard, shard_bytes = {}, 0
            shard_id += 1

    for name, leaf in _flatten_with_names(tree):
        arr, logical_dtype = _stored(leaf)
        key = name.replace("/", "__")
        manifest["leaves"].append({
            "name": name, "key": key, "shard": shard_id,
            "shape": list(arr.shape), "dtype": logical_dtype})
        shard[key] = arr
        shard_bytes += arr.nbytes
        if shard_bytes >= limit:
            flush()
    flush()
    manifest["shards"] = shard_id
    manifest["shard_digests"] = digests
    with open(path / "manifest.json", "w") as f:
        json.dump(manifest, f)
    if on_before_commit is not None:
        on_before_commit()
    (path / "_COMMITTED").touch()       # atomicity marker, written last
    return str(path)


def _leaf(arr: np.ndarray, dtype: str, device) -> Any:
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        return t if device is None else t.to(device)
    return arr if device is None else torch.from_numpy(arr).to(device)


def load_checkpoint(directory: str, step: Optional[int] = None,
                    target: Optional[Pytree] = None,
                    device=None) -> Tuple[Pytree, Dict]:
    """Restore ``(tree, extra)`` from the last committed step (or
    ``step``).  Without ``target`` the tree is ``{name: leaf}``; with it,
    ``target``'s structure.  Leaves are numpy arrays (bfloat16 ones CPU
    tensors, numpy has no bfloat16), or tensors on ``device`` when one
    is named."""
    base = pathlib.Path(directory)
    if step is None:
        steps = sorted(int(p.name.split("_")[1]) for p in base.glob("step_*")
                       if (p / "_COMMITTED").exists())
        if not steps:
            raise FileNotFoundError(f"no committed checkpoints in {directory}")
        step = steps[-1]
    path = base / f"step_{step:08d}"
    if not (path / "_COMMITTED").exists():
        raise FileNotFoundError(f"checkpoint {path} not committed")
    with open(path / "manifest.json") as f:
        manifest = json.load(f)
    # manifests without digests (older checkpoints) skip verification
    digests = manifest.get("shard_digests", {})
    shards = {}
    for i in range(manifest["shards"]):   # the manifest stores the exact count
        shard_path = path / f"shard_{i}.npz"
        held = [leaf["name"] for leaf in manifest["leaves"] if leaf["shard"] == i]
        if not shard_path.exists():
            raise FileNotFoundError(
                f"checkpoint {path} is committed but {shard_path.name} is "
                f"missing; it held {len(held)} leaves: {held}")
        want = digests.get(shard_path.name)
        if want is not None:
            got = _file_digest(shard_path)
            if got != want:
                raise IntegrityError(
                    f"checkpoint shard {shard_path} is corrupt: sha256 "
                    f"{got[:16]}… != manifest {want[:16]}… — the shard set "
                    f"is intact but the bytes changed since the save "
                    f"(bitrot / partial overwrite); it held {len(held)} "
                    f"leaves: {held}")
        shards[i] = np.load(shard_path)
    by_name = {leaf["name"]: _leaf(shards[leaf["shard"]][leaf["key"]],
                                   leaf["dtype"], device)
               for leaf in manifest["leaves"]}
    if target is None:
        return by_name, manifest["extra"]
    leaves = iter([by_name[name] for name, _ in _flatten_with_names(target)])
    return _unflatten(target, leaves), manifest["extra"]


class CheckpointManager:
    """Async, rolling checkpoints: ``save()`` returns at once and a writer
    thread serialises in the background; ``wait()`` joins it and raises
    what it raised.  ``keep`` committed steps are retained."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()    # guards last_saved across threads
        self.last_saved: Optional[int] = None

    def save(self, step: int, tree: Pytree, extra: Optional[Dict] = None,
             block: bool = False,
             on_before_commit: Optional[Callable[[], None]] = None) -> None:
        self.wait()                      # one in-flight save at a time
        # snapshot before the writer runs (device tensors come to the host)
        host_tree = _unflatten(tree, iter(
            [_host(leaf) for _, leaf in _flatten_with_names(tree)]))

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, extra,
                                on_before_commit=on_before_commit)
                with self._lock:
                    self.last_saved = step
                self._gc()
            except BaseException as e:   # surfaced on the next wait()/save()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if block:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"background checkpoint save failed; last committed step is "
                f"{self.last_saved}") from err

    def restore(self, target=None, device=None, step=None):
        return load_checkpoint(self.directory, step, target, device)

    def _gc(self) -> None:
        base = pathlib.Path(self.directory)
        steps = sorted(int(p.name.split("_")[1]) for p in base.glob("step_*")
                       if (p / "_COMMITTED").exists())
        for s in steps[:-self.keep]:
            p = base / f"step_{s:08d}"
            for f in p.iterdir():
                f.unlink()
            p.rmdir()

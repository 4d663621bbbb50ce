"""``torch.distributed`` multi-process launcher and env-var attach.

Two halves of one contract, as in the JAX package's ``mesh.launcher``:

* :func:`launch`: subprocess fan-out for tests and single-host runs.
  It starts N python processes on localhost, each wired to a fresh
  coordinator through the ``REPRO_MESH_*`` environment variables, runs a
  target per process and collects its output.  The target is either a
  ``"pkg.mod:fn"`` spec (re-entered via ``python -m
  repro_torch.mesh.launcher``, which attaches, calls ``fn(*args)`` and
  leaves the process group) or a script path (run as ``python script.py
  args...``; the script calls :func:`attach` itself).  Children start by
  ``subprocess`` (fork + exec), never by a bare ``fork``: a forked CUDA
  context is unusable.

* :func:`attach`: env-var attach for children and real clusters.  It
  reads the ``REPRO_MESH_*`` variables (a scheduler can set the same
  ones), names the backend, binds the process to its device and calls
  ``torch.distributed.init_process_group`` over ``tcp://<coordinator>``.
  With no variables set it is a no-op returning the single-process view,
  safe to call unconditionally at program start.

Environment variables::

    REPRO_MESH_COORDINATOR    host:port of process 0's rendezvous store
    REPRO_MESH_NUM_PROCESSES  total process count N
    REPRO_MESH_PROCESS_ID     this process's id in [0, N)
    REPRO_MESH_LOCAL_DEVICES  ranks this process batches on its device
                              (the ppn that discovery reports)
    REPRO_MESH_BACKEND        "gloo" or "nccl" (optional; see attach)

The backend is named, never guessed: ``gloo`` on the CPU, ``nccl`` on
CUDA unless ``REPRO_MESH_BACKEND=gloo`` or ``attach(backend="gloo")``
asks otherwise.  A process's device is ``cuda:(process_id %
device_count)``.  NCCL refuses two ranks on one device, so
:func:`attach` raises before NCCL would when two processes of a host
map to the same card.

Importing this module starts no process and touches no device.
"""
from __future__ import annotations

import dataclasses
import datetime
import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

ENV_COORDINATOR = "REPRO_MESH_COORDINATOR"
ENV_NUM_PROCESSES = "REPRO_MESH_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_MESH_PROCESS_ID"
ENV_LOCAL_DEVICES = "REPRO_MESH_LOCAL_DEVICES"
ENV_BACKEND = "REPRO_MESH_BACKEND"

BACKENDS = ("gloo", "nccl")
#: how long a process waits for its peers at the rendezvous and in a
#: collective before it gives up
TIMEOUT = datetime.timedelta(seconds=600)

__all__ = ["attach", "detach", "launch", "pick_coordinator", "mesh_env",
           "LaunchError", "LaunchResult", "BACKENDS",
           "ENV_COORDINATOR", "ENV_NUM_PROCESSES", "ENV_PROCESS_ID",
           "ENV_LOCAL_DEVICES", "ENV_BACKEND"]

#: the package's parent directory (``src``): children import the port from it
_SRC = str(Path(__file__).resolve().parents[2])


class LaunchError(RuntimeError):
    """A launched process failed; carries every process's output tail."""


def pick_coordinator(host: str = "127.0.0.1") -> str:
    """A free ``host:port`` for a fresh coordinator (bind-and-release)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return f"{host}:{s.getsockname()[1]}"


def mesh_env(coordinator: str, num_processes: int, process_id: int,
             local_devices: Optional[int] = None) -> Dict[str, str]:
    """The ``REPRO_MESH_*`` variables for one process of a job."""
    env = {
        ENV_COORDINATOR: coordinator,
        ENV_NUM_PROCESSES: str(int(num_processes)),
        ENV_PROCESS_ID: str(int(process_id)),
    }
    if local_devices is not None:
        env[ENV_LOCAL_DEVICES] = str(int(local_devices))
    return env


def _backend(requested: Optional[str]) -> str:
    """The named backend: the argument, else ``REPRO_MESH_BACKEND``, else
    ``nccl`` when CUDA is available and ``gloo`` when it is not."""
    name = requested or os.environ.get(ENV_BACKEND) or (
        "nccl" if torch.cuda.is_available() else "gloo")
    if name not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {name!r}")
    if name == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the nccl backend needs CUDA; use backend='gloo' "
                           "on the CPU")
    return name


def _check_devices(store, process_id: int, num_processes: int,
                   device: str) -> None:
    """Raise when two processes of one host would drive one device with
    NCCL, which rejects duplicate GPUs in a communicator: each process
    posts ``host:device`` to the rendezvous store and reads every peer's."""
    mine = f"{socket.gethostname()}:{device}"
    store.set(f"repro_mesh/device/{process_id}", mine)
    peers = [store.get(f"repro_mesh/device/{p}").decode()
             for p in range(num_processes)]
    shared = sorted({d for d in peers if peers.count(d) > 1})
    if shared:
        raise RuntimeError(
            f"nccl cannot run two processes on one device ({', '.join(shared)} "
            f"is shared by {num_processes} processes); use the gloo backend "
            f"(REPRO_MESH_BACKEND=gloo or attach(backend='gloo')) to share "
            f"a device, or one process per device")


def attach(verbose: bool = False, backend: Optional[str] = None
           ) -> Dict[str, object]:
    """Join the process group described by the ``REPRO_MESH_*`` environment.

    Returns a summary dict; ``attached`` is False when no coordinator is
    set (the plain single-process path; nothing is touched).  Otherwise
    the process binds to ``cuda:(process_id % device_count)`` when CUDA
    is available, and ``init_process_group`` runs with the named backend
    (module docstring) over a TCP store at the coordinator, which process
    0 hosts.
    """
    coordinator = os.environ.get(ENV_COORDINATOR)
    if not coordinator:
        return {"attached": False, "process_id": 0, "num_processes": 1}
    import torch.distributed as dist
    num_processes = int(os.environ[ENV_NUM_PROCESSES])
    process_id = int(os.environ[ENV_PROCESS_ID])
    name = _backend(backend)
    device = "cpu"
    if torch.cuda.is_available():
        index = process_id % torch.cuda.device_count()
        torch.cuda.set_device(index)
        device = f"cuda:{index}"
    host, port = coordinator.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0, timeout=TIMEOUT)
    if name == "nccl":
        _check_devices(store, process_id, num_processes, device)
    dist.init_process_group(name, store=store, rank=process_id,
                            world_size=num_processes, timeout=TIMEOUT)
    info = {"attached": True, "coordinator": coordinator,
            "process_id": process_id, "num_processes": num_processes,
            "backend": name, "device": device,
            "local_devices": int(os.environ.get(ENV_LOCAL_DEVICES) or 1)}
    if verbose:
        print(f"[mesh.attach] p{process_id}/{num_processes} -> {coordinator} "
              f"({name}, {device}, {info['local_devices']} local ranks)",
              flush=True)
    return info


def detach() -> None:
    """Leave the process group :func:`attach` joined (no-op without one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass
class LaunchResult:
    coordinator: str
    returncodes: List[int]
    outputs: List[str]          # combined stdout+stderr per process

    def output(self, process_id: int = 0) -> str:
        return self.outputs[process_id]


def _child_cmd(target: str, args: Sequence[str], python: str) -> List[str]:
    if target.endswith(".py") or os.path.sep in target:
        return [python, target, *map(str, args)]
    return [python, "-m", "repro_torch.mesh.launcher", target,
            json.dumps(list(map(str, args)))]


def launch(target: str, n_processes: int, *, args: Sequence[str] = (),
           local_devices: int = 1, env: Optional[Dict[str, str]] = None,
           timeout_s: float = 600.0, python: str = sys.executable
           ) -> LaunchResult:
    """Run ``target`` in ``n_processes`` coordinator-connected processes.

    Every child gets the ``REPRO_MESH_*`` variables (``local_devices``
    ranks per process) on top of this process's environment and ``env``,
    and the port's ``src`` directory on ``PYTHONPATH``.  Raises
    :class:`LaunchError` with every process's output tail if any process
    exits non-zero or exceeds ``timeout_s`` (the others are then killed).
    """
    coordinator = pick_coordinator()
    with tempfile.TemporaryDirectory(prefix="repro_mesh_") as tmp:
        logs = [open(os.path.join(tmp, f"p{pid}.log"), "w+")
                for pid in range(int(n_processes))]
        procs = []
        try:
            for pid, log in enumerate(logs):
                child_env = dict(os.environ)
                child_env.update(env or {})
                child_env.update(mesh_env(coordinator, n_processes, pid,
                                          local_devices))
                path = child_env.get("PYTHONPATH")
                child_env["PYTHONPATH"] = _SRC + (os.pathsep + path if path else "")
                procs.append(subprocess.Popen(
                    _child_cmd(target, args, python), env=child_env,
                    stdout=log, stderr=subprocess.STDOUT, text=True))
            why = _wait_all(procs, timeout_s)
        finally:
            for p in procs:     # a peer of a dead process would wait forever
                if p.poll() is None:
                    p.kill()
                p.wait()
        outputs = []
        for log in logs:
            log.seek(0)
            outputs.append(log.read())
            log.close()
    returncodes = [p.returncode for p in procs]
    if why:
        raise LaunchError(f"launch({target!r}, n={n_processes}) {why} "
                          f"(returncodes={returncodes}); tails:\n" + _tails(outputs))
    return LaunchResult(coordinator, returncodes, outputs)


def _wait_all(procs: List[subprocess.Popen], timeout_s: float) -> str:
    """Wait until every process exits 0 (returns ""), one fails
    ("failed") or ``timeout_s`` passes ("timed out after ...")."""
    deadline = time.monotonic() + timeout_s
    while True:
        rcs = [p.poll() for p in procs]
        if any(rc not in (None, 0) for rc in rcs):
            return "failed"
        if all(rc == 0 for rc in rcs):
            return ""
        if time.monotonic() > deadline:
            return f"timed out after {timeout_s}s"
        time.sleep(0.05)


def _tails(outputs: List[str], lines: int = 25) -> str:
    parts = []
    for pid, out in enumerate(outputs):
        tail = "\n".join(out.splitlines()[-lines:])
        parts.append(f"--- process {pid} ---\n{tail}")
    return "\n".join(parts)


def _child_main(argv: List[str]) -> int:
    """``python -m repro_torch.mesh.launcher pkg.mod:fn '[json args]'``:
    the module:function child entry: attach, import, call, detach."""
    if not argv:
        print("usage: python -m repro_torch.mesh.launcher pkg.mod:fn "
              "'[args...]'", file=sys.stderr)
        return 2
    target = argv[0]
    call_args = json.loads(argv[1]) if len(argv) > 1 else []
    attach(verbose=True)
    try:
        mod_name, _, fn_name = target.partition(":")
        fn = getattr(importlib.import_module(mod_name), fn_name)
        fn(*call_args)
    finally:
        detach()
    return 0


if __name__ == "__main__":
    raise SystemExit(_child_main(sys.argv[1:]))

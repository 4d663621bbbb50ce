"""Build the port's CUDA sources with nvcc and bind them with ctypes.

Every ``src/repro_torch/csrc/*.cu`` file has a plain C interface and is
compiled on its own into ``build/kernels/<name>-<hash>.so`` at the root
of the checkout, for ``sm_90a`` (Hopper).  The hash covers the source and
the flags, so an edited source rebuilds and an unchanged one is reused.
All sources build in parallel, one ``nvcc`` each, at the first kernel
launch (or at an explicit :func:`build_all`).  Nothing is built or
imported when the module is imported.

``launches`` counts kernel launches per wrapper name; each wrapper adds
one where it launches its kernel and nowhere else.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Optional

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("ell_spmm", "bsr_spmm", "decode_attn")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

launches: collections.Counter = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    launches.clear()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def _lib_path(name: str, flags) -> pathlib.Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(ptxas_verbose: bool = False) -> Dict[str, object]:
    """Compile every source whose library is missing, all at once.

    Returns ``{"seconds": wall, "built": [...], "log": {name: nvcc stderr}}``;
    raises with the compiler's output when any build fails.
    """
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if ptxas_verbose else ())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in SOURCES:
        out = _lib_path(name, NVCC_FLAGS)
        if out.exists() and not ptxas_verbose:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [_nvcc(), *flags, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    log, failed = {}, []
    for name, (out, tmp, proc) in procs.items():
        log[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(log[n] for n in failed))
    return {"seconds": time.perf_counter() - t0, "built": sorted(procs),
            "log": log}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source, building all sources if needed."""
    lib: Optional[ctypes.CDLL] = _libs.get(name)
    if lib is None:
        path = _lib_path(name, NVCC_FLAGS)
        if not path.exists():
            build_all()
        lib = _libs[name] = ctypes.CDLL(str(path))
    return lib


def check_status(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")

"""Guards of the port: it stays free of JAX and of the JAX package, and
it runs on the GPU unless the caller asks for the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.api as port_api
from repro_torch.core.spmv_torch import compile_nap
from repro_torch.core.partition import contiguous_partition
from repro_torch.core.topology import Topology
from repro_torch.device import resolve_device
from repro_torch.sparse import poisson_2d

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def test_import_loads_neither_jax_nor_reference():
    code = ("import sys, repro_torch, repro_torch.api, repro_torch.core.spmv_torch\n"
            "import repro_torch.models.convert, repro_torch.launch.serve\n"
            "import repro_torch.kernels.decode_attn\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\nprint('clean')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "clean" in proc.stdout


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_source_imports_no_jax_or_reference(path):
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    hits = pattern.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


def test_operator_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = poisson_2d(6)
    topo = Topology(2, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_api.operator(a, topo)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compile_nap(a, contiguous_partition(36, 4), topo)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert port_api.operator(a, topo, device="cpu").shape == (36, 36)
    assert resolve_device("cpu") == torch.device("cpu")


def test_standard_and_bsr_ops_raise_without_cuda(monkeypatch):
    from repro_torch.core.spmv_torch import compile_standard
    from repro_torch.kernels.bsr_spmv import bsr_spmm, bsr_spmv
    from repro_torch.sparse import BSR
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = poisson_2d(6)
    topo = Topology(2, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_api.operator(a, topo, method="standard")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compile_standard(a, contiguous_partition(36, 4), topo)
    b = BSR.from_csr(a, bm=8, bn=8)
    x = torch.ones(b.shape[1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bsr_spmm(b, x[:, None])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bsr_spmv(b, x)
    assert bsr_spmv(b, x, device="cpu").device.type == "cpu"
    assert port_api.operator(a, topo, method="standard", device="cpu").shape == (36, 36)


def test_lm_serve_and_decode_attention_raise_without_cuda(monkeypatch):
    from repro_torch.configs import get_reduced
    from repro_torch.kernels.decode_attn import decode_attention
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced("gemma2-2b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "gemma2-2b"])
    q, kv = torch.zeros(1, 4, 16), torch.zeros(1, 8, 2, 16)
    lengths = torch.ones(1, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decode_attention(q, kv, kv, lengths)
    assert build_model(cfg, device="cpu").device == torch.device("cpu")
    assert decode_attention(q, kv, kv, lengths, device="cpu").device.type == "cpu"


def test_comm_and_amg_import_loads_neither_jax_nor_reference():
    code = ("import sys, repro_torch.comm, repro_torch.amg\n"
            "import repro_torch.core.integrity\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\nprint('clean')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "clean" in proc.stdout


def test_multistep_and_level_operators_raise_without_cuda(monkeypatch):
    from repro_torch.amg import level_operators, smoothed_aggregation_hierarchy
    from repro_torch.core.spmv_torch import compile_multistep
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = poisson_2d(8)
    topo = Topology(2, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_api.operator(a, topo, method="multistep")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_api.operator(a, topo, comm="auto")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compile_multistep(a, contiguous_partition(64, 4), topo)
    levels = smoothed_aggregation_hierarchy(a, coarse_size=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        level_operators(levels, topo)
    ops = level_operators(levels, topo, comm="auto", device="cpu")
    assert ops[0].a.shape == (64, 64) and ops[0].p.shape == levels[0].p.shape
    assert port_api.operator(a, topo, method="multistep",
                             device="cpu").method == "multistep"


def test_simulate_and_integrity_import_loads_neither_jax_nor_reference():
    code = ("import sys, repro_torch.core.spmv, repro_torch.comm.simulate\n"
            "import repro_torch.core.integrity, repro_torch.core.executors\n"
            "from repro_torch.core.spmv_torch import _msg_checksums, _apply_fault\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\nprint('clean')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "clean" in proc.stdout


def test_spgemm_paper_and_examples_import_loads_neither_jax_nor_reference():
    code = ("import sys, repro_torch.spgemm, repro_torch.spgemm.spgemm_torch\n"
            "import repro_torch.spgemm.rap, repro_torch.spgemm.simulate\n"
            "import repro_torch.examples.quickstart, repro_torch.examples.amg_spmv\n"
            "import repro_torch.sparse.suitesparse_like\n"
            "import repro_torch.configs.paper_spmv\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\nprint('clean')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "clean" in proc.stdout


def test_spgemm_materialize_and_examples_raise_without_cuda(monkeypatch):
    """The device SpGEMM, ``level_operators(materialize=True)`` and
    ``distributed_rap`` (whose products default to the device backend),
    ``materialize`` of device factors and the examples need CUDA or
    ``device="cpu"``; the simulate backend runs on the host."""
    from repro_torch.amg import level_operators, smoothed_aggregation_hierarchy
    from repro_torch.examples import amg_spmv, quickstart
    from repro_torch.spgemm import distributed_rap, distributed_spgemm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = poisson_2d(8)
    topo = Topology(2, 2)
    part = contiguous_partition(64, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed_spgemm(a, a, part, part, topo)
    assert distributed_spgemm(a, a, part, part, topo, backend="simulate").nnz > 0
    assert distributed_spgemm(a, a, part, part, topo, device="cpu").nnz > 0
    for rap in (distributed_rap(topo, backend="torch"), distributed_rap(topo)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            smoothed_aggregation_hierarchy(a, coarse_size=8, rap=rap)
    levels = smoothed_aggregation_hierarchy(a, coarse_size=8)
    for kw in (dict(spgemm_backend="torch"), {}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            level_operators(levels, topo, materialize=True, **kw)
    ops = level_operators(levels, topo, device="cpu", materialize=True,
                          spgemm_backend="simulate")
    assert ops[0].galerkin(materialize=True).spec.device == "cpu"
    for example in (quickstart, amg_spmv):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            example.main([])


def test_simulate_runs_on_the_host_and_integrity_raises_without_cuda(monkeypatch):
    """The float64 simulators are host numpy and need no GPU; the device
    backend with integrity on still needs CUDA or ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = poisson_2d(6)
    topo = Topology(2, 2)
    for method in ("nap", "standard", "multistep"):
        op = port_api.operator(a, topo, method=method, backend="simulate",
                               integrity="detect")
        assert (op @ np.ones(36)).dtype == np.float64
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_api.operator(a, topo, method=method, integrity="detect")
    assert port_api.operator(a, topo, integrity="recover",
                             device="cpu").integrity_report()["mode"] == "recover"

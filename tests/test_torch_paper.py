"""The paper's own surfaces in the port: the SuiteSparse surrogates and
the experiment configuration equal the JAX package's exactly, and the
port's two examples run to their final assertion on the CPU."""
import dataclasses

import numpy as np
import pytest

import repro.configs.paper_spmv as ref_cfg
import repro.sparse.suitesparse_like as ref_ss

import repro_torch.configs.paper_spmv as port_cfg
import repro_torch.sparse.suitesparse_like as port_ss
from repro_torch.examples import amg_spmv, quickstart
from repro_torch.sparse import random_fixed_nnz

NAMES = [s.name for s in ref_ss.SPECS]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", NAMES)
def test_suitesparse_like_build_matches_reference(name, seed):
    got = port_ss.build(name, scale=8192, seed=seed)
    want = ref_ss.build(name, scale=8192, seed=seed)
    assert got.shape == want.shape
    for field in ("indptr", "indices", "data"):
        x, y = getattr(got, field), getattr(want, field)
        assert x.dtype == y.dtype and np.array_equal(x, y), field


def test_suitesparse_like_specs_match_reference():
    assert [dataclasses.astuple(s) for s in port_ss.SPECS] == \
        [dataclasses.astuple(s) for s in ref_ss.SPECS]
    assert sorted(port_ss.BY_NAME) == sorted(ref_ss.BY_NAME)
    # the graph family, which no published spec uses, builds as the reference's
    a = port_ss.random_fixed_nnz(300, 7, 2, symmetric_pattern=True)
    b = ref_ss.random_fixed_nnz(300, 7, 2, symmetric_pattern=True)
    assert np.array_equal(a.indices, b.indices) and np.array_equal(a.data, b.data)
    c = random_fixed_nnz(300, 7, 2)
    assert np.array_equal(c.to_dense(), ref_ss.random_fixed_nnz(300, 7, 2).to_dense())


def test_paper_spmv_config_matches_reference():
    assert dataclasses.asdict(port_cfg.CONFIG) == dataclasses.asdict(ref_cfg.CONFIG)
    assert [f.name for f in dataclasses.fields(port_cfg.SpMVExperimentConfig)] == \
        [f.name for f in dataclasses.fields(ref_cfg.SpMVExperimentConfig)]
    assert dataclasses.asdict(port_cfg.SpMVExperimentConfig(ppn=4)) == \
        dataclasses.asdict(ref_cfg.SpMVExperimentConfig(ppn=4))


@pytest.mark.parametrize("example", [quickstart, amg_spmv],
                         ids=["quickstart", "amg_spmv"])
def test_example_runs_on_cpu(example, capsys):
    example.main(["--device", "cpu"])
    out = capsys.readouterr().out
    last = out.strip().splitlines()[-1]
    assert last.startswith({"quickstart": "device NAPSpMV matches",
                            "amg_spmv": "BiCG with forward+transpose"}[
                                example.__name__.rsplit(".", 1)[-1]])

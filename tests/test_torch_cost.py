"""The port's message cost models (paper Eqs. 10-12) against the JAX
package's, to rtol 1e-12, under the paper's Blue Waters parameters and
under a machine built from the reference's TPU v5e values (passed to
both packages; the port holds no TPU constants)."""
import dataclasses

import numpy as np
import pytest

import repro.api as ref_api
import repro.core.comm_graph as ref_comm
import repro.core.cost_model as ref_cost
import repro.core.partition as ref_partition
import repro.sparse as ref_sparse
from repro.core.topology import Topology as RefTopology

import repro_torch.api as port_api
import repro_torch.core.comm_graph as port_comm
import repro_torch.core.cost_model as port_cost
import repro_torch.core.partition as port_partition
import repro_torch.sparse as port_sparse
from repro_torch.core.topology import Topology

RTOL = 1e-12


def _port_machine(ref_machine):
    """The reference machine's values as a port ``MachineParams``."""
    return port_cost.MachineParams(
        name=ref_machine.name,
        inter={k: port_cost.ProtocolParams(**dataclasses.asdict(v))
               for k, v in ref_machine.inter.items()},
        intra={k: port_cost.LocalParams(**dataclasses.asdict(v))
               for k, v in ref_machine.intra.items()},
        short_cutoff=ref_machine.short_cutoff,
        eager_cutoff=ref_machine.eager_cutoff)


MACHINES = {
    "blue_waters": (ref_cost.BLUE_WATERS, port_cost.BLUE_WATERS),
    "tpu_v5e_values": (ref_cost.TPU_V5E, _port_machine(ref_cost.TPU_V5E)),
}

# (name, generator + args, topology, partition kind)
LAYOUTS = [
    ("aniso_4x4", ("rotated_anisotropic_2d", (24,)), (4, 4), "contiguous"),
    ("poisson_2x2", ("poisson_2d", (8,)), (2, 2), "contiguous"),
    ("random_3x2_strided", ("random_fixed_nnz", (60, 6)), (3, 2), "strided"),
]


def _plans(layout, method):
    _, (gen, args), (nn, ppn), kind = layout
    a_ref = getattr(ref_sparse, gen)(*args)
    a_port = getattr(port_sparse, gen)(*args)
    n = a_ref.shape[0]
    mk = f"{kind}_partition"
    p_ref = getattr(ref_partition, mk)(n, nn * ppn)
    p_port = getattr(port_partition, mk)(n, nn * ppn)
    build = f"build_{method}_plan"
    # the port builds the NAP plan with the aligned slot pairing only
    kw = {"pairing": "aligned"} if method == "nap" else {}
    return (getattr(ref_comm, build)(a_ref.indptr, a_ref.indices, p_ref,
                                     RefTopology(nn, ppn), **kw),
            getattr(port_comm, build)(a_port.indptr, a_port.indices, p_port,
                                      Topology(nn, ppn)))


def test_blue_waters_is_the_papers_tables():
    assert port_cost.BLUE_WATERS == _port_machine(ref_cost.BLUE_WATERS)
    assert not hasattr(port_cost, "TPU_V5E")


@pytest.mark.parametrize("machine", MACHINES)
def test_message_models_match(machine):
    ref_m, port_m = MACHINES[machine]
    for nbytes in (0, 8, 512, 513, 4096, 8192, 8193, 10**6):
        assert port_m.protocol(nbytes) == ref_m.protocol(nbytes)
        np.testing.assert_allclose(port_cost.intra_node_time(nbytes, port_m),
                                   ref_cost.intra_node_time(nbytes, ref_m),
                                   rtol=RTOL)
        for ppn in (1, 4, 16):
            np.testing.assert_allclose(
                port_cost.inter_node_time(nbytes, ppn, port_m),
                ref_cost.inter_node_time(nbytes, ppn, ref_m), rtol=RTOL)
    assert port_cost.compute_time(12345) == ref_cost.compute_time(12345)


@pytest.mark.parametrize("method", ["standard", "nap"])
@pytest.mark.parametrize("machine", MACHINES)
@pytest.mark.parametrize("layout", LAYOUTS, ids=[s[0] for s in LAYOUTS])
def test_plan_cost_matches(layout, machine, method):
    ref_m, port_m = MACHINES[machine]
    ref_plan, port_plan = _plans(layout, method)
    want = getattr(ref_cost, f"{method}_cost")(ref_plan, ref_m)
    got = getattr(port_cost, f"{method}_cost")(port_plan, port_m)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("method", ["standard", "nap"])
def test_operator_cost_matches_reference(method):
    a_ref = ref_sparse.rotated_anisotropic_2d(16)
    a_port = port_sparse.rotated_anisotropic_2d(16)
    ref = ref_api.operator(a_ref, topo=RefTopology(2, 4), backend="simulate",
                           method=method)
    port = port_api.operator(a_port, Topology(2, 4), method=method, device="cpu")
    want = ref.cost(ref_cost.BLUE_WATERS)
    got = port.cost(port_cost.BLUE_WATERS)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)

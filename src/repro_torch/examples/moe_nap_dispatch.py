"""NAPSpMV applied to Mixture-of-Experts dispatch (the paper -> LMs bridge).

Runs the port's MoE dispatch (:mod:`repro_torch.moe`) on a 2-pod x
4-chip island, its 8 chips batched on one device, from both of its faces:

1. **The island** (the serving path): the same MoE layer through its
   dispatch modes and wire dtypes via ``moe_apply_sharded``, showing
   * every mode agrees with the dense-masked oracle,
   * the node-aware (3-step, pod-deduplicated) dispatch sends FEWER bytes
     across the pod boundary than the flat all-to-all: the paper's E(n, m)
     dedup applied to tokens routed to several experts of one remote pod,
     counted where the communicator moves them
     (``repro_torch.mesh.comm.inter_node_bytes``), and
   * quantized wire payloads (``wire_dtype="bf16" | "fp8_e4m3"``) cut the
     counted pod-crossing bytes again while staying inside the modeled
     error budget.
2. **The registered operator** (the plan path): ``dispatch_operator``
   compiles a concrete routing into the node-aware plan machinery: the
   per-direction flat-vs-nap verdicts and the quantized byte accounting,
   on the host.

    PYTHONPATH=src python -m repro_torch.examples.moe_nap_dispatch [--device cpu]
"""
import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.core.topology import Topology
from repro_torch.device import resolve_device
from repro_torch.mesh.comm import inter_node_bytes, reset_inter_node_bytes
from repro_torch.models.moe import EPInfo, moe_apply_local, moe_apply_sharded, moe_init
from repro_torch.moe import wire_error_bound
from repro_torch.moe.dispatch import dispatch_operator


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="device of the island (default: CUDA)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_reduced("qwen3-moe-235b-a22b").replace(
        n_experts=8, top_k=4, moe_dff=64, d_model=64, capacity_factor=8.0)
    topo = Topology(n_nodes=2, ppn=4)            # 2 pods of 4 chips
    params = moe_init(0, cfg, torch.float32, device=dev)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 16, cfg.d_model)) * 0.3) \
        .to(device=dev, dtype=torch.float32)
    want = moe_apply_local(params, cfg, x)
    scale = float(want.abs().max())
    ep = EPInfo(inner_axis="model", pod_axis="pod")

    def run(mcfg):
        """The island's output and the bytes it sent between pods."""
        reset_inter_node_bytes()
        got = moe_apply_sharded(params, mcfg, x, ep, topo)
        counted = inter_node_bytes()
        return got, counted.get("node", 0) + counted.get("nodexproc", 0)

    # -- the island: flat vs nap in float32 -----------------------------------
    results = {}
    for mode in ("flat", "nap"):
        got, pod_bytes = run(cfg.replace(moe_dispatch=mode))
        results[mode] = (pod_bytes, got)
        err = float((got - want).abs().max()) / scale
        print(f"{mode:4s} dispatch: max rel err vs dense oracle = {err:.2e}, "
              f"pod-crossing bytes = {pod_bytes:,}")
        assert err < 1e-4, f"{mode} dispatch diverged from the oracle"
    (flat_b, _), (nap_b, nap_out) = results["flat"], results["nap"]
    print(f"\nEXPENSIVE-axis (inter-pod) bytes: flat {flat_b:,} -> nap {nap_b:,}  "
          f"({flat_b / max(nap_b, 1):.2f}x less)")
    assert nap_b < flat_b, "NAP must reduce pod-crossing traffic"

    # -- the island: quantized wire payloads on the nap exchange --------------
    print("\nquantized wire (nap dispatch):")
    for wd in ("bf16", "fp8_e4m3"):
        wcfg = cfg.replace(moe_dispatch="nap", wire_dtype=wd)
        got, pod_bytes = run(wcfg)
        err = float((got - nap_out).abs().max()) / scale
        bound = wire_error_bound(wcfg)
        print(f"  {wd:8s}: pod-crossing bytes = {pod_bytes:,} "
              f"({nap_b / max(pod_bytes, 1):.2f}x less than f32), "
              f"rel err vs f32 = {err:.2e} (budget {bound:.2e})")
        assert pod_bytes < nap_b, f"{wd} must shrink the pod-crossing bytes"
        assert err <= bound, f"{wd} outside its error budget"

    # -- the registered operator: a routing compiled into the plans -----------
    print("\ndispatch_operator (plan layer, auto mode):")
    acfg = cfg.replace(moe_dispatch="auto", wire_dtype="fp8_e4m3")
    op = dispatch_operator(acfg, topo, n_tokens=256)
    rep = op.autotune_report()
    st = op.stats()
    print(f"  per-direction verdicts: dispatch={rep['dispatch_resolved']} "
          f"combine={rep['combine_resolved']}")
    print(f"  modeled injected inter-pod bytes/RHS: "
          f"dispatch {st['dispatch_injected_inter_bytes']:,} "
          f"combine {st['combine_injected_inter_bytes']:,} "
          f"at {st['bytes_per_val']} B/value on the wire")
    print(f"nap MoE dispatch sends {flat_b / nap_b:.2f}x fewer pod-crossing bytes "
          f"than flat on {topo.n_procs} chips batched on {dev}")


if __name__ == "__main__":
    main()

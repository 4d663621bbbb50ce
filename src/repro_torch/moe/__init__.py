"""MoE token dispatch of the port, beside ``repro/moe``.

* :mod:`repro_torch.moe.plan`: a top-k routing as the sparse routing
  matrix ``R [E, T]`` in the node-aware plan machinery, the per-direction
  flat-vs-nap verdict, the representative routing of ``"auto"``;
* :mod:`repro_torch.moe.wire`: the quantized wire codecs (numpy and
  torch), the error budgets, the checksummed quantizing simulator wire;
* :mod:`repro_torch.moe.dispatch`: the expert-parallel island
  (``moe_apply_sharded``, flat / nap / auto, on the device, over one
  process or a process's block of pods) and ``dispatch_operator`` (the
  ``backend="moe"`` executors on the host).

Importing the package touches no device.
"""
from repro_torch.moe.plan import (DISPATCH_MODES, DISPATCH_PREFERENCE,
                                  build_dispatch_plans, choose_dispatch,
                                  dispatch_partitions, dispatch_traffic,
                                  dispatch_verdict, representative_routing,
                                  routing_matrix)
from repro_torch.moe.wire import (FP8_MAX, WIRE_DTYPES, QuantSimWire,
                                  check_wire_dtype, codec_sweep, corrupt_wire_np,
                                  decode_np, decode_torch,
                                  dispatch_error_budget, encode_np,
                                  encode_torch, make_wire, quantize_np,
                                  wire_bytes, wire_error_bound, wire_eps)

__all__ = [
    "DISPATCH_MODES", "DISPATCH_PREFERENCE", "routing_matrix",
    "dispatch_partitions", "build_dispatch_plans", "dispatch_traffic",
    "dispatch_verdict", "choose_dispatch", "representative_routing",
    "WIRE_DTYPES", "FP8_MAX", "check_wire_dtype", "wire_bytes", "wire_eps",
    "encode_np", "decode_np", "quantize_np", "codec_sweep", "encode_torch",
    "decode_torch",
    "wire_error_bound", "dispatch_error_budget", "corrupt_wire_np",
    "QuantSimWire", "make_wire",
    "EPInfo", "moe_apply_sharded", "dispatch_operator",
    "resolve_dispatch_mode", "topology_of_mesh",
]

_DISPATCH_SYMBOLS = ("EPInfo", "moe_apply_sharded", "dispatch_operator",
                     "resolve_dispatch_mode", "topology_of_mesh")


def __getattr__(name):
    if name in _DISPATCH_SYMBOLS:
        from repro_torch.moe import dispatch
        return getattr(dispatch, name)
    raise AttributeError(f"module 'repro_torch.moe' has no attribute {name!r}")

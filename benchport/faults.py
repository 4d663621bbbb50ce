"""Faults planted under the timed path, to see ``correct`` come out false.

Each entry of ``FAULTS`` puts programs in the program's place, as the
control does (``programs(problem, ref)``): the program's own, with its
output broken.  ``exchange_left_out`` instead breaks the program itself
for as long as it is active: the inter-node exchange of
``repro_torch.core.spmv_torch`` returns zeros, as if no node's values
reached another.  The benchmark's runs never use them; the tests do at
a tiny size, and ``control.py --fault`` on the card at a cell's size.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict


def _wrap(change: Callable):
    def programs(problem, ref) -> Dict[str, Callable]:
        def fault(prog):
            return lambda s: change(prog(s).clone())
        return {d: fault(p) for d, p in problem.programs.items()}
    return programs


def _half(w):
    """Half of the batch left out: the block's last columns at nv > 1,
    the last half of the ranks at nv = 1."""
    if w.dim() == 4:
        w[..., w.shape[-1] // 2:] = 0
    else:
        w.view(-1, w.shape[-1])[w.shape[0] * w.shape[1] // 2:] = 0
    return w


def _altered(w):
    """One answer altered where it is produced: the first row's result."""
    w.view(-1)[0] += 1.0
    return w


def _padding(w):
    """Answers written where none is due: every rank's last padding slot
    (a slot no row owns in either configuration)."""
    w[:, :, -1] = 1.0
    return w


FAULTS = {
    "state_unchanged": lambda problem, ref: {d: (lambda s: s.clone())
                                             for d in problem.programs},
    "half_the_batch": _wrap(_half),
    "answer_altered": _wrap(_altered),
    "padding_written": _wrap(_padding),
}


@contextlib.contextmanager
def exchange_left_out():
    """The inter-node exchange returns zeros while the context is open."""
    import torch
    from repro_torch.core import spmv_torch
    saved = spmv_torch.node_all_to_all
    spmv_torch.node_all_to_all = lambda x, **kw: torch.zeros_like(x)
    try:
        yield
    finally:
        spmv_torch.node_all_to_all = saved

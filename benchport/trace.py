"""The traced stretch: ``torch.profiler`` over a few requests, reduced
from its Chrome trace to what the per-layer readers and the result's
``breakdown`` need.

The arithmetic is copied from ``chip_smoke.py::profile_program`` (the
device's busy time as the time its operations ran, and device time
summed by kernel name) and widened in two ways: busy time is the union
of the operations' intervals inside the stretch, so that overlapping
operations count once, and each device operation is attributed to the
benchmark's annotation (``benchport.program``, ``benchport.normalize``)
whose host interval launched it, through the trace's correlation ids.

The host and device timestamps of a Kineto trace share one clock, in
microseconds.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from typing import Callable, Dict, List, Optional

#: trace categories that are device operations
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: host categories that launch device work
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: the annotations the benchmark wraps around its calls
REQUEST = "benchport.request"
OWNERS = ("benchport.program", "benchport.normalize")
BREAKDOWN_ENTRIES = 10


def profile_requests(request: Callable[[], None], n: int,
                     host: bool = True) -> List[dict]:
    """Run ``request`` ``n`` times under the profiler, each inside a
    ``benchport.request`` annotation, and return the trace's events.
    ``host=False`` records the device's activity alone, which slows the
    host far less (the host's operators and annotations are not
    recorded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU] if host else []
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for _ in range(n):
            with record_function(REQUEST):
                request()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def device_span(events: List[dict]) -> Dict[str, float]:
    """``{"busy_s", "window_s"}`` of a device-only trace: the union of its
    device operations' intervals, and the stretch from the first one's
    start to the last one's end."""
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in _complete(events, DEVICE_CATS))
    if not ops:
        return {"busy_s": 0.0, "window_s": 0.0}
    busy, cursor = 0.0, ops[0][0]
    for start, end in ops:
        if end > cursor:
            busy += end - max(start, cursor)
            cursor = end
    return {"busy_s": busy / 1e6, "window_s": (max(e for _, e in ops) - ops[0][0]) / 1e6}


def _complete(events: List[dict], cats) -> List[dict]:
    return [e for e in events if e.get("ph") == "X"
            and str(e.get("cat", "")).lower() in cats]


class _Host:
    """Host intervals, for 'the shortest one that contains t'."""

    def __init__(self, events: List[dict]) -> None:
        self.events = sorted(events, key=lambda e: float(e["ts"]))
        self.starts = [float(e["ts"]) for e in self.events]
        self.longest = max((float(e["dur"]) for e in self.events), default=0.0)

    def innermost(self, t: float, tid=None) -> Optional[dict]:
        best = None
        for k in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            e = self.events[k]
            if self.starts[k] + self.longest < t:
                break
            if (tid is None or e.get("tid") == tid) \
                    and self.starts[k] + float(e["dur"]) >= t \
                    and (best is None or float(e["dur"]) < float(best["dur"])):
                best = e
        return best


def reduce(events: List[dict]) -> Dict[str, object]:
    """``{"window_s", "busy_s", "requests", "ops": [{"name", "start",
    "dur", "owner", "call"}], "device_ops": [[name, s]], "idle_gaps":
    [[label, s]]}`` over the stretch from the first request's start to the
    last one's end.  ``owner`` is the benchmark annotation that launched
    the operation, or None; ``call`` tells that annotation's instances
    apart (its start), so that operations count by the call that launched
    them."""
    requests = [e for e in _complete(events, ("user_annotation",))
                if e.get("name") == REQUEST]
    if not requests:
        raise ValueError("the trace holds no benchport.request annotation")
    t0 = min(float(e["ts"]) for e in requests)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in requests)
    annotations = _Host([e for e in _complete(events, ("user_annotation",))
                         if e.get("name") in OWNERS])
    host = _Host(_complete(events, ("cpu_op",) + LAUNCH_CATS))
    wrappers = _Host([e for e in _complete(events, ("user_annotation",))
                      if e.get("name") in OWNERS + (REQUEST,)])
    launches = {}
    for e in _complete(events, LAUNCH_CATS):
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            launches[corr] = e
    ops = []
    for e in _complete(events, DEVICE_CATS):
        start, dur = float(e["ts"]), float(e["dur"])
        if start + dur < t0 or start > t1:
            continue
        launch = launches.get((e.get("args") or {}).get("correlation"))
        owner = call = None
        if launch is not None:
            ann = annotations.innermost(float(launch["ts"]), launch.get("tid"))
            if ann is not None:
                owner, call = ann["name"], float(ann["ts"])
        ops.append({"name": e["name"], "start": start, "dur": dur, "owner": owner,
                    "call": call})
    ops.sort(key=lambda o: o["start"])

    busy, gaps = 0.0, collections.Counter()
    cursor = t0
    for o in ops:
        start, end = max(o["start"], t0), min(o["start"] + o["dur"], t1)
        if start > cursor:
            gaps[_label(host, wrappers, (cursor + start) / 2)] += start - cursor
        if end > cursor:
            busy += end - max(start, cursor)
            cursor = end
    if t1 > cursor:
        gaps[_label(host, wrappers, (cursor + t1) / 2)] += t1 - cursor
    by_name = collections.Counter()
    for o in ops:
        by_name[o["name"]] += o["dur"]
    return {
        "window_s": (t1 - t0) / 1e6,
        "busy_s": busy / 1e6,
        "requests": len(requests),
        "ops": ops,
        "device_ops": [[name[:120], us / 1e6] for name, us in
                       by_name.most_common(BREAKDOWN_ENTRIES)],
        "idle_gaps": [[label, us / 1e6] for label, us in
                      gaps.most_common(BREAKDOWN_ENTRIES)],
    }


def _label(host: _Host, wrappers: _Host, t: float) -> str:
    """What the host was doing at ``t``: its innermost operation there,
    under the benchmark annotation that holds it."""
    ann = wrappers.innermost(t)
    inner = host.innermost(t, None if ann is None else ann.get("tid"))
    if inner is None:
        return "host, outside any operation" if ann is None else ann["name"]
    name = inner["name"][:80]
    return name if ann is None else f"{ann['name']} > {name}"

"""Reduce a ``torch.profiler`` chrome trace of the measured window to
device time by layer, busy time and idle gaps.

Each device event (kernel, memcpy, memset) is tied to the host call that
launched it: its ``correlation`` names a CUDA runtime event on the
launching thread, and the Python frames and operators open on that thread
at that moment are the call's stack (the profiler records them with
``with_stack=True``). The event's layer is the first layer, walking the
stack from the innermost frame out, one of whose modules the frame's file
belongs to (``layers/*.json``). A launch from an autograd backward node of
C++ has no frames of its own; it takes the frames of the forward operator
the node came from, which the trace links by its forward-backward flows.
What matches no layer counts as ``other``.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "portbench.window"


@dataclass
class Reduced:
    window_s: float
    busy_s: float
    layer_s: Dict[str, float]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    events: int = 0
    kernels_by_layer: Dict[str, List[Tuple[str, float]]] = field(default_factory=dict)


def _frame_file(name: str) -> str:
    """The file of a python_function event name ``path(line): func``."""
    head = name.split("(", 1)[0]
    return head.replace("\\", "/")


def layer_of_file(path: str, layers: Dict[str, dict]) -> Optional[str]:
    for layer, spec in layers.items():
        for module in spec.get("modules", ()):
            if path.endswith(module):
                return layer
    return None


def reduce_trace(trace: dict, layers: Dict[str, dict], top: int = 10) -> Reduced:
    events = [e for e in trace.get("traceEvents", []) if isinstance(e, dict)]
    window = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"]
    if not window:
        raise ValueError(f"the trace holds no {WINDOW!r} annotation")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    main_tid = window[0].get("tid")

    # Host events by thread, for the stack sweep.
    by_tid = defaultdict(list)
    py_parent, py_name = {}, {}
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X" or cat in DEVICE_CATS:
            continue
        if cat == "python_function":
            args = e.get("args", {})
            pid = args.get("Python id")
            py_name[pid] = e.get("name", "")
            py_parent[pid] = args.get("Python parent id")
        if cat in ("python_function", "cpu_op", "user_annotation") or cat in LAUNCH_CATS:
            by_tid[e.get("tid")].append(e)
    flows_s, flows_f = {}, defaultdict(list)
    for e in events:
        if e.get("cat") == "fwdbwd":
            if e.get("ph") == "s":
                flows_s[e.get("id")] = (e.get("tid"), float(e["ts"]))
            elif e.get("ph") == "f":
                flows_f[(e.get("tid"), float(e["ts"]))].append(e.get("id"))

    # Sweep: for each host event, the innermost enclosing python frame and op.
    launch_ctx = {}        # correlation -> (python id, op key)
    op_ctx = {}            # op key (tid, ts) -> (python id, parent op key)
    op_start = defaultdict(list)   # tid -> sorted op start times
    for tid, evs in by_tid.items():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0))))
        stack = []         # (end, python id, op key)
        for e in evs:
            ts = float(e["ts"])
            end = ts + float(e.get("dur", 0))
            while stack and stack[-1][0] <= ts:
                stack.pop()
            py = stack[-1][1] if stack else None
            op = stack[-1][2] if stack else None
            cat = e.get("cat")
            if cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launch_ctx[corr] = (py, op)
                continue
            if cat == "python_function":
                py = e.get("args", {}).get("Python id")
            else:
                key = (tid, ts)
                op_ctx[key] = (py, op)
                op_start[tid].append(ts)
                op = key
            stack.append((end, py, op))
        op_start[tid].sort()

    def frames(py):
        seen = 0
        while py is not None and seen < 256:
            yield py_name.get(py, "")
            py = py_parent.get(py)
            seen += 1

    def layer_from_py(py):
        for name in frames(py):
            layer = layer_of_file(_frame_file(name), layers)
            if layer:
                return layer
        return None

    def op_at(tid, ts):
        """The op that starts at (tid, ts), if any (a flow's binding point)."""
        starts = op_start.get(tid, [])
        i = bisect.bisect_left(starts, ts - 1e-3)
        if i < len(starts) and abs(starts[i] - ts) <= 1e-3:
            return (tid, starts[i])
        return None

    def layer_of_launch(corr):
        ctx = launch_ctx.get(corr)
        if ctx is None:
            return None
        py, op = ctx
        layer = layer_from_py(py)
        if layer:
            return layer
        hops = 0
        while op is not None and hops < 64:
            for fid in flows_f.get(op, ()):
                src = flows_s.get(fid)
                if src is None:
                    continue
                fwd = op_at(*src)
                fwd_py = op_ctx[fwd][0] if fwd in op_ctx else None
                layer = layer_from_py(fwd_py)
                if layer:
                    return layer
            op = op_ctx.get(op, (None, None))[1]
            hops += 1
        return None

    layer_s = defaultdict(float)
    by_name = defaultdict(float)
    kernels_by_layer = defaultdict(lambda: defaultdict(float))
    intervals = []
    n_dev = 0
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        lo, hi = max(ts, w0), min(ts + dur, w1)
        if hi <= lo:
            continue
        n_dev += 1
        sec = (hi - lo) * 1e-6
        layer = layer_of_launch(e.get("args", {}).get("correlation")) or "other"
        name = e.get("name", "")
        layer_s[layer] += sec
        by_name[name] += sec
        kernels_by_layer[layer][name] += sec
        intervals.append((lo, hi))

    intervals.sort()
    merged = []
    for lo, hi in intervals:
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    busy = sum(hi - lo for lo, hi in merged) * 1e-6
    gaps = []
    prev = w0
    for lo, hi in merged:
        if lo > prev:
            gaps.append((prev, lo))
        prev = max(prev, hi)
    if w1 > prev:
        gaps.append((prev, w1))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    main = by_tid.get(main_tid, [])
    idle = []
    for lo, hi in gaps[:top]:
        idle.append((_host_label(main, (lo + hi) / 2), (hi - lo) * 1e-6))
    ops = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:top]
    kl = {k: sorted(v.items(), key=lambda kv: kv[1], reverse=True)[:top]
          for k, v in kernels_by_layer.items()}
    return Reduced(window_s=(w1 - w0) * 1e-6, busy_s=busy, layer_s=dict(layer_s),
                   device_ops=ops, idle_gaps=idle, events=n_dev, kernels_by_layer=kl)


def _host_label(events, t: float) -> str:
    """What the main thread was running at time t: the innermost frame of
    the program's package and the innermost operator or frame."""
    inner, port = None, None
    for e in events:
        ts = float(e["ts"])
        if ts <= t <= ts + float(e.get("dur", 0)):
            d = float(e.get("dur", 0))
            name = e.get("name", "")
            if inner is None or d < inner[0]:
                inner = (d, name)
            if "tensornetworks_tpu_torch" in name and (port is None or d < port[0]):
                port = (d, name.split("tensornetworks_tpu_torch/", 1)[-1])
    parts = [p[1] for p in (port, inner) if p is not None]
    return " | ".join(dict.fromkeys(parts))[:200] or "no host event"


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)

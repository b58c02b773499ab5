"""Reduce the program's own spans in a ``torch.profiler`` chrome trace of
the measured window: for each span name its calls, host ms, self device
ms and kernel launches, and the device's idle gaps by the span the host
was in.

The port records a span (``train.span``, a user annotation) at each of its
layer boundaries while a profiler runs; the names are the layers' own
(``engine.epoch``, ``born.fold``, ``circuit.backward``, ...). Spans on one
thread nest.

- A device operation (kernel, memcpy, memset) goes to the innermost span
  open on the thread that launched it (its ``correlation`` names the CUDA
  runtime call) at the launch. Where that thread has none open, as on
  autograd's thread outside a custom Function's backward, it goes to the
  span open around the forward operator of the backward node that
  launched it (the trace's forward-backward flows, tried from the
  innermost operator out); failing that, to the main thread's innermost
  span at the launch, and else to ``NO_SPAN``.
- A span's host ms is its duration less the time any thread spent waiting
  for the device inside it: in a synchronising CUDA runtime call
  (``blocked``), and in a call that queues work (``queued``) beyond that
  call's lower-quartile duration in the window. A launch returns at once
  until the stream's queue is full; in an epoch that never syncs the host
  then waits in each launch for a slot, at the device's pace.
- ``checked`` gives nothing where the window's ``engine.epoch`` spans are
  not one per epoch, so that no reading per epoch is taken from them.
- ``device_ms`` adds the device time of the spans nested inside; a span
  that opens on another thread with none open there nests in the main
  thread's innermost span at its start.
- ``backward_host_ms``: the host time of the backward nodes (on any
  thread) whose forward operator ran with the span innermost around it.
- ``kernels_by_span``: each span's operations with the most self device
  seconds, by name.
- ``idle_by_span``: each of the window's longest device gaps goes to the
  innermost span open at its start on any thread, the latest-started one
  first; where none is open there, as before the window's first span, to
  the first span that opens in the gap.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from .trace import DEVICE_CATS, LAUNCH_CATS, WINDOW

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
BACKWARD_NODE = "autograd::engine::evaluate_function: "
NO_SPAN = "(no span)"


@dataclass
class SpanRow:
    calls: int = 0
    host_ms: float = 0.0
    self_device_ms: float = 0.0
    device_ms: float = 0.0
    launches: int = 0
    backward_host_ms: float = 0.0


@dataclass
class Spans:
    table: Dict[str, SpanRow]
    idle_by_span: List[Tuple[str, float]] = field(default_factory=list)
    kernels_by_span: Dict[str, List[Tuple[str, float]]] = field(default_factory=dict)
    sync_ms: float = 0.0
    queue_wait_ms: float = 0.0


def blocked(name: str) -> bool:
    """A CUDA runtime call that blocks the host until the device is done:
    the synchronisations and the synchronous ``cudaMemcpy*``."""
    return name in SYNC_CALLS or (name.startswith("cudaMemcpy") and "Async" not in name)


def queued(name: str) -> bool:
    """A CUDA runtime or driver call that puts work on a stream and returns:
    the launches, the ``*Async`` copies and sets, ``cudaEventRecord``."""
    return not blocked(name) and ("Launch" in name or name.endswith("Async")
                                  or name == "cudaEventRecord")


class _Nest:
    """The properly nested intervals of one thread, each with a payload:
    the innermost one open at a time, by bisection and the parent chain."""

    def __init__(self, items: List[tuple]):
        self.items = sorted(items, key=lambda x: (x[0], -x[1]))
        self.starts = [x[0] for x in self.items]
        self.parent: List[int] = []
        stack: List[int] = []
        for i, (ts, _, _) in enumerate(self.items):
            while stack and self.items[stack[-1]][1] <= ts:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t: float) -> int:
        """The index of the innermost interval with start <= t < end, or -1."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.items[i][1] <= t:
            i = self.parent[i]
        return i


class _Merged:
    """A union of intervals, for the measure of its overlap with another."""

    def __init__(self, intervals: Iterable[Tuple[float, float]]):
        merged: List[List[float]] = []
        for lo, hi in sorted(intervals):
            if merged and lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        self.lo = [m[0] for m in merged]
        self.hi = [m[1] for m in merged]

    def overlap(self, a: float, b: float) -> float:
        total = 0.0
        i = max(0, bisect.bisect_right(self.lo, a) - 1)
        while i < len(self.lo) and self.lo[i] < b:
            total += max(0.0, min(b, self.hi[i]) - max(a, self.lo[i]))
            i += 1
        return total


def reduce_spans(trace: dict, top: int = 10) -> Spans:
    events = [e for e in trace.get("traceEvents", []) if isinstance(e, dict)]
    window = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"]
    if not window:
        raise ValueError(f"the trace holds no {WINDOW!r} annotation")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    main = (window[0].get("pid"), window[0].get("tid"))

    def key(e):
        return (e.get("pid"), e.get("tid"))

    spans, ops, syncs, launch = defaultdict(list), defaultdict(list), [], {}
    calls = defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts = e.get("cat"), float(e["ts"])
        end = ts + float(e.get("dur", 0))
        if cat == "user_annotation" and e.get("name") != WINDOW:
            spans[key(e)].append((ts, end, e.get("name", "")))
        elif cat == "cpu_op":
            ops[key(e)].append((ts, end, e.get("name", "")))
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = (key(e), ts)
            if blocked(e.get("name", "")):
                syncs.append((ts, end))
            elif queued(e.get("name", "")) and w0 <= ts <= w1:
                calls[e["name"]].append((ts, end))
    waits = []
    for spells in calls.values():
        cost = sorted(end - ts for ts, end in spells)[len(spells) // 4]
        waits += [(ts + cost, end) for ts, end in spells if end - ts > cost]
    span_nest = {k: _Nest(v) for k, v in spans.items()}
    op_nest = {k: _Nest(v) for k, v in ops.items()}
    waiting = _Merged(syncs + waits)
    flows_s, flows_f = {}, defaultdict(list)
    for e in events:
        if e.get("cat") == "fwdbwd":
            if e.get("ph") == "s":
                flows_s[e.get("id")] = (key(e), float(e["ts"]))
            elif e.get("ph") == "f":
                flows_f[(key(e), float(e["ts"]))].append(e.get("id"))

    def span_at(k, t) -> Optional[Tuple[tuple, int]]:
        nest = span_nest.get(k)
        i = nest.at(t) if nest else -1
        return (k, i) if i >= 0 else None

    def forward_span(k, ts):
        """The span around the forward operator of the backward node whose
        flow ends at (thread, ts)."""
        for fid in flows_f.get((k, ts), ()):
            src = flows_s.get(fid)
            if src is not None:
                found = span_at(*src)
                if found:
                    return found
        return None

    def owner(corr) -> Optional[Tuple[tuple, int]]:
        if corr not in launch:
            return None
        k, t = launch[corr]
        found = span_at(k, t)
        nest = op_nest.get(k)
        i = nest.at(t) if nest else -1
        while found is None and i >= 0:
            found = forward_span(k, nest.items[i][0])
            i = nest.parent[i]
        return found or span_at(main, t)

    def parent(inst):
        k, i = inst
        p = span_nest[k].parent[i]
        if p >= 0:
            return (k, p)
        return span_at(main, span_nest[k].items[i][0]) if k != main else None

    def name(inst) -> str:
        return span_nest[inst[0]].items[inst[1]][2] if inst else NO_SPAN

    table: Dict[str, SpanRow] = defaultdict(SpanRow)
    for k, nest in span_nest.items():
        for ts, end, nm in nest.items:
            if w0 <= ts <= w1:
                row = table[nm]
                row.calls += 1
                row.host_ms += 1e-3 * (end - ts - waiting.overlap(ts, end))

    intervals = []
    kernels = defaultdict(lambda: defaultdict(float))
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        ts = float(e["ts"])
        lo, hi = max(ts, w0), min(ts + float(e.get("dur", 0)), w1)
        if hi <= lo:
            continue
        intervals.append((lo, hi))
        inst = owner(e.get("args", {}).get("correlation"))
        row = table[name(inst)]
        row.self_device_ms += 1e-3 * (hi - lo)
        kernels[name(inst)][e.get("name", "")] += (hi - lo) * 1e-6
        row.launches += e.get("cat") == "kernel"
        seen = set()
        while inst is not None:
            nm = name(inst)
            if nm not in seen:
                seen.add(nm)
                table[nm].device_ms += 1e-3 * (hi - lo)
            inst = parent(inst)
        if not seen:
            table[NO_SPAN].device_ms += 1e-3 * (hi - lo)

    # Backward nodes by the span of their forward operator, each node once
    # (the evaluate_function event around the node's own operator).
    counted = set()
    for (k, ts), _ in flows_f.items():
        nest = op_nest.get(k)
        i = nest.at(ts) if nest else -1
        if i < 0:
            continue
        p = nest.parent[i]
        if p >= 0 and nest.items[p][2].startswith(BACKWARD_NODE):
            i = p
        if (k, i) in counted:
            continue
        counted.add((k, i))
        fwd = forward_span(k, ts)
        lo, hi = max(nest.items[i][0], w0), min(nest.items[i][1], w1)
        if fwd and hi > lo:
            table[name(fwd)].backward_host_ms += 1e-3 * (hi - lo - waiting.overlap(lo, hi))

    busy = _Merged(intervals)
    gaps, prev = [], w0
    for lo, hi in zip(busy.lo, busy.hi):
        if lo > prev:
            gaps.append((prev, lo))
        prev = max(prev, hi)
    if w1 > prev:
        gaps.append((prev, w1))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    def start(inst):
        return span_nest[inst[0]].items[inst[1]][0]

    def first_opened(lo, hi):
        """The earliest span on any thread that opens in [lo, hi)."""
        found = []
        for k, nest in span_nest.items():
            i = bisect.bisect_left(nest.starts, lo)
            if i < len(nest.starts) and nest.starts[i] < hi:
                found.append((k, i))
        return min(found, key=start, default=None)

    idle = []
    for lo, hi in gaps[:top]:
        open_now = [s for s in (span_at(k, lo) for k in span_nest) if s is not None]
        inst = max(open_now, key=start, default=None) or first_opened(lo, hi)
        idle.append((name(inst), (hi - lo) * 1e-6))
    kbs = {k: sorted(v.items(), key=lambda kv: kv[1], reverse=True)[:top]
           for k, v in kernels.items()}
    return Spans(table=dict(table), idle_by_span=idle, kernels_by_span=kbs,
                 sync_ms=1e-3 * _Merged(syncs).overlap(w0, w1),
                 queue_wait_ms=1e-3 * _Merged(waits).overlap(w0, w1))


def checked(spans: Spans, epochs: int) -> Optional[Spans]:
    """``spans`` where the window holds one ``engine.epoch`` span per epoch,
    else None: a span dropped or doubled would skew every reading per
    epoch."""
    row = spans.table.get("engine.epoch") if spans is not None else None
    return spans if row is not None and row.calls == epochs else None

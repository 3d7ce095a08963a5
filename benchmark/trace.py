"""The profiled sub-window of a traced run, reduced to what the per-layer
readers and the ``breakdown`` read.

``collect(prof)`` takes the events of a stopped ``torch.profiler.profile``
(the kineto results, or its Chrome trace where those lack the fields);
``Trace`` holds the device's activity (kernels, copies and sets, each
with its start, length and stream), the host's operations, the device
busy time (the union of the device intervals) and the length of the
sub-window on the host clock, between two synchronisations.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass
from typing import List

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function", "user_annotation")


@dataclass
class Event:
    cat: str
    name: str
    start_ns: int
    dur_ns: int
    lane: int  # the stream of a device event, the thread of a host one


def short(name: str) -> str:
    """A kernel's own name: ``void ns::k<T>(A)`` -> ``k``."""
    name, depth, plain = name.replace("(anonymous namespace)", "anon"), 0, ""
    for ch in name:
        depth += (ch == "<") - (ch == ">")
        if depth == 0 and ch != ">":
            plain += ch
    head = plain.split("(", 1)[0].strip()
    return head.rsplit("::", 1)[-1].split()[-1] if head else name


def _from_kineto(prof) -> List[Event]:
    out = []
    for e in prof.profiler.kineto_results.events():
        cat = e.activity_type()
        if cat in DEVICE_CATS:
            lane = e.device_resource_id()
        elif cat in HOST_CATS:
            lane = e.start_thread_id()
        else:
            continue
        out.append(Event(cat, e.name(), int(e.start_ns()), int(e.duration_ns()), int(lane)))
    return out


def _from_chrome(prof) -> List[Event]:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out = []
    for e in events:
        cat = e.get("cat")
        if (cat in DEVICE_CATS or cat in HOST_CATS) and "dur" in e:
            lane = e.get("tid", 0)
            out.append(Event(cat, e.get("name", ""), int(e["ts"] * 1000),
                             int(e["dur"] * 1000), lane if isinstance(lane, int) else 0))
    return out


def collect(prof) -> List[Event]:
    try:
        return _from_kineto(prof)
    except (AttributeError, TypeError):
        return _from_chrome(prof)


class Trace:
    def __init__(self, events: List[Event], window_s: float, steps: int):
        self.window_s = window_s
        self.steps = steps
        self.device = sorted((e for e in events if e.cat in DEVICE_CATS),
                             key=lambda e: e.start_ns)
        self.kernels = [e for e in self.device if e.cat == "kernel"]
        self.host = [e for e in events if e.cat in HOST_CATS]
        self.busy_s = sum(b - a for a, b in self._busy()) / 1e9

    def _busy(self):
        """The union of the device intervals, as sorted (start, end) ns."""
        spans = []
        for e in self.device:
            a, b = e.start_ns, e.start_ns + e.dur_ns
            if spans and a <= spans[-1][1]:
                spans[-1][1] = max(spans[-1][1], b)
            else:
                spans.append([a, b])
        return spans

    def kernel_seconds(self, pick) -> float:
        """Seconds of the kernels whose short name ``pick`` accepts."""
        return sum(e.dur_ns for e in self.kernels if pick(short(e.name))) / 1e9

    def family_seconds(self, members: dict, followers: tuple) -> dict:
        """{family: kernel seconds}: a kernel whose short name is in
        ``members`` (name -> family) counts to its family; one in
        ``followers`` (a stage launched by several kernels) to the family of
        the member kernel that ran last before it on its stream."""
        out, last = {}, {}
        for e in self.kernels:
            name = short(e.name)
            fam = members.get(name)
            if fam is not None:
                last[e.lane] = fam
            elif name in followers:
                fam = last.get(e.lane)
            if fam is not None:
                out[fam] = out.get(fam, 0.0) + e.dur_ns / 1e9
        return out

    def top_ops(self, n=10):
        """[[kernel or copy name, seconds]] of the device ops with the most
        time, largest first."""
        tot = {}
        for e in self.device:
            key = short(e.name) if e.cat == "kernel" else e.name
            tot[key] = tot.get(key, 0.0) + e.dur_ns / 1e9
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n=10):
        """[[what the host was doing, seconds]] of the longest gaps between
        device intervals: the innermost host operation over the gap's
        middle, or ``host (no torch op)``."""
        spans = self._busy()
        gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(spans, spans[1:])
                       if b[0] > a[1]), reverse=True)[:n]
        out = []
        for length, a, b in gaps:
            mid = (a + b) // 2
            over = [e for e in self.host if e.start_ns <= mid <= e.start_ns + e.dur_ns]
            name = max(over, key=lambda e: e.start_ns).name if over else "host (no torch op)"
            out.append([name, length / 1e9])
        return out

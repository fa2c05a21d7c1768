"""Reading a ``torch.profiler`` trace: device intervals, their union, the
time by kernel, and the host's activity in the device's idle gaps.

A stretch is profiled with CUDA activity only when it measures the
device (the profiler's CPU tracing slows the host and so inflates the
idle share), and with CPU activity too when it attributes the gaps."""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")


@dataclass
class Stretch:
    """Device events (name, start us, duration us), host events likewise,
    the host clock's seconds over the stretch and the steps it held."""

    device: list
    host: list
    wall_s: float
    steps: int
    launches: dict = field(default_factory=dict)

    def busy_s(self) -> float:
        return union_us([(t, d) for _, t, d in self.device]) * 1e-6

    def seconds_where(self, keep) -> float:
        """Device seconds of the events whose name ``keep`` accepts (their
        sum: events of one stream do not overlap)."""
        return sum(d for n, _, d in self.device if keep(n)) * 1e-6


def union_us(intervals) -> float:
    """Length of the union of (start, duration) intervals."""
    total, end = 0.0, None
    for t, d in sorted(intervals):
        lo, hi = t, t + d
        if end is None or lo > end:
            total += hi - lo
            end = hi
        elif hi > end:
            total += hi - end
            end = hi
    return total


def merged(intervals):
    out = []
    for t, d in sorted(intervals):
        if out and t <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t + d)
        else:
            out.append([t, t + d])
    return out


_ANON = re.compile(r"\(anonymous namespace\)::")


def kernel_id(name: str) -> str:
    """A kernel's bare name: ``void ns::k<...>(...)`` gives ``k``."""
    s = _ANON.sub("", name)
    if s.startswith("void "):
        s = s[5:]
    s = re.split(r"[<(]", s, maxsplit=1)[0].strip()
    return s.rsplit("::", 1)[-1]


def profile(fn, steps: int, with_cpu: bool) -> Stretch:
    """Run ``fn`` (``steps`` whole steps, ending in a device sync) under
    ``torch.profiler``; the trace goes through a file in ``TMPDIR``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                      if with_cpu else [])
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with torch_profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((e["name"], float(e["ts"]), float(e["dur"])))
        elif cat in HOST_CATS:
            host.append((e["name"], float(e["ts"]), float(e["dur"])))
    return Stretch(dev, host, wall, steps)


def top_device_ops(s: Stretch, n: int = 10):
    """[name, seconds a step] of the device operations that took most."""
    by = {}
    for name, _, d in s.device:
        key = name[:120]
        by[key] = by.get(key, 0.0) + d * 1e-6 / s.steps
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(s: Stretch, n: int = 10):
    """[host activity, seconds a step] of the device's idle gaps between
    its first and last operation, each gap named by the innermost host
    event around its middle."""
    busy = merged([(t, d) for _, t, d in s.device])
    gaps = [(a, b) for (_, a), (b, _) in zip(busy, busy[1:])]
    if not gaps:
        return []
    mids = np.array([0.5 * (a + b) for a, b in gaps])
    order = np.argsort(mids)
    mids = mids[order]
    best = np.full(len(mids), np.inf)
    who = np.full(len(mids), -1)
    for i, (_, t, d) in enumerate(s.host):
        lo = np.searchsorted(mids, t)
        hi = np.searchsorted(mids, t + d, side="right")
        if hi > lo:
            sel = best[lo:hi] > d
            best[lo:hi][sel] = d
            who[lo:hi][sel] = i
    by = {}
    for k, j in enumerate(order):
        a, b = gaps[j]
        key = s.host[who[k]][0][:120] if who[k] >= 0 else "(no host event)"
        by[key] = by.get(key, 0.0) + (b - a) * 1e-6 / s.steps
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

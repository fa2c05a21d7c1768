"""The program's spans and counters, and its profiling hooks (the port's
``dgl1_tpu/utils/profiler.py``, grown).

``span(name, **attrs)`` marks a phase of the program where its work runs
and ``count(name, n)`` adds to a counter there. Both are off by default,
and off they cost one flag check: ``span`` hands back one shared object
that does nothing, ``count`` returns at once. They are on while any
``torch.profiler`` session runs (the benchmark's traced stretches, an
operator's :func:`profile_trace`) and inside :func:`collect`. On:

* a span enters ``torch.profiler.record_function("dgl1::<name>")``, so
  the profiler's trace shows it on the clock of the card's kernels (a
  span with ``attrs`` shows their values too: ``dgl1::model.layer[1]``);
* inside a trainer's call (:func:`train_record`; ``train.train`` and the
  sampled trainers open one) it records its host start and end, its
  parent and its ``attrs``, and, when the trainer's tensors are on a
  card, a pair of CUDA events on the current stream: its device interval.
  A span opened on autograd's backward thread takes the trainer's open
  ``train.backward`` span as its parent. Counters add to the call's
  record.

:func:`records` gives one :class:`Record` a trainer's call made while
tracing was on: its steps, a table by span name (calls, host seconds,
device seconds, self device seconds: the device interval less its
children's) and its counters. A record is resolved when first read,
which is the only sync. The names and what reads them are in PERF.md's
list of layers.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["span", "count", "collect", "records", "tracing", "Record",
           "train_record", "profile_trace", "device_ms", "union_length",
           "STEP", "BACKWARD"]

# The trainer's step span, and its backward span, which adopts the spans
# autograd's backward thread opens.
STEP = "train.step"
BACKWARD = "train.backward"


class _State:
    """Tracing's switches: how many :func:`collect` blocks are open, the
    trainer's open record, the spans each thread has open."""

    def __init__(self):
        self.collecting = 0
        self.record = None
        self.records = []
        self.lock = threading.Lock()
        self.local = threading.local()

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st


_STATE = _State()


def tracing() -> bool:
    """Whether spans and counters are on: inside :func:`collect` or while
    a ``torch.profiler`` session runs."""
    return bool(_STATE.collecting or _autograd_profiler._is_profiler_enabled)


class _Noop:
    """What ``span`` gives while tracing is off: one shared object."""

    __slots__ = ("pending",)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def drop(self) -> None:
        pass

    def __call__(self, fn):
        name, attrs = self.pending
        return _decorate(fn, name, attrs)


_NOOP = _Noop()
_NOOP.pending = ("", {})


def _decorate(fn, name, attrs):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with span(name, **attrs):
            return fn(*args, **kwargs)

    return wrapper


class _Span:
    """An open span while tracing is on (see the module docstring)."""

    __slots__ = ("name", "attrs", "rf", "rec", "parent", "t0", "t1", "ev0",
                 "ev1", "dropped")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs
        self.rec = self.parent = self.ev0 = self.ev1 = self.t1 = None
        self.dropped = False

    def __call__(self, fn):
        return _decorate(fn, self.name, self.attrs)

    def drop(self) -> None:
        """Leave this span out of the record (a dispatch attempt its
        engine declined); its children go to its parent."""
        self.dropped = True

    def __enter__(self):
        label = self.name
        if self.attrs:
            label += "[" + ",".join(str(v) for v in self.attrs.values()) + "]"
        self.rf = torch.profiler.record_function("dgl1::" + label)
        self.rf.__enter__()
        rec = _STATE.record
        if rec is not None:
            self.rec = rec
            st = _STATE.stack()
            self.parent = st[-1] if st else rec.backward
            st.append(self)
            if self.name == BACKWARD:
                rec.backward = self
            rec.entered.append(self)
            if rec.cuda:
                self.ev0 = torch.cuda.Event(enable_timing=True)
                self.ev0.record()
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            self.t1 = time.perf_counter()
            if rec.cuda:
                self.ev1 = torch.cuda.Event(enable_timing=True)
                self.ev1.record()
            st = _STATE.stack()
            if st and st[-1] is self:
                st.pop()
            if self.name == BACKWARD:
                rec.backward = None
        self.rf.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A span named ``name`` (see the module docstring): a context manager,
    or a decorator that opens it around each call of the function."""
    if _STATE.collecting or _autograd_profiler._is_profiler_enabled:
        return _Span(name, attrs)
    # The decorator form reads the name back at once.
    _NOOP.pending = (name, attrs)
    return _NOOP


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the trainer's open record."""
    if not (_STATE.collecting or _autograd_profiler._is_profiler_enabled):
        return
    rec = _STATE.record
    if rec is not None:
        with _STATE.lock:
            rec.raw_counters[name] = rec.raw_counters.get(name, 0) + int(n)


class Record:
    """One trainer call's spans and counters, resolved when first read:

    * ``steps``: its ``train.step`` spans;
    * ``spans``: one dict a span in opening order (``name``, ``attrs``,
      ``parent`` (an index or None), ``host_start`` and ``host_end``
      (``time.perf_counter``), ``device_s`` and ``self_device_s``, None
      off a card);
    * ``table``: by span name, ``calls``, ``host_s``, ``device_s`` and
      ``self_device_s`` summed;
    * ``counters``: by name."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.entered = []
        self.backward = None
        self.raw_counters = {}
        self._resolved = None

    def _resolve(self):
        if self._resolved is not None:
            return self._resolved
        if self.cuda:
            torch.cuda.synchronize()
        kept = [s for s in self.entered if not s.dropped and s.t1 is not None]
        index = {id(s): i for i, s in enumerate(kept)}

        def parent_of(s):
            p = s.parent
            while p is not None and id(p) not in index:
                p = p.parent
            return None if p is None else index[id(p)]

        spans = []
        for s in kept:
            dev = (s.ev0.elapsed_time(s.ev1) * 1e-3
                   if s.ev0 is not None and s.ev1 is not None else None)
            spans.append({"name": s.name, "attrs": dict(s.attrs),
                          "parent": parent_of(s), "host_start": s.t0,
                          "host_end": s.t1, "device_s": dev,
                          "self_device_s": dev})
        for sp in spans:
            p = sp["parent"]
            if p is not None and sp["device_s"] is not None \
                    and spans[p]["self_device_s"] is not None:
                spans[p]["self_device_s"] -= sp["device_s"]
        table = {}
        for sp in spans:
            row = table.setdefault(sp["name"], {
                "calls": 0, "host_s": 0.0,
                "device_s": 0.0 if self.cuda else None,
                "self_device_s": 0.0 if self.cuda else None})
            row["calls"] += 1
            row["host_s"] += sp["host_end"] - sp["host_start"]
            if self.cuda and sp["device_s"] is not None:
                row["device_s"] += sp["device_s"]
                row["self_device_s"] += sp["self_device_s"]
        self._resolved = (spans, table, dict(self.raw_counters))
        self.entered = []
        return self._resolved

    @property
    def spans(self) -> list:
        return self._resolve()[0]

    @property
    def table(self) -> dict:
        return self._resolve()[1]

    @property
    def counters(self) -> dict:
        return self._resolve()[2]

    @property
    def steps(self) -> int:
        row = self.table.get(STEP)
        return row["calls"] if row else 0

    def as_dict(self) -> dict:
        return {"steps": self.steps, "table": self.table,
                "counters": self.counters}


@contextlib.contextmanager
def train_record(device):
    """The record of one trainer call on ``device``'s tensors: opened when
    tracing is on as the call starts, else None."""
    if not tracing():
        yield None
        return
    rec = Record(cuda=torch.device(device).type == "cuda")
    prev, _STATE.record = _STATE.record, rec
    try:
        yield rec
    finally:
        _STATE.record = prev
        _STATE.records.append(rec)


def records() -> list:
    """Every :class:`Record` made in this process so far, in order."""
    return list(_STATE.records)


@contextlib.contextmanager
def collect():
    """Tracing on inside the block, with or without a profiler; yields a
    list that holds, once the block ends, the records made inside."""
    made = []
    with _STATE.lock:
        _STATE.collecting += 1
        start = len(_STATE.records)
    try:
        yield made
    finally:
        with _STATE.lock:
            _STATE.collecting -= 1
        made.extend(_STATE.records[start:])


@contextlib.contextmanager
def profile_trace(log_dir: str = None):
    """With ``log_dir``, profile the block (the host, and the card when
    there is one) and write the trace there for TensorBoard, where the
    program's spans show beside the kernels they launched; the span
    tables of the trainer calls made in the block go to
    ``<log_dir>/spans.json``. Yields the profiler. Without ``log_dir``,
    do nothing and yield None."""
    if not log_dir:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with collect() as made:
        with torch.profiler.profile(
                activities=acts,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    str(log_dir))) as prof:
            yield prof
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(str(log_dir), "spans.json"), "w") as f:
        json.dump([r.as_dict() for r in made], f)


def union_length(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for lo, hi in sorted(intervals):
        if end is None or lo > end:
            total += hi - lo
            end = hi
        elif hi > end:
            total += hi - end
            end = hi
    return total


def device_ms(prof, top: int = 6) -> tuple:
    """Device busy ms over a ``torch.profiler`` window (the union of its
    device intervals: kernels on several streams, or nested in an
    annotation's device span, count once) and its ``top`` kernels by
    their summed time (name, ms, calls). Annotations (``record_function``
    ranges, which the trace also draws on the device) are not work."""
    events = list(prof.events())
    host = {e.name for e in events
            if e.device_type == torch.autograd.DeviceType.CPU}
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name not in host]
    busy_us = union_length((e.time_range.start, e.time_range.end)
                           for e in kernels)
    by = {}
    for e in kernels:
        us, n = by.get(e.name, (0.0, 0))
        by[e.name] = (us + e.time_range.end - e.time_range.start, n + 1)
    first = sorted(by.items(), key=lambda kv: -kv[1][0])[:top]
    return busy_us / 1e3, [(k, us / 1e3, n) for k, (us, n) in first]

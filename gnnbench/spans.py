"""The program's own spans and counters, as the per-layer readers take
them: the record ``dgl1_tpu_torch.utils.profiler`` keeps of the device
stretch, the first ``train`` call traced in the process. (The host
stretch's is the second; its CPU tracing slows the host, so no reader
takes it.) Each record gives its ``steps``, its ``spans`` (dicts with
``name``, ``attrs``, ``parent``, ``host_start``, ``host_end``,
``device_s``), a ``table`` by span name and its ``counters``.

A program that keeps no records (one without ``utils.profiler.records``),
or whose first record does not hold the stretch's steps, gives None, and
so does every reader built on it."""

from __future__ import annotations


def device_record(ctx):
    """The device stretch's record, or None."""
    try:
        from dgl1_tpu_torch.utils.profiler import records
    except ImportError:
        return None
    found = records()
    if not found or found[0].steps != ctx.stretch.steps \
            or found[0].steps <= 0:
        return None
    return found[0]


def within(rec, span: dict, prefix: str) -> bool:
    """Whether an ancestor of ``span`` has a name starting ``prefix``."""
    p = span["parent"]
    while p is not None:
        if rec.spans[p]["name"].startswith(prefix):
            return True
        p = rec.spans[p]["parent"]
    return False


def device_ms(rec, spans) -> float | None:
    """Device ms a step summed over ``spans``; None when a span has no
    device interval."""
    total = 0.0
    for s in spans:
        if s["device_s"] is None:
            return None
        total += s["device_s"]
    return total * 1e3 / rec.steps

"""``host_issue_ms`` (ms a step, Trainer): host ms from the start of the
program's ``train.step`` span to the start of its ``train.readback``
(``train.py``), averaged over the device stretch's steps: how long the
host takes to issue a step. Near ``epoch_ms`` on a device-bound cell, it
says a sync hides in mid-step; far under it, the host has room."""

from gnnbench import spans


def read(ctx):
    rec = spans.device_record(ctx)
    if rec is None:
        return None
    start = {}
    for i, s in enumerate(rec.spans):
        if s["name"] == "train.step":
            start[i] = s["host_start"]
    gaps = [s["host_start"] - start[s["parent"]] for s in rec.spans
            if s["name"] == "train.readback" and s["parent"] in start]
    if not gaps or len(gaps) != len(start):
        return None
    return 1e3 * sum(gaps) / len(gaps)

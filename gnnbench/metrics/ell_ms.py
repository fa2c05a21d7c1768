"""``ell_ms`` (ms a step, Engines): device ms a step in the ELL engine's
stacks and inverse permutes (the program's ``ell.stack`` and
``ell.permute`` spans, ``ops/engine_ell.py``), wherever they are called
from: the ELL engine's g-SpMM, the hub engine's and the hub attention's
tails. None where no ELL stack ran."""

from gnnbench import spans


def read(ctx):
    rec = spans.device_record(ctx)
    if rec is None:
        return None
    ell = [s for s in rec.spans if s["name"] in ("ell.stack", "ell.permute")]
    if not ell:
        return None
    return spans.device_ms(rec, ell)

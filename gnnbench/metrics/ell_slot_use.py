"""``ell_slot_use`` (%, Engines): the share of the ELL stacks' gathered
slots that hold an edge, over the device stretch: the program's counters
``ell.real`` over ``ell.slots`` (each stack adds its real edges and its
padded slots, n_rows * k over its buckets). None where no stack
counted."""

from gnnbench import spans


def read(ctx):
    rec = spans.device_record(ctx)
    if rec is None:
        return None
    slots = rec.counters.get("ell.slots", 0)
    if slots <= 0:
        return None
    return 100.0 * rec.counters.get("ell.real", 0) / slots

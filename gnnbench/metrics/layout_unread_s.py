"""``layout_unread_s`` (s, Host layout): set-up seconds spent on layouts
that no step read: the program's ``build_s`` (host seconds of each
format's build and copy to the card, ``graph.py``; summed over the
relations of a heterograph) of every format but ``adj`` that had no
``layout.read.<format>`` count in the device stretch (the engines count
each format they read). None where the program keeps neither."""

from gnnbench import spans


def read(ctx):
    built = getattr(ctx.graph, "build_s", None)
    rec = spans.device_record(ctx)
    if not built or rec is None:
        return None
    return sum(sec for fmt, sec in built.items()
               if fmt != "adj" and not rec.counters.get(f"layout.read.{fmt}"))

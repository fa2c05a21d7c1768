"""``attn_glue_ms`` (ms a step, Engines): the hub attention's torch glue,
its ELL stacks included: device ms a step in the program's ``attn.*``
spans (``ops/attention.py``) less the ``kernel.*`` spans inside them
(K6-K8). None where the program ran no hub attention."""

from gnnbench import spans


def read(ctx):
    rec = spans.device_record(ctx)
    if rec is None:
        return None
    attn = [s for s in rec.spans if s["name"].startswith("attn.")]
    if not attn:
        return None
    kernels = [s for s in rec.spans if s["name"].startswith("kernel.")
               and spans.within(rec, s, "attn.")]
    total, inside = spans.device_ms(rec, attn), spans.device_ms(rec, kernels)
    if total is None or inside is None:
        return None
    return total - inside

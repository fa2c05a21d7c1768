"""``dead_rel_ms`` (ms a step, Model): device ms a step in the last layer's
relations whose destination is not the configuration's output type
(``target``): work whose output no loss reads. The program's
``hetero.rel`` spans (``nn/hetero.py``, attrs ``src``, ``etype``,
``dst``) inside the ``model.layer`` spans of the highest ``index``
(``models/rgcn.py``); forward only, as the relations' backward is not
run. None without layer spans or a target type."""

from gnnbench import spans


def read(ctx):
    target = ctx.cfg.get("target")
    rec = spans.device_record(ctx)
    if rec is None or target is None:
        return None
    layers = [i for i, s in enumerate(rec.spans) if s["name"] == "model.layer"]
    if not layers:
        return None
    last = max(rec.spans[i]["attrs"]["index"] for i in layers)
    last_ids = {i for i in layers if rec.spans[i]["attrs"]["index"] == last}

    def in_last(s):
        p = s["parent"]
        while p is not None:
            if p in last_ids:
                return True
            p = rec.spans[p]["parent"]
        return False

    dead = [s for s in rec.spans if s["name"] == "hetero.rel"
            and s["attrs"]["dst"] != target and in_last(s)]
    return spans.device_ms(rec, dead)

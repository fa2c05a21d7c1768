"""``layout_build_s`` (s, Host layout): set-up's seconds in the program's
graph build, the harness's ``layout_build`` span around
``dgl1_tpu_torch.graph`` / ``heterograph`` (host layouts and the copy to
the card)."""


def read(ctx):
    return ctx.spans.get("layout_build")

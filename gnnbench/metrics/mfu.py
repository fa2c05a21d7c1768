"""``mfu`` (%, Model, the whole step): the configuration's FLOPs a step
(``models/<model>.py``'s ``step_flops``) over the window's ``epoch_ms``,
over the card's float32 peak."""

from gnnbench.peaks import FP32_FLOPS_PER_S


def read(ctx):
    if ctx.flops <= 0 or ctx.epoch_ms <= 0:
        return None
    return 100.0 * ctx.flops / (ctx.epoch_ms * 1e-3) / FP32_FLOPS_PER_S

"""``idle_share`` (%, Device): the share of a step in which no kernel, copy
or fill ran on the card: 1 - the union of their intervals a step in the
device stretch over the window's ``epoch_ms``. The window's own step
time, and not the stretch's wall clock, because the profiler's tracing
of each launch slows the host, and a host-paced step with it."""


def read(ctx):
    s = ctx.stretch
    if not s.device or ctx.epoch_ms <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s() / s.steps / (ctx.epoch_ms * 1e-3))

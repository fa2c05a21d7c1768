"""``glue_ms`` (ms a step, Engines and front end): device time in every
other kernel, copy and fill (torch's gathers, scatters, reductions and
elementwise work around the hand kernels and the GEMMs)."""

from gnnbench.metrics.gemm_ms import is_gemm
from gnnbench.metrics.kernel_ms import is_hand


def read(ctx):
    if not ctx.stretch.device:
        return None
    rest = ctx.stretch.seconds_where(
        lambda n: not is_hand(n) and not is_gemm(n))
    return rest * 1e3 / ctx.stretch.steps

"""``gemm_ms`` (ms a step, Model's dense projections): device time in
cuBLAS and CUTLASS matrix products, told by their kernels' names."""

GEMM_MARKS = ("gemm", "gemv", "cutlass", "cublas", "xmma", "nvjet",
              "splitk")


def is_gemm(name: str) -> bool:
    low = name.lower()
    return any(m in low for m in GEMM_MARKS)


def read(ctx):
    if not ctx.stretch.device:
        return None
    return ctx.stretch.seconds_where(is_gemm) * 1e3 / ctx.stretch.steps

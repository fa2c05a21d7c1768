"""Run one cell of the benchmark once and print its result line.

    python3 -m gnnbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Measures the port (``dgl1_tpu_torch``) on
one CUDA card; exits non-zero without a result when there is no card, or
when JAX or the JAX package is loaded. The compared numbers and their
limits are the last lines of standard error and the last key of the
result, the last line of standard output."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip() or out.stderr.strip()


def main(argv=None) -> int:
    t_start = time.perf_counter()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from gnnbench import bench

    spec = bench.load_benchmark()
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}
    if args.workload not in chips:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < chips[args.workload]):
        print(f"needs {chips[args.workload]} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr, flush=True)
    try:
        result = bench.run_cell(args.workload, args.seed, args.seconds,
                                bool(args.trace), "cuda", bench=spec,
                                t_start=t_start)
        bench.assert_no_jax("exit")
    except bench.ForbiddenModules as e:
        print(f"forbidden modules: {e}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

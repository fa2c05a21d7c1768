"""The readings a cell's limits are set from, many seeds in one process.

    python3 -m gnnbench.calibrate --workload <cell> --seeds 1 2 3 \
        --modes program control half_batch

Set-up as a run's (the graph generated and built once); then for each
seed the weights and inputs, each mode's three checked steps and the
float64 reference's, and one JSON line a (seed, mode) with the three
compared numbers (``check.py``) and their worst leaves. Modes:

* ``program``: the program as a run drives it (the lower reading);
* ``control``: the reference with its matmuls in TF32, in the
  program's place (the upper reading);
* ``program_tf32``: the program with the card's TF32 matmuls switched
  on;
* ``unchanged``, ``half_batch``: the program with a fault
  of ``faults.py`` planted.

Not run by the benchmark's runs. Writes nothing but its output."""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from contextlib import nullcontext

import torch

from gnnbench import bench, check, faults

MODES = ("program", "control", "program_tf32",
         "unchanged", "half_batch")


def readings(workload: str, seeds, modes, device="cuda", overrides=None):
    """Yield one dict a (seed, mode)."""
    cell = bench.Cell(bench.load_benchmark(), workload, overrides)
    cfg, dev = cell.cfg, torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        from dgl1_tpu_torch import cuda_build

        for name in cuda_build.build():
            cuda_build.load(name)
    coo = bench.generate(cell.traffic)
    graph = bench.build_graph(coo, cell.traffic, dev)
    specs = cell.model.params(cfg, coo)
    for seed in seeds:
        inp = cell.model.inputs(
            cfg, coo, torch.Generator(device=dev).manual_seed(seed), dev)
        runs = {}
        for mode in modes:
            t0 = time.perf_counter()
            weights = bench.make_weights(specs, seed, dev)
            if mode == "control":
                runs[mode] = bench.reference_steps(cell, coo, inp, weights,
                                                   "tf32", dev)
            else:
                model = cell.model.build(
                    cfg, graph, dev,
                    torch.Generator(device=dev).manual_seed(seed))
                bench.load_weights(model, weights)
                ctx = (faults.FAULTS.get(mode)
                       or faults.LOWER_PRECISION.get(mode))
                with ctx(model) if ctx else nullcontext():
                    runs[mode] = bench.program_steps(
                        model, graph, inp, cfg["lr"], bench.CHECKED_STEPS)
                del model
            runs[mode]["seconds"] = time.perf_counter() - t0
            del weights
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ref = bench.reference_steps(cell, coo, inp,
                                    bench.make_weights(specs, seed, dev),
                                    "float64", dev)
        ref_s = time.perf_counter() - t0
        for mode, run in runs.items():
            row = {"workload": workload, "seed": seed, "mode": mode,
                   **check.gaps(run, ref), "losses": run["losses"],
                   "ref_losses": ref["losses"], "seconds": run["seconds"],
                   "reference_s": ref_s}
            yield row
        del inp, runs, ref
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--modes", nargs="+", choices=MODES, default=["program"])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    for row in readings(args.workload, args.seeds, args.modes):
        print(json.dumps(row), flush=True)
    bench.assert_no_jax("exit")
    return 0


if __name__ == "__main__":
    sys.exit(main())

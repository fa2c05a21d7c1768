"""Device profile of the examples harness's trainers on the card: for
each entry of :data:`~dgl1_tpu_torch.tools.run_examples.EXAMPLES`, the
trainer's ``build`` at the harness's arguments, its ``first_batch``, one
warm-up Adam step of its ``step_loss`` (model in eval mode: dropout 0;
training mode for a model with an RNN, as cuDNN asks),
then a ``torch.profiler`` window of ``--steps`` steps on that batch.

    python -m dgl1_tpu_torch.tools.profile_examples [--only gcmc dgmg]
        [--steps 3]

Prints one JSON line an entry: host ms a step (between two device
syncs), device busy ms a step (the union of the profiler's device
intervals, ``utils.profiler.device_ms``), the idle share (1 - busy /
host), the hand kernels' launches a step and the top
device kernels. Runs on ``cuda`` only: the idle share of a CPU run means
nothing.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import tempfile
import time

import torch

from dgl1_tpu_torch.tools import run_examples as H
from dgl1_tpu_torch.utils.profiler import device_ms


def kernel_modules():
    from dgl1_tpu_torch.ops import (attn_kernels, bdense_kernels,
                                    hub_kernels, tile_kernels)

    return hub_kernels, attn_kernels, tile_kernels, bdense_kernels


def launches() -> dict:
    out = {}
    for m in kernel_modules():
        out.update({k: v for k, v in m.LAUNCHES.items() if v})
    return out


def profile_entry(entry: str, steps: int, device) -> dict:
    from torch.profiler import ProfilerActivity, profile

    mod = importlib.import_module(H.module_of(entry))
    args = mod.parse_args(list(H.EXAMPLES[entry][0]))
    data, model = mod.build(args, device)
    batch = (mod.first_batch(args, data, device)
             if hasattr(mod, "first_batch") else None)
    # Dropout off, as the step-0 check runs it; a model with a cuDNN RNN
    # stays in training mode (cuDNN has no RNN backward in eval mode).
    if not any(isinstance(m, torch.nn.RNNBase) for m in model.modules()):
        model.eval()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        mod.step_loss(args, data, model, batch).backward()
        opt.step()

    step()
    torch.cuda.synchronize()
    for m in kernel_modules():
        m.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
    busy, top = device_ms(prof)
    busy /= steps
    return {"entry": entry, "steps": steps, "host_ms_per_step": host_ms,
            "device_busy_ms_per_step": busy,
            "idle_share": 1.0 - busy / host_ms,
            "launches_per_step": {k: v / steps
                                  for k, v in launches().items()},
            "top_kernels": [{"name": n[:80], "ms_per_step": ms / steps,
                             "calls_per_step": c / steps}
                            for n, ms, c in top]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=None,
                    help="substring filters on entry names")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_examples: no CUDA device", file=sys.stderr)
        return 1
    names = sorted(H.EXAMPLES)
    if args.only:
        names = [n for n in names if any(s in n for s in args.only)]
    dev = torch.device("cuda", 0)
    os.environ.setdefault("DGL1_TPU_DATA_DIR",
                          tempfile.mkdtemp(prefix="dgl1_profile_"))
    for name in names:
        print(json.dumps(profile_entry(name, args.steps, dev)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

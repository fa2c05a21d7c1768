"""Integration harness of the port's trainers
(``dgl1_tpu_torch/examples``), the counterpart of the reference's
``tools/run_examples.py``: each ported trainer runs as a subprocess
(``python -m dgl1_tpu_torch.examples.<name>``) at a small configuration
that keeps its own gate, and must exit 0.

Usage:
    python -m dgl1_tpu_torch.tools.run_examples          # on the card
    python -m dgl1_tpu_torch.tools.run_examples --cpu --only gcn
    python -m dgl1_tpu_torch.tools.run_examples --list

``--cpu`` passes ``--cpu`` to every trainer; without it they run on
``cuda`` (one card, so ``--jobs`` defaults to 1 there, 2 on the CPU). A
distributed trainer (``--parts P``) runs P ranks: P gloo processes under
``--cpu``, one card a rank over NCCL on the card, where an entry whose P
exceeds the cards present is not run (its line says so; it counts neither
as passed nor as failed, and the summary names it). Exit code 0 when every
selected trainer that ran passed, 1 when one failed, 2 when a script of
the reference's ``examples/`` is neither ported here nor in
:data:`PENDING` (the coverage guard reads file names only).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent.parent
# The reference's trainers, whose names the coverage guard reads.
EXAMPLES_DIR = REPO / "examples"

# name -> (args, timeout_s): the reference harness's entries for the
# trainers ported so far. "script.py#variant" runs the script again under
# a second configuration.
EXAMPLES = {
    "train_gcn.py": (["--epochs", "60"], 300),
    "train_gat.py": (["--epochs", "40"], 400),
    "train_gcn2.py": (["--epochs", "60", "--layers", "4"], 400),
    "train_citation_zoo.py": (["--epochs", "50"], 900),
    "train_sage_minibatch.py": (["--epochs", "2"], 600),
    "train_cluster_gcn.py": (["--epochs", "8"], 500),
    "train_saint.py": (["--epochs", "5"], 500),
    "train_sign.py": (["--epochs", "40"], 400),
    "train_dgi.py": (["--epochs", "30", "--probe-epochs", "30"], 400),
    "train_link_pred.py": (["--epochs", "3"], 400),
    "train_hetero.py": (["--epochs", "40"], 400),
    "train_hetero_link_pred.py": (["--epochs", "3"], 400),
    "train_han.py": (["--epochs", "30"], 400),
    "train_rgcn.py": (["--epochs", "40"], 400),
    # The identity typed layouts (where the graph has a hub layout; the
    # synthetic AIFB stand-in takes the plain subgraphs).
    "train_rgcn.py#identity": (["--epochs", "40", "--identity"], 400),
    "train_rgcn_link_pred.py": (["--epochs", "5"], 500),
    "train_rgcn_sampled.py": (["--epochs", "2"], 600),
    "train_rgcn_dist.py": (["--parts", "2", "--epochs", "40"], 500),
    "train_dist.py": (["--parts", "2", "--epochs", "20",
                       "--nodes", "5000"], 400),
    # The failable int8-wire gate: a hard SBM task with headroom (the
    # reference calibrated both wires at ~0.888 here, cut 0.425), so wire
    # or identity-relabel damage of ~5 points trips 0.84. The flagship
    # layout: hub identity, combined and prefilled, int8 halo, 4 parts.
    "train_dist.py#hard-int8": (
        ["--parts", "4", "--nodes", "4000", "--epochs", "30",
         "--homophily", "0.55", "--noise-mult", "1.0",
         "--halo-dtype", "int8", "--hub-identity",
         "--acc-gate", "0.84"], 600),
    "train_dist_sampled.py": (["--parts", "2", "--epochs", "2",
                               "--nodes", "3000", "--sharded-store"], 600),
    "train_graph_classification.py": (["--epochs", "12"], 500),
    "train_diffpool.py": (["--epochs", "300"], 600),
    "train_ggnn.py": (["--epochs", "60"], 900),
    "train_chem.py": (["--model", "mpnn", "--epochs", "8"], 900),
    "train_lgnn.py": (["--epochs", "6"], 500),
    "train_treelstm.py": (["--epochs", "5"], 500),
    "train_pinsage.py": (["--steps", "60"], 400),
    "train_metapath2vec.py": (["--epochs", "30"], 600),
    "train_dgmg.py": (["--iters", "700", "--samples", "50"], 700),
    "train_pointcloud.py": (["--epochs", "20"], 700),
    "train_transformer.py": (["--steps", "400"], 500),
    "train_gcmc.py": ([], 500),
    "train_rgcn_dist_sampled.py": (["--parts", "4",
                                    "--epochs", "4"], 700),
}

# The reference's trainers not ported yet.
PENDING = frozenset()


def script_of(name: str) -> str:
    return name.split("#")[0]


def module_of(name: str) -> str:
    return "dgl1_tpu_torch.examples." + Path(script_of(name)).stem


def uncovered() -> list:
    """The reference's scripts neither ported nor pending."""
    ported = {script_of(n) for n in EXAMPLES}
    on_disk = sorted(p.name for p in EXAMPLES_DIR.glob("*.py"))
    return [n for n in on_disk if n not in ported and n not in PENDING]


def parts_of(args) -> int:
    """The ``--parts`` of an entry's arguments (1 without the flag)."""
    args = list(args)
    return int(args[args.index("--parts") + 1]) if "--parts" in args else 1


def not_run(args, cpu: bool, cards: int):
    """The line of an entry that cannot run on ``cards`` cards (its ranks
    need one card each), or None where it can; nothing is skipped on the
    CPU."""
    p = parts_of(args)
    if cpu or p <= cards:
        return None
    return f"not run: needs {p} cards, {cards} present"


def run_one(name: str, args, timeout_s: int, cpu: bool, jobs: int = 1):
    """Run one entry as a subprocess; (exit code, seconds, output). On
    the CPU each of ``jobs`` concurrent trainers gets its share of the
    cores as torch's thread count (``OMP_NUM_THREADS``, unless set): with
    every process on every core, a trainer of many small ops runs 50x
    slower than alone."""
    cmd = [sys.executable, "-m", module_of(name)] + list(args)
    env = dict(os.environ)
    if cpu:
        cmd.append("--cpu")
        env.setdefault("OMP_NUM_THREADS",
                       str(max(1, (os.cpu_count() or 1) // jobs)))
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout_s, env=env, cwd=str(REPO))
        rc, out = p.returncode, p.stdout + p.stderr
    except subprocess.TimeoutExpired as e:
        def text(b):
            return (b.decode(errors="replace") if isinstance(b, bytes)
                    else (b or ""))

        rc = -1
        out = (text(e.stdout) + text(e.stderr)
               + f"\n*** TIMEOUT after {timeout_s}s")
    return rc, time.perf_counter() - t0, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=None,
                    help="substring filters on entry names")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--verbose", action="store_true",
                    help="print each trainer's output")
    ap.add_argument("--cpu", action="store_true",
                    help="run every trainer on the CPU")
    ap.add_argument("--jobs", type=int, default=None,
                    help="concurrent trainers (default 1 on the card, 2 "
                         "with --cpu)")
    args = ap.parse_args(argv)

    missing = uncovered()
    if missing:
        print(f"FATAL: examples neither ported nor pending: {missing}")
        return 2
    names = sorted(EXAMPLES)
    if args.only:
        names = [n for n in names if any(s in n for s in args.only)]
    if args.list:
        for n in names:
            print(n, " ".join(EXAMPLES[n][0]))
        return 0
    jobs = args.jobs or (2 if args.cpu else 1)
    cards = 0
    if not args.cpu:
        import torch

        cards = torch.cuda.device_count()
    skipped = {n: not_run(EXAMPLES[n][0], args.cpu, cards) for n in names}
    skipped = {n: why for n, why in skipped.items() if why}
    runs = [n for n in names if n not in skipped]
    for name, why in sorted(skipped.items()):
        print(f"[ -/{len(names)}] {name:36s} {why}", flush=True)

    def job(name):
        ex_args, timeout_s = EXAMPLES[name]
        return name, run_one(name, ex_args, timeout_s, args.cpu, jobs)

    failures = []
    total_t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max(jobs, 1)) as pool:
        # Longest first packs the pool better.
        order = sorted(runs, key=lambda n: -EXAMPLES[n][1])
        for done, (name, (rc, dt, out)) in enumerate(pool.map(job, order),
                                                     1):
            status = "ok" if rc == 0 else f"FAIL rc={rc}"
            print(f"[{done:2d}/{len(names)}] {name:36s} {status:10s} "
                  f"{dt:6.1f}s", flush=True)
            if args.verbose or rc != 0:
                tail = "\n".join(out.strip().splitlines()[-15:])
                print("    " + tail.replace("\n", "\n    "), flush=True)
            if rc != 0:
                failures.append(name)
    dt = time.perf_counter() - total_t0
    print(f"\n{len(runs) - len(failures)}/{len(runs)} passed "
          f"in {dt / 60:.1f} min"
          + (f"; {len(skipped)} not run ({', '.join(sorted(skipped))}: "
             f"more parts than the {cards} cards present)"
             if skipped else ""))
    if failures:
        print("FAILED:", " ".join(failures))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

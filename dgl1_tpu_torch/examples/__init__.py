"""The port's trainers: one module per script of the reference's
``examples/``, each run as ``python -m dgl1_tpu_torch.examples.<name>``
with the script's flags, names and defaults (``--cpu`` runs on the CPU;
without it the trainer runs on ``cuda`` and raises where there is no
card).

Each module is split as ``parse_args(argv)``, ``build(args, device) ->
(data, model)``, ``train(args, data, model, device) -> dict`` and
``gate(args, data, metrics) -> str``; ``main(argv)`` runs them through
:func:`run`. ``train`` returns ``losses`` (the loss of every step, before
its update), ``step_ms`` (each step's host time, ending where its loss is
read back), ``val`` and ``test`` (the metrics the script reports: best
validation accuracy and the test accuracy at it, or the script's own
final metric under ``test``; None where it has none). ``gate`` returns the
line it prints, raises ``SystemExit`` where the script's gate fails, and
says "no gate" where the script enforces none.

The distributed trainers (``--parts P``) run one process a part over
``torch.distributed`` (:func:`run_parts`): P spawned ranks, gloo on the
CPU and NCCL on the card, one card a rank; ``--parts 1`` runs in this
process. Their ``build`` and ``train`` run on every rank, each on its own
part; rank 0 prints, gates and returns the metrics.

This module holds what the trainers share.
"""

from __future__ import annotations

import contextlib
import importlib
import multiprocessing as mp
import os
import pickle
import shutil
import socket
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from dgl1_tpu_torch.graph import resolve_device

__all__ = ["run", "device_of", "masked_ce", "accuracy", "literature_gate",
           "first_of", "NO_GATE", "Stepper", "load_reference",
           "reference_state_dict", "need_cards", "process_group",
           "run_parts", "run_rank", "spawn_ranks", "rank_and_world",
           "free_port_base", "module_name"]

NO_GATE = "no gate"


def device_of(args) -> torch.device:
    """The CPU under ``--cpu``; else ``cuda``, which raises without a
    card."""
    return torch.device("cpu") if args.cpu else resolve_device(None)


def run(mod, argv=None) -> dict:
    """``mod``'s trainer end to end: parse, build, train, gate. Returns
    the metrics with ``wall_s`` (build and train) and ``gate`` (the gate's
    line); a failed gate raises ``SystemExit`` with its message."""
    args = mod.parse_args(argv)
    dev = device_of(args)
    t0 = time.perf_counter()
    data, model = mod.build(args, dev)
    metrics = mod.train(args, data, model, dev)
    metrics["wall_s"] = time.perf_counter() - t0
    metrics["gate"] = mod.gate(args, data, metrics)
    print(metrics["gate"])
    return metrics


def masked_ce(logits, labels, mask, floor: Optional[float] = None):
    """``sum(ce * m) / sum(m)`` over the rows of ``mask`` (the scripts'
    loss); ``floor`` bounds the denominator from below where the script
    does (``jnp.maximum(sum(m), floor)``)."""
    ce = F.cross_entropy(logits, labels.long(), reduction="none")
    m = mask.to(ce.dtype)
    den = m.sum() if floor is None else m.sum().clamp_min(floor)
    return (ce * m).sum() / den


def accuracy(pred, labels, mask) -> float:
    """Share of the rows of ``mask`` whose prediction is the label."""
    m = mask.to(torch.float32)
    correct = (pred == labels.long()).to(torch.float32)
    return float((correct * m).sum() / m.sum().clamp_min(1.0))


def literature_gate(best_test: float, gate: Optional[float],
                    synthetic: bool, what: str) -> str:
    """The citation scripts' gate: on real data only, ``best_test`` must
    reach ``gate`` (already less its tolerance)."""
    if gate is None or synthetic:
        return NO_GATE + (" on synthetic data" if synthetic else "")
    if best_test < gate:
        raise SystemExit(f"ACCURACY GATE FAILED: {what} test "
                         f"{best_test:.4f} < {gate:.4f}")
    return f"accuracy gate passed ({best_test:.4f} >= {gate:.4f})"


def reference_state_dict(params, renames=None) -> dict:
    """The reference script's flax parameter tree (numpy arrays) as the
    port's ``state_dict``: :func:`~dgl1_tpu_torch.params.from_jax_params`,
    then each part of a name that is a key of ``renames`` takes that
    key's value in its place (flax's auto names to the port's)."""
    from dgl1_tpu_torch.params import from_jax_params

    renames = renames or {}
    return {".".join(renames.get(part, part) for part in k.split(".")): v
            for k, v in from_jax_params(params).items()}


def load_reference(model, params, renames=None):
    """Load :func:`reference_state_dict` of ``params`` into ``model``."""
    model.load_state_dict(reference_state_dict(params, renames), strict=True)
    return model


def first_of(batches):
    """The first item of ``batches``; its iterator is closed after, which
    stops a loader's worker threads."""
    it = iter(batches)
    try:
        return next(it)
    finally:
        if hasattr(it, "close"):
            it.close()


class Stepper:
    """Records each step's loss and host time: ``start()`` before the
    step, ``done(loss)`` after its update (reading the loss back ends the
    step's device work)."""

    def __init__(self):
        self.losses, self.step_ms = [], []
        self._t0 = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def done(self, loss) -> float:
        v = float(loss.detach()) if isinstance(loss, torch.Tensor) \
            else float(loss)
        self.step_ms.append((time.perf_counter() - self._t0) * 1e3)
        self.losses.append(v)
        return v

    def metrics(self, **kw) -> dict:
        out = {"losses": self.losses, "step_ms": self.step_ms, "val": None,
               "test": None}
        out.update(kw)
        return out


# ----------------------------------------------------------------------
# Distributed trainers: one process a part
# ----------------------------------------------------------------------

# A rank that has not finished by then is killed and the run fails.
RANK_TIMEOUT_S = 1800.0
# A collective that waits longer for a peer raises (a rank that died
# leaves the others waiting at most this long).
GROUP_TIMEOUT_S = 600.0


def need_cards(parts: int, device, present: Optional[int] = None) -> None:
    """Exit before any work when ``parts`` ranks do not fit the cards:
    NCCL places one rank a card, and nothing moves to the CPU on its own.
    ``present`` defaults to ``torch.cuda.device_count()``; the CPU takes
    any number of gloo ranks."""
    if torch.device(device).type != "cuda":
        return
    n = torch.cuda.device_count() if present is None else int(present)
    if parts > n:
        raise SystemExit(
            f"need {parts} devices, have {n}: one card a rank over NCCL; "
            f"run with --cpu for {parts} gloo ranks on the CPU")


def rank_and_world(group=None):
    """(rank, world size) of the process group, (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


@contextlib.contextmanager
def process_group(world: int, rank: int, device, init: Optional[str] = None):
    """Inside the block this process is rank ``rank`` of a group of
    ``world`` (``parallel.initialize``: nccl on cuda, gloo on the CPU),
    joined at the init URL ``init`` (None: a file store in a temporary
    directory, for a group of one). A group already up is used as it is
    and left up; a group made here is destroyed on the way out."""
    from dgl1_tpu_torch import parallel

    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} is up; this "
                f"run needs {world}")
        yield
        return
    tmp = None
    if init is None:
        tmp = tempfile.mkdtemp(prefix="dgl1_group_")
        init = f"file://{tmp}/init"
    parallel.initialize(init, world, rank, timeout_s=GROUP_TIMEOUT_S,
                        device=device)
    try:
        yield
    finally:
        parallel.exit_client()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def rank_device(args, rank: int) -> torch.device:
    """The CPU under ``--cpu``; else this rank's card."""
    dev = device_of(args)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def module_name(mod) -> str:
    """``mod``'s importable name (``python -m`` runs it as ``__main__``,
    a name a spawned rank cannot import)."""
    spec = getattr(mod, "__spec__", None)
    return spec.name if spec is not None else mod.__name__


def run_rank(modname: str, argv, rank: int, world: int,
             init: Optional[str] = None) -> dict:
    """One rank of a distributed trainer: join the group, ``build`` and
    ``train`` this rank's part; rank 0 also gates and prints the gate's
    line. Returns the metrics (``wall_s``; ``gate`` on rank 0)."""
    mod = importlib.import_module(modname)
    args = mod.parse_args(argv)
    dev = rank_device(args, rank)
    with process_group(world, rank, dev, init):
        t0 = time.perf_counter()
        data, model = mod.build(args, dev)
        metrics = mod.train(args, data, model, dev)
        metrics["wall_s"] = time.perf_counter() - t0
        if rank == 0:
            metrics["gate"] = mod.gate(args, data, metrics)
            print(metrics["gate"], flush=True)
    return metrics


def _rank_entry(modname: str, fn: str, call: tuple, rank: int,
                out_dir: str):
    """A spawned rank: one torch thread (P ranks share the cores), rank
    0's output only; the result or the failure goes to ``out_dir``."""
    torch.set_num_threads(1)
    if rank:
        sys.stdout = open(os.devnull, "w")
    out = Path(out_dir)
    try:
        res = getattr(importlib.import_module(modname), fn)(*call)
        with open(out / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    except SystemExit as e:
        (out / f"rank{rank}.exit").write_text(str(e.code))
        sys.stdout.flush()
        os._exit(1)
    except BaseException:  # noqa: BLE001 - reported to the parent
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        sys.stdout.flush()
        os._exit(1)
    sys.stdout.flush()


def spawn_ranks(modname: str, fn: str, calls, timeout_s: float =
                RANK_TIMEOUT_S):
    """``modname.fn(*calls[r])`` in ``len(calls)`` spawned processes;
    returns rank 0's result. A rank's traceback fails the call
    (RuntimeError), a rank's ``SystemExit`` exits with its message (a
    failed gate), and a run past ``timeout_s`` is killed and fails
    (TimeoutError); every rank is stopped before this returns."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="dgl1_ranks_") as tmp:
        out = Path(tmp)
        procs = [ctx.Process(target=_rank_entry,
                             args=(modname, fn, tuple(c), r, tmp))
                 for r, c in enumerate(calls)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode for p in procs):
                    break  # one failed: the others may wait on it
                if time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        errs = [(out / f"rank{r}.err") for r in range(len(procs))]
        msgs = [f"rank {r}:\n{e.read_text()}" for r, e in enumerate(errs)
                if e.exists()]
        if msgs:
            raise RuntimeError("rank failed:\n" + "\n".join(msgs))
        exits = [(out / f"rank{r}.exit") for r in range(len(procs))]
        for e in exits:
            if e.exists():
                raise SystemExit(e.read_text())
        bad = [(r, p.exitcode) for r, p in enumerate(procs)
               if p.exitcode and r not in hung]
        if bad:
            raise RuntimeError(f"ranks exited with {bad}")
        if hung:
            raise TimeoutError(f"ranks {hung} still running after "
                               f"{timeout_s} s; killed")
        with open(out / "rank0.pkl", "rb") as f:
            return pickle.load(f)


def run_parts(mod, argv=None) -> dict:
    """``mod``'s distributed trainer end to end on ``--parts`` ranks:
    :func:`run_rank` in this process for one part, else in as many
    spawned ranks (a file-store group in a temporary directory). Exits
    before any work when the parts do not fit the cards
    (:func:`need_cards`). Returns rank 0's metrics; a failed gate raises
    ``SystemExit`` with its message."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = mod.parse_args(argv)
    need_cards(args.parts, device_of(args))
    name = module_name(mod)
    if args.parts == 1:
        return run_rank(name, argv, 0, 1)
    with tempfile.TemporaryDirectory(prefix="dgl1_group_") as tmp:
        init = f"file://{tmp}/init"
        return spawn_ranks(__name__, "run_rank",
                           [(name, argv, r, args.parts, init)
                            for r in range(args.parts)])


def free_port_base(n: int = 1, host: str = "127.0.0.1") -> int:
    """A port p with p .. p + n - 1 all free on ``host`` now (a later
    bind may still lose a race)."""
    for _ in range(200):
        with socket.socket() as s:
            s.bind((host, 0))
            base = s.getsockname()[1]
        if base + n > 65535:
            continue
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind((host, p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no {n} consecutive free ports on {host}")

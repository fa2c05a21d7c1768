"""One run of one cell: set-up, the measured window, the traced stretches,
then the check against the plain reference.

Everything a cell needs is found by the names in ``BENCHMARK.json``:
``configs/<config>.json`` (sizes), ``traffic/<traffic>.json`` (the graph,
read by :mod:`gnnbench.generators`), ``models/<model>.py`` and
``reference/<model>.py`` (the configuration's ``model`` key),
``metrics/<metric>.py`` (one reader a per-layer metric) and
``limits/<cell>.json`` (the limit of each compared number). The harness
holds no list of them.

Set-up, counted in ``setup_s``: the program's kernels built or loaded,
the graph generated from the traffic file's dataset seed and built by
the program (the ``layout_build`` span), features, labels and weights
drawn on the device from ``--seed``, the model built, and three training
steps through ``dgl1_tpu_torch.train.train``: they warm every shape the
window uses, and they are the steps the reference follows; then two
more, whose faster step sizes the window. The window is one ``train``
call of as many steps as ``--seconds`` holds at that time; ``epoch_ms``
is its wall time over its steps."""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from contextlib import nullcontext
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from gnnbench import check, generators, trace
from gnnbench.reference.common import adam_steps, matmul

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dgl1_tpu")
CHECKED_STEPS = 3
# The weights' generator is seeded apart from the inputs'.
WEIGHT_STREAM = 1 << 40
# Seconds of the device stretch (CUDA activity) and of the host stretch
# (CPU activity too) a traced run profiles after its window.
DEVICE_STRETCH_S = 0.5
HOST_STRETCH_S = 0.25


class ForbiddenModules(RuntimeError):
    pass


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: the program's name begins with the latter)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def assert_no_jax(when: str) -> None:
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(f"{when}: loaded {', '.join(found)}")


def load_module(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(
        f"gnnbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric: str):
    """The reader of a per-layer metric, ``metrics/<name>.py``."""
    return load_module("metrics", metric)


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


class Cell:
    """A workload's entry, configuration, traffic, model and reference
    modules, and limits. ``overrides`` (tests only) updates the
    configuration and traffic dicts, to run a cell at a small size."""

    def __init__(self, bench: dict, workload: str, overrides=None):
        entries = [w for w in bench["workloads"] if w["name"] == workload]
        if len(entries) != 1:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.name = workload
        self.entry = entries[0]
        files = {c["name"]: c["file"] for c in bench["configs"]}
        with open(ROOT / files[self.entry["config"]]) as f:
            self.cfg = json.load(f)
        self.traffic = load_json("traffic", self.entry["traffic"])
        overrides = overrides or {}
        self.cfg.update(overrides.get("config", {}))
        self.traffic.update(overrides.get("traffic", {}))
        self.model = load_module("models", self.cfg["model"])
        self.reference = load_module("reference", self.model.REFERENCE)
        path = HERE / "limits" / f"{workload}.json"
        self.limits = load_json("limits", workload) if path.is_file() \
            else None
        self.end_to_end = [m for m in bench["end_to_end"]
                           if applies(m, workload)]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if applies(m, workload) and m["moves"] in e2e]


def applies(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def launches() -> dict:
    """The program's launch counters of its hand kernels, summed."""
    from dgl1_tpu_torch.ops import (attn_kernels, bdense_kernels,
                                    hub_kernels, tile_kernels)

    out = {}
    for mod in (hub_kernels, attn_kernels, tile_kernels, bdense_kernels):
        for k, v in mod.LAUNCHES.items():
            out[k] = out.get(k, 0) + v
    return out


def build_graph(coo: dict, traffic: dict, device):
    """The program's graph of the generated edge lists: ``graph`` with
    one self-loop a node appended when the traffic asks (what
    ``add_self_loop`` builds, without a first build it would discard)
    and the traffic's ``formats``; or ``heterograph``."""
    import dgl1_tpu_torch as dgl

    if coo["kind"] == "homo":
        n, src, dst = coo["num_nodes"], coo["src"], coo["dst"]
        if traffic.get("self_loops"):
            loops = np.arange(n, dtype=src.dtype)
            src, dst = np.concatenate([src, loops]), np.concatenate([dst,
                                                                     loops])
        fm = traffic.get("formats")
        return dgl.graph((src, dst), num_nodes=n,
                         formats=tuple(fm) if fm else None, device=device)
    return dgl.heterograph(dict(coo["relations"]), coo["num_nodes"],
                           device=device)


def make_weights(specs, seed: int, device) -> dict:
    """Every parameter from one normal draw on ``device`` (``seed`` plus
    WEIGHT_STREAM), each leaf its slice times its std; std 0 is zeros."""
    gen = torch.Generator(device=device).manual_seed(seed + WEIGHT_STREAM)
    total = sum(math.prod(s) for _, s, std in specs if std > 0)
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape, std in specs:
        if std > 0:
            k = math.prod(shape)
            out[name] = flat[off:off + k].view(shape).mul_(std)
            off += k
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def load_weights(model, weights: dict) -> None:
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"the model's parameters {sorted(params)} are not "
                         f"the configuration's {sorted(weights)}")
    with torch.no_grad():
        for k, p in params.items():
            if tuple(p.shape) != tuple(weights[k].shape):
                raise ValueError(f"{k}: shape {tuple(p.shape)}, expected "
                                 f"{tuple(weights[k].shape)}")
            p.copy_(weights[k])


def program_steps(model, graph, inp: dict, lr: float, steps: int) -> dict:
    """``steps`` steps of ``dgl1_tpu_torch.train.train``: the losses, each
    parameter's first gradient as the optimizer holds it after one step
    (its first moment over 1 - beta1; a parameter with no state got no
    gradient) and the norm of each parameter's change."""
    from dgl1_tpu_torch.train import train

    named = list(model.named_parameters())
    start = {k: p.detach().clone() for k, p in named}
    grad = {}

    def first_step(opt, args, kwargs):
        if grad:
            return
        b1 = opt.param_groups[0]["betas"][0]
        for k, p in named:
            st = opt.state.get(p, {})
            grad[k] = (float(st["exp_avg"].norm()) / (1 - b1)
                       if "exp_avg" in st else 0.0)

    hook = register_optimizer_step_post_hook(first_step)
    try:
        res = train(graph, inp["feat"], inp["labels"], model, steps=steps,
                    lr=lr)
    finally:
        hook.remove()
    change = {k: float((p.detach() - start[k]).norm()) for k, p in named}
    return {"losses": res["losses"], "grad": grad, "change": change,
            "step_s": res["step_s"]}


def reference_steps(cell: Cell, coo: dict, inp: dict, weights: dict,
                    precision: str, device) -> dict:
    """The plain reference's checked steps in float64 (``tf32``: its
    matmuls in TF32) from the same weights and inputs."""
    ref, cfg = cell.reference, cell.cfg
    prep = ref.prepare(cfg, coo, device)
    inp64 = {"feat": inp["feat"].double(), "labels": inp["labels"]}
    w64 = {k: v.double() for k, v in weights.items()}
    mm = matmul(precision)
    return adam_steps(w64, lambda p: ref.loss(cfg, prep, inp64, p, mm),
                      CHECKED_STEPS, cfg["lr"])


@dataclass
class Context:
    """What a per-layer metric's reader reads: the cell's configuration,
    traffic and edge lists, the program's graph, the device stretch
    (``stretch``: CUDA activity and the launch counters' deltas) and the
    host stretch (``host``: CPU activity too), the window's ``epoch_ms``,
    the configuration's FLOPs a step and the harness's spans (seconds)."""

    cfg: dict
    traffic: dict
    coo: dict
    graph: object
    stretch: trace.Stretch
    host: trace.Stretch
    epoch_ms: float
    flops: float
    spans: dict


def generate(traffic: dict) -> dict:
    coo = generators.generate(traffic)
    coo["self_loops"] = bool(traffic.get("self_loops"))
    return coo


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device="cuda", *, bench=None, overrides=None, fault=None,
             t_start=None) -> dict:
    """One run; returns the result line's dict. ``fault`` (tests and
    calibration only) is a function of the model returning a context
    manager under which the program's steps run broken."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(bench or load_benchmark(), workload, overrides)
    cfg, dev = cell.cfg, torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phases = {"start": time.perf_counter() - t_start}
    mark = time.perf_counter()

    def phase(name):
        nonlocal mark
        now = time.perf_counter()
        phases[name] = now - mark
        mark = now

    if dev.type == "cuda":
        from dgl1_tpu_torch import cuda_build

        for name in cuda_build.build():
            cuda_build.load(name)
    from dgl1_tpu_torch.train import train
    phase("kernels")
    coo = generate(cell.traffic)
    phase("generate")
    graph = build_graph(coo, cell.traffic, dev)
    _sync(dev)
    phase("layout_build")
    spans = {"layout_build": phases["layout_build"]}
    inp = cell.model.inputs(cfg, coo,
                            torch.Generator(device=dev).manual_seed(seed), dev)
    specs = cell.model.params(cfg, coo)
    model = cell.model.build(cfg, graph, dev,
                             torch.Generator(device=dev).manual_seed(seed))
    load_weights(model, make_weights(specs, seed, dev))
    _sync(dev)
    phase("inputs_model_weights")
    broken = (lambda: fault(model)) if fault is not None else nullcontext
    with broken():
        first = program_steps(model, graph, inp, cfg["lr"], CHECKED_STEPS)
    phase("checked_steps")
    del first["step_s"]
    # Two more steps size the window: the checked steps' times still
    # hold first-call work.
    step_s = min(train(graph, inp["feat"], inp["labels"], model, steps=2,
                       lr=cfg["lr"])["step_s"])
    _sync(dev)
    phase("sizing_steps")
    setup_s = time.perf_counter() - t_start
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in phases.items()),
          file=sys.stderr, flush=True)
    assert_no_jax("end of set-up")

    steps = max(1, round(seconds / step_s))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with broken():
        t0 = time.perf_counter()
        res = train(graph, inp["feat"], inp["labels"], model, steps=steps,
                    lr=cfg["lr"])
        _sync(dev)
        window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    assert_no_jax("window closed")
    epoch_ms = window_s * 1e3 / steps
    e2e = {"epoch_ms": epoch_ms, "peak_mem_gib": peak / 2 ** 30,
           "setup_s": setup_s}
    metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
               for m in cell.end_to_end}
    device_rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                  "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": False, "attempted": steps,
           "failed": sum(not math.isfinite(x) for x in res["losses"])}
    if traced:
        metrics, breakdown, busy, wall = traced_metrics(
            cell, coo, graph, model, inp, step_s, epoch_ms, spans)
        device_rec.update(busy_s=busy, window_s=wall)
        out["breakdown"] = breakdown
    del model, graph, res
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_steps(cell, coo, inp, make_weights(specs, seed, dev),
                          "float64", dev)
    numbers = check.gaps(first, ref)
    if cell.limits is None:
        raise FileNotFoundError(f"no limits/{workload}.json")
    correct, checks = check.judge(numbers, cell.limits)
    out.update(correct=bool(correct and out["failed"] == 0),
               metrics=metrics, device=device_rec)
    out["checks"] = checks
    return out


def traced_metrics(cell, coo, graph, model, inp, step_s, epoch_ms, spans):
    """The per-layer metrics from two stretches after the window: whole
    steps of ``train`` under the profiler, CUDA activity only (the device
    numbers), then with CPU activity (what the host did in each gap)."""
    from dgl1_tpu_torch.train import train

    lr = cell.cfg["lr"]

    def steps_of(k):
        return lambda: train(graph, inp["feat"], inp["labels"], model,
                             steps=k, lr=lr)

    k = max(2, math.ceil(DEVICE_STRETCH_S / step_s))
    before = launches()
    stretch = trace.profile(steps_of(k), k, with_cpu=False)
    after = launches()
    stretch.launches = {n: after[n] - before.get(n, 0) for n in after}
    if not stretch.device:
        raise RuntimeError("the profiler recorded no device activity")
    kh = max(2, math.ceil(HOST_STRETCH_S / step_s))
    host = trace.profile(steps_of(kh), kh, with_cpu=True)
    ctx = Context(cell.cfg, cell.traffic, coo, graph, stretch, host,
                  epoch_ms, cell.model.step_flops(cell.cfg, coo), spans)
    metrics = {}
    for m in cell.per_layer:
        value = load_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    breakdown = {"device_ops": trace.top_device_ops(stretch),
                 "idle_gaps": trace.idle_gaps(host)}
    return metrics, breakdown, stretch.busy_s(), stretch.wall_s

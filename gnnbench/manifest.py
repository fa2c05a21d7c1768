"""The check of ``BENCHMARK.json`` against the files the harness finds by
its names, and against the form the benchmark's contract gives it.

    python3 -m gnnbench.manifest

prints each problem and exits 1 when there is one."""

from __future__ import annotations

import re
import sys
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
# The end-to-end metrics the harness measures.
E2E = ("epoch_ms", "peak_mem_gib", "setup_s")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def _text(v, limit=200) -> bool:
    return isinstance(v, str) and 0 < len(v) <= limit and "\n" not in v \
        and "\t" not in v


def problems(bench: dict, root: Path) -> list:
    """Every way ``bench`` breaks the rules, as lines of text."""
    here = root / "gnnbench"
    out = []
    if set(bench) != TOP_KEYS:
        out.append(f"top-level keys {sorted(bench)}")
        return out
    if not (isinstance(bench["run_seconds"], int)
            and 1 <= bench["run_seconds"] <= 51):
        out.append("run_seconds is not a whole number from 1 to 51")
    names = []

    def name_ok(what, v):
        if not (isinstance(v, str) and NAME.match(v)):
            out.append(f"{what}: bad name {v!r}")

    configs = {}
    for c in bench["configs"]:
        name_ok("config", c.get("name"))
        configs[c.get("name")] = c
        names.append(c.get("name"))
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            out.append(f"config {c.get('name')}: keys {sorted(c)}")
            continue
        if not (root / c["file"]).is_file():
            out.append(f"config {c['name']}: no file {c['file']}")
        for k in c["reduced"]:
            name_ok(f"config {c['name']} reduced", k)
        for k in ("source", "why"):
            if not _text(c[k]):
                out.append(f"config {c['name']}: bad {k}")
    cells = {}
    pairs = set()
    for w in bench["workloads"]:
        name_ok("workload", w.get("name"))
        cells[w.get("name")] = w
        names.append(w.get("name"))
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            out.append(f"workload {w.get('name')}: keys {sorted(w)}")
            continue
        name_ok(f"workload {w['name']} traffic", w["traffic"])
        if w["config"] not in configs:
            out.append(f"workload {w['name']}: no config {w['config']}")
        if not (here / "traffic" / f"{w['traffic']}.json").is_file():
            out.append(f"workload {w['name']}: no traffic file "
                       f"traffic/{w['traffic']}.json")
        if not (here / "limits" / f"{w['name']}.json").is_file():
            out.append(f"workload {w['name']}: no limits/{w['name']}.json")
        if w["chips"] != 1:
            out.append(f"workload {w['name']}: chips {w['chips']}; the "
                       f"harness drives one card")
        if not _text(w["why"]):
            out.append(f"workload {w['name']}: bad why")
        if (w["config"], w["traffic"]) in pairs:
            out.append(f"workload {w['name']}: its config and traffic "
                       f"repeat another cell's")
        pairs.add((w["config"], w["traffic"]))
    used = {w.get("config") for w in bench["workloads"]}
    for c in configs:
        if c not in used:
            out.append(f"config {c}: no cell uses it")

    def metric_common(m, kind):
        name_ok(kind, m.get("name"))
        names.append(m.get("name"))
        if not (isinstance(m.get("unit"), str) and UNIT.match(m["unit"])):
            out.append(f"{kind} {m.get('name')}: bad unit {m.get('unit')!r}")
        if m.get("better") not in ("lower", "higher"):
            out.append(f"{kind} {m.get('name')}: better {m.get('better')!r}")
        for cell in m.get("workloads", []):
            if cell not in cells:
                out.append(f"{kind} {m['name']}: no workload {cell}")

    def reports(m, cell):
        return cell in m.get("workloads", [cell])

    e2e = {}
    for m in bench["end_to_end"]:
        metric_common(m, "end_to_end")
        if m.get("name") not in E2E:
            out.append(f"end_to_end {m.get('name')}: the harness measures "
                       f"only {', '.join(E2E)}")
        e2e[m.get("name")] = m
        extra = set(m) - {"name", "unit", "better", "bound", "source",
                          "workloads"}
        if extra:
            out.append(f"end_to_end {m.get('name')}: keys {sorted(extra)}")
        if m.get("source") not in ("host_clock", "device_trace"):
            out.append(f"end_to_end {m.get('name')}: source "
                       f"{m.get('source')!r}")
        b = m.get("bound")
        if not (isinstance(b, (int, float)) and 0.01 <= b <= 0.25):
            out.append(f"end_to_end {m.get('name')}: bound {b!r}")
    if "setup_s" not in e2e:
        out.append("no end_to_end setup_s")
    for m in bench["per_layer"]:
        metric_common(m, "per_layer")
        extra = set(m) - {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if extra:
            out.append(f"per_layer {m.get('name')}: keys {sorted(extra)}")
        if m.get("source") not in SOURCES:
            out.append(f"per_layer {m.get('name')}: source "
                       f"{m.get('source')!r}")
        if not _text(m.get("layer")):
            out.append(f"per_layer {m.get('name')}: bad layer")
        if not (here / "metrics" / f"{m.get('name')}.py").is_file():
            out.append(f"per_layer {m.get('name')}: no reader "
                       f"metrics/{m.get('name')}.py")
        moved = e2e.get(m.get("moves"))
        if moved is None:
            out.append(f"per_layer {m.get('name')}: moves "
                       f"{m.get('moves')!r}, no end_to_end metric")
            continue
        for cell in m.get("workloads", list(cells)):
            if not reports(moved, cell):
                out.append(f"per_layer {m['name']}: {cell} does not "
                           f"report {m['moves']}")
    for cell in cells:
        mine = [n for n, m in e2e.items() if reports(m, cell)]
        if "setup_s" not in mine or len(mine) < 2:
            out.append(f"workload {cell}: reports {mine}")
        if not any(reports(m, cell) for m in bench["per_layer"]):
            out.append(f"workload {cell}: no per_layer metric")
    seen = set()
    for n in names:
        if n in seen:
            out.append(f"name {n!r} used twice")
        seen.add(n)
    return out


def main() -> int:
    from gnnbench.bench import ROOT, load_benchmark

    found = problems(load_benchmark(), ROOT)
    for line in found:
        print(line)
    return 1 if found else 0


if __name__ == "__main__":
    sys.exit(main())

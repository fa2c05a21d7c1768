"""Nothing the harness loads is JAX or the JAX package, and a run without
a card prints no result."""

import os
import subprocess
import sys

from gnnbench import bench

IMPORT_PATH = """
import sys
from gnnbench import bench, calibrate, manifest, run
import dgl1_tpu_torch
from dgl1_tpu_torch.train import train
spec = bench.load_benchmark()
for w in spec["workloads"]:
    cell = bench.Cell(spec, w["name"])
    for m in cell.per_layer:
        bench.load_reader(m["name"])
bench.launches()
print(bench.forbidden_modules())
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(bench.ROOT)
    return env


def test_import_path_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", IMPORT_PATH], cwd=bench.ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dgl1_tpu_torch_lookalike", sys)
    assert "dgl1_tpu" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "dgl1_tpu.ops", sys)
    assert bench.forbidden_modules() == ["dgl1_tpu", "jax"]


def test_run_without_a_card_prints_nothing():
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, "-m", "gnnbench.run", "--workload",
         "gat-arxiv.powerlaw", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], cwd=bench.ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""

"""The port's trainers (``dgl1_tpu_torch/examples``) end to end on the
CPU, and their harness (``dgl1_tpu_torch/tools/run_examples.py``).

Smoke: every entry of the harness through its trainer's ``main`` with
``--cpu`` at a tiny size (a distributed one on its gloo ranks): exit 0
(no ``SystemExit``), the metrics the gates read, a finite loss for every
step. Harness: ``--list``, the
coverage guard against the reference's ``examples/`` and one trainer
through the harness's subprocess path.

Datasets are built under a temporary data directory with the port's
cache writes stubbed out.
"""

from __future__ import annotations

import importlib
from pathlib import Path

import numpy as np
import pytest

import dgl1_tpu_torch as tdgl
from dgl1_tpu_torch.tools import run_examples as harness

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("DGL1_TPU_DATA_DIR", str(tmp_path))
    monkeypatch.setattr(tdgl.data.base, "save_graphs", lambda *a, **k: None)


# name -> tiny arguments for the CPU smoke run of each harness entry.
SMOKE = {
    "train_gcn.py": ["--epochs", "2"],
    "train_gat.py": ["--epochs", "2", "--dataset", "cora"],
    "train_gcn2.py": ["--epochs", "2", "--layers", "2"],
    "train_citation_zoo.py": ["--epochs", "2"],
    "train_sage_minibatch.py": ["--epochs", "1", "--fanouts", "3,3",
                                "--hidden", "16", "--batch-size", "4096",
                                "--feature-store"],
    "train_cluster_gcn.py": ["--epochs", "1"],
    "train_saint.py": ["--epochs", "1", "--mode", "walk"],
    "train_sign.py": ["--epochs", "2", "--hops", "2"],
    "train_dgi.py": ["--epochs", "2", "--probe-epochs", "2"],
    "train_link_pred.py": ["--epochs", "1"],
    "train_hetero.py": ["--epochs", "2"],
    "train_hetero_link_pred.py": ["--epochs", "3"],
    "train_han.py": ["--epochs", "2"],
    "train_rgcn.py": ["--epochs", "2"],
    "train_rgcn.py#identity": ["--epochs", "2", "--identity"],
    "train_rgcn_link_pred.py": ["--epochs", "2", "--scale", "64",
                                "--presorted"],
    "train_rgcn_sampled.py": ["--epochs", "1", "--scale", "256"],
}


# The graph-level and the generative and sequence entries run in their
# own files (test_torch_examples_graph.py, test_torch_examples_gen.py),
# which keep each file's time short under --dist loadfile.
SMOKE_GRAPH = {
    "train_graph_classification.py": ["--epochs", "1", "--num-graphs", "40",
                                      "--batch-size", "8", "--hidden", "8"],
    "train_diffpool.py": ["--epochs", "3", "--num-graphs", "40",
                          "--hidden", "8"],
    "train_chem.py": ["--model", "mpnn", "--epochs", "1",
                      "--num-molecules", "24", "--batch-size", "8",
                      "--hidden", "8", "--steps", "1"],
    "train_ggnn.py": ["--epochs", "1", "--num-graphs", "10", "--hidden", "8",
                      "--steps", "2"],
    "train_pointcloud.py": ["--epochs", "1", "--clouds", "16", "--points",
                            "24", "--batch-size", "4", "--hidden", "8",
                            "--k", "4"],
}
# The distributed entries, each over its --parts gloo ranks (ports and the partition directory are the
# launcher's free ports and temporary directory). The gates run in the
# spawned ranks: the accuracy floors are set to what a tiny run reaches.
SMOKE_DIST = {
    "train_dist.py": ["--parts", "2", "--nodes", "600", "--epochs", "2",
                      "--feat-dim", "8", "--hidden", "8", "--classes", "4"],
    "train_dist.py#hard-int8": ["--parts", "2", "--nodes", "600",
                                "--epochs", "2", "--feat-dim", "8",
                                "--hidden", "8", "--classes", "4",
                                "--halo-dtype", "int8", "--hub-identity"],
    "train_rgcn_dist.py": ["--parts", "2", "--epochs", "2", "--scale",
                           "800", "--hidden", "8", "--feat-dim", "8",
                           "--min-acc", "0"],
    "train_rgcn_dist_sampled.py": ["--parts", "2", "--epochs", "1",
                                   "--scale", "800", "--hidden", "8",
                                   "--embed-dim", "8", "--batch-size",
                                   "16", "--min-acc", "0"],
    "train_dist_sampled.py": ["--parts", "2", "--epochs", "1", "--nodes",
                              "600", "--sharded-store", "--hidden", "8"],
}
SMOKE_GEN = {
    "train_lgnn.py": ["--epochs", "1", "--graphs", "6", "--nodes", "20",
                      "--hidden", "8"],
    "train_treelstm.py": ["--epochs", "1", "--batch-size", "64",
                          "--x-size", "8", "--h-size", "8"],
    "train_transformer.py": ["--steps", "2", "--batch-size", "4",
                             "--seq-len", "5", "--dim", "16", "--heads",
                             "2"],
    "train_gcmc.py": ["--epochs", "2", "--users", "40", "--items", "30",
                      "--ratings-per-user", "8", "--hidden", "8"],
    "train_pinsage.py": ["--steps", "2", "--items", "60", "--users", "30",
                         "--batch-size", "8", "--hidden", "8"],
    "train_metapath2vec.py": ["--epochs", "2", "--authors", "40",
                              "--papers", "60", "--dim", "8"],
    "train_dgmg.py": ["--iters", "2", "--n-min", "4", "--n-max", "5",
                      "--hidden", "8", "--batch", "4", "--samples", "3"],
}


def main_to_gate(mod, argv, monkeypatch):
    """``mod.main(argv + ['--cpu'])`` with the trainer's real gate run and
    its verdict recorded: the gate's line, or the message of the
    ``SystemExit`` a failed gate raises (the gates are not meant to hold
    at smoke sizes). Returns (metrics, gate verdict)."""
    seen = {}
    real = mod.gate

    def gate(args, data, metrics):
        try:
            seen["line"] = real(args, data, metrics)
        except SystemExit as e:
            seen["line"] = str(e.code)
        return seen["line"]

    monkeypatch.setattr(mod, "gate", gate)
    return mod.main(argv + ["--cpu"]), seen["line"]


def check_metrics(m, line, out):
    """The metrics the gates read, a finite loss for every step, the gate's
    verdict printed."""
    assert {"losses", "step_ms", "val", "test", "wall_s", "gate"} <= set(m)
    assert m["losses"] and len(m["losses"]) == len(m["step_ms"])
    assert all(np.isfinite(m["losses"]))
    assert m["gate"] == line and line in out


def test_smoke_covers_the_harness():
    """Every harness entry has a smoke run in one of the four files."""
    tables = [set(SMOKE), set(SMOKE_GRAPH), set(SMOKE_GEN), set(SMOKE_DIST)]
    assert sum(len(t) for t in tables) == len(set().union(*tables))
    assert set().union(*tables) == set(harness.EXAMPLES)


@pytest.mark.parametrize("entry", sorted(SMOKE))
def test_trainer_main_runs_on_the_cpu(entry, capsys):
    """Each trainer end to end through ``main(argv + ['--cpu'])``: the
    metrics the gates read, a loss for every step, the gate's line."""
    mod = importlib.import_module(harness.module_of(entry))
    m = mod.main(SMOKE[entry] + ["--cpu"])
    assert {"losses", "step_ms", "val", "test", "wall_s", "gate"} <= set(m)
    assert m["losses"] and len(m["losses"]) == len(m["step_ms"])
    assert all(np.isfinite(m["losses"]))
    assert m["gate"] in capsys.readouterr().out


@pytest.mark.parametrize("entry", sorted(SMOKE_DIST))
def test_dist_trainer_main_runs_on_gloo_ranks(entry, capfd):
    """Each distributed entry through ``main(argv + ['--cpu'])`` on its
    gloo ranks at a tiny size: rank 0's metrics, a loss a step, the
    gate's line printed by rank 0 (the spawned ranks write to the file
    descriptor, hence ``capfd``)."""
    mod = importlib.import_module(harness.module_of(entry))
    m = mod.main(SMOKE_DIST[entry] + ["--cpu"])
    check_metrics(m, m["gate"], capfd.readouterr().out)


def test_harness_list():
    assert harness.main(["--list"]) == 0
    assert harness.main(["--list", "--only", "rgcn"]) == 0


def test_harness_coverage_is_the_reference_examples():
    """Ported entries and ``PENDING`` together are the reference's 32
    scripts, each once; every ported module exists."""
    on_disk = {p.name for p in (REPO / "examples").glob("*.py")}
    ported = {harness.script_of(n) for n in harness.EXAMPLES}
    assert len(on_disk) == 32
    assert ported | harness.PENDING == on_disk
    assert not ported & harness.PENDING
    assert len(harness.PENDING) == 0 and len(ported) == 32
    # With train_rgcn.py#identity and train_dist.py#hard-int8.
    assert len(harness.EXAMPLES) == 34
    assert harness.uncovered() == []
    for n in harness.EXAMPLES:
        importlib.import_module(harness.module_of(n))


def test_harness_guard_fails_on_an_unknown_script(tmp_path, monkeypatch,
                                                  capsys):
    for p in (REPO / "examples").glob("*.py"):
        (tmp_path / p.name).write_text("")
    (tmp_path / "train_unknown.py").write_text("")
    monkeypatch.setattr(harness, "EXAMPLES_DIR", tmp_path)
    assert harness.main(["--list"]) == 2
    assert "train_unknown.py" in capsys.readouterr().out


def test_harness_runs_a_trainer_on_the_cpu(monkeypatch):
    """The harness's subprocess path: ``python -m`` with ``--cpu``."""
    rc, secs, out = harness.run_one("train_gcn.py", ["--epochs", "2"], 300,
                                    cpu=True)
    assert rc == 0, out
    assert "no gate on synthetic data" in out

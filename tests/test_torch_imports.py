"""The port imports no JAX and nothing of the JAX package, and asks for
CUDA by default."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

import dgl1_tpu_torch as tdgl

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
import dgl1_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dgl1_tpu_torch.__path__,
                                               "dgl1_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "ml_dtypes", "dgl1_tpu"))
print(",".join(names), bad)
"""

# Modules each slice added; the probe must have imported every one.
_MODULES = ("graph", "hub_format", "ops.engine_hub", "ops.hub_kernels",
            "ops.attention", "ops.attn_kernels", "random", "sampling",
            "sampling.fused", "dataloading", "dataloading.dataloader",
            "dataloading.neighbor_sampler", "ops.engine_tile",
            "ops.tile_kernels", "models.graphsage")


def test_port_imports_no_jax_and_no_reference():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, check=True)
    names, bad = out.stdout.strip().split(" ", 1)
    assert bad == "[]", bad
    names = set(names.split(","))
    missing = [m for m in _MODULES if f"dgl1_tpu_torch.{m}" not in names]
    assert not missing, missing


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        g = tdgl.graph(([0, 1], [1, 2]), num_nodes=3)
        assert g.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdgl.graph(([0, 1], [1, 2]), num_nodes=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdgl.models.GCN(4, 8, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdgl.data.powerlaw_graph(64, 2)
    g = tdgl.graph(([0, 1], [1, 2]), num_nodes=3, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        g.to("cuda")

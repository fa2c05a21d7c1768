"""Utilities (the port's ``dgl1_tpu/utils``): jsonl step metrics,
``torch.profiler`` traces and npz checkpoints in the reference's
layout."""

from dgl1_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from dgl1_tpu_torch.utils.logging import MetricsLogger
from dgl1_tpu_torch.utils.profiler import profile_trace

__all__ = ["MetricsLogger", "save_checkpoint", "load_checkpoint",
           "profile_trace"]

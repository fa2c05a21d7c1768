"""Profiling hook (the port's ``dgl1_tpu/utils/profiler.py``): a
``torch.profiler`` trace written by its TensorBoard trace handler."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["profile_trace"]


@contextlib.contextmanager
def profile_trace(log_dir: str = None):
    """With ``log_dir``, profile the block (the host, and the card when
    there is one) and write the trace there for TensorBoard; yields the
    profiler. Without it, do nothing and yield None."""
    if not log_dir:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(log_dir))) as prof:
        yield prof

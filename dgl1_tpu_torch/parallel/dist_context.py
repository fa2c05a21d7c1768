"""Distributed context entry points (``initialize`` / ``exit_client``).

The port's counterpart of ``dgl1_tpu/parallel/dist_context.py``: joining
the multi-process runtime is ``torch.distributed.init_process_group``
with the reference's coordinator, process count, process id and timeout
arguments. The backend follows the device: ``nccl`` for cuda, ``gloo``
for the CPU. Nothing on a machine tells a program of its cluster: the
caller (or ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``
in the environment, or a DistDGL-style ``ip_config`` file) gives them.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["initialize", "exit_client"]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               ip_config: Optional[str] = None,
               timeout_s: Optional[float] = 300.0,
               device=None) -> Optional[str]:
    """Join the process group (parity: ``dgl.distributed.initialize``);
    returns the backend, or None when single-process (no coordinator).

    ``coordinator_address``: ``host:port`` (a TCP store on that host) or
    any ``torch.distributed`` init URL (``tcp://``, ``file://``); rank 0
    serves it. ``ip_config``: a host file whose first line ``host
    [port]`` names the coordinator. ``device`` (None: cuda) picks the
    backend: ``nccl`` on cuda, ``gloo`` on the CPU; this process's card
    is ``cuda:<process_id % device_count>``. ``timeout_s``: a peer that
    never joins raises RuntimeError within it instead of hanging.
    """
    from dgl1_tpu_torch.graph import resolve_device

    if dist.is_initialized():
        return dist.get_backend()
    if ip_config and not coordinator_address:
        with open(ip_config) as f:
            first = f.readline().split()
        if first:
            port = first[1] if len(first) > 1 else "12321"
            coordinator_address = f"{first[0]}:{port}"
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return None
    num_processes = num_processes or int(os.environ.get("NUM_PROCESSES", 1))
    process_id = process_id if process_id is not None else int(
        os.environ.get("PROCESS_ID", 0))
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    kw = {}
    if dev.type == "cuda":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    try:
        dist.init_process_group(backend, init_method=url,
                                world_size=int(num_processes),
                                rank=int(process_id), **kw)
    except Exception as exc:
        raise RuntimeError(
            f"distributed initialize failed: process {process_id}/"
            f"{num_processes} could not join {coordinator_address} within "
            f"{timeout_s} s; check that every peer is up") from exc
    return backend


def exit_client() -> None:
    """Leave the process group (parity: ``dgl.distributed.exit_client``)."""
    if dist.is_initialized():
        dist.destroy_process_group()

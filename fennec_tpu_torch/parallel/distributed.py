"""Several processes, one per host: torch.distributed set up once.

Counterpart of fennec_tpu/parallel/distributed.py.  The reference has no
distributed dimension (single-process Go).  Images are independent, so
the batch engines need no collective: each process drives its own cards
(global_data_mesh) over its own share of the files.  A process group is
set up only for callers that coordinate processes themselves (barriers,
gathering results).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import DataMesh, data_mesh

# The variables torchrun and similar launchers set; any one of them
# means this process is part of a cluster.
CLUSTER_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Join the process group (no-op on a single host).

    With no arguments, the launcher's environment (MASTER_ADDR,
    WORLD_SIZE, RANK, "env://") is used when it is set, and nothing is
    done when it is not.  Explicit arguments name the coordinator
    ("host:port", reached as tcp://host:port), the number of processes
    and this process's rank; all three are needed.  The backend is NCCL
    when PyTorch sees a card, gloo otherwise.  Nothing is done when a
    process group exists already.

    An explicit configuration that fails raises: silently degrading to
    one host would hang a caller's collectives much later.  A rank
    outside [0, num_processes) or an address without a port raises
    ValueError before any connection is tried (a wrong rank would
    otherwise wait for its peers for the store's whole timeout)."""
    if not dist.is_available() or dist.is_initialized():
        return
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    explicit = (coordinator_address, num_processes, process_id)
    if all(x is None for x in explicit):
        if not any(os.environ.get(k) for k in CLUSTER_ENV):
            return
        try:
            dist.init_process_group(backend, init_method="env://")
        except (RuntimeError, ValueError):
            pass  # as in the JAX package: the process runs on its own
        return
    if any(x is None for x in explicit):
        raise ValueError("fennec: initialize_distributed needs "
                         "coordinator_address, num_processes and "
                         "process_id together")
    host, sep, port = str(coordinator_address).rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"fennec: coordinator_address must be host:port, "
                         f"got {coordinator_address!r}")
    if not 0 <= int(process_id) < int(num_processes):
        raise ValueError(f"fennec: process_id {process_id} is outside "
                         f"[0, {num_processes})")
    dist.init_process_group(backend, init_method=f"tcp://{host}:{port}",
                            world_size=int(num_processes),
                            rank=int(process_id))


def global_data_mesh() -> DataMesh:
    """The 1-D ("data",) mesh of this process's cards (every visible
    card).  Other processes drive their own cards: no chunk crosses a
    host."""
    return data_mesh()

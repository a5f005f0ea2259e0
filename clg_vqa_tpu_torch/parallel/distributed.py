"""Multi-process initialisation (port of clg_vqa_tpu/parallel/distributed.py:19-40).

One process per GPU, as the reference trains (``init_process_group`` and
``--local_rank``, train_task.py:148-159): :func:`initialize` joins the
process group and binds the process to its card; parallel/mesh.py then lays
the (dp, mp) mesh over the ranks. Launch with ``torchrun --nproc_per_node
N script.py`` (which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``) and call ``initialize()``, or pass the
address, the process count and the rank yourself.

Input sharding: pass ``mesh.dp_rank`` / ``mesh.n_dp`` to ``TrainPipeline``
as its ``host_id`` / ``num_hosts`` (the DistributedSampler equivalent); the
mp ranks of one dp group read the same batches.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .. import resolve_device


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, backend: str | None = None,
               device=None) -> torch.device:
    """Join the process group; returns this rank's device.

    A no-op for one process, as in JAX, unless an address is given (a world
    of one). ``coordinator_address``: ``host:port`` (TCP) or a
    ``tcp://`` / ``file://`` URL; without one the ``torchrun`` environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) is read.
    ``device``: ``cuda:{LOCAL_RANK}`` by default (``LOCAL_RANK`` from the
    environment, else the rank), never the current device; pass
    ``device="cpu"`` for a CPU rank. ``backend``: NCCL on a card and gloo on
    the CPU by default; gloo also takes CUDA tensors, for all-reduce and
    broadcast, the only collectives the port uses."""
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    if device is None:
        device = f"cuda:{int(env.get('LOCAL_RANK', process_id))}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not ((num_processes or 1) > 1 or coordinator_address):
        return dev
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes or 1, rank=process_id)
    return dev


def host_id() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def num_hosts() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """rank-0 gating (the reference's ``default_gpu`` flag)."""
    return host_id() == 0

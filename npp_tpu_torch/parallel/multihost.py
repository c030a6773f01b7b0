"""Joining a process group across processes and hosts, a port of
`npp_tpu/parallel/multihost.py`.

npp_tpu joins every host's process through jax.distributed; the port
runs one process per card and joins them in a torch.distributed group:
NCCL between cards, gloo for CPU tensors. Per-image fits are
independent, so the only traffic is the gather of results and the mean
of metrics (parallel/mesh.py).
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout_s: Optional[float] = None) -> None:
    """init_process_group with npp_tpu's environment fallbacks
    (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID), then torchrun's
    (MASTER_ADDR:MASTER_PORT / WORLD_SIZE / RANK). A no-op in npp_tpu's
    cases: no coordinator, or num_processes <= 1; also when a group is
    already initialised.

    coordinator_address: 'host:port' (a tcp:// init), or a 'file://' URL
    of a file every process can reach. backend: default NCCL where a card
    is present, else gloo; a failed init raises. On a machine with cards
    each process takes its own (LOCAL_RANK, else process_id, modulo the
    card count) as the current device."""
    env = os.environ
    if dist.is_initialized():
        return
    coordinator_address = coordinator_address or env.get('COORDINATOR_ADDRESS')
    torchrun = coordinator_address is None and 'MASTER_ADDR' in env and \
        'MASTER_PORT' in env
    if torchrun:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env.get('NUM_PROCESSES') or (
            env.get('WORLD_SIZE', '1') if torchrun else '1'))
    if process_id is None:
        process_id = int(env.get('PROCESS_ID') or env.get('RANK', '0'))
    if coordinator_address is None or num_processes <= 1:
        return
    if backend is None:
        backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    if torch.cuda.is_available():
        local = int(env.get('LOCAL_RANK', process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    init = coordinator_address if coordinator_address.startswith('file://') \
        else f'tcp://{coordinator_address}'
    kw = {} if timeout_s is None else \
        {'timeout': datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id, **kw)


def local_examples(examples, process_id: Optional[int] = None,
                   num_processes: Optional[int] = None):
    """Static round-robin assignment of examples to processes (default: this
    process's rank and the group's size, or 0 and 1 without a group)."""
    grouped = dist.is_available() and dist.is_initialized()
    pid = process_id if process_id is not None else \
        (dist.get_rank() if grouped else 0)
    n = num_processes if num_processes is not None else \
        (dist.get_world_size() if grouped else 1)
    return [e for i, e in enumerate(examples) if i % n == pid]

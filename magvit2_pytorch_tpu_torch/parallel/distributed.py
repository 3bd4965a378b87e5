"""Multi-process bring-up on ``torch.distributed`` (PyTorch counterpart of
``magvit2_pytorch_tpu/parallel/distributed.py``).

One process drives one device. The JAX package calls
``jax.distributed.initialize`` once per process and sees every device after
it; here one ``init_process_group`` per process gives the collectives, and
the mesh (:mod:`.mesh`) arranges the ranks.

Under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` set)::

    from magvit2_pytorch_tpu_torch.parallel import (
        initialize_distributed, make_mesh)
    initialize_distributed()          # NCCL, the card LOCAL_RANK
    mesh = make_mesh()                # data parallel over every rank

Without ``torchrun``, give the coordinator yourself (a two-process test)::

    initialize_distributed('localhost:29500', num_processes=2,
                           process_id=rank, device='cpu')

The JAX ``cpu_devices_per_process`` has no counterpart: one rank is one
device, and ``device='cpu'`` (gloo, on the host) takes its place.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
    **kwargs,
) -> None:
    """Idempotent ``torch.distributed.init_process_group``.

    - A second call, or a call with a group already up, does nothing.
    - With no arguments and no ``torchrun`` environment it does nothing: a
      single process has nothing to coordinate.
    - ``coordinator_address`` (``host:port``) with ``num_processes`` and
      ``process_id`` joins over ``tcp://``; else the ``env://`` variables
      of ``torchrun`` are read.
    - The backend is NCCL, on the card ``LOCAL_RANK`` (else
      ``process_id`` modulo the visible cards), unless ``device='cpu'``,
      which takes gloo. If NCCL cannot start, this raises: it never falls
      back to gloo or to the CPU.

    ``kwargs`` go to ``init_process_group`` (``timeout`` in seconds or a
    ``timedelta``)."""
    if dist.is_initialized():
        return
    under_torchrun = 'RANK' in os.environ and 'WORLD_SIZE' in os.environ
    if (coordinator_address is None and num_processes is None
            and not under_torchrun):
        return
    on_cpu = device is not None and torch.device(device).type == 'cpu'
    backend = 'gloo' if on_cpu else 'nccl'
    if not on_cpu:
        if not torch.cuda.is_available():
            raise RuntimeError('initialize_distributed: no CUDA device for '
                               f'the {backend} backend; pass device="cpu" '
                               'for gloo on the host')
        local = os.environ.get('LOCAL_RANK')
        local = int(local) if local is not None else int(process_id or 0)
        torch.cuda.set_device(local % torch.cuda.device_count())
    if isinstance(kwargs.get('timeout'), (int, float)):
        kwargs['timeout'] = datetime.timedelta(seconds=kwargs['timeout'])
    if coordinator_address is not None:
        assert num_processes is not None and process_id is not None, (
            'coordinator_address needs num_processes and process_id')
        dist.init_process_group(
            backend, init_method=f'tcp://{coordinator_address}',
            world_size=num_processes, rank=process_id, **kwargs)
    else:
        dist.init_process_group(backend, init_method='env://', **kwargs)


def process_count() -> int:
    """The number of processes (1 without a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0

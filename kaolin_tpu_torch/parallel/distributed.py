"""Multi-process execution: one process (rank) per card, on
``torch.distributed``.

Port of ``kaolin_tpu/parallel/distributed.py``, the scale-out design of
BASELINE config #5 (multi-host inverse rendering: views sharded over every
card of every host, parameters replicated, the gradients summed over the
ranks).  ``jax.distributed`` becomes ``torch.distributed``: NCCL between
cards, gloo on the CPU.

Usage (once per process, before any collective):

    from kaolin_tpu_torch.parallel import distributed as D
    D.initialize('host0:1234', num_processes=2, process_id=i)
    mesh = D.make_global_mesh()                     # every rank, ('data',)
    views = D.host_local_array(mesh, per_rank_views)   # this rank's shard
    step = multi_view_grad(loss_fn, mesh)           # parallel/sharding.py

The CPU tests (``tests/test_torch_multihost.py``) start 2 processes on
gloo and check that the summed loss and gradients agree across them.
"""

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from kaolin_tpu_torch._device import entry_device
from kaolin_tpu_torch.parallel.sharding import _distributed, make_mesh

__all__ = ['initialize', 'is_initialized', 'make_global_mesh',
           'host_local_array', 'process_index', 'process_count']


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, local_device_ids=None, backend=None,
               device=None):
    """Connect this process to the others (``init_process_group``).

    Idempotent: a process that is already connected is left as it is.

    Args:
        coordinator_address: ``'host:port'`` of rank 0's TCP store, or an
            init-method URL such as ``'file:///path/store'``; None reads
            ``MASTER_ADDR`` and ``MASTER_PORT`` from the environment, as
            ``torchrun`` sets them.
        num_processes: the world size (None: ``WORLD_SIZE``).
        process_id: this process's rank (None: ``RANK``).
        local_device_ids: the card of this process, as a one-element
            sequence (default: the local rank modulo the number of cards,
            so two ranks on a one-card host share ``cuda:0``; the local
            rank is ``LOCAL_RANK``, else ``process_id``, else ``RANK``).
        backend: ``'nccl'`` or ``'gloo'`` (default: nccl on a card, gloo on
            the CPU).  NCCL refuses two ranks on one card; such a run names
            gloo.
        device: ``'cpu'``, or None for the card
            (:func:`~kaolin_tpu_torch._device.entry_device`).

    Returns:
        The device this rank computes on.
    """
    device = entry_device(device)
    if device.type == 'cuda':
        if local_device_ids is not None:
            index = int(local_device_ids[0])
        else:
            local = os.environ.get('LOCAL_RANK', process_id)
            if local is None:
                local = os.environ.get('RANK', 0)
            index = int(local) % torch.cuda.device_count()
        device = torch.device('cuda', index)
        torch.cuda.set_device(device)
    if is_initialized():
        return device
    if backend is None:
        backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if coordinator_address is None:
        init_method = 'env://'
    elif '://' in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = 'tcp://' + coordinator_address
    kwargs = {}
    if num_processes is not None:
        kwargs['world_size'] = num_processes
    if process_id is not None:
        kwargs['rank'] = process_id
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    return device


def is_initialized():
    return _distributed()


def process_index():
    return dist.get_rank() if is_initialized() else 0


def process_count():
    return dist.get_world_size() if is_initialized() else 1


def make_global_mesh(axis_names=('data',), axis_shapes=None, device=None):
    """Mesh over every rank of every process, in rank order.

    For an explicit host / card split use
    ``axis_names=('host', 'device'), axis_shapes=(num_hosts, -1)``.
    """
    n = process_count()
    if axis_shapes is None:
        axis_shapes = (n,) if len(axis_names) == 1 else None
    if axis_shapes is None:
        raise ValueError("axis_shapes required for multi-axis meshes")
    shapes = list(axis_shapes)
    if -1 in shapes:
        known = int(np.prod([s for s in shapes if s != -1]))
        shapes[shapes.index(-1)] = n // known
    return make_mesh(shapes, axis_names, device=device)


def host_local_array(mesh, host_local_data, axis='data'):
    """This rank's shard of a global batch from the data it holds.

    Each process passes only ITS slice of the global batch (leading axis),
    in rank order along ``axis``, and gets it back as tensors on its
    device: no rank reads another's data (the port of
    ``jax.make_array_from_process_local_data``).
    """
    mesh.axis_index(axis)       # raises for a rank outside the mesh
    return pytree.tree_map(
        lambda x: torch.as_tensor(x, device=mesh.device), host_local_data)

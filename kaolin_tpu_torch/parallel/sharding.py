"""Rank meshes and sharding helpers for multi-GPU rendering.

Port of ``kaolin_tpu/parallel/sharding.py`` onto ``torch.distributed``.  A
JAX mesh lays out the devices of one program on named axes; in PyTorch each
device is driven by a process of its own (a rank), so a :class:`Mesh` lays
out the ranks of the process group on named axes and holds, for the rank
that made it, its index along each axis and the process group of its peers
along it.  Views are sharded over an axis, parameters replicated, and the
loss and the parameter gradients summed over the axis by one all-reduce, as
the JAX package's ``psum`` sums them.

Every rank of the default process group calls :func:`make_mesh` with the
same arguments: it creates the axes' groups, and ``dist.new_group`` is
collective over the whole default group.  Without a process group a mesh
of one rank still works, and every collective is then the identity, as on
a one-device JAX mesh.
"""

import collections
import math

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from kaolin_tpu_torch._device import entry_device

__all__ = ['Mesh', 'make_mesh', 'shard_views', 'replicate',
           'multi_view_grad']


def _distributed():
    return dist.is_available() and dist.is_initialized()


class Mesh:
    """Ranks laid out on named axes, as seen by one rank.

    Attributes:
        shape: ordered dict, axis name -> size.
        ranks: int array of the mesh's ranks, of that shape.
        device: the device this rank computes on.
    """

    def __init__(self, ranks, axis_names, device):
        self.ranks = ranks
        self.axis_names = tuple(axis_names)
        self.shape = collections.OrderedDict(zip(self.axis_names,
                                                 ranks.shape))
        self.device = device
        rank = dist.get_rank() if _distributed() else 0
        where = np.argwhere(ranks == rank)
        self._coords = tuple(int(c) for c in where[0]) if len(where) else None
        self._groups = {}
        if not _distributed():
            return
        # one group per line of peers along each axis, then one of the whole
        # mesh; every rank creates every group, in the same order.  A line
        # of every rank is the default group, and a 1-D mesh's whole-mesh
        # group is its axis group, so neither makes a communicator of its own
        world = set(range(dist.get_world_size()))
        lines = [(name, np.moveaxis(ranks, axis, -1).reshape(
                     -1, ranks.shape[axis]))
                 for axis, name in enumerate(self.axis_names)]
        if ranks.ndim > 1:
            lines.append((None, ranks.reshape(1, -1)))
        for name, peers in lines:
            for line in peers:
                line = line.tolist()
                group = (dist.group.WORLD if set(line) == world
                         else dist.new_group(line))
                if rank in line:
                    self._groups[name] = group
        if ranks.ndim == 1 and self.axis_names[0] in self._groups:
            self._groups[None] = self._groups[self.axis_names[0]]

    def _member(self):
        if self._coords is None:
            raise ValueError('this rank is not in the mesh')
        return self._coords

    def axis_index(self, axis):
        """This rank's index along ``axis`` (``jax.lax.axis_index``)."""
        return self._member()[self.axis_names.index(axis)]

    def all_reduce(self, tensor, axis=None):
        """Sum ``tensor`` in place over the ranks along ``axis`` (None: the
        whole mesh), outside autograd; returns it.  Without a process group
        it is returned as it is."""
        if _distributed():
            self._member()
            dist.all_reduce(tensor, group=self._groups[axis])
        return tensor

    def broadcast(self, tensor):
        """Overwrite ``tensor`` in place with the mesh's first rank's;
        returns it."""
        if _distributed():
            self._member()
            dist.broadcast(tensor, int(self.ranks.flat[0]),
                           group=self._groups[None])
        return tensor


def make_mesh(axis_shapes=None, axis_names=('data',), devices=None,
              device=None):
    """Create a rank mesh.

    Args:
        axis_shapes: sizes per axis (default: every rank on one axis).
        axis_names: names per axis (default ('data',)).
        devices: the ranks to lay out, in order (default: every rank of the
            default process group, or rank 0 alone without one).
        device: the device this rank computes on (default: the card this
            process has selected, see
            :func:`~kaolin_tpu_torch._device.entry_device`).

    Returns:
        :class:`Mesh` over the first ``prod(axis_shapes)`` of ``devices``.

    Raises:
        ValueError: the shape needs more ranks than there are.
    """
    device = entry_device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    if devices is None:
        devices = range(dist.get_world_size() if _distributed() else 1)
    devices = list(devices)
    if axis_shapes is None:
        axis_shapes = (len(devices),)
    if len(axis_shapes) != len(axis_names):
        raise ValueError(f'{len(axis_shapes)} axis sizes for '
                         f'{len(axis_names)} axis names')
    need = math.prod(axis_shapes)
    if need > len(devices):
        raise ValueError(
            f"mesh shape {tuple(axis_shapes)} needs {need} ranks, "
            f"only {len(devices)} available")
    ranks = np.asarray(devices[:need], dtype=np.int64).reshape(axis_shapes)
    return Mesh(ranks, axis_names, device)


def shard_views(mesh, tree, axis='data'):
    """This rank's contiguous slice of the leading (view / batch) axis of
    every leaf, in rank order along ``axis``, on the mesh's device.

    Every rank passes the same global ``tree``.  Only the slice is copied
    to the device, into storage of its own: a rank holds its shard, not
    the global batch."""
    n, i = mesh.shape[axis], mesh.axis_index(axis)

    def local(x):
        x = torch.as_tensor(x)      # where it is: no copy of a tensor/array
        if x.shape[0] % n:
            raise ValueError(f'leading axis {x.shape[0]} not divisible by '
                             f'mesh axis {axis!r} of size {n}')
        k = x.shape[0] // n
        return x[i * k:(i + 1) * k].to(mesh.device, copy=True)
    return pytree.tree_map(local, tree)


def replicate(mesh, tree):
    """Every leaf as the same copy on every rank of the mesh: the mesh's
    first rank's, broadcast to the others, on the mesh's device.  A leaf
    that requires a gradient gives a leaf that requires one."""
    def rep(x):
        if x is None:
            return None
        t = mesh.broadcast(torch.as_tensor(x, device=mesh.device)
                           .detach().clone())
        if torch.is_tensor(x) and x.requires_grad:
            t.requires_grad_()
        return t
    return pytree.tree_map(rep, tree)


def multi_view_grad(loss_fn, mesh, axis='data'):
    """Build a sharded value-and-gradient function for multi-view
    optimisation.

    ``loss_fn(params, views) -> scalar`` is evaluated on this rank's shard
    of the views (from :func:`shard_views` or
    :func:`~kaolin_tpu_torch.parallel.distributed.host_local_array`); its
    value and its gradients to ``params`` (any tree of tensors that require
    a gradient, such as an ``InverseRenderParams``) come from local
    autograd, and are then summed over ``axis`` by one all-reduce of them
    all, outside autograd.  So each gradient is counted once: an
    all-reduce inside the graph, back-propagated by every rank from its own
    copy of the summed loss, returns the gradients times the axis size.

    Returns:
        ``fn(params, views) -> (loss, grads)``, both the same on every rank
        of the axis, ``grads`` of the tree structure of ``params``.
    """
    def fn(params, views):
        leaves, spec = pytree.tree_flatten(params)
        value = loss_fn(params, views)
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
        flat = torch.cat([value.detach().reshape(1)] + [
            (torch.zeros_like(p) if g is None else g).reshape(-1)
            for p, g in zip(leaves, grads)])
        mesh.all_reduce(flat, axis)
        out, start = [], 1
        for p in leaves:
            out.append(flat[start:start + p.numel()].view_as(p)
                       .to(p.dtype))
            start += p.numel()
        return flat[0].to(value.dtype), pytree.tree_unflatten(out, spec)
    return fn

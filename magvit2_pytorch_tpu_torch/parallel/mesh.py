"""The device mesh and placement helpers (PyTorch counterpart of
``magvit2_pytorch_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``jax.sharding.Mesh`` with axes
``('data', 'tensor')``, or ``('dcn', 'data', 'tensor')`` across slices, and
lets XLA insert the collectives. Here one rank is one device: the ranks
``0 .. world - 1`` are laid out row-major over the same axes
(``torch.distributed.device_mesh.init_device_mesh``), the batch is cut over
``('dcn', 'data')`` and the trainer calls the collectives itself: one
gradient all-reduce per optimizer step over the batch axes and, with
``tensor_parallel``, an all-gather of the parameters and a reduce-scatter of
their gradients over ``'tensor'``.

``data_sharding`` and ``replicated_sharding`` (JAX ``NamedSharding``\\ s)
have no counterpart: a rank holds plain tensors, its rows of the batch
(:func:`shard_batch`) and a copy of the state (:func:`replicate`).
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from magvit2_pytorch_tpu_torch.parallel.distributed import (
    process_count, process_index)


class Mesh:
    """The world's ranks over named axes: ``axis_names``, ``shape`` (name
    -> extent, as ``jax.sharding.Mesh.shape``), the torch ``DeviceMesh``
    (None for one process without a group) and the process group of any
    set of axes (:meth:`group`)."""

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int],
                 device_type: str, device_mesh=None,
                 rank: Optional[int] = None):
        self.rank = process_index() if rank is None else rank
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.device_type = device_type
        self.device_mesh = device_mesh
        self.ranks = np.arange(math.prod(self.shape.values())).reshape(
            tuple(self.shape.values()))
        self._groups = {}

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def coordinate(self) -> dict:
        """This rank's index along each axis."""
        at = np.argwhere(self.ranks == self.rank)[0]
        return dict(zip(self.axis_names, (int(i) for i in at)))

    def group(self, axes: Sequence[str]):
        """The process group of this rank's fellows along ``axes`` (None
        without a process group; a group of one rank where the extent is
        1)."""
        axes = tuple(a for a in self.axis_names if a in axes)
        if self.device_mesh is None:
            return None
        if axes == self.axis_names:
            return dist.group.WORLD
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        return self._groups[axes]

    def _make_group(self, axes):
        """The group of several axes (one axis has the device mesh's).
        Every rank takes part in making every such group, so all ranks
        call this alike."""
        axes = tuple(a for a in self.axis_names if a in axes)
        if len(axes) > 1 and axes != self.axis_names:
            keep = [self.axis_names.index(a) for a in axes]
            rest = [i for i in range(len(self.axis_names)) if i not in keep]
            members = self.ranks.transpose(rest + keep).reshape(
                -1, math.prod(self.shape[a] for a in axes))
            mine, _ = dist.new_subgroups_by_enumeration(members.tolist())
            self._groups[axes] = mine


def _device_type() -> str:
    if dist.is_initialized() and dist.get_backend() == 'nccl':
        return 'cuda'
    return 'cuda' if torch.cuda.is_available() else 'cpu'


def mesh_layout(n: int, data: Optional[int] = None, tensor: int = 1,
                dcn: int = 1):
    """The axis names and extents of a mesh over ``n`` ranks (the JAX
    package's rule and assertion)."""
    if data is None:
        data = n // (tensor * dcn)
    assert data * tensor * dcn == n, (
        f'mesh {dcn}x{data}x{tensor} does not cover {n} devices')
    if dcn > 1:
        return ('dcn', 'data', 'tensor'), (dcn, data, tensor)
    return ('data', 'tensor'), (data, tensor)


def make_mesh(data: Optional[int] = None, tensor: int = 1,
              dcn: int = 1) -> Mesh:
    """``('data', 'tensor')``, or ``('dcn', 'data', 'tensor')`` when
    ``dcn > 1``, over every rank of the world, row-major with ``dcn``
    slowest (``dcn`` should be the number of hosts). Defaults to pure data
    parallelism. Without a process group it is a one-rank mesh on the card
    (on the host where there is none)."""
    names, sizes = mesh_layout(process_count(), data, tensor, dcn)
    device_type = _device_type()
    if not dist.is_initialized():
        return Mesh(names, sizes, device_type)
    from torch.distributed.device_mesh import init_device_mesh
    mesh = Mesh(names, sizes, device_type, init_device_mesh(
        device_type, sizes, mesh_dim_names=names))
    mesh._make_group(batch_axes(mesh))
    return mesh


def batch_axes(mesh: Mesh):
    """The mesh axes the batch is cut over (``'dcn'`` first when
    present)."""
    return tuple(a for a in ('dcn', 'data') if a in mesh.axis_names)


def data_parallel_extent(mesh: Mesh) -> int:
    """The number of ways the batch is cut (the product over the batch
    axes)."""
    return math.prod(mesh.shape[a] for a in batch_axes(mesh))


def batch_index(mesh: Mesh) -> int:
    """This rank's position among the batch's shards (dcn-major)."""
    at = mesh.coordinate
    index = 0
    for a in batch_axes(mesh):
        index = index * mesh.shape[a] + at[a]
    return index


def is_main_process() -> bool:
    return process_index() == 0


def shard_batch(batch, mesh: Mesh, leading_none: int = 0):
    """This rank's contiguous rows of a global ``batch`` (numpy or torch),
    cut along the axis after ``leading_none`` unsharded ones (e.g. a
    grad-accumulation axis): the rows ``DataLoader(num_shards, shard_id)``
    hands this rank."""
    n = data_parallel_extent(mesh)
    rows = batch.shape[leading_none]
    assert rows % n == 0, (
        f'a batch of {rows} does not divide the data-parallel extent {n}')
    per = rows // n
    i = batch_index(mesh)
    return batch[(slice(None),) * leading_none
                 + (slice(i * per, (i + 1) * per),)]


def _tensors(tree):
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return [*tree.parameters(), *tree.buffers()]
    if isinstance(tree, Mapping):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


@torch.no_grad()
def _broadcast_coalesced(tensors, group=None, src: int = 0):
    """Broadcast ``tensors`` from global rank ``src`` in place, one flat
    buffer per dtype and device."""
    by_kind = {}
    for t in tensors:
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    for ts in by_kind.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        dist.broadcast(flat, src=src, group=group)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def replicate(tree, mesh: Mesh):
    """Every tensor of ``tree`` (a tensor, a module's parameters and
    buffers, or dicts / lists of them) broadcast in place from rank 0 over
    the mesh, so every rank holds rank 0's values; returns ``tree``."""
    if mesh.size > 1 and dist.is_initialized():
        _broadcast_coalesced(_tensors(tree), group=mesh.group(mesh.axis_names))
    return tree


def _jax_shape(name, p, kinds):
    """The shape the JAX package gives the parameter ``name`` (its bridge
    transform; its own shape without one)."""
    from magvit2_pytorch_tpu_torch.models.jax_import import TRANSFORMS
    view = np.broadcast_to(np.float32(0), tuple(p.shape))
    if name in kinds:
        view = TRANSFORMS[kinds[name]][1](view)
    return np.shape(view)


def tensor_parallel_shardings(params: Mapping, mesh: Mesh,
                              min_elements: int = 1 << 14,
                              entries=()) -> dict:
    """The JAX package's channel-parallel placement over ``'tensor'``: a
    parameter is cut when its JAX shape has two or more axes, at least
    ``min_elements`` elements and an output-channel (trailing) extent that
    the tensor axis divides; every other one is replicated.

    ``params`` maps the port's names to tensors, ``entries`` is the bridge's
    table (``(port name, JAX path, transform)``, ``models/jax_import.py``),
    which gives each JAX shape, so the same leaves are cut in both packages.
    Returns name -> the port's dim that is cut (the JAX trailing dim: dim 0
    of a port conv or ``Linear`` weight), or None."""
    tp = mesh.shape.get('tensor', 1)
    kinds = {key: kind for key, _, kind in entries}
    out = {}
    for name, p in params.items():
        shape = _jax_shape(name, p, kinds)
        cut = (tp > 1 and len(shape) >= 2 and math.prod(shape) >= min_elements
               and shape[-1] % tp == 0)
        out[name] = (None if not cut
                     else 0 if kinds.get(name, 'copy') != 'copy'
                     else p.ndim - 1)
    return out


def shard_params_tensor_parallel(params: Mapping, mesh: Mesh,
                                 min_elements: int = 1 << 14,
                                 entries=()) -> dict:
    """Name -> this rank's part of each parameter (a copy of its slice
    along the cut dim, at its ``'tensor'`` coordinate), or the whole
    parameter where :func:`tensor_parallel_shardings` replicates it."""
    dims = tensor_parallel_shardings(params, mesh, min_elements, entries)
    tp = mesh.shape.get('tensor', 1)
    k = mesh.coordinate.get('tensor', 0)
    return {name: (p if dims[name] is None
                   else p.detach().chunk(tp, dims[name])[k].clone())
            for name, p in params.items()}

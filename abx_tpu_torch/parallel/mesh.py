"""A 1-D data mesh over processes, and batch sharding on it.

Counterpart of abx_tpu/parallel/mesh.py.  The JAX package lays a 1-D
`jax.sharding.Mesh` over local devices and lets XLA place each device's
rows; here a mesh is a `torch.distributed` process group with one device
per process (rank), and each rank holds its own rows:

  * `make_mesh` -- the group, this rank, the world size and this rank's
    `torch.device`;
  * `shard_batch` -- this rank's contiguous rows of each leading axis (an
    undivisible leading axis is replicated, as in the JAX package);
  * `replicate` -- every rank gets rank 0's values;
  * `check_shards` -- the ranks' shards, gathered in rank order, are the
    batch bit for bit (the runner and the trainer call it once a run);
  * `all_gather_rows` -- the one gather: ranks' tensors concatenated in
    rank order along axis 0.

The backend is the caller's choice (`init_process_group`): `nccl` when
each rank has its own card; `gloo` on the CPU, and for several ranks that
share one card (NCCL refuses two ranks on one device).  Gloo takes CUDA
tensors for `broadcast` and `all_reduce` only, so `all_gather_rows` stages
CUDA tensors through host memory under gloo.

Sampling is independent per (complex, sample), so a sampling mesh makes no
collective in the hot loop; training reduces its gradients over the mesh
(train/trainer.py).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist


def init_process_group(backend: str, coordinator: str, world_size: int,
                       rank: int, timeout_s: float = 1800.0) -> None:
    """Join the default process group at `tcp://<coordinator>` (host:port
    of rank 0).  `backend` is 'nccl' or 'gloo'; it is never guessed."""
    if backend not in ('nccl', 'gloo'):
        raise ValueError(f'backend {backend!r}: nccl or gloo')
    dist.init_process_group(
        backend, init_method=f'tcp://{coordinator}', world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))


def rank_device(backend: Optional[str], rank: int) -> torch.device:
    """The device a rank runs on when the caller names none: under nccl
    the card `LOCAL_RANK` names (torchrun sets it), else card rank mod the
    cards; the CPU otherwise."""
    if backend == 'nccl':
        local = int(os.environ.get('LOCAL_RANK',
                                   rank % max(torch.cuda.device_count(), 1)))
        return torch.device('cuda', local)
    return torch.device('cpu')


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the ranks of `group` (None: this one process)."""
    group: Any
    rank: int
    size: int
    device: torch.device
    backend: Optional[str]
    axis_name: str = 'data'


def local_mesh(device) -> Mesh:
    """A mesh of this one process on `device`, whatever process group is
    initialised (e.g. one host's sampling under a multi-host group)."""
    return Mesh(None, 0, 1, torch.device(device), None)


def make_mesh(group=None, axis_name: str = 'data',
              device=None) -> Mesh:
    """The mesh over `group`'s ranks (the default group when None; one
    process when no process group is initialised).  `device` is this
    rank's device (default: `rank_device`)."""
    if not dist.is_initialized():
        if group is not None:
            raise ValueError('make_mesh: a group without an initialised '
                             'process group')
        return dataclasses.replace(local_mesh(device or 'cpu'),
                                   axis_name=axis_name)
    group = group if group is not None else dist.group.WORLD
    rank = dist.get_rank(group)
    size = dist.get_world_size(group)
    backend = dist.get_backend(group)
    dev = (torch.device(device) if device is not None
           else rank_device(backend, dist.get_rank()))
    return Mesh(group, rank, size, dev, backend, axis_name)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a leading axis lies on the mesh: split in contiguous blocks over
    `axis_name`'s ranks, or replicated (`axis_name` None)."""
    axis_name: Optional[str]
    size: int

    def rows(self, n: int, rank: int) -> slice:
        """The rows of a leading axis of length n that `rank` holds: its
        block when n divides evenly, else all of them."""
        if self.axis_name is None or n % self.size:
            return slice(0, n)
        b = n // self.size
        return slice(rank * b, (rank + 1) * b)


def batch_sharding(mesh: Mesh, axis_name: Optional[str] = None) -> Sharding:
    """First-axis (batch) sharding."""
    return Sharding(axis_name or mesh.axis_name, mesh.size)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(None, mesh.size)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        children = [_map(fn, v) for v in tree]
        # A NamedTuple (e.g. geometry.rigid.Rigid) takes its fields apart.
        return (type(tree)(*children) if hasattr(tree, '_fields')
                else type(tree)(children))
    return fn(tree)


def _leaves(tree, path=''):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f'{path}/{k}')
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f'{path}/{i}')
    else:
        yield path, tree


def _sharded(x) -> bool:
    return (torch.is_tensor(x) or isinstance(x, np.ndarray)) and x.ndim > 0


def shard_batch(mesh: Mesh, batch, axis_name: Optional[str] = None):
    """This rank's rows of every array leaf's leading axis (tensors or
    numpy arrays; other leaves pass through).  A leading axis the mesh
    size does not divide is replicated: pad with `pad_batch_to_devices`
    to split it."""
    sh = batch_sharding(mesh, axis_name)
    return _map(lambda x: x[sh.rows(x.shape[0], mesh.rank)]
                if _sharded(x) else x, batch)


def replicate(mesh: Mesh, tree):
    """Every tensor leaf with rank 0's values (a broadcast; the leaves must
    have one shape and dtype on every rank)."""
    if mesh.size == 1:
        return tree

    def bcast(x):
        if not torch.is_tensor(x):
            return x
        y = x.detach().clone().contiguous()
        dist.broadcast(y, src=dist.get_global_rank(mesh.group, 0),
                       group=mesh.group)
        return y
    return _map(bcast, tree)


def all_gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The ranks' `x` (one shape on every rank) concatenated in rank order
    along axis 0, on every rank.  Gloo gathers no CUDA tensor: under gloo
    a CUDA tensor goes through host memory, explicitly, here."""
    if mesh.size == 1:
        return x
    staged = mesh.backend == 'gloo' and x.is_cuda
    src = (x.cpu() if staged else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    out = torch.cat(parts, dim=0)
    return out.to(x.device) if staged else out


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def min_over_ranks(mesh: Mesh, value: int) -> int:
    """The least of the ranks' `value`s, on every rank (one all_reduce)."""
    if mesh.size == 1:
        return value
    t = torch.tensor([value], dtype=torch.int64,
                     device=mesh.device if mesh.backend == 'nccl' else 'cpu')
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.group)
    return int(t.item())


def all_ranks_agree(mesh: Mesh, ok: bool) -> bool:
    """True when `ok` holds on every rank."""
    return min_over_ranks(mesh, int(ok)) == 1


def check_shards(mesh: Mesh, batch, shards,
                 axis_name: Optional[str] = None) -> None:
    """Exact-match check of a sharding: for every leaf, the ranks'
    `shards` gathered in rank order are `batch` bit for bit (a replicated
    leaf: this rank's shard is the batch).  Raises RuntimeError on every
    rank when one rank's check fails."""
    sh = batch_sharding(mesh, axis_name)
    bad = []
    for (path, full), (_, part) in zip(_leaves(batch), _leaves(shards)):
        if not _sharded(full):
            continue
        full = torch.as_tensor(full)
        part = torch.as_tensor(part).to(full.device)
        n = full.shape[0]
        if sh.rows(n, 0) != slice(0, n):
            part = all_gather_rows(mesh, part)
        if part.shape != full.shape or part.dtype != full.dtype \
                or not torch.equal(_bits(part), _bits(full)):
            bad.append(path)
    if not all_ranks_agree(mesh, not bad):
        raise RuntimeError(
            f'check_shards: the shards gathered in rank order are not the '
            f'batch (rank {mesh.rank}: leaves {bad or "all equal"})')


def pad_batch_to_devices(batch: Dict[str, Any], num_devices: int):
    """Pad the leading axis to a multiple of num_devices (masked work)."""
    def pad(x):
        b = x.shape[0]
        rem = (-b) % num_devices
        if rem == 0:
            return x, b
        pad_width = [(0, rem)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(np.asarray(x), pad_width), b
    sizes = set()
    out = {}
    for k, v in batch.items():
        padded, b = pad(v)
        out[k] = padded
        sizes.add(b)
    assert len(sizes) == 1
    return out, sizes.pop()

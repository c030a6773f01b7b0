"""Device meshes over a torch.distributed process group, a port of
`npp_tpu/parallel/mesh.py`.

npp_tpu is single-controller: one process addresses every chip and XLA
inserts the collectives. The port runs one process per card in a process
group. A Mesh names axes over the group's ranks, laid out row-major as
npp_tpu reshapes its device list; a leading axis sharded over a mesh axis
of size n gives the rank at coordinate r along it the contiguous rows
[r*b/n, (r+1)*b/n) of the axis padded to b, a multiple of n, as
NamedSharding(mesh, P(axis)) lays rows out. Tensors stay plain tensors,
each rank holding its block.

The axes npp_tpu shards: 'images' (independent per-image fits),
'pixels' (the coordinates of one image's render), 'candidates' (the
ranking's lattices). The cross-rank traffic is what XLA's is: a gather
of results back to the full axis and a mean of metrics. NCCL carries the
card's tensors in place; under gloo a collective is staged through host
memory (copied to the CPU, gathered there, copied back), which is what
the CPU tests run and what two ranks sharing one card use.
"""
from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """Named axes over the ranks of `group` (None: a one-rank mesh with no
    group). `shape` maps axis names to sizes, as jax's Mesh.shape."""

    def __init__(self, axis_names: Sequence[str], axis_sizes: Sequence[int],
                 group=None):
        self.axis_names = tuple(axis_names)
        self.axis_sizes = tuple(int(s) for s in axis_sizes)
        self.group = group
        self.size = math.prod(self.axis_sizes)
        self.rank = dist.get_rank(group) if group is not None else 0
        world = dist.get_world_size(group) if group is not None else 1
        if self.size != world:
            raise ValueError(f'mesh shape {self.axis_sizes} needs {self.size} '
                             f'ranks, the group has {world}')
        self.coords = tuple(int(c) for c in np.unravel_index(
            self.rank, self.axis_sizes))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        return self.coords[self.axis_names.index(axis)]

    def ranks_along(self, axis: str) -> List[int]:
        """The ranks whose coordinates equal this rank's but along `axis`,
        in the order of their coordinate there."""
        a = self.axis_names.index(axis)
        out = []
        for i in range(self.axis_sizes[a]):
            c = list(self.coords)
            c[a] = i
            out.append(int(np.ravel_multi_index(c, self.axis_sizes)))
        return out

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)


def make_mesh(axis_names: Sequence[str] = ('images',),
              shape: Optional[Tuple[int, ...]] = None, group=None) -> Mesh:
    """A mesh over `group` (default: the default process group if one is
    initialised, else a one-rank mesh without a group). The default shape
    puts every rank on the first axis."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    world = dist.get_world_size(group) if group is not None else 1
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names):
        raise ValueError(f'axes {axis_names} and shape {shape} differ')
    return Mesh(axis_names, shape, group)


def group_mesh(axis_names: Sequence[str] = ('images',)) -> Optional[Mesh]:
    """make_mesh over the default group when one is initialised, else None:
    the default of the entry points that shard, as npp_tpu's default mesh is
    every device."""
    if dist.is_available() and dist.is_initialized():
        return make_mesh(axis_names)
    return None


class RowSharding:
    """The rows of a leading axis a rank holds: its block along `axis`, or
    every row (axis None, replicated)."""

    def __init__(self, mesh: Mesh, axis: Optional[str]):
        self.mesh, self.axis = mesh, axis
        self.parts = mesh.shape[axis] if axis is not None else 1

    def padded(self, n: int) -> int:
        """n rounded up to a multiple of the axis size."""
        return -(-n // self.parts) * self.parts

    def rows(self, n: int) -> slice:
        """This rank's rows of an axis of n rows (padded first)."""
        if self.axis is None:
            return slice(0, n)
        k = self.padded(n) // self.parts
        r = self.mesh.index(self.axis)
        return slice(r * k, (r + 1) * k)

    def owner(self, row: int, n: int) -> int:
        """The coordinate along the axis that holds `row` of n rows."""
        return 0 if self.axis is None else row // (self.padded(n) // self.parts)


def image_sharding(mesh: Mesh, axis: str = 'images') -> RowSharding:
    """Leading-axis sharding for per-image stacked tensors."""
    return RowSharding(mesh, axis)


def replicated(mesh: Mesh) -> RowSharding:
    return RowSharding(mesh, None)


def _tree_map(fn, tree):
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def pad_rows(x, n: int):
    """x with its leading axis padded to n rows by repeating the last row
    (npp_tpu's padding of an image batch)."""
    k = x.shape[0]
    if k == n:
        return x
    if isinstance(x, np.ndarray):
        return np.concatenate([x, np.repeat(x[-1:], n - k, 0)], 0)
    return torch.cat([x, x[-1:].expand((n - k,) + tuple(x.shape[1:]))], 0)


def shard_leading_axis(tree, mesh: Mesh, axis: str = 'images'):
    """This rank's block of every tensor (or numpy array) in `tree`, each
    leading axis first padded to a multiple of the axis size by repeating
    its last row."""
    sh = image_sharding(mesh, axis)

    def one(x):
        n = x.shape[0]
        return pad_rows(x, sh.padded(n))[sh.rows(n)]
    return _tree_map(one, tree)


def _collective_tensor(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x where the group's backend reads it: under gloo staged through host
    memory; under NCCL it must already be on the card."""
    if mesh.backend == 'gloo':
        return x.detach().cpu().contiguous()
    if x.device.type != 'cuda':
        raise ValueError(f'{mesh.backend} collectives need CUDA tensors, got '
                         f'one on {x.device}')
    return x.detach().contiguous()


def gather_leading_axis(tree, mesh: Mesh, axis: str = 'images',
                        n: Optional[int] = None):
    """Every rank's block of each tensor in `tree` along `axis`, all-gathered
    back to the full leading axis (the counterpart of reading a sharded
    jax.Array), the padding dropped (rows beyond n); on each tensor's own
    device. Every rank calls it with blocks of one shape."""
    def one(x: torch.Tensor) -> torch.Tensor:
        if mesh.group is None:
            out = x
        else:
            t = _collective_tensor(x, mesh)
            parts = [torch.empty_like(t) for _ in range(mesh.size)]
            dist.all_gather(parts, t, group=mesh.group)
            out = torch.cat([parts[r] for r in mesh.ranks_along(axis)]).to(
                x.device)
        return out if n is None else out[:n]
    return _tree_map(one, tree)


def mean_over_mesh(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean of x over the ranks (a metric's mean over the images axis:
    a value replicated along the other axes keeps its mean)."""
    if mesh.group is None:
        return x
    t = _collective_tensor(x, mesh).clone()
    dist.all_reduce(t, group=mesh.group)
    return (t / mesh.size).to(x.device)


def gather_objects(obj: Any, mesh: Mesh) -> List[Any]:
    """Every rank's picklable `obj`, in rank order (small records only)."""
    if mesh.group is None:
        return [obj]
    out: List[Any] = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out

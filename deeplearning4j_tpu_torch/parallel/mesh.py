"""Device-mesh helpers, the counterpart of the JAX package's
`parallel/mesh.py`.

JAX builds one `Mesh` over every device of a single controller; a torch
mesh is the processes of one `torch.distributed` job, one rank a
process, each with one explicit device. `make_mesh` lays the ranks of
the default process group out row-major over named axes and builds a
process group for every non-empty set of those axes, so a collective
"over `data`" or "over (`data`, `model`)" runs inside this rank's group
for that set (`parallel/collectives.py`).

Backend: a mesh on CUDA devices takes NCCL, one on the CPU takes gloo,
unless `backend=` names one. gloo is also how several ranks share one
card (NCCL refuses two ranks of a communicator on one device): the
collectives then stage CUDA tensors through host memory and count the
bytes (`collectives.host_staged_bytes`).

`replicated` and `batch_sharding` are placement descriptors, not
placements: `DeviceFeed`, the trainers and `checkpoint.restore_params_
for` read them to decide which rows or slices this rank holds.
"""

from __future__ import annotations

import itertools
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import default_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "PartitionSpec", "P",
           "Placement", "make_mesh", "replicated", "batch_sharding",
           "current_mesh"]

#: the meshes entered with `with mesh:`, innermost last
_CURRENT: list = []


def current_mesh() -> "Mesh":
    """The innermost mesh entered with `with mesh:`."""
    if not _CURRENT:
        raise RuntimeError("no current mesh: an axis name needs a mesh "
                           "entered with `with mesh:`")
    return _CURRENT[-1]


class PartitionSpec(tuple):
    """Which mesh axis splits each dimension of an array (None: not
    split), as `jax.sharding.PartitionSpec`; `str()` prints as JAX does,
    e.g. `PartitionSpec(None, 'model')`."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec({', '.join(repr(p) for p in self)})"

    __str__ = __repr__


P = PartitionSpec


class Mesh:
    """Ranks of the default process group over named axes (row-major:
    the last axis varies fastest). `devices` holds the global ranks in
    the mesh's shape, `shape` maps axis name -> size, `device` is this
    rank's device and `coords` its index along each axis."""

    def __init__(self, ranks: np.ndarray, axis_names: Tuple[str, ...],
                 device: torch.device, backend: str):
        import torch.distributed as dist

        self.devices = ranks
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, ranks.shape))
        self.device = device
        self.backend = backend
        self.rank = dist.get_rank()
        where = np.argwhere(ranks == self.rank)
        #: this rank's index along each axis (None when the mesh was
        #: built over ranks that leave this one out)
        self.coords = (dict(zip(self.axis_names, map(int, where[0])))
                       if len(where) else None)
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._members: Dict[Tuple[str, ...], list] = {}
        # every rank of the job builds every group, in one order
        # (new_group is collective over the default group)
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                moved = np.moveaxis(
                    ranks, [self.axis_names.index(a) for a in axes],
                    list(range(ranks.ndim - k, ranks.ndim)))
                for members in moved.reshape(-1, int(np.prod(
                        [self.shape[a] for a in axes]))):
                    members = [int(r) for r in members]
                    group = dist.new_group(members, backend=backend)
                    if self.rank in members:
                        self._groups[axes] = group
                        self._members[axes] = members

    def _key(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"mesh {self.axis_names} has no axis "
                             f"{unknown[0]!r}")
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes):
        """This rank's process group over `axes` (a name or a tuple)."""
        return self._groups[self._key(axes)]

    def members(self, axes) -> list:
        """Global ranks of this rank's group over `axes`, ordered by
        their index along `axes` in the order given (first axis
        major)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        ranks = self._members[self._key(axes)]
        return sorted(ranks, key=lambda r: self.linear_index(axes, r))

    def axis_index(self, axis: str) -> int:
        """This rank's index along `axis` (`lax.axis_index`)."""
        return self.coords[axis]

    def axis_size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return int(np.prod([self.shape[a] for a in self._key(axes)]))

    def linear_index(self, axes, rank: Optional[int] = None) -> int:
        """Index of `rank` (default this one) along `axes` taken together
        in the order given, first axis major: the shard it holds of a
        dimension split over `axes` (`P((a, b))`)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        rank = self.rank if rank is None else rank
        where = np.argwhere(self.devices == rank)[0]
        idx = 0
        for a in axes:
            i = self.axis_names.index(a)
            idx = idx * self.shape[a] + int(where[i])
        return idx

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __enter__(self) -> "Mesh":
        """`with mesh:` makes it the current mesh, as in the JAX package
        (`guardian.all_finite(axis_name=)` reduces over its axes)."""
        _CURRENT.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _CURRENT.pop()

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, backend={self.backend!r}, "
                f"device={self.device})")


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence[int]] = None,
              backend: Optional[str] = None, device=None) -> Mesh:
    """Build a Mesh. Default: every rank of the default process group on
    one data axis.

    `axes` maps axis name -> size; sizes must multiply to the rank count
    (one axis may be -1 to infer). `devices` is the global ranks to lay
    out (default all). `device` is this rank's device (None = the CUDA
    device); `backend` defaults to NCCL on CUDA and gloo on the CPU.
    Every rank of the job must call it with the same arguments: group
    creation is collective."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call parallel.multihost."
            "initialize(...) on every rank first")
    devices = list(devices if devices is not None
                   else range(dist.get_world_size()))
    if axes is None:
        axes = {DATA_AXIS: len(devices)}
    names = list(axes.keys())
    sizes = list(axes.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = len(devices) // known
    total = int(np.prod(sizes))
    if total != len(devices):
        raise ValueError(f"Mesh axes {dict(zip(names, sizes))} need {total} "
                         f"devices, have {len(devices)}")
    device = default_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the NCCL backend needs CUDA tensors, the mesh's "
                         f"device is {device}")
    ranks = np.asarray(devices, dtype=np.int64).reshape(sizes)
    return Mesh(ranks, tuple(names), device, backend)


class Placement(NamedTuple):
    """A placement descriptor, `NamedSharding(mesh, spec)`'s counterpart:
    dimension i of an array is split over `spec[i]` (an axis, a tuple of
    axes, or None)."""

    mesh: Mesh
    spec: PartitionSpec

    def local(self, array):
        """This rank's block of a global `array` (tensor or numpy)."""
        out = array
        for dim, axes in enumerate(self.spec):
            if axes is None:
                continue
            n = out.shape[dim]
            k = self.mesh.axis_size(axes)
            if n % k:
                raise ValueError(f"dimension {dim} of size {n} does not "
                                 f"split over {axes!r} of size {k}")
            i = self.mesh.linear_index(axes)
            index = [slice(None)] * out.ndim
            index[dim] = slice(i * (n // k), (i + 1) * (n // k))
            out = out[tuple(index)]
        return out


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, P())


def batch_sharding(mesh: Mesh, axis: str = DATA_AXIS) -> Placement:
    """Shard the leading (batch) dimension over `axis`."""
    return Placement(mesh, P(axis))

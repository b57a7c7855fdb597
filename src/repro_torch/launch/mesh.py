"""Named-axis meshes over the ranks of a ``torch.distributed`` group.

The port of the JAX package's ``launch/mesh.py``. A JAX mesh is an array
of devices with named axes; here it is the ranks of the default process
group laid out row-major over the named axes (the first ``prod(shape)``
ranks, as ``jax.make_mesh`` takes the first devices), each rank one
device. :class:`Mesh` is one rank's view of it:

* ``shape`` — the ordered ``{axis: size}`` that ``ShardingPlan.axis_size``
  reads as the JAX code reads ``mesh.shape``;
* ``coords`` — this rank's index on each axis (``jax.lax.axis_index``);
* ``group(axes)`` — the subgroup of the ranks that differ from this one
  only along ``axes`` (an axis name or a tuple of them, the mesh's order
  or another), with its members in the order of their linear index over
  ``axes`` (the first axis major, as a ``PartitionSpec`` entry
  ``("pod", "data")`` lays the blocks out).

Every subgroup is made when the mesh is made, by every rank of the
default group in the same order (``new_group`` is a collective call).
A mesh of one rank needs no process group. Any other shape raises when the
group has fewer ranks than the product of the shape, as ``jax.make_mesh``
raises with too few devices; a rank past the product gets None.

Single pod: 16x16 = 256 chips, axes (data, model); multi-pod: 2 x 16 x 16
= 512 chips, axes (pod, data, model). Spawn the ranks with
``core.analysis.distributed.launch_mesh(fn, shape, axes=...)``, which
hands ``fn`` such a mesh.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as tdist

__all__ = ["make_production_mesh", "make_debug_mesh", "MESH_AXES", "Mesh",
           "axes_tuple", "spec_axes"]

MESH_AXES = ("data", "model")

Axes = Union[str, Tuple[str, ...]]


def axes_tuple(axes: Optional[Axes]) -> Tuple[str, ...]:
    """``axes`` (a name, a tuple of names or None) as a tuple."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def spec_axes(spec) -> Tuple[str, ...]:
    """The mesh axes a partition spec names, over all its entries."""
    return tuple(a for entry in spec for a in axes_tuple(entry))


class Mesh:
    """One rank's view of a named-axis mesh (see the module docstring).

    ``device`` is where this rank's blocks live, ``backend`` the process
    group's (``"gloo"``: a CUDA tensor goes through the host in each
    collective; ``"nccl"``; ``None`` for a one-rank mesh)."""

    def __init__(self, shape: Dict[str, int], rank: int, device,
                 backend: Optional[str], groups: Dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.rank = rank
        self.device = torch.device(device)
        self.backend = backend
        self._groups = groups
        sizes = tuple(shape.values())
        self.coords = dict(zip(self.axis_names,
                               _unravel(rank, sizes)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_size(self, axes: Optional[Axes]) -> int:
        return math.prod(self.shape[a] for a in axes_tuple(axes))

    def axis_index(self, axes: Optional[Axes]) -> int:
        """This rank's linear index over ``axes`` (the first axis major):
        ``jax.lax.axis_index`` of a name or of a tuple of names."""
        idx = 0
        for a in axes_tuple(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes: Optional[Axes]):
        """(process group or None, the members' global ranks in linear
        order over ``axes``) of this rank's subgroup along ``axes``. The
        group is None when it has one member."""
        key = tuple(sorted(axes_tuple(axes), key=self.axis_names.index))
        members = self._members(axes_tuple(axes))
        if self.axis_size(axes) <= 1:
            return None, members
        return self._groups[key][self._others(key)], members

    def _others(self, key: Tuple[str, ...]) -> Tuple[int, ...]:
        return tuple(self.coords[a] for a in self.axis_names if a not in key)

    def _members(self, axes: Tuple[str, ...]):
        out = []
        for idx in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = dict(self.coords)
            c.update(zip(axes, idx))
            out.append(_ravel(tuple(c[a] for a in self.axis_names),
                              tuple(self.shape.values())))
        return out

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, "
                f"device={self.device}, backend={self.backend})")


def _unravel(rank: int, sizes: Sequence[int]) -> Tuple[int, ...]:
    out = []
    for s in reversed(sizes):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def _ravel(coords: Sequence[int], sizes: Sequence[int]) -> int:
    r = 0
    for c, s in zip(coords, sizes):
        r = r * s + c
    return r


#: the subgroups of each mesh layout made so far, keyed by the default
#: group, the shape and the axes (a new group is a collective call, made
#: once)
_MESH_GROUPS: Dict[Tuple, Dict] = {}


def _make_groups(shape: Dict[str, int], n: int) -> Dict:
    """{axes (mesh order): {other axes' coords: group}} for every subset of
    two or more ranks, made by every rank of the default group in one
    order."""
    names, sizes = tuple(shape), tuple(shape.values())
    groups: Dict = {}
    for r in range(1, len(names) + 1):
        for key in itertools.combinations(names, r):
            if math.prod(shape[a] for a in key) <= 1:
                continue
            rest = [a for a in names if a not in key]
            groups[key] = {}
            for other in itertools.product(*(range(shape[a]) for a in rest)):
                ranks = []
                for idx in itertools.product(*(range(shape[a]) for a in key)):
                    c = dict(zip(rest, other))
                    c.update(zip(key, idx))
                    ranks.append(_ravel(tuple(c[a] for a in names), sizes))
                groups[key][tuple(other)] = tdist.new_group(sorted(ranks))
    return groups


def _mesh(shape: Sequence[int], axes: Sequence[str], device) -> Optional[Mesh]:
    from ..core.analysis.wavefront import resolve_device

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    named = dict(zip(axes, shape))
    n = math.prod(shape)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if n == 1:
        return Mesh(named, 0, dev, None, {})
    world = (tdist.get_world_size() if tdist.is_available()
             and tdist.is_initialized() else 1)
    if world < n:
        raise ValueError(
            f"Number of ranks {world} must be >= the product of mesh_shape "
            f"{shape}: the mesh needs {n} ranks (start them with "
            f"core.analysis.distributed.launch_mesh or torchrun)")
    key = (id(tdist.group.WORLD), shape, axes)
    if key not in _MESH_GROUPS:
        _MESH_GROUPS[key] = _make_groups(named, n)
    rank = tdist.get_rank()
    if rank >= n:
        return None
    return Mesh(named, rank, dev, tdist.get_backend(), _MESH_GROUPS[key])


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_debug_mesh(shape=(1, 1), axes=MESH_AXES, device="cuda") -> Mesh:
    """A small mesh over the process group's first ranks (the tests, the
    chip's gloo ranks sharing one card)."""
    return _mesh(shape, axes, device)

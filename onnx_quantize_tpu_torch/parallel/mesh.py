"""A mesh of process groups, and the partition specs that say which slice of
a global array each rank keeps.

Counterpart of ``onnx_quantize_tpu/parallel/mesh.py``. The JAX package is
single-controller: one ``shard_map`` program takes global arrays over a
``jax.sharding.Mesh`` of devices. The port is multi-controller: one process
per rank, every rank calling the same function with the same global inputs
(``torch.distributed``'s default group initialised by the caller: ``torchrun``,
a test or ``chip_smoke.py``). A :class:`Mesh` lays the ranks of that group
out on named axes and holds, for this rank, its coordinate on each axis and
one process group per axis (the ranks that differ from it on that axis only).

The backend is the caller's: ``nccl`` is one GPU a rank (the deployment),
``gloo`` the CPU tests and ranks that share one GPU. A mesh never switches
backend; under ``nccl`` it refuses ranks that share a device (NCCL does too).

Collectives over a mesh axis are in ``parallel/comm.py``; the code that runs
them reads the axis from the mesh made current by :func:`use_mesh` (as
``shard_map`` binds the axis names its body's collectives use).
"""

from __future__ import annotations

import contextlib
import socket

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "P", "make_mesh", "data_sharding", "replicated", "use_mesh",
           "current_mesh", "shard_local"]


class P(tuple):
    """A partition spec: one entry per array dimension, the mesh axis name that
    dimension is split over or None (``jax.sharding.PartitionSpec``'s form).
    Trailing dimensions past the entries are whole."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class Mesh:
    """Ranks of the default process group on named axes.

    ``shape`` maps each axis name to its size (in axis order, as
    ``jax.sharding.Mesh.shape``); ``coords`` maps it to this rank's
    coordinate; ``groups`` to this rank's process group along it. ``ranks``
    is the grid of global ranks. Every rank of the default group must build
    the same meshes in the same order (``dist.new_group`` is collective), a
    rank outside the grid included: its ``coords`` and ``groups`` are empty.
    """

    def __init__(self, ranks: np.ndarray, axis_names: tuple[str, ...]):
        if not dist.is_initialized():
            raise RuntimeError("a Mesh needs an initialised default process group "
                               "(torch.distributed.init_process_group)")
        ranks = np.asarray(ranks, dtype=np.int64)
        if ranks.ndim != len(axis_names):
            raise ValueError(f"rank grid of shape {ranks.shape} for axes {axis_names}")
        self.ranks = ranks
        self.axis_names = tuple(axis_names)
        self.shape = {name: int(n) for name, n in zip(axis_names, ranks.shape)}
        self.backend = dist.get_backend()
        self.rank = dist.get_rank()
        where = np.argwhere(ranks == self.rank)
        self.coords = ({name: int(c) for name, c in zip(axis_names, where[0])}
                       if len(where) else {})
        self.groups: dict[str, dist.ProcessGroup] = {}
        # The global ranks of this rank's group on each axis, by coordinate.
        self.members: dict[str, list[int]] = {}
        for axis, name in enumerate(axis_names):
            # Every line of ranks along this axis is one group; each rank makes
            # all of them, in the same order, and keeps the one it is in.
            lines = np.moveaxis(ranks, axis, -1).reshape(-1, ranks.shape[axis])
            for line in lines:
                members = [int(r) for r in line]
                group = dist.new_group(members)
                if self.rank in members:
                    self.groups[name] = group
                    self.members[name] = members
        if self.backend == "nccl":
            self._refuse_shared_devices()

    def _refuse_shared_devices(self) -> None:
        """NCCL takes one rank a device: two ranks of this mesh on one GPU raise."""
        mine = (socket.gethostname(), torch.cuda.current_device())
        seen: list = [None] * dist.get_world_size()
        # Over a gloo group: an NCCL collective on a shared device would fail
        # inside NCCL before this check could say why.
        dist.all_gather_object(seen, mine, group=dist.new_group(backend="gloo"))
        members = [seen[int(r)] for r in self.ranks.reshape(-1)]
        if len(set(members)) != len(members):
            raise ValueError(
                f"nccl mesh: ranks share a device ({members}); NCCL runs one rank a "
                "GPU. Give each rank its own device, or initialise the process group "
                "with the gloo backend for ranks that share one")

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, backend={self.backend!r}, coords={self.coords})"


def make_mesh(model_parallel: int | None = None, ranks=None,
              axis_names: tuple[str, str] = ("data", "model")) -> Mesh:
    """A (data, model) mesh over ``ranks`` (default: every rank of the world).

    ``model_parallel`` defaults to the largest of 8, 4 and 2 that divides the
    rank count, as the JAX package's."""
    if ranks is None:
        ranks = list(range(dist.get_world_size()))
    n = len(ranks)
    if model_parallel is None:
        model_parallel = next((c for c in (8, 4, 2) if n % c == 0), 1)
    if n % model_parallel != 0:
        raise ValueError(f"{n} ranks do not split into model_parallel={model_parallel}")
    return Mesh(np.asarray(ranks).reshape(n // model_parallel, model_parallel), axis_names)


def data_sharding(mesh: Mesh, ndim: int) -> P:
    """The leading (batch) dimension split over ``data``; the rest whole."""
    return P("data", *(None,) * (ndim - 1))


def replicated(mesh: Mesh) -> P:
    return P()


_ACTIVE: list[Mesh] = []


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Make ``mesh`` the one whose axes the collectives inside name."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def current_mesh() -> Mesh:
    if not _ACTIVE:
        raise RuntimeError("a collective over a mesh axis ran outside use_mesh(mesh)")
    return _ACTIVE[-1]


def shard_local(x: torch.Tensor, spec: P, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the global ``x`` under ``spec`` (contiguous)."""
    if not spec or all(axis is None for axis in spec):
        return x
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n, i = mesh.shape[axis], mesh.coords[axis]
        if x.shape[dim] % n != 0:
            raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not split "
                             f"over {axis}={n}")
        w = x.shape[dim] // n
        x = x.narrow(dim, i * w, w)
    return x.contiguous()

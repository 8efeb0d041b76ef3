"""Collectives over one axis of the current mesh, counted.

The port's counterparts of ``lax.psum``, ``lax.all_gather`` (tiled),
``lax.all_to_all``, ``lax.ppermute``, ``lax.axis_index`` and
``lax.axis_size``, each over the process group of a named axis of the mesh
made current by ``mesh.use_mesh``. Every module of ``parallel/`` and every
model hook goes through these; nothing else calls ``torch.distributed``.

Staging. Under ``nccl`` every collective takes the CUDA tensor as it is.
Under ``gloo``, whose transport is the host's, every CUDA tensor is copied
to pinned host memory, the collective runs on the host copy and the result
is copied back (gloo's own collectives that accept a CUDA tensor make the
same host copy inside). That happens here and nowhere else, and is counted:
``stats`` holds the calls and bytes of every collective and, apart, of the
staged ones. Collectives over an axis of size 1 are no-ops and are not
counted.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from onnx_quantize_tpu_torch.parallel.mesh import current_mesh

__all__ = ["stats", "reset_stats", "axis_index", "axis_size", "all_reduce",
           "all_gather", "all_to_all", "ppermute", "ppermute_start"]

stats: dict = {}


def reset_stats() -> None:
    stats.clear()
    stats.update(calls=0, bytes=0, staged_calls=0, staged_bytes=0, ops={})


reset_stats()


def axis_index(axis: str) -> int:
    return current_mesh().coords[axis]


def axis_size(axis: str) -> int:
    return current_mesh().shape[axis]


def _count(op: str, nbytes: int, staged: bool) -> None:
    stats["calls"] += 1
    stats["bytes"] += nbytes
    stats["ops"][op] = stats["ops"].get(op, 0) + 1
    if staged:
        stats["staged_calls"] += 1
        stats["staged_bytes"] += nbytes


def _stage(x: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a CUDA tensor."""
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host


def _prepare(op: str, x: torch.Tensor):
    """(tensor to hand the collective, whether it was staged), counted."""
    mesh = current_mesh()
    x = x.contiguous()
    staged = mesh.backend == "gloo" and x.is_cuda
    _count(op, x.numel() * x.element_size(), staged)
    return (_stage(x) if staged else x), staged


def _back(t: torch.Tensor, like: torch.Tensor, staged: bool) -> torch.Tensor:
    return t.to(like.device, non_blocking=True) if staged else t


def all_reduce(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (a new tensor)."""
    mesh = current_mesh()
    if mesh.shape[axis] == 1:
        return x
    t, staged = _prepare("all_reduce", x)
    if not staged:
        t = t.clone()  # the sum is a new tensor; the caller's stays as it was
    dist.all_reduce(t, group=mesh.groups[axis])
    return _back(t, x, staged)


def all_gather(x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in axis order (tiled)."""
    mesh = current_mesh()
    n = mesh.shape[axis]
    if n == 1:
        return x
    t, staged = _prepare("all_gather", x)
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=mesh.groups[axis])
    return _back(torch.cat(parts, dim=dim), x, staged)


def all_to_all(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``x`` (n, ...) with n the axis size: block j goes to rank j, and block
    j of the result came from rank j (``lax.all_to_all`` with split and
    concat axis 0, untiled)."""
    mesh = current_mesh()
    n = mesh.shape[axis]
    if x.shape[0] != n:
        raise ValueError(f"all_to_all over {axis}={n} needs a leading dim of {n}, "
                         f"got {tuple(x.shape)}")
    if n == 1:
        return x
    t, staged = _prepare("all_to_all", x)
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=mesh.groups[axis])
    return _back(out, x, staged)


class Pending:
    """A ring shift in flight: ``wait()`` returns the received tensors."""

    def __init__(self, works, received, likes, staged: bool):
        self._works, self._received, self._likes, self._staged = works, received, likes, staged

    def wait(self) -> list[torch.Tensor]:
        for work in self._works:
            work.wait()
        return [_back(r, like, self._staged) for r, like in zip(self._received, self._likes)]


def ppermute_start(xs: list[torch.Tensor], axis: str, perm) -> Pending:
    """Start sending each of ``xs`` along ``perm`` ((source, destination)
    coordinate pairs on ``axis``) and receiving what this rank is sent; a
    rank no pair sends to receives zeros (``lax.ppermute``). The local work
    queued before ``wait()`` overlaps the transfer (under gloo's staging, only
    the host side of it)."""
    mesh = current_mesh()
    me = mesh.coords[axis]
    members = mesh.members[axis]
    group = mesh.groups[axis]
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"perm {perm} sends or receives twice at coordinate {me}")
    ops, received, works = [], [], []
    staged = False
    for x in xs:
        if mesh.shape[axis] == 1 or (dst == [me] and src == [me]):
            received.append(x)
            continue
        t, staged = _prepare("ppermute", x)
        recv = torch.zeros_like(t)
        if dst:
            ops.append(dist.P2POp(dist.isend, t, members[dst[0]], group))
        if src:
            ops.append(dist.P2POp(dist.irecv, recv, members[src[0]], group))
        received.append(recv)
    if ops:
        works = dist.batch_isend_irecv(ops)
    return Pending(works, received, xs, staged)


def ppermute(x: torch.Tensor, axis: str, perm) -> torch.Tensor:
    return ppermute_start([x], axis, perm).wait()[0]

"""Explicit collectives over a mesh axis: the port's counterpart of the
`lax` collectives the JAX package's parallel code calls inside
`shard_map` (`psum`, `pmean`, `pmax`, `all_gather`, `psum_scatter`,
`all_to_all`, `ppermute`).

Each takes a tensor, the `Mesh` and an axis name (or a tuple of names)
and runs in this rank's process group over those axes. The ones a
gradient flows through are `torch.autograd.Function`s carrying JAX's
transpose rules for values every rank then uses alike (each rank
computes the same loss from them):

- `psum`: all-reduce forward; backward the identity (the cotangent of
  a replicated sum is each addend's);
- `pmean`: all-reduce / n forward; backward / n;
- `all_gather` (tiled along a dim): backward takes this rank's slice;
- `all_to_all` (tiled, split dim = concat dim): backward is the same
  all-to-all of the cotangent;
- `ppermute(perm)`: backward is the reverse permutation. It is one
  `batch_isend_irecv` (every send and receive posted together), so a
  ring never deadlocks; a rank no pair sends to receives zeros, as in
  JAX.

Collectives inside a backward run in the order autograd reaches them,
which is the reverse of creation order for a one-device graph; every
rank must therefore create the same collectives in the same order, and
a collective's output that one rank does not use must still reach its
loss (`depend`), or that rank would skip the backward's exchange.

Backend. On NCCL tensors stay on their device. On gloo a CUDA tensor is
copied to the host and back around the call (gloo's point-to-point and
several of its collectives take CPU tensors only): `host_staged_bytes`
counts the bytes copied each way, the cost one card shared by several
ranks pays. A CPU tensor never stages.
"""

from __future__ import annotations

import warnings
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

#: bytes copied device -> host and host -> device around gloo calls on
#: CUDA tensors since import (chip_smoke.py reads it per rank)
host_staged_bytes = 0

__all__ = ["psum", "pmean", "pmax", "all_gather", "reduce_scatter",
           "all_to_all", "ppermute", "depend", "all_reduce_",
           "host_staged_bytes"]


def _staging(mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.is_cuda


def _to_host(mesh, t: torch.Tensor) -> torch.Tensor:
    global host_staged_bytes
    if not _staging(mesh, t):
        return t.contiguous()
    host_staged_bytes += t.numel() * t.element_size()
    return t.detach().cpu()


def _back(mesh, host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    global host_staged_bytes
    if host.device == like.device:
        return host
    host_staged_bytes += host.numel() * host.element_size()
    return host.to(like.device)


# ----------------------------------------------------------------- plain
@torch.no_grad()
def all_reduce_(t: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """In-place all-reduce of `t` over `axes` (no autograd); returns t."""
    host = _to_host(mesh, t)
    dist.all_reduce(host, op=op, group=mesh.group(axes))
    if host is not t:
        t.copy_(_back(mesh, host, t))
    return t


def _gather_chunks(t: torch.Tensor, mesh, axes) -> List[torch.Tensor]:
    """Every rank's `t` along `axes`, in the axes' index order."""
    group = mesh.group(axes)
    host = _to_host(mesh, t)
    n = mesh.axis_size(axes)
    out = torch.empty((n * host.shape[0], *host.shape[1:]),
                      dtype=host.dtype, device=host.device)
    with warnings.catch_warnings():
        # newer torch renames it all_gather_single, which older lacks
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, host, group=group)
    chunks = list(out.chunk(n))
    # group ranks are ascending global ranks; reorder to the axes' order
    by_rank = sorted(mesh.members(axes))
    order = {r: i for i, r in enumerate(by_rank)}
    return [_back(mesh, chunks[order[r]], t) for r in mesh.members(axes)]


def _reduce_scatter0(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    group = mesh.group(axes)
    host = _to_host(mesh, t)
    n = mesh.axis_size(axes)
    # members in the axes' order must be ascending group ranks for the
    # chunk this rank keeps to be its own: reorder the chunks first
    by_rank = sorted(mesh.members(axes))
    chunks = host.chunk(n)
    idx = {r: i for i, r in enumerate(mesh.members(axes))}
    host = torch.cat([chunks[idx[r]] for r in by_rank])
    out = torch.empty_like(chunks[0])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, host.contiguous(), group=group)
    return _back(mesh, out, t)


def _all_to_all0(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Tiled all-to-all along dim 0 over one axis: chunk j goes to the
    rank of index j, and chunk j of the result came from it."""
    group = mesh.group(axis)
    host = _to_host(mesh, t)
    out = torch.empty_like(host)
    dist.all_to_all_single(out, host, group=group)
    return _back(mesh, out, t)


def _permute(t: torch.Tensor, mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """`t` sent along `perm` [(src index, dst index)] over `axis`; the
    result is what this rank received, zeros if nothing."""
    me = mesh.axis_index(axis)
    members = mesh.members(axis)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    host = _to_host(mesh, t)
    out = torch.zeros_like(host)
    if dst and src and dst[0] == me and src[0] == me:
        return _back(mesh, host.clone(), t)
    ops = []
    group = mesh.group(axis)
    if dst:
        ops.append(dist.P2POp(dist.isend, host, members[dst[0]], group))
    if src:
        ops.append(dist.P2POp(dist.irecv, out, members[src[0]], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _back(mesh, out, t)


# ---------------------------------------------------------- differentiable
class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, scale):
        ctx.scale = scale
        out = x.detach().clone().contiguous()
        all_reduce_(out, mesh, axes)
        return out * scale if scale != 1.0 else out

    @staticmethod
    def backward(ctx, g):
        return (g * ctx.scale if ctx.scale != 1.0 else g), None, None, None


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum over `axes` (`lax.psum`); backward the identity."""
    return _PSum.apply(x, mesh, axes, 1.0)


def pmean(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Mean over `axes` (`lax.pmean`); backward / n."""
    return _PSum.apply(x, mesh, axes, 1.0 / mesh.axis_size(axes))


@torch.no_grad()
def pmax(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Max over `axes` (`lax.pmax`), not differentiable."""
    out = x.detach().clone().contiguous()
    return all_reduce_(out, mesh, axes, op=dist.ReduceOp.MAX)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        ctx.n = x.shape[dim]
        xt = x.detach().movedim(dim, 0).contiguous()
        return torch.cat(_gather_chunks(xt, mesh, axes)).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.linear_index(ctx.axes)
        return (g.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous(), None,
                None, None)


def all_gather(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """Tiled all-gather along `dim` over `axes` (`lax.all_gather(...,
    tiled=True)`), shards in the axes' index order; backward takes this
    rank's slice."""
    return _AllGather.apply(x, mesh, axes, dim)


@torch.no_grad()
def reduce_scatter(x: torch.Tensor, mesh, axes, dim: int = 0
                   ) -> torch.Tensor:
    """Sum over `axes`, then keep this rank's slice of `dim`
    (`lax.psum_scatter(..., tiled=True)`); not differentiable."""
    xt = x.detach().movedim(dim, 0).contiguous()
    return _reduce_scatter0(xt, mesh, axes).movedim(0, dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_to_all0(x.detach().contiguous(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all0(g.contiguous(), ctx.mesh, ctx.axis), None, None


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Tiled all-to-all over `axis` with split dim = concat dim = 0
    (`lax.all_to_all(x, axis, 0, 0, tiled=True)`): chunk j of dim 0 goes
    to the rank of index j. Backward: the same all-to-all."""
    if x.shape[0] % mesh.axis_size(axis):
        raise ValueError(f"dim 0 of size {x.shape[0]} does not split over "
                         f"{axis!r} of size {mesh.axis_size(axis)}")
    return _AllToAll.apply(x, mesh, axis)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, perm, *xs):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return tuple(_permute(x.detach(), mesh, axis, perm) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        back = [(d, s) for s, d in ctx.perm]
        return (None, None, None, *(
            _permute(g.contiguous(), ctx.mesh, ctx.axis, back) for g in gs))


def ppermute(x, mesh, axis: str, perm: Sequence[Tuple[int, int]]):
    """Send along `perm`, pairs (source index, destination index) over
    `axis` (`lax.ppermute`); `x` a tensor or a tuple of tensors sent
    together. Backward: the reverse permutation of the cotangents."""
    perm = [(int(s), int(d)) for s, d in perm]
    if isinstance(x, torch.Tensor):
        return _PPermute.apply(mesh, axis, perm, x)[0]
    return _PPermute.apply(mesh, axis, perm, *x)


class _Depend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *deps):
        ctx.specs = [(d.shape, d.dtype, d.device) for d in deps]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=dt, device=dev)
                     for s, dt, dev in ctx.specs))


def depend(x: torch.Tensor, *deps: torch.Tensor) -> torch.Tensor:
    """`x`, with `deps` joined into its graph with a zero cotangent: a
    collective output this rank does not use still gets its backward
    exchange (which its peers wait for)."""
    deps = tuple(d for d in deps if d.requires_grad)
    if not deps or not torch.is_grad_enabled():
        return x
    return _Depend.apply(x, *deps)

"""Meshes: the ranks of a (data, model, seq) layout and the collectives the
parallel paths use over them (port of flashattn_tpu/parallel/mesh.py).

Axis convention, as in the JAX package (models/, parallel/):

  * ``slice`` -- optional OUTERMOST axis for multi-slice layouts: only the
    gradient all-reduce and the loss reduction cross it (extra data
    parallelism);
  * ``data``  -- batch (DP); gradients all-reduced across it;
  * ``model`` -- attention heads / MLP columns (TP);
  * ``seq``   -- sequence / context (SP): ring attention or Ulysses.

The JAX package runs one program per device under ``shard_map`` with XLA's
collectives. One card cannot host several NCCL ranks, so the port's mesh
holds the ranks of this process, and every per-rank value is a list with one
entry per local rank (``mesh.ranks`` gives their flat indices, row-major
over ``mesh.axis_names``). Two implementations share one interface:

* :class:`VirtualMesh` -- every rank in this process, on one device; each
  rank's shard is a tensor of its own, and a collective is a list operation
  that autograd differentiates (its transpose is the true one: the gradient
  of a ``psum`` is the ``psum`` of the cotangents). The ring's K/V rotation
  runs on a side stream on the card (``ring_kernel.VirtualRanks``).
* :class:`ProcessGroupMesh` -- this process's rank of a ``torch.distributed``
  group, built on ``DeviceMesh`` with its per-axis subgroups (gloo on the
  CPU, NCCL with a card per process). Its collectives are differentiable:
  ``psum`` is ``torch.distributed.nn.functional.all_reduce``; ``all_gather``
  and ``all_to_all`` are functions of their own built on ``all_gather`` and
  ``all_reduce`` (``torch.distributed.nn``'s backward of ``all_gather``
  scatters by global rank on gloo, which fails on a subgroup), and
  ``ppermute`` is an ``all_gather`` and a pick.

Shardings are written as the JAX ``PartitionSpec``s are: a tuple with, per
tensor dim, None (replicated), an axis name, or a tuple of axis names (the
first outermost).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist

from flashattn_tpu_torch.parallel.ring_kernel import ProcessGroupRing, VirtualRanks


def _gather(x, group) -> list[torch.Tensor]:
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x.contiguous(), group=group)
    return out


class _AllGather(torch.autograd.Function):
    """Tiled all_gather along ``dim``. Its backward keeps this rank's block of
    the cotangent summed over the ranks (a reduce-scatter: each rank's use
    of the gathered tensor is its own), or, with ``replicated``, of this
    rank's cotangent alone: the gathered tensor is one global value held on
    every rank (``unshard``), and every rank's cotangent is the same."""

    @staticmethod
    def forward(ctx, x, group, dim, replicated=False):
        ctx.group, ctx.dim, ctx.replicated = group, dim, replicated
        return torch.cat(_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if not ctx.replicated:
            dist.all_reduce(g, group=ctx.group)
        n = dist.get_world_size(ctx.group)
        return torch.chunk(g, n, dim=ctx.dim)[dist.get_rank(ctx.group)], None, None, None


class _AllToAll(torch.autograd.Function):
    """Tiled all-to-all (by an all_gather of the whole tensor); its backward
    is the all-to-all with the two dims swapped."""

    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        me, n = dist.get_rank(group), dist.get_world_size(group)
        return torch.cat([torch.chunk(y, n, dim=split_dim)[me] for y in _gather(x, group)],
                         dim=concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _AllToAll.apply(g, ctx.group, concat_dim, split_dim), None, None, None


def _axes(axes) -> tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


class _Mesh:
    """What both meshes share: the shape, the coordinates of a flat rank and
    the shard / block arithmetic of a PartitionSpec."""

    def __init__(self, shape: dict[str, int]):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())

    def coords(self, rank: int) -> dict[str, int]:
        """The coordinate of flat rank ``rank`` on every axis (row-major)."""
        out = {}
        for name in reversed(self.axis_names):
            rank, out[name] = divmod(rank, self.shape[name])
        return {name: out[name] for name in self.axis_names}

    def _block(self, rank: int, axes) -> tuple[int, int]:
        """``(index, count)`` of ``rank``'s block along a dim sharded over
        ``axes`` (row-major over them, the first outermost)."""
        c = self.coords(rank)
        index, count = 0, 1
        for a in _axes(axes):
            index, count = index * self.shape[a] + c[a], count * self.shape[a]
        return index, count

    def axis_index(self, axis: str) -> list[int]:
        """Each local rank's coordinate on ``axis`` (``jax.lax.axis_index``)."""
        return [self.coords(r)[axis] for r in self.ranks]

    def shard(self, x: torch.Tensor, spec) -> list[torch.Tensor]:
        """Each local rank's block of the global ``x`` under ``spec`` (views)."""
        out = []
        for r in self.ranks:
            y = x
            for dim, axes in enumerate(spec):
                if axes is not None:
                    i, n = self._block(r, axes)
                    if y.shape[dim] % n:
                        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split into "
                                         f"{n} shards over {_axes(axes)}")
                    m = y.shape[dim] // n
                    y = y.narrow(dim, i * m, m)
            out.append(y)
        return out


class VirtualMesh(_Mesh):
    """Every rank of the mesh in this process, on ``device``."""

    def __init__(self, shape: dict[str, int], device="cuda"):
        super().__init__(shape)
        self.device = torch.device(device)
        self.ranks = tuple(range(self.size))
        self._transports: dict[str, VirtualRanks] = {}

    def __repr__(self):
        return f"VirtualMesh({self.shape}, device={self.device})"

    def groups(self, axes) -> list[list[int]]:
        """The local ranks that differ only on ``axes``, one list per group,
        each in row-major order over ``axes`` (the order of ``jax.lax``'s
        collectives over those axes)."""
        axes = _axes(axes)
        others = [a for a in self.axis_names if a not in axes]
        by_key: dict = {}
        for i, r in enumerate(self.ranks):
            c = self.coords(r)
            by_key.setdefault(tuple(c[a] for a in others), []).append((self._block(r, axes)[0], i))
        return [[i for _, i in sorted(g)] for g in by_key.values()]

    def rings(self, axis: str):
        """``[(transport, members)]``: one ring per group of ``axis``, its
        transport (``ring_kernel.VirtualRanks``, which moves the chunks on a
        side stream on the card) and its local ranks in ring order."""
        xport = self._transports.setdefault(axis, VirtualRanks(self.shape[axis]))
        return [(xport, g) for g in self.groups(axis)]

    def psum(self, xs, axes):
        out = list(xs)
        if not _axes(axes):
            return out
        for g in self.groups(axes):
            total = functools.reduce(torch.add, (xs[i] for i in g))
            for i in g:
                out[i] = total
        return out

    def all_gather(self, xs, axis: str, dim: int):
        out = list(xs)
        for g in self.groups(axis):
            full = torch.cat([xs[i] for i in g], dim=dim)
            for i in g:
                out[i] = full
        return out

    def all_to_all(self, xs, axis: str, split_dim: int, concat_dim: int):
        """Tiled all-to-all: member j of a group receives block j of every
        member's ``split_dim``, concatenated along ``concat_dim`` in member
        order (``jax.lax.all_to_all(..., tiled=True)``)."""
        out = list(xs)
        for g in self.groups(axis):
            parts = [torch.chunk(xs[i], len(g), dim=split_dim) for i in g]
            for j, i in enumerate(g):
                out[i] = torch.cat([p[j] for p in parts], dim=concat_dim)
        return out

    def ppermute(self, xs, axis: str, perm):
        """``jax.lax.ppermute``: ``perm`` holds (source, destination)
        coordinates along ``axis``; a rank that no pair reaches gets zeros."""
        out = [torch.zeros_like(x) for x in xs]
        for g in self.groups(axis):
            for src, dst in perm:
                out[g[dst]] = xs[g[src]]
        return out

    def unshard(self, xs, spec) -> torch.Tensor:
        """The global tensor of the local blocks ``xs`` under ``spec``
        (differentiable; of replicated blocks the first rank's is taken)."""
        blocks = {}
        for r, x in zip(self.ranks, xs):
            key = tuple(self._block(r, axes)[0] if axes is not None else 0 for axes in spec)
            blocks.setdefault(key, x)

        def join(prefix, dim):
            if dim == len(spec):
                return blocks[prefix]
            n = self._block(0, spec[dim])[1] if spec[dim] is not None else 1
            parts = [join(prefix + (i,), dim + 1) for i in range(n)]
            return parts[0] if n == 1 else torch.cat(parts, dim=dim)

        return join((), 0)


class ProcessGroupMesh(_Mesh):
    """This process's rank of a ``torch.distributed`` group laid out as
    ``shape`` (row-major over the group's ranks), with one subgroup per axis
    from ``DeviceMesh``."""

    def __init__(self, shape: dict[str, int], device_type: str = "cuda"):
        super().__init__(shape)
        from torch.distributed.device_mesh import init_device_mesh

        world = dist.get_world_size()
        if self.size != world:
            raise ValueError(f"mesh {'x'.join(map(str, self.shape.values()))}={self.size} "
                             f"does not match the {world} ranks of the process group")
        self.device_mesh = init_device_mesh(device_type, tuple(self.shape.values()),
                                            mesh_dim_names=self.axis_names)
        self.ranks = (dist.get_rank(),)
        self.device = torch.device(device_type) if device_type == "cpu" else torch.device(
            device_type, torch.cuda.current_device())

    def __repr__(self):
        return f"ProcessGroupMesh({self.shape}, rank {self.ranks[0]})"

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def rings(self, axis: str):
        return [(ProcessGroupRing(self.group(axis)), [0])]

    def psum(self, xs, axes):
        from torch.distributed.nn.functional import all_reduce

        (x,) = xs
        for a in _axes(axes):
            if self.shape[a] > 1:
                x = all_reduce(x, group=self.group(a))
        return [x]

    def all_gather(self, xs, axis: str, dim: int):
        (x,) = xs
        if self.shape[axis] == 1:
            return [x]
        return [_AllGather.apply(x, self.group(axis), dim)]

    def all_to_all(self, xs, axis: str, split_dim: int, concat_dim: int):
        (x,) = xs
        if self.shape[axis] == 1:
            return [x]
        return [_AllToAll.apply(x, self.group(axis), split_dim, concat_dim)]

    def ppermute(self, xs, axis: str, perm):
        (x,) = xs
        me = self.axis_index(axis)[0]
        srcs = [s for s, d in perm if d == me]
        if self.shape[axis] == 1:
            return [x if srcs else torch.zeros_like(x)]
        # every rank's x stacked on a new leading dim (all ranks take part),
        # then the source's
        full = _AllGather.apply(x.unsqueeze(0), self.group(axis), 0)
        return [full[srcs[0]] if srcs else torch.zeros_like(x)]

    def unshard(self, xs, spec) -> torch.Tensor:
        """The global tensor under ``spec``, gathered from every rank (inner
        axes first, so blocks land row-major). It is one value held on every
        rank: its backward keeps this rank's block of the cotangent."""
        (x,) = xs
        for dim, axes in enumerate(spec):
            for a in reversed(_axes(axes)):
                if self.shape[a] > 1:
                    x = _AllGather.apply(x, self.group(a), dim, True)
        return x


def make_mesh(data: int = 1, model: int = 1, seq: int = 1, *, slices: int = 1, devices=None):
    """Build a ``(data, model, seq)`` mesh -- or, with ``slices > 1``, a
    ``(slice, data, model, seq)`` mesh with the slice axis outermost.

    With an initialised ``torch.distributed`` default group of more than one
    rank: a :class:`ProcessGroupMesh` over it (its size must equal the
    group's; ``devices`` is ignored). Otherwise a :class:`VirtualMesh`, whose
    ranks share one device: ``devices`` is that device (default ``"cuda"``),
    or a list of the mesh's devices, all one device -- then, as in the JAX
    function, a mesh of more ranks than the list holds raises ValueError."""
    shape = {"slice": slices} if slices > 1 else {}
    shape.update(data=data, model=model, seq=seq)
    n = math.prod(shape.values())
    dims = "x".join(str(x) for x in (slices, data, model, seq))
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        if n > dist.get_world_size():
            raise ValueError(f"mesh {dims}={n} exceeds {dist.get_world_size()} devices")
        backend = dist.get_backend()
        return ProcessGroupMesh(shape, "cpu" if backend == "gloo" else "cuda")
    if isinstance(devices, (list, tuple)):
        if n > len(devices):
            raise ValueError(f"mesh {dims}={n} exceeds {len(devices)} devices")
        if len({torch.device(d) for d in devices}) != 1:
            raise ValueError(f"a VirtualMesh's ranks share one device, got {devices}")
        devices = devices[0]
    return VirtualMesh(shape, "cuda" if devices is None else devices)

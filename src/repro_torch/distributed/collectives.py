"""Collectives over the named axes of a device mesh: the counterparts of the
`lax` collectives the reference calls inside `shard_map`.

The port runs a mesh as explicit SPMD: one process per rank, every tensor a
local block, and these functions where the reference's shard_map body has
its collectives. An axis name ('data', 'model') or a tuple of them is
resolved against the innermost `axis_env(mesh)`, the counterpart of the
named-axis scope shard_map opens; `mesh` is a torch DeviceMesh
(`launch.mesh.make_host_mesh`). Blocks are ordered by the row-major mesh
coordinate along the named axes, as `lax.all_gather(..., tiled=True)` orders
them.

Gradients follow the transposes shard_map gives these collectives, where
every rank back-propagates the one global loss:

    psum(x)            forward sum; backward identity (the cotangent of a
                       replicated result is already the whole cotangent)
    pmean(x)           psum(x) / size
    pvary(x)           forward identity; backward psum: a replicated value
                       used by rank-varying work (shard_map inserts it)
    all_gather(x)      backward psum_scatter: the gathered value feeds work
                       that varies over the axis
    all_gather(x, invariant=True)
                       backward takes the rank's block: the work after it is
                       the same on every rank of the axis
    psum_scatter(x)    backward all_gather
    shard_rows(x)      a replicated value cut to the rank's block; backward
                       all_gather
    gather_leaf(x, spec, varying)
                       a parameter block -> the whole parameter, backward
                       summed over `varying` and cut to the block

Backends: NCCL, and gloo on CPU and on CUDA tensors (ranks that share a
card), take every collective used here: all_reduce (sum, min, max; fp32,
bf16, int32, int64), all_gather_into_tensor and reduce_scatter_tensor
(chip_smoke.py's phase 17 probes gloo on the card before it trains).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Tensor = torch.Tensor
Axes = Union[str, Sequence[str]]

# the stack of meshes whose axis names are in scope (see axis_env). Plain
# process state, not thread-local: autograd replays a checkpointed block's
# forward on its own thread
_ENV: list = []


@contextlib.contextmanager
def axis_env(mesh):
    """Make `mesh`'s axis names resolvable by the collectives below."""
    _ENV.append(mesh)
    try:
        yield mesh
    finally:
        _ENV.pop()


def current_mesh():
    if not _ENV:
        raise RuntimeError("a collective over named axes was called outside axis_env(mesh)")
    return _ENV[-1]


# ------------------------------------------------------------------ meshes


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh, or of any object whose `shape` is
    such a dict (the reference's Mesh, or a plain namespace in tests)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    """How a model is laid out on a device mesh (mesh None: one device);
    re-exported as models.stack.MeshCtx. It is defined here, beside the
    collectives the mesh path runs, so that the sharding rules need nothing
    of the models.

    `mesh` is a DeviceMesh (launch.mesh.make_host_mesh), `data_axes` the
    axes the batch is split over, `model_axis` the expert-parallel axis.
    `param_specs` is the spec tree of the model's params on the mesh
    (models.build_model fills it in from distributed.param_specs);
    `tokens_sharded` says whether each rank holds its rows of the batch
    (True) or the whole batch (a batch too small to split over the data
    axes; the train step sets it from the batch's layout)."""

    mesh: Any = None
    data_axes: Tuple[str, ...] = ()
    model_axis: str = ""
    param_specs: Any = None
    tokens_sharded: bool = True

    @property
    def use_ep(self) -> bool:
        return self.mesh is not None and bool(self.model_axis)

    @property
    def batch_spec(self):
        if not self.data_axes:
            return None
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate along every mesh axis."""
        if self.mesh is None:
            return {}
        return {name: self.mesh.get_local_rank(name) for name in self.mesh.mesh_dim_names}

    def constrain(self, x, *spec):
        """The reference pins an activation's GSPMD layout here. Every tensor
        of the port's SPMD program is already this rank's local block, so
        there is nothing to pin: x is returned as it is."""
        return x


def _names(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(axes: Axes, mesh=None) -> int:
    shape = mesh_shape(current_mesh() if mesh is None else mesh)
    return math.prod(shape[a] for a in _names(axes))


def axis_index(axes: Axes, mesh=None) -> int:
    """This rank's row-major coordinate over `axes` (the reference's
    `_flat_axis_index`)."""
    mesh = current_mesh() if mesh is None else mesh
    shape = mesh_shape(mesh)
    idx = 0
    for a in _names(axes):
        idx = idx * shape[a] + mesh.get_local_rank(a)
    return idx


def group(axes: Axes, mesh=None):
    """The process group over `axes`: one mesh dimension's group, or the
    whole mesh's when `axes` names every dimension in order (a host mesh
    has two: data and model)."""
    mesh = current_mesh() if mesh is None else mesh
    names = _names(axes)
    if len(names) == 1:
        return mesh.get_group(names[0])
    if names == tuple(mesh.mesh_dim_names) and mesh.size() == dist.get_world_size():
        return dist.group.WORLD
    raise NotImplementedError(f"a group over axes {names} of a mesh with axes {mesh.mesh_dim_names}")


# ------------------------------------------------------- plain collectives


def _size_rank(grp) -> Tuple[int, int]:
    return dist.get_world_size(grp), dist.get_rank(grp)


def _psum(x: Tensor, grp) -> Tensor:
    y = x.contiguous().clone()
    if dist.get_world_size(grp) > 1:
        dist.all_reduce(y, group=grp)
    return y


def _all_gather(x: Tensor, grp, dim: int) -> Tensor:
    """Blocks of every rank concatenated along `dim` in group-rank order."""
    n = dist.get_world_size(grp)
    if n == 1:
        return x
    blk = x.shape[dim]
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * blk,) + tuple(xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=grp)
    return out.movedim(0, dim).contiguous()


def _psum_scatter(x: Tensor, grp, dim: int) -> Tensor:
    """The sum over the group, cut to this rank's block along `dim`."""
    n = dist.get_world_size(grp)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"psum_scatter: dimension {dim} of {tuple(x.shape)} does not split {n} ways")
    blk = x.shape[dim] // n
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((blk,) + tuple(xt.shape[1:]))
    dist.reduce_scatter_tensor(out, xt, group=grp)
    return out.movedim(0, dim).contiguous()


def _block(x: Tensor, grp, dim: int) -> Tensor:
    n, r = _size_rank(grp)
    blk = x.shape[dim] // n
    return x.narrow(dim, r * blk, blk).contiguous()


def _pextreme(x: Tensor, grp, op) -> Tensor:
    if dist.get_world_size(grp) == 1:
        return x
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=grp)
    return y


# ------------------------------------------------------ autograd functions


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        return _psum(x, grp)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _psum(dy, ctx.grp), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp, dim, invariant):
        ctx.grp, ctx.dim, ctx.invariant = grp, dim, invariant
        return _all_gather(x, grp, dim)

    @staticmethod
    def backward(ctx, dy):
        f = _block if ctx.invariant else _psum_scatter
        return f(dy.contiguous(), ctx.grp, ctx.dim), None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp, dim):
        ctx.grp, ctx.dim = grp, dim
        return _psum_scatter(x, grp, dim)

    @staticmethod
    def backward(ctx, dy):
        return _all_gather(dy.contiguous(), ctx.grp, ctx.dim), None, None


class _ShardRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp, dim):
        ctx.grp, ctx.dim = grp, dim
        return _block(x, grp, dim)

    @staticmethod
    def backward(ctx, dy):
        return _all_gather(dy.contiguous(), ctx.grp, ctx.dim), None, None


def _trivial(axes: Axes) -> bool:
    """No axes, or axes of one rank in all: every collective is the identity."""
    return not _names(axes) or axis_size(axes) == 1


def psum(x: Tensor, axes: Axes) -> Tensor:
    return x if _trivial(axes) else _PSum.apply(x, group(axes))


def pmean(x: Tensor, axes: Axes) -> Tensor:
    return x if _trivial(axes) else psum(x, axes) / axis_size(axes)


def pvary(x: Tensor, axes: Axes) -> Tensor:
    return x if _trivial(axes) else _PVary.apply(x, group(axes))


def pmin(x: Tensor, axes: Axes) -> Tensor:
    """Elementwise minimum over the ranks of `axes` (no gradient)."""
    return x if _trivial(axes) else _pextreme(x.detach(), group(axes), dist.ReduceOp.MIN)


def pmax(x: Tensor, axes: Axes) -> Tensor:
    return x if _trivial(axes) else _pextreme(x.detach(), group(axes), dist.ReduceOp.MAX)


def all_gather(x: Tensor, axes: Axes, *, axis: int = 0, invariant: bool = False) -> Tensor:
    """Tiled all-gather along `axis` (blocks in mesh-coordinate order)."""
    return x if _trivial(axes) else _AllGather.apply(x, group(axes), axis % x.dim(), invariant)


def psum_scatter(x: Tensor, axes: Axes, *, scatter_dimension: int = 0) -> Tensor:
    """Tiled reduce-scatter: the sum over `axes`, this rank's block of it."""
    if _trivial(axes):
        return x
    return _PsumScatter.apply(x, group(axes), scatter_dimension % x.dim())


def shard_rows(x: Tensor, axes: Axes, *, axis: int = 0) -> Tensor:
    """This rank's block along `axis` of a value replicated over `axes`."""
    return x if _trivial(axes) else _ShardRows.apply(x, group(axes), axis % x.dim())


# ------------------------------------------------------ parameter gathers


Spec = Tuple  # per dimension: None, an axis name, or a tuple of axis names


def spec_axes(entry) -> Tuple[str, ...]:
    return () if entry is None else _names(entry)


class _GatherLeaf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, spec, varying):
        ctx.mesh, ctx.spec, ctx.varying = mesh, spec, varying
        for dim, entry in enumerate(spec):
            if entry is not None:
                x = _all_gather(x, group(entry, mesh), dim)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, spec, varying = ctx.mesh, ctx.spec, set(ctx.varying)
        g = g.contiguous()
        summed = set()
        for dim, entry in enumerate(spec):
            axes = spec_axes(entry)
            if not axes:
                continue
            if set(axes) <= varying:  # the work varied over these axes: sum, keep the block
                g = _psum_scatter(g, group(axes, mesh), dim)
                summed |= set(axes)
            else:
                over = tuple(a for a in axes if a in varying)
                if over:
                    g = _psum(g, group(over, mesh))
                    summed |= set(over)
                g = _block(g, group(axes, mesh), dim)
        rest = tuple(a for a in ctx.varying if a not in summed)
        if rest:
            g = _psum(g, group(rest, mesh))
        return g, None, None, None


def gather_leaf(x: Tensor, spec: Spec, mesh, varying: Tuple[str, ...] = ()) -> Tensor:
    """The whole parameter from this rank's block of it, laid out by `spec`
    (one entry per dimension). Its gradient is summed over the `varying`
    axes, those over which the work that uses it differs (the data axes
    when the batch is split over them), and cut to this rank's block; over
    the other axes the work is the same on every rank, so the block is
    taken without a sum."""
    if not any(spec) and not varying:
        return x
    return _GatherLeaf.apply(x, mesh, tuple(spec), tuple(varying))


__all__ = [
    "MeshCtx",
    "all_gather",
    "axis_env",
    "axis_index",
    "axis_size",
    "current_mesh",
    "gather_leaf",
    "group",
    "mesh_shape",
    "pmax",
    "pmean",
    "pmin",
    "psum",
    "psum_scatter",
    "pvary",
    "shard_rows",
    "spec_axes",
]

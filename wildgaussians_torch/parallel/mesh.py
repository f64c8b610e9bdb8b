"""The one-axis device mesh for sharded rendering and training.

Counterpart of `wildgaussians_tpu/parallel/mesh.py`. A `TileMesh` is a
torch.distributed process group, one rank per device: its D ranks split
the image's tiles into D contiguous bands for blending and, with the
sharded sort engine (`ops/sharded_sort_engine.py`) and the config's
`shard_gaussian_store`, the Gaussian store into D contiguous blocks. Modules
consult the active mesh through `current_mesh()`, so the same render and
training code runs on one device (no mesh) and on D (`use_mesh(mesh)`).

Two autograd helpers move tensors between the two layouts:
`gather_shards` concatenates every rank's block (the backward keeps this
rank's block of a gradient that is the same on every rank, without summing
it) and `take_shard` is its transpose (this rank's block forward; the
gradient blocks of every rank gathered backward).
"""
import contextlib
import threading
from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

TILE_AXIS = "tiles"

_state = threading.local()


class TileMesh(NamedTuple):
    group: Any              # the torch.distributed process group (None: the default group)
    rank: int               # this process's rank in it
    size: int               # D, the number of ranks
    device: torch.device    # this rank's device


def make_tile_mesh(group=None, device=None) -> TileMesh:
    """The mesh over the ranks of `group` (the default group when None),
    which must be initialized. `device` defaults to the current CUDA device
    under NCCL and to the CPU under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("make_tile_mesh: torch.distributed is not initialized "
                           "(parallel.multihost.init_multihost)")
    if device is None:
        if dist.get_backend(group) == "nccl":
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            device = torch.device("cpu")
    return TileMesh(group, dist.get_rank(group), dist.get_world_size(group),
                    torch.device(device))


@contextlib.contextmanager
def use_mesh(mesh: Optional[TileMesh]):
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def current_mesh() -> Optional[TileMesh]:
    return getattr(_state, "mesh", None)


def shard_block(n: int, mesh: TileMesh) -> slice:
    """This rank's contiguous block of an axis of n (n divisible by D)."""
    if n % mesh.size:
        raise ValueError(f"an axis of {n} does not split over {mesh.size} ranks")
    k = n // mesh.size
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def all_gather_cat(x: torch.Tensor, mesh: TileMesh, dim: int = 0) -> torch.Tensor:
    """Every rank's x (equal shapes) concatenated along `dim`, rank order."""
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=dim)


def all_reduce_(x: torch.Tensor, mesh: TileMesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """x reduced over the ranks, in place; returns x."""
    dist.all_reduce(x, op=op, group=mesh.group)
    return x


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh: TileMesh, dim: int):
        ctx.mesh, ctx.dim, ctx.k = mesh, dim, x.shape[dim]
        return all_gather_cat(x, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        k = ctx.k
        return g.narrow(ctx.dim, ctx.mesh.rank * k, k).contiguous(), None, None


class _TakeShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh: TileMesh, dim: int):
        ctx.mesh, ctx.dim = mesh, dim
        k = x.shape[dim] // mesh.size
        return x.narrow(dim, mesh.rank * k, k).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.mesh, ctx.dim), None, None


def gather_shards(x: torch.Tensor, mesh: TileMesh, dim: int = 0) -> torch.Tensor:
    """Every rank's block of x concatenated along `dim`. Differentiable:
    the gradient, which must be the same on every rank (computed from the
    gathered tensor by every rank alike), comes back as this rank's block."""
    if x.requires_grad:
        return _GatherShards.apply(x, mesh, dim)
    return all_gather_cat(x, mesh, dim)


def take_shard(x: torch.Tensor, mesh: TileMesh, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous block of x along `dim` (divisible by D).
    Differentiable: the gradient of x is every rank's gradient block,
    gathered (zero nowhere: each block is some rank's)."""
    shard_block(x.shape[dim], mesh)     # raises unless divisible
    if x.requires_grad:
        return _TakeShard.apply(x, mesh, dim)
    k = x.shape[dim] // mesh.size
    return x.narrow(dim, mesh.rank * k, k).contiguous()


def shard_store(tree, capacity: int, mesh: Optional[TileMesh] = None):
    """This rank's contiguous capacity / D block of every [capacity, ...]
    tensor of `tree` (a dict, a NamedTuple or a tensor; other leaves are
    kept), or `tree` itself without a mesh. The JAX package constrains the
    same arrays to the mesh's Gaussian axis."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return tree
    block = shard_block(capacity, mesh)

    def one(a):
        if isinstance(a, torch.Tensor) and a.dim() >= 1 and a.shape[0] == capacity:
            return a[block].detach().clone().requires_grad_(a.requires_grad)
        return a
    return _map_tree(one, tree)


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tree(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)

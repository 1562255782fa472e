"""A (dp, tp) device mesh and its sharding rules (port of
``mixdq_tpu/parallel/mesh.py``), on ``torch.distributed``: one process a
rank, gloo on the CPU, NCCL on the card.

* **dp** shards the batch: serving batches, QAT batches and the
  sensitivity sweeps' points.
* **tp** shards parameters over their last (output-channel) axis: dense
  ``[K, N]``, conv HWIO ``[kh, kw, C, K]`` and the per-channel vectors
  that follow the out-channel (``param_spec``). A rank keeps only its
  shard. The port's kernels take whole weights (GEGLU's ``[h | gate]``,
  the fused QKV / KV projections, the whole-attention kernels), so a
  sharded tensor is gathered over tp where it is read, before the launch:
  ``shard_module`` makes each sharded parameter gather on access
  (``sharded_copy``: on a copy, the caller's module untouched), and
  ``ShardedTree`` (a deploy or qparams dict) gathers an entry on lookup.
  Compute then runs replicated across tp; the shards save memory at rest.
  A gather that carries gradients goes through
  ``torch.distributed.nn.functional.all_gather``; its backward sums the tp
  ranks' identical gradients, so the shard's gradient is scaled by
  ``1 / tp`` first.

Process groups start from a ``FileStore`` (``init_world``, a world of
several ranks; ``launch.spawn`` starts one) or a ``HashStore`` (a world of
one), so no port and no network is needed.

Deviation from the JAX package: ``make_mesh`` raises when it is asked for
more ranks than the world has (JAX silently takes the devices there are),
and a mesh spans the whole world.
"""

from __future__ import annotations

import copy
import dataclasses
from collections.abc import Mapping
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.nn.utils import parametrize

Spec = Tuple[Optional[str], ...]


def init_world(rank: int = 0, world_size: int = 1,
               store_path: Optional[str] = None, device="cpu") -> None:
    """Start the default process group: ``world_size`` ranks meeting at
    the ``FileStore`` ``store_path``, or a world of one on a
    ``HashStore``. On CUDA each rank takes device ``rank``."""
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a world of {dist.get_world_size()} ranks "
                               f"is running, not {world_size}")
        return
    dev = torch.device(device)
    if dev.type == "cuda":
        if world_size > torch.cuda.device_count():
            raise ValueError(f"{world_size} ranks asked for, "
                             f"{torch.cuda.device_count()} CUDA devices")
        torch.cuda.set_device(rank)
    if store_path is None:
        if world_size != 1:
            raise ValueError("a world of several ranks needs a store path")
        store = dist.HashStore()
    else:
        store = dist.FileStore(store_path, world_size)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=store, rank=rank, world_size=world_size)


def make_mesh(n_devices: Optional[int] = None, tp: Optional[int] = None,
              device=None) -> DeviceMesh:
    """A (dp, tp) mesh over the world's ranks (a world of one is started
    here if none runs; its device: CUDA unless ``'cpu'`` is asked for).
    In a running world ``device`` defaults to its backend's (NCCL: CUDA,
    gloo: the CPU). ``tp`` defaults to 2 on an even count above one, else
    1. Raises when ``n_devices`` is not the world's size."""
    from ..pipeline import resolve_device

    if device is None and dist.is_initialized():
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dev = resolve_device(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"make_mesh({n_devices}): no process group "
                             "runs; start a world of that many ranks "
                             "(init_world, launch.spawn)")
        init_world(0, 1, None, dev)
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"make_mesh({n}): the world has {world} ranks "
                         f"and a mesh spans the whole world")
    if tp is None:
        tp = 2 if n % 2 == 0 and n > 1 else 1
    if n % tp:
        raise ValueError(f"tp {tp} does not divide {n} ranks")
    return DeviceMesh(dev.type, torch.arange(n).reshape(n // tp, tp),
                      mesh_dim_names=("dp", "tp"))


def dp_size(mesh: DeviceMesh) -> int:
    return mesh.size(0)


def tp_size(mesh: DeviceMesh) -> int:
    return mesh.size(1)


def dp_rank(mesh: DeviceMesh) -> int:
    return mesh.get_local_rank("dp")


def tp_rank(mesh: DeviceMesh) -> int:
    return mesh.get_local_rank("tp")


def param_spec(path: Tuple, leaf, tp_size: int) -> Spec:
    """Sharding rule for one leaf (JAX's ``PartitionSpec`` as a tuple):
    shard the last (out-channel) axis over ``'tp'`` when it divides;
    replicate otherwise. Scalars and non-tensors replicate."""
    shape = tuple(getattr(leaf, "shape", ()))
    if len(shape) == 0:
        return ()
    if shape[-1] % tp_size == 0 and shape[-1] >= tp_size:
        return (None,) * (len(shape) - 1) + ("tp",)
    return (None,) * len(shape)


def tree_leaves(tree, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) of every tensor of ``tree``: a module's parameters
    (by dotted name), a dict or a dataclass (a deploy entry, layer
    qparams)."""
    if isinstance(tree, nn.Module):
        for n, p in tree.named_parameters():
            yield prefix + (n,), p
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, Mapping):
        for k in tree:
            yield from tree_leaves(tree[k], prefix + (k,))
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from tree_leaves(getattr(tree, f.name), prefix + (f.name,))


def make_param_shardings(mesh: DeviceMesh, tree) -> Dict[Tuple, Spec]:
    """``param_spec`` of every tensor of ``tree`` (params, qparams or a
    deploy dict), by path."""
    n = tp_size(mesh)
    return {path: param_spec(path, leaf, n)
            for path, leaf in tree_leaves(tree)}


def make_batch_sharding(mesh: DeviceMesh) -> Spec:
    """The batch axis over dp, everything else replicated."""
    return ("dp",)


def make_replicated(mesh: DeviceMesh) -> Spec:
    return ()


# ---------------------------------------------------------------------------
# tp: shards and gathers
# ---------------------------------------------------------------------------


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient times ``factor``."""

    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def tp_shard(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's tp shard of ``t``'s last axis (a copy)."""
    return t.detach().tensor_split(tp_size(mesh), -1)[tp_rank(mesh)].clone()


def tp_gather(shard: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The whole tensor from every tp rank's shard of its last axis; with
    gradients when the shard takes them (the tp ranks compute the same
    function on the same batch, so the summed gradient is scaled back)."""
    group, n = mesh.get_group("tp"), tp_size(mesh)
    if shard.requires_grad and torch.is_grad_enabled():
        from torch.distributed.nn.functional import all_gather

        parts = all_gather(_ScaleGrad.apply(shard, 1.0 / n), group=group)
    else:
        parts = [torch.empty_like(shard) for _ in range(n)]
        dist.all_gather(parts, shard.contiguous(), group=group)
    return torch.cat(parts, -1)


class _Gather(nn.Module):
    """A parametrization: the stored tensor is this rank's shard, the
    module reads the whole tensor."""

    def __init__(self, mesh: DeviceMesh):
        super().__init__()
        self.mesh = mesh

    def forward(self, shard):
        return tp_gather(shard, self.mesh)

    def right_inverse(self, full):
        return tp_shard(full, self.mesh)


def shard_module(module: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Keep only this rank's tp shard of every parameter of ``module``
    that ``param_spec`` shards; each read of it gathers the whole tensor.
    In place; a no-op at tp 1."""
    if tp_size(mesh) == 1:
        return module
    n = tp_size(mesh)
    for m in list(module.modules()):
        # a parametrized tensor's ``original`` is already a shard
        if isinstance(m, parametrize.ParametrizationList):
            continue
        for pname, p in list(m.named_parameters(recurse=False)):
            if "tp" in param_spec((pname,), p, n):
                parametrize.register_parametrization(m, pname, _Gather(mesh),
                                                     unsafe=True)
    return module


def sharded_copy(module: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """``shard_module`` of a copy of ``module``; ``module`` is left as it
    is (as JAX's ``device_put`` leaves its input). The copy's parameters
    are new ``Parameter`` objects over the same storage (sharding swaps
    the storage of a parametrized tensor's ``Parameter`` in place) and
    its buffers are the caller's, so only the shards take new memory.
    ``module`` itself at tp 1."""
    if tp_size(mesh) == 1:
        return module
    memo = {id(p): nn.Parameter(p.detach(), p.requires_grad)
            for p in module.parameters()}
    memo.update({id(b): b for b in module.buffers()})
    return shard_module(copy.deepcopy(module, memo), mesh)


def _map_entry(entry, fn, path=()):
    """``entry`` with ``fn(path, tensor)`` applied to every tensor field
    (recursing into dataclass fields: a split entry's halves)."""
    if isinstance(entry, torch.Tensor):
        return fn(path, entry)
    if dataclasses.is_dataclass(entry):
        kw = {}
        for f in dataclasses.fields(entry):
            v = getattr(entry, f.name)
            if isinstance(v, torch.Tensor) or dataclasses.is_dataclass(v):
                kw[f.name] = _map_entry(v, fn, path + (f.name,))
        return dataclasses.replace(entry, **kw) if kw else entry
    return entry


class ShardedTree(Mapping):
    """``{name: entry}`` (deploy entries, layer qparams or tensors) whose
    tensors ``param_spec`` shards are held as this rank's tp shards
    (``local``); a lookup returns the entry with each of them gathered."""

    def __init__(self, tree: Mapping, mesh: DeviceMesh):
        self.mesh = mesh
        n = tp_size(mesh)
        self.sharded = set()

        def shard(path, t):
            if "tp" in param_spec(path, t, n):
                self.sharded.add(path)
                return tp_shard(t, mesh)
            return t

        self.local = {k: _map_entry(v, shard, (k,)) for k, v in tree.items()}

    def __getitem__(self, name):
        return _map_entry(
            self.local[name],
            lambda path, t: (tp_gather(t, self.mesh) if path in self.sharded
                             else t), (name,))

    def __iter__(self):
        return iter(self.local)

    def __len__(self):
        return len(self.local)


def shard_tree(mesh: DeviceMesh, tree: Optional[Mapping]):
    """``tree`` tp-sharded (``ShardedTree``); as it is at tp 1 or when
    empty."""
    if not tree or tp_size(mesh) == 1:
        return tree
    return ShardedTree(tree, mesh)


# ---------------------------------------------------------------------------
# dp: the batch
# ---------------------------------------------------------------------------


def dp_slice(mesh: DeviceMesh, n: int) -> slice:
    """This rank's rows of a batch of ``n`` (contiguous, ``n / dp``
    each)."""
    dp = dp_size(mesh)
    if n % dp:
        raise ValueError(f"batch {n} does not split over dp {dp}")
    b = n // dp
    return slice(dp_rank(mesh) * b, (dp_rank(mesh) + 1) * b)


def shard_batch_tree(mesh: DeviceMesh, tree, axis: int = 0):
    """This rank's dp share of every tensor of ``tree`` with an ``axis``
    (the leading one by default); scalars, None and other leaves as they
    are."""
    if isinstance(tree, torch.Tensor):
        if tree.ndim <= axis:
            return tree
        return tree.narrow(axis, dp_slice(mesh, tree.shape[axis]).start,
                           tree.shape[axis] // dp_size(mesh))
    if isinstance(tree, Mapping):
        return {k: shard_batch_tree(mesh, v, axis) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch_tree(mesh, v, axis) for v in tree)
    return tree


def gather_batch(mesh: DeviceMesh, t: torch.Tensor) -> torch.Tensor:
    """Every dp rank's ``t`` concatenated along axis 0, in rank order
    (a collective at dp 1 too: a copy)."""
    n = dp_size(mesh)
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=mesh.get_group("dp"))
    return torch.cat(parts, 0)


def dp_points(mesh: DeviceMesh, points):
    """This rank's share of a list of independent work items (every
    ``dp``-th, from its dp rank)."""
    return list(points)[dp_rank(mesh)::dp_size(mesh)]


def gather_points(mesh: DeviceMesh, points, local_values) -> list:
    """The values of every item of ``points``, in order, from each dp
    rank's ``local_values`` of its ``dp_points`` share."""
    n = dp_size(mesh)
    shares = [None] * n
    dist.all_gather_object(shares, list(local_values),
                           group=mesh.get_group("dp"))
    out = [None] * len(points)
    for r, vals in enumerate(shares):
        out[r::n] = vals
    return out


def dp_mean_(tensors, mesh: DeviceMesh) -> None:
    """Average each tensor over dp, in place."""
    n = dp_size(mesh)
    if n == 1:
        return
    for t in tensors:
        dist.all_reduce(t, group=mesh.get_group("dp"))
        t.div_(n)

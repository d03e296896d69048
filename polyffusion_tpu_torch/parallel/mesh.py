"""Process groups, device meshes and the placement of batches (counterpart of
``polyffusion_tpu/parallel/mesh.py``).

The JAX package runs one program over a mesh of devices and lets GSPMD insert
the collectives. Here each device is driven by a process of its own (a rank of
a ``torch.distributed`` process group: NCCL between cards, gloo on the CPU),
and the collectives are explicit:

- a 1-D ``DeviceMesh`` over every rank with axis name ``"dp"``;
- rank r keeps rows ``[r B / n, (r + 1) B / n)`` of each global batch of B rows
  (``batch_sharding``, ``shard_batch``); every rank reads the same seeded
  loader and draws the same global step noise, and keeps its rows;
- parameters replicated (a broadcast from rank 0), the fp32 master gradients
  averaged over ``dp`` after each backward (``all_reduce_mean_``): the
  gradient of the global batch's mean loss, as the JAX step's psum.

Each rank's device is ``cuda:<local rank>`` (``device.resolve_device`` after
``torch.cuda.set_device``) or the CPU.
"""

from __future__ import annotations

import socket
from contextlib import contextmanager
from typing import Callable, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Shard

from ..device import DeviceLike

DP = "dp"


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_process_group(device: DeviceLike = None, rank: int = 0, world_size: int = 1,
                       init_method: Optional[str] = None) -> None:
    """Joins (or, for one rank, makes) the default process group: NCCL for a
    CUDA ``device`` (the default), gloo for the CPU. ``init_method``:
    ``tcp://localhost:<port>``, by default a free port (one rank only)."""
    if dist.is_initialized():
        return
    cpu = device is not None and torch.device(device).type == "cpu"
    if init_method is None:
        if world_size != 1:
            raise ValueError("several ranks need the init_method they share")
        init_method = f"tcp://localhost:{free_port()}"
    dist.init_process_group("gloo" if cpu else "nccl", init_method=init_method, rank=rank,
                            world_size=world_size)


def _spawned(index: int, count: int, init_method: str, kind: str, body: Callable,
             argv) -> None:
    if kind == "cuda":
        torch.cuda.set_device(index)
    init_process_group(kind, index, count, init_method)
    try:
        body(argv)
    finally:
        dist.destroy_process_group()


def launch(body: Callable, argv, device: DeviceLike, batch_size: int,
           nproc: Optional[int] = None):
    """Run ``body(argv)`` data-parallel over ``nproc`` processes, one rank
    each: on CUDA one card a rank (NCCL), on the CPU gloo ranks. By default
    every visible card when ``device`` names no card index (dropping to the
    largest count that divides ``batch_size``, as the JAX CLIs do), else one
    process. A count of one runs ``body`` in this process, as does a
    caller's existing process group (its ranks). Returns ``body``'s result
    in-process, else None."""
    if dist.is_initialized():
        return body(argv)
    dev = torch.device("cuda" if device is None else device)
    if nproc is None:
        count = 1
        if dev.type == "cuda" and dev.index is None:
            count = max(torch.cuda.device_count(), 1)
            while batch_size % count:
                count -= 1
    else:
        count = nproc
        if count < 1 or batch_size % count:
            raise ValueError(f"batch_size {batch_size} does not divide over {count} processes")
        if dev.type == "cuda" and count > 1 and (
                dev.index is not None or count > torch.cuda.device_count()):
            raise ValueError(f"{count} processes need {count} cards, one each (NCCL takes one "
                             f"rank a card): {torch.cuda.device_count()} visible, device "
                             f"{device!r}")
    if count == 1:
        return body(argv)
    torch.multiprocessing.spawn(_spawned, nprocs=count, args=(
        count, f"tcp://localhost:{free_port()}", dev.type, body, argv))
    return None


@contextmanager
def data_parallel_mesh(device: DeviceLike, need: bool):
    """The dp mesh over the process group if there is one of several ranks
    or ``need`` asks for one (a one-rank group is then made here, and
    destroyed on exit); else None."""
    made = need and not dist.is_initialized()
    if made:
        init_process_group(device)
    try:
        yield make_mesh(device) if need or world_size() > 1 else None
    finally:
        if made:
            dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def from_rank0(obj):
    """``obj`` as rank 0 has it, on every rank."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    """Wait for every rank (nothing to wait for without a group of several)."""
    if world_size() > 1:
        dist.barrier()


def make_mesh(device: DeviceLike = None, axis: str = DP) -> DeviceMesh:
    """1-D mesh over every rank of the process group (which must exist)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: init_process_group first")
    kind = "cpu" if device is not None and torch.device(device).type == "cpu" else "cuda"
    return init_device_mesh(kind, (dist.get_world_size(),), mesh_dim_names=(axis,))


def dp_size(mesh: Optional[DeviceMesh]) -> int:
    return 1 if mesh is None or DP not in (mesh.mesh_dim_names or ()) else mesh.size(
        mesh.mesh_dim_names.index(DP))


def dp_group(mesh: DeviceMesh):
    return mesh.get_group(DP)


class RowShard(NamedTuple):
    """Rank ``index`` of ``count`` along dp: it keeps rows ``[index B / count,
    (index + 1) B / count)`` of a global batch of B rows."""

    index: int
    count: int

    def rows(self, n: int) -> slice:
        if n % self.count:
            raise ValueError(f"{n} rows do not divide over {self.count} dp ranks")
        per = n // self.count
        return slice(self.index * per, (self.index + 1) * per)


def batch_sharding(mesh: DeviceMesh, axis: str = DP) -> RowShard:
    """The rows this rank keeps (counterpart of JAX's ``P(axis)`` sharding)."""
    dim = mesh.mesh_dim_names.index(axis)
    return RowShard(mesh.get_local_rank(dim), mesh.size(dim))


def shard_batch(batch, mesh: DeviceMesh, axis: str = DP):
    """This rank's rows of every array or tensor of a global ``batch`` (a
    tuple; ``None`` entries pass)."""
    shard = batch_sharding(mesh, axis)
    vals = [v if v is None else v[shard.rows(v.shape[0])] for v in batch]
    return type(batch)(*vals) if hasattr(batch, "_fields") else tuple(vals)


def global_view(batch, count: int):
    """Shape-only stand-ins (meta tensors) of the global batch whose rows
    ``batch`` holds a 1/count of: what a task's ``draw_noise`` reads."""
    vals = [v if not isinstance(v, torch.Tensor) else
            torch.empty((v.shape[0] * count, *v.shape[1:]), dtype=v.dtype, device="meta")
            for v in batch]
    return type(batch)(*vals) if hasattr(batch, "_fields") else tuple(vals)


def keep_rows(noise, shard: RowShard):
    """This rank's rows of a step's global noise: the fields a noise type
    lists in ``ROWS`` (per-row draws; per-step coins are shared)."""
    return noise._replace(**{f: getattr(noise, f)[shard.rows(getattr(noise, f).shape[0])]
                             for f in type(noise).ROWS})


def replicated(module: nn.Module) -> nn.Module:
    """In place: every parameter and buffer of ``module`` broadcast from rank 0
    over the process group, so that all ranks start from rank 0's weights."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0)
    return module


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def init_on_cpu(init_fn: Callable[..., nn.Module], *args, device: DeviceLike = "cpu",
                **kwargs) -> nn.Module:
    """Build a module on the host, then move it to ``device``: hundreds of
    small initialisers run as host code, and one copy goes to the card."""
    return init_fn(*args, **kwargs).to(device)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard, else the tensor itself. Under ``no_grad`` the
    shard is the DTensor's own storage, so in-place updates reach it."""
    return t.to_local() if isinstance(t, DTensor) else t


def local_chunk(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's piece of the full tensor ``full`` laid out as ``like`` (a
    DTensor of even shards, or a plain tensor: all of it)."""
    if not isinstance(like, DTensor):
        return full
    coord = like.device_mesh.get_coordinate()
    for i, p in enumerate(like.placements):
        if isinstance(p, Shard):
            full = full.chunk(like.device_mesh.size(i), p.dim)[coord[i]]
    return full


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor (gathered when it is a DTensor; collective)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group, count: int) -> None:
    """In place, one collective: each tensor becomes its mean over ``group``
    (a flat fp32 buffer of all of them, summed, divided by ``count``)."""
    tensors = [t for t in tensors if t is not None]
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= count
    for t, piece in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(piece.view_as(t))


def gather_rows(x: torch.Tensor, group, count: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along rows, in rank order, on every rank."""
    if count == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(count)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the gradient is summed the same way. Each dp rank
    differentiates its own loss term, so the gradient of a global statistic
    collects every rank's share (as ``SyncBatchNorm`` does)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over ``group`` (gradient: the sum of the gradients);
    ``x`` itself when ``group`` is None (one process)."""
    return x if group is None else _AllReduceSum.apply(x, group)


def set_batch_group(module: nn.Module, group) -> None:
    """Point every submodule that takes statistics over the batch (it has a
    ``batch_group`` attribute: the discriminator's batch norms, the
    autoencoder's adaptive weight) at ``group``, so that they take them over
    the global batch."""
    for m in module.modules():
        if hasattr(m, "batch_group"):
            m.batch_group = group


def batch_sharded(apply_fn: Callable, mesh: DeviceMesh) -> Callable:
    """``apply_fn`` (x, t, cond, ...) on this rank's rows of every argument
    with x's leading size, the outputs gathered back along rows: a net
    evaluated batch-sharded over dp, seen whole by every rank.

    With ``cfg_fork=True`` (where ``apply_fn`` supports it) an argument of
    twice x's leading size is CFG's ``[uncond | cond]`` pair: the rank takes
    its rows of each half, so that its own fork sees ``[uncond_local |
    cond_local]`` beside its rows of x, and its output, laid out the same
    way, is gathered back into ``[uncond | cond]`` of the whole batch."""
    shard = batch_sharding(mesh)
    group = dp_group(mesh)

    def apply(x, *rest, cfg_fork=False):
        b = x.shape[0]
        rows = shard.rows(b)

        def mine(a):
            if not isinstance(a, torch.Tensor) or not a.dim():
                return a
            if a.shape[0] == b:
                return a[rows]
            if cfg_fork and a.shape[0] == 2 * b:
                return torch.cat([half[rows] for half in a.chunk(2)])
            return a

        args = [mine(a) for a in (x, *rest)]
        if not cfg_fork:
            return gather_rows(apply_fn(*args), group, shard.count)
        out = gather_rows(apply_fn(*args, cfg_fork=True), group, shard.count)
        # rank-major [uncond_r | cond_r] pairs -> [uncond | cond]
        return out.view(shard.count, 2, b // shard.count, *out.shape[1:]).transpose(0, 1).reshape(
            out.shape)

    apply.supports_cfg_fork = getattr(apply_fn, "supports_cfg_fork", False)
    return apply


def sharded_square_sums(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sum of squares of every element of the logical tensors, fp32: a plain
    tensor counts once (it is replicated), a DTensor's shards are summed over
    the ranks that hold them (one collective per mesh)."""
    plain = [t for t in tensors if not isinstance(t, DTensor)]
    total = torch.zeros((), dtype=torch.float32,
                        device=(tensors[0].device if not isinstance(tensors[0], DTensor)
                                else tensors[0].to_local().device))
    if plain:
        total = total + torch.stack(torch._foreach_norm([t.float() for t in plain])).square().sum()
    by_mesh = {}
    for t in tensors:
        if isinstance(t, DTensor):
            by_mesh.setdefault(id(t.device_mesh), (t.device_mesh, []))[1].append(t.to_local())
    for mesh, shards in by_mesh.values():
        s = torch.stack(torch._foreach_norm([t.float() for t in shards])).square().sum()
        dist.all_reduce(s, group=mesh.get_group())
        total = total + s
    return total

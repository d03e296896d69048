"""Megatron-style tensor parallelism for the UNet (counterpart of
``polyffusion_tpu/parallel/tp.py``).

The JAX package shards only the weights and lets GSPMD place the activations
and the collectives. Here the sites are explicit modules over the ``tp`` axis
of a 2-D ("dp", "tp") mesh, their sharded weights DTensors (full shapes and
the reference's names in the state dict):

- a ResBlock's ``in_layers.2`` conv (JAX ``in_conv``) and its time-embedding
  projection ``emb_layers.1`` (``emb_proj``) are column-parallel: output
  channels split, bias too. Its ``out_layers.0`` GroupNorm then normalizes
  the local channel shard with 32 / tp groups (group boundaries align with
  the shards for tp | 32), and ``out_layers.3`` (``out_conv``) is
  row-parallel: input channels split, the partial outputs summed over tp,
  the replicated bias added once;
- attention: ``to_q``, ``to_k``, ``to_v`` column-parallel, ``to_out.0``
  row-parallel; each rank attends over its own heads (the attention kernels
  take any head count). Where tp does not divide the heads, q, k and v are
  gathered over tp, the attention runs whole on every rank, and ``to_out.0``
  takes the rank's slice of its input;
- the GeGLU feed-forward: ``ff.net.0.proj`` (``geglu_proj``) column-parallel,
  each rank computing its slice of both the value and the gate half;
  ``ff.net.2`` (``proj_out``) row-parallel;
- the UNet's last conv ``out.2`` (JAX ``out_conv`` too, which the policy's
  name rule takes) is row-parallel on its whole input: each rank takes its
  slice of the channels;
- everything else (norms, the input conv, skips, the SpatialTransformer's
  1x1 ``proj_in`` / ``proj_out``) is replicated.

A column-parallel op is the identity forward and sums its input's gradient
over tp backward; a row-parallel op sums over tp forward and is the identity
backward (every tp rank computes the same loss). The gradients of replicated
parameters are then the same on every tp rank, those of sharded ones their
rank's shard.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Shard

from ..device import DeviceLike
from ..models.unet import CrossAttention, FeedForward, GroupNorm32, ResBlock, UNetModel
from ..ops.gn_bwd import group_norm_affine
from .mesh import DP, world_size

TP = "tp"

# the JAX policy's modules by the port's (the reference's) names
COLUMN = ("in_layers.2", "emb_layers.1", "to_q", "to_k", "to_v", "ff.net.0.proj")
COLUMN_BIAS = ("in_layers.2", "emb_layers.1", "ff.net.0.proj")
ROW = ("out_layers.3", "to_out.0", "ff.net.2", "out.2")


def make_tp_mesh(n_dp: int, n_tp: int, device: DeviceLike = None) -> DeviceMesh:
    """2-D ("dp", "tp") mesh over the process group's ranks; tp is the inner
    (adjacent-rank) axis."""
    assert n_dp * n_tp == world_size(), (n_dp, n_tp, world_size())
    kind = "cpu" if device is not None and torch.device(device).type == "cpu" else "cuda"
    return init_device_mesh(kind, (n_dp, n_tp), mesh_dim_names=(DP, TP))


def _site(name: str, suffixes) -> bool:
    mod = name.rpartition(".")[0]
    return any(mod == s or mod.endswith("." + s) for s in suffixes)


def _spec_for(name: str, ndim: int) -> Optional[int]:
    """The torch dimension of parameter ``name`` split over tp, or None."""
    leaf = name.rpartition(".")[2]
    if leaf == "weight" and ndim in (2, 4):
        if _site(name, ROW):
            return 1
        if _site(name, COLUMN) and (ndim == 4) == _site(name, ("in_layers.2",)):
            return 0
    if leaf == "bias" and ndim == 1 and _site(name, COLUMN_BIAS):
        return 0
    return None


def infer_tp_sharding(module: nn.Module, mesh: DeviceMesh) -> Dict[str, Optional[int]]:
    """Parameter name -> the torch dimension split over tp, or None
    (replicated), under the Megatron policy. A mesh without a tp axis
    replicates everything (the dp-only behaviour). The Adam moments and the
    EMA copy follow their parameter."""
    has_tp = TP in (mesh.mesh_dim_names or ())
    return {n: _spec_for(n, p.dim()) if has_tp else None for n, p in module.named_parameters()}


# -- the collectives, as autograd functions ---------------------------------------


def _chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x.chunk(dist.get_world_size(group), dim)[dist.get_rank(group)].contiguous()


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    """Gather along ``dim`` for a replicated consumer: backward keeps the
    rank's own chunk of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.dim, ctx.group), None, None


class _ScatterToTP(torch.autograd.Function):
    """The rank's chunk along ``dim`` of a replicated tensor: backward
    gathers the chunks' gradients."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _chunk(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _GatherShards(torch.autograd.Function):
    """Gather a weight's shards along ``dim`` for a consumer that differs by
    rank: backward sums the gradients over tp and keeps the rank's chunk."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _chunk(_all_reduce(g, ctx.group), ctx.dim, ctx.group), None, None


# -- the modules ----------------------------------------------------------------------


def _sharded(p: nn.Parameter, mesh: DeviceMesh, dim: int) -> nn.Parameter:
    """The rank's chunk of a (replicated) parameter along ``dim``, as a
    DTensor of the parameter's full shape."""
    shard = DTensor.from_local(_chunk(p.detach(), dim, mesh.get_group()), mesh, [Shard(dim)],
                               run_check=False)
    return nn.Parameter(shard, requires_grad=p.requires_grad)


class _Parallel(nn.Module):
    """A Linear or Conv2d's weight (and bias) over the tp mesh ``mesh``."""

    def __init__(self, mod: nn.Module, mesh: DeviceMesh):
        super().__init__()
        self.group = mesh.get_group()
        self.conv = isinstance(mod, nn.Conv2d)
        self.stride, self.padding = (mod.stride, mod.padding) if self.conv else (None, None)

    def _op(self, x, w, b=None):
        if self.conv:
            return F.conv2d(x, w, b, self.stride, self.padding)
        return F.linear(x, w, b)


class ColumnParallel(_Parallel):
    """Output features (channels) split over tp. ``gather_output``: gather
    them back (for a replicated consumer)."""

    def __init__(self, mod: nn.Module, mesh: DeviceMesh, gather_output: bool = False):
        super().__init__(mod, mesh)
        self.gather_output = gather_output
        self.weight = _sharded(mod.weight, mesh, 0)
        self.bias = None if mod.bias is None else _sharded(mod.bias, mesh, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _CopyToTP.apply(x, self.group)
        y = self._op(x, self.weight.to_local(), None if self.bias is None else self.bias.to_local())
        if self.gather_output:
            y = _GatherFromTP.apply(y, 1 if self.conv else -1, self.group)
        return y


class RowParallel(_Parallel):
    """Input features (channels) split over tp, the partial outputs summed,
    the replicated bias added once. ``input_is_parallel=False``: the input is
    whole and the rank takes its slice."""

    def __init__(self, mod: nn.Module, mesh: DeviceMesh, input_is_parallel: bool = True):
        super().__init__(mod, mesh)
        self.input_is_parallel = input_is_parallel
        self.weight = _sharded(mod.weight, mesh, 1)
        self.bias = mod.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.input_is_parallel:
            x = _ScatterToTP.apply(x, 1 if self.conv else -1, self.group)
        y = _ReduceFromTP.apply(self._op(x, self.weight.to_local()), self.group)
        if self.bias is None:
            return y
        return y + (self.bias[:, None, None] if self.conv else self.bias)


class GLUColumnParallel(_Parallel):
    """GeGLU's projection, column-parallel over both halves: the rank
    computes its slice of the value half and the same slice of the gate half
    (a plain column split would hand one rank the values and another the
    gates). The weight is stored as the policy shards it (rows split in
    order); its shards are gathered for the forward."""

    def __init__(self, mod: nn.Linear, mesh: DeviceMesh):
        super().__init__(mod, mesh)
        self.weight = _sharded(mod.weight, mesh, 0)
        self.bias = None if mod.bias is None else _sharded(mod.bias, mesh, 0)

    def _mine(self, t: torch.Tensor) -> torch.Tensor:
        whole = _GatherShards.apply(t.to_local(), 0, self.group)
        val, gate = whole.chunk(2, 0)
        return torch.cat([_chunk(val, 0, self.group), _chunk(gate, 0, self.group)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _CopyToTP.apply(x, self.group)
        bias = None if self.bias is None else self._mine(self.bias)
        return F.linear(x, self._mine(self.weight), bias)


class LocalGroupNorm(GroupNorm32):
    """A GroupNorm over the rank's channel shard, with groups / tp groups;
    its scale and bias stay whole (replicated), their gradients summed over
    tp."""

    def __init__(self, norm: GroupNorm32, mesh: DeviceMesh):
        n = mesh.size()
        if norm.groups % n:
            raise ValueError(f"tp {n} does not divide the GroupNorm's {norm.groups} groups")
        nn.Module.__init__(self)
        self.eps, self.groups, self.group = norm.eps, norm.groups // n, mesh.get_group()
        self.weight, self.bias = norm.weight, norm.bias

    def _mine(self, p: torch.Tensor) -> torch.Tensor:
        return _CopyToTP.apply(p, self.group).chunk(dist.get_world_size(self.group))[
            dist.get_rank(self.group)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_affine(x, self._mine(self.weight), self._mine(self.bias), self.groups,
                                 self.eps)


def shard_state(module: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """In place: the UNet ``module``'s sites become the tp modules over
    ``mesh``'s tp axis (its weights must be the same on every rank). Refused
    for a site through the fused GroupNorm-SiLU-conv kernels or the XLA int8
    route, and for the space-to-depth level 0."""
    if TP not in (mesh.mesh_dim_names or ()):
        return module
    for m in module.modules():
        if isinstance(m, ResBlock) and m.gn_conv == "s2d":
            raise NotImplementedError(
                "gn_conv='s2d' under tensor parallelism (ROADMAP item 22): the folded kernels "
                "over a channel shard are not ported; use gn_conv='unfused'")
        if isinstance(m, ResBlock) and m.gn_conv == "int8_xla":
            raise NotImplementedError(
                "gn_conv='int8_xla' under tensor parallelism (ROADMAP item 21): the "
                "row-parallel out conv would take its activation amax over a channel shard, "
                "not over the item; use gn_conv='unfused'")
        if isinstance(m, ResBlock) and m.gn_conv != "unfused":
            raise NotImplementedError(
                f"gn_conv={m.gn_conv!r} under tensor parallelism (ROADMAP item 21): "
                "train tp with gn_conv='unfused'")
    plan = infer_tp_sharding(module, mesh)
    tp = mesh[TP]
    n = tp.size()
    for m in list(module.modules()):
        if isinstance(m, ResBlock):
            m.in_layers[2] = ColumnParallel(m.in_layers[2], tp)
            m.emb_layers[1] = ColumnParallel(m.emb_layers[1], tp)
            m.out_layers[0] = LocalGroupNorm(m.out_layers[0], tp)
            m.out_layers[3] = RowParallel(m.out_layers[3], tp)
        elif isinstance(m, CrossAttention):
            whole_heads = m.n_heads % n == 0
            for name in ("to_q", "to_k", "to_v"):
                setattr(m, name, ColumnParallel(getattr(m, name), tp,
                                                gather_output=not whole_heads))
            m.to_out[0] = RowParallel(m.to_out[0], tp, input_is_parallel=whole_heads)
        elif isinstance(m, FeedForward):
            m.net[0].proj = GLUColumnParallel(m.net[0].proj, tp)
            m.net[2] = RowParallel(m.net[2], tp)
        elif isinstance(m, UNetModel):
            m.out[2] = RowParallel(m.out[2], tp, input_is_parallel=False)
    for name, p in module.named_parameters():
        got = p.placements[0].dim if isinstance(p, DTensor) else None
        if got != plan[name]:
            raise NotImplementedError(f"tensor parallelism of {type(module).__name__}: "
                                      f"{name} is not a site the tp modules cover")
    return module

"""ZeRO-3 / FSDP sharding of the train state with FSDP2 (counterpart of
``polyffusion_tpu/parallel/fsdp.py``).

The policy is the JAX package's: a parameter of at least ``MIN_SHARD_ELEMS``
elements is sharded over ``dp`` along its largest dimension that the dp size
divides (ties toward the leading dimension of the JAX layout: (kh, kw, in,
out) for a conv kernel, (in, out) for a dense one); every other parameter is
replicated. ``shard_state_fsdp`` applies it with ``fully_shard``: the sharded
parameters become DTensors (their ``shard_placement_fn`` placement), the
replicated ones are ``ignored_params`` that FSDP2 neither shards nor reduces
(the train step averages their gradients itself). The fp32 masters, both Adam
moments and the EMA copy are made from the sharded parameters, so they are
sharded alike. FSDP2 all-gathers the weights before each block's forward and
backward and reduce-scatters the gradients in fp32
(``MixedPrecisionPolicy(param_dtype=bfloat16, reduce_dtype=float32)`` for a
bf16 model: it takes the place of ``utils/precision.MasterWeights`` for the
sharded parameters).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard
from torch.distributed.tensor import Shard

from ..utils.precision import keeps_fp32
from .mesh import DP

#: parameters smaller than this stay replicated: sharding a (64,) GroupNorm
#: scale buys nothing and costs a collective
MIN_SHARD_ELEMS = 2**13


def jax_axes(module: nn.Module, name: str, param: torch.Tensor) -> List[int]:
    """The torch dimensions of ``param`` in the order of its JAX layout: a
    conv weight (out, in, *k) is (*k, in, out) there, a transposed conv's
    (in, out, *k) is (*k, in, out), a dense weight (out, in) is (in, out);
    anything else keeps its order."""
    owner = module.get_submodule(name.rpartition(".")[0])
    is_weight = name.endswith("weight")
    if is_weight and isinstance(owner, nn.modules.conv._ConvNd) and param.dim() >= 3:
        k = list(range(2, param.dim()))
        return k + ([0, 1] if owner.transposed else [1, 0])
    if is_weight and isinstance(owner, nn.Linear):
        return [1, 0]
    return list(range(param.dim()))


def _choose_dim(shape, axes: List[int], n: int) -> Optional[int]:
    """The largest dimension that ``n`` divides, ties toward the leading one
    of ``axes`` (JAX's order); a torch dimension, or None."""
    order = sorted(range(len(axes)), key=lambda i: (shape[axes[i]], -i), reverse=True)
    for i in order:
        d = axes[i]
        if shape[d] % n == 0 and shape[d] >= n:
            return d
    return None


def infer_fsdp_sharding(module: nn.Module, mesh: DeviceMesh, axis: str = DP,
                        min_elems: int = MIN_SHARD_ELEMS) -> Dict[str, Optional[int]]:
    """Parameter name -> the torch dimension sharded over ``axis``, or None
    (replicated). A mesh without the axis replicates everything.

    On one rank JAX's policy replicates everything; here every dimension
    divides one, so the large parameters get a one-way shard along their
    largest dimension. A shard of one holds the whole parameter, which is
    the replicated layout, and one card runs the FSDP2 code that several
    run."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        return {name: None for name, _ in module.named_parameters()}
    n = mesh.size(names.index(axis))
    return {name: None if p.dim() == 0 or p.numel() < min_elems
            else _choose_dim(p.shape, jax_axes(module, name, p), n)
            for name, p in module.named_parameters()}


def _blocks(module: nn.Module) -> List[nn.Module]:
    """The units FSDP2 gathers one at a time: the root's children, and the
    children of its module lists (a UNet's blocks)."""
    out = []
    for child in module.children():
        if isinstance(child, (nn.ModuleList, nn.ModuleDict)):
            out.extend(child.children())
        else:
            out.append(child)
    return out


def shard_state_fsdp(module: nn.Module, mesh: DeviceMesh,
                     param_dtype: Optional[torch.dtype] = None) -> nn.Module:
    """In place: ``fully_shard`` ``module`` by ``infer_fsdp_sharding`` over
    the dp mesh, each block's gathered weights freed after its forward
    (ZeRO-3).

    The policy's sharded parameters become DTensors; the others stay plain
    (``ignored_params``). ``param_dtype``: the dtype the gathered weights
    compute in (bf16 for a bf16 model; gradients are reduced in fp32) except
    for the own parameters of the modules that ``keeps_fp32`` picks (norms),
    which compute in their own dtype."""
    plan = infer_fsdp_sharding(module, mesh)
    sharded = {p: Shard(plan[name]) for name, p in module.named_parameters()
               if plan[name] is not None}
    if not sharded:
        return module
    ignored = {p for p in module.parameters() if p not in sharded}

    def kwargs(dtype):
        return dict(mesh=mesh, reshard_after_forward=True,
                    shard_placement_fn=lambda p: sharded[p], ignored_params=ignored,
                    mp_policy=MixedPrecisionPolicy(param_dtype=dtype,
                                                   reduce_dtype=torch.float32,
                                                   cast_forward_inputs=False))

    def holds_sharded(m, recurse=True):
        return any(p in sharded for p in m.parameters(recurse=recurse))

    # fp32 modules with a sharded parameter of their own first: a group each,
    # gathered without a cast
    for m in module.modules():
        if m is not module and keeps_fp32(m) and holds_sharded(m, recurse=False):
            fully_shard(m, **kwargs(None))
    for block in _blocks(module):
        if holds_sharded(block):
            fully_shard(block, **kwargs(param_dtype))
    fully_shard(module, **kwargs(param_dtype))
    return module

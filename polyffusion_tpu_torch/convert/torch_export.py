"""Parameter trees and the port's training state -> reference PyTorch
checkpoints (the port's copy of ``polyffusion_tpu/convert/torch_export.py``).

``save_reference_checkpoint`` writes the reference's legacy learner layout
(``{"model": {"ldm.eps_model.<...>": tensor}}``), which the reference's
``Polyffusion_SDF.load_trained`` and the port's ``inference.load_unet_params``
read. ``export_learner_checkpoint`` writes the whole learner checkpoint
(``{step, epoch, model, optimizer, scaler}``, reference ``learner.py:70-84``)
from the port's fp32 master weights and its ``torch.optim.Adam`` state: the
trainer's ``legacy_checkpoints`` mirror.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from . import unet_state_from_jax
from .torch_import import unet_params_from_torch


def unet_params_to_torch(params: Mapping) -> Dict[str, np.ndarray]:
    """A JAX ``UNetModel`` tree (NumPy leaves) -> the reference UNet's state
    dict (NumPy): ``unet_state_from_jax``'s mapping."""
    return {k: v.numpy() for k, v in unet_state_from_jax(params).items()}


def save_reference_checkpoint(params: Mapping, path: str, prefix: str = "ldm.eps_model") -> None:
    """Write a legacy-learner-format torch checkpoint the reference can load."""
    torch.save({"model": {f"{prefix}.{k}": v for k, v in unet_state_from_jax(params).items()}},
               path)


# ---------------------------------------------------------------------------
# Full legacy-learner checkpoint (resume-compatible, reference learner.py:70-124)
# ---------------------------------------------------------------------------

# per-module (torch-param-name, flax-path) orders, matching the reference
# modules' registration order (JAX tests/test_legacy_checkpoint.py checks it
# against the reference's named_parameters())
def _resblock_order(tk, fp, has_skip):
    pairs = [
        (f"{tk}.in_layers.0", fp + ("in_norm",), "norm"),
        (f"{tk}.in_layers.2", fp + ("in_conv",), "conv"),
        (f"{tk}.emb_layers.1", fp + ("emb_proj",), "linear"),
        (f"{tk}.out_layers.0", fp + ("out_norm",), "norm"),
        (f"{tk}.out_layers.3", fp + ("out_conv",), "conv"),
    ]
    if has_skip:
        pairs.append((f"{tk}.skip_connection", fp + ("skip",), "conv"))
    return pairs


def _transformer_order(tk, fp, sub):
    pairs = [
        (f"{tk}.norm", fp + ("norm",), "norm"),
        (f"{tk}.proj_in", fp + ("proj_in",), "conv"),
    ]
    k = 0
    while f"block_{k}" in sub:
        bt, bp = f"{tk}.transformer_blocks.{k}", fp + (f"block_{k}",)
        for attn, nrm in (("attn1", "norm1"), ("attn2", "norm2")):
            for proj in ("to_q", "to_k", "to_v"):
                pairs.append((f"{bt}.{attn}.{proj}", bp + (attn, proj), "linear_nobias"))
            pairs.append((f"{bt}.{attn}.to_out.0", bp + (attn, "to_out"), "linear"))
            pairs.append((f"{bt}.{nrm}", bp + (nrm,), "norm"))
        pairs.append((f"{bt}.ff.net.0.proj", bp + ("ff", "geglu_proj"), "linear"))
        pairs.append((f"{bt}.ff.net.2", bp + ("ff", "proj_out"), "linear"))
        pairs.append((f"{bt}.norm3", bp + ("norm3",), "norm"))
        k += 1
    pairs.append((f"{tk}.proj_out", fp + ("proj_out",), "conv"))
    return pairs


def unet_param_order(params: Mapping):
    """(torch key, flax path, kind) triples in the reference UNetModel's
    ``named_parameters()`` order (module registration order), for a JAX
    ``UNetModel`` tree."""
    order = [
        ("time_embed.0", ("time_embed_0",), "linear"),
        ("time_embed.2", ("time_embed_2",), "linear"),
        ("input_blocks.0.0", ("input_blocks_0_0",), "conv"),
    ]

    def block_ids(side):
        ids = set()
        for name in params:
            if name.startswith(side) and name != "input_blocks_0_0":
                _, i, j = name.rsplit("_", 2)
                ids.add((int(i), int(j)))
        return sorted(ids)

    def emit(side, i, j):
        name = f"{side}_{i}_{j}"
        sub = params[name]
        tk = f"{side}.{i}.{j}"
        fp = (name,)
        if "in_norm" in sub:
            order.extend(_resblock_order(tk, fp, "skip" in sub))
        elif "proj_in" in sub:
            order.extend(_transformer_order(tk, fp, sub))
        elif "conv" in sub:
            suffix = ".op" if side == "input_blocks" else ".conv"
            order.append((tk + suffix, fp + ("conv",), "conv"))
        else:  # pragma: no cover
            raise KeyError(name)

    for i, j in block_ids("input_blocks"):
        emit("input_blocks", i, j)
    mb0, mb1, mb2 = ("middle_block_0",), ("middle_block_1",), ("middle_block_2",)
    order.extend(_resblock_order("middle_block.0", mb0, "skip" in params["middle_block_0"]))
    order.extend(_transformer_order("middle_block.1", mb1, params["middle_block_1"]))
    order.extend(_resblock_order("middle_block.2", mb2, "skip" in params["middle_block_2"]))
    for i, j in block_ids("output_blocks"):
        emit("output_blocks", i, j)
    order.append(("out.0", ("out_norm",), "norm"))
    order.append(("out.2", ("out_conv",), "conv"))
    return order


def _leaf_pairs(kind, tk):
    """[(torch param key, flax leaf key)] for one module, in the reference's
    registration order."""
    if kind in ("conv", "linear"):
        return [(f"{tk}.weight", "kernel"), (f"{tk}.bias", "bias")]
    if kind == "linear_nobias":
        return [(f"{tk}.weight", "kernel")]
    if kind == "norm":
        return [(f"{tk}.weight", "scale"), (f"{tk}.bias", "bias")]
    raise KeyError(kind)


def reference_param_keys(params: Mapping[str, torch.Tensor]):
    """The port UNet's parameter names (``params``: its state by name) in the
    reference ``UNetModel``'s ``named_parameters()`` order, by
    ``unet_param_order`` over the JAX tree of the same weights."""
    tree = unet_params_from_torch({k: v.detach().cpu().numpy() for k, v in params.items()})
    return [key for tk, _, kind in unet_param_order(tree) for key, _ in _leaf_pairs(kind, tk)]


def export_learner_checkpoint(
    params: Mapping[str, torch.Tensor],
    path: str,
    *,
    schedule,
    opt_state: Optional[Dict] = None,
    step: int = 0,
    epoch: int = 0,
    learning_rate: float = 5e-5,
    extra_model_state: Optional[Dict] = None,
    n_extra_params: Optional[int] = None,
    fp16: bool = False,
) -> None:
    """Write a whole legacy-learner checkpoint (reference ``learner.py:70-84``):
    ``{"step", "epoch", "model", "optimizer", "scaler"}``, which the
    reference's resume path (``learner.restore_from_checkpoint``) accepts.

    - ``params``: the port UNet's fp32 weights by parameter name, in its
      ``named_parameters()`` order (``TrainState.params()``);
    - ``schedule``: the task's ``NoiseSchedule``; fills the LatentDiffusion
      parameters and buffer (``ldm.alpha/beta/alpha_bar/sigma2``,
      latent_diffusion.py:90-108);
    - ``opt_state``: the ``torch.optim.Adam`` state dict over ``params`` in that
      order (``TrainState.optimizer.state_dict()``); its moments are written as
      the reference's Adam ``exp_avg`` / ``exp_avg_sq`` by name, at the indices
      of ``Polyffusion_SDF.parameters()`` (the 3 frozen schedule parameters
      first, then the UNet in ``unet_param_order``). A parameter without
      state (no step taken) gets zero moments at step 0, as an optax state
      after ``init``;
    - ``extra_model_state``: tensors of the frozen encoders (``chord_enc.*``)
      stored beside the UNet, as the reference's checkpoints do;
      ``n_extra_params`` overrides how many of them are parameters (all by
      default).

    Raises where ``params`` holds a name the reference UNet does not."""
    beta = np.asarray(schedule.beta, np.float32)
    alpha_bar = np.asarray(schedule.alpha_bar, np.float32)
    model_sd = {
        "ldm.alpha": torch.from_numpy(1.0 - beta),
        "ldm.beta": torch.from_numpy(beta),
        "ldm.alpha_bar": torch.from_numpy(alpha_bar),
        "ldm.sigma2": torch.from_numpy(beta),
    }
    keys = reference_param_keys(params)
    if sorted(keys) != sorted(params):
        raise KeyError(f"not the reference UNet's parameters: "
                       f"{sorted(set(params) ^ set(keys))[:8]}")
    model_sd.update({f"ldm.eps_model.{k}": params[k].detach().cpu().float().contiguous().clone()
                     for k in keys})
    extra_model_state = extra_model_state or {}
    for k, v in extra_model_state.items():
        model_sd[k] = (
            v if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(np.asarray(v)))
        )

    # ----- optimizer: torch Adam state dict ---------------------------------
    n_frozen_schedule = 3  # ldm.alpha, ldm.beta, ldm.alpha_bar (sigma2 is a buffer)
    if n_extra_params is None:
        n_extra_params = len(extra_model_state)
    n_total = n_frozen_schedule + len(keys) + n_extra_params
    state = {}
    if opt_state is not None:
        index = {name: i for i, name in enumerate(params)}
        for idx, key in enumerate(keys, n_frozen_schedule):
            st = opt_state["state"].get(index[key])
            zeros = torch.zeros_like(params[key], device="cpu", dtype=torch.float32)
            state[idx] = {
                "step": torch.tensor(float(st["step"]) if st else 0.0),
                "exp_avg": st["exp_avg"].detach().cpu().contiguous().clone() if st else zeros,
                "exp_avg_sq": (st["exp_avg_sq"].detach().cpu().contiguous().clone() if st
                               else zeros.clone()),
            }
    optimizer_sd = {
        "state": state,
        "param_groups": [
            {
                "lr": learning_rate,
                "betas": (0.9, 0.999),
                "eps": 1e-8,
                "weight_decay": 0,
                "amsgrad": False,
                "maximize": False,
                "foreach": None,
                "capturable": False,
                "differentiable": False,
                "fused": None,
                "params": list(range(n_total)),
            }
        ],
    }

    scaler_sd = (
        {
            "scale": 65536.0,
            "growth_factor": 2.0,
            "backoff_factor": 0.5,
            "growth_interval": 2000,
            "_growth_tracker": 0,
        }
        if fp16
        else {}
    )

    torch.save(
        {
            "step": int(step),
            "epoch": int(epoch),
            "model": model_sd,
            "optimizer": optimizer_sd,
            "scaler": scaler_sd,
        },
        path,
    )

"""Kernel 6's shapes on the plain DDPM and autoencoder train steps, on the CPU.

A forward hook on every ``GroupNorm32`` of each preset's network at its
published widths, run on the meta device at the preset's batch of 16 rolls
(128 x 128, fp32: no memory, no arithmetic), lists the GroupNorms whose
backward a train step hands the kernel: 45 in the DDPM UNet (its final norm
with 8 groups, its 2048-channel concat with 64 channels a group) and 52 in
the autoencoder. ``gn_bwd_plan`` and the wrapper's checks must take each of
them (the kernel has no fallback on the card)."""

from collections import Counter

import pytest
import torch

from polyffusion_tpu_torch.config import load_params
from polyffusion_tpu_torch.models.unet import GroupNorm32
from polyffusion_tpu_torch.ops.gn_bwd import (
    MAX_CHANNELS_PER_GROUP,
    SMEM_LIMIT,
    gn_bwd_plan,
    group_norm_bwd,
)
from polyffusion_tpu_torch.tasks import AutoencoderTask, DDPMTask

B = 16
# (C, H, W, groups): GroupNorms per train step
DDPM_SHAPES = {
    (64, 128, 128, 32): 7, (128, 128, 128, 32): 3, (64, 128, 128, 8): 1,
    (64, 64, 64, 32): 2, (128, 64, 64, 32): 5, (192, 64, 64, 32): 1, (256, 64, 64, 32): 2,
    (128, 32, 32, 32): 2, (256, 32, 32, 32): 5, (384, 32, 32, 32): 1, (512, 32, 32, 32): 2,
    (256, 16, 16, 32): 2, (1024, 16, 16, 32): 9, (1280, 16, 16, 32): 1, (2048, 16, 16, 32): 2,
}
AE_SHAPES = {
    (64, 128, 128, 32): 10, (128, 128, 128, 32): 1,
    (64, 64, 64, 32): 1, (128, 64, 64, 32): 8, (256, 64, 64, 32): 1,
    (128, 32, 32, 32): 1, (256, 32, 32, 32): 9,
    (256, 16, 16, 32): 21,
}


def groupnorm_shapes(model: torch.nn.Module, *args) -> Counter:
    """(C, H, W, groups) of each GroupNorm32 that ``model(*args)`` runs."""
    seen = Counter()
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: seen.update([(*inp[0].shape[1:], mod.groups)]))
        for m in model.modules() if isinstance(m, GroupNorm32)]
    try:
        with torch.no_grad():
            model(*args)
    finally:
        for h in hooks:
            h.remove()
    return seen


def _on_meta(task_cls, name):
    with torch.device("meta"):
        return task_cls(load_params(name), device="meta")


def test_ddpm_train_step_groupnorms():
    task = _on_meta(DDPMTask, "ddpm")
    x = torch.empty(B, 2, 128, 128, device="meta")
    t = torch.zeros(B, dtype=torch.long, device="meta")
    seen = groupnorm_shapes(task.unet, x, t)
    assert dict(seen) == DDPM_SHAPES
    assert sum(seen.values()) == 45


def test_autoencoder_train_step_groupnorms():
    task = _on_meta(AutoencoderTask, "autoencoder")
    x = torch.empty(B, 3, 128, 128, device="meta")
    eps = torch.empty(B, 4, 16, 16, device="meta")
    seen = groupnorm_shapes(task.ae, x, eps)
    assert dict(seen) == AE_SHAPES
    assert sum(seen.values()) == 52


@pytest.mark.parametrize("c,h,w,groups", sorted(set(DDPM_SHAPES) | set(AE_SHAPES)))
def test_kernel_plan_takes_every_new_shape(c, h, w, groups):
    """fp32 at batch 16: at most 64 channels a group, spans of whole 16-byte
    vectors, and a cluster whose shares fit; the CPU route of the wrapper
    runs the same shape's checks."""
    assert c // groups <= MAX_CHANNELS_PER_GROUP and (h * w) % 8 == 0
    plan = gn_bwd_plan(B, c, h, w, torch.float32, groups)
    assert plan.smem <= SMEM_LIMIT and plan.cluster in (1, 2, 4, 8)
    x = torch.zeros(1, c, h, w)
    stats = torch.ones(1, c)
    dx, dgamma, dbeta = group_norm_bwd(x, x, stats * 0, stats, torch.ones(c), groups)
    assert dx.shape == x.shape and dgamma.shape == dbeta.shape == (c,)


def test_final_norm_and_widest_concat_plans():
    """The two shapes no earlier path gave the kernel: the final norm's span
    of 8 channels x 128^2 fp32 takes clusters of 8 CTAs of 128 KB (over the
    64 KB budget, under the 200 KB limit); the 2048-channel concat (64 a
    group, the most the kernel takes) two CTAs of 64 KB."""
    assert gn_bwd_plan(B, 64, 128, 128, torch.float32, 8) == (8, 16384, 4096, 131072)
    assert gn_bwd_plan(B, 2048, 16, 16, torch.float32, 32) == (2, 8192, 4096, 65536)

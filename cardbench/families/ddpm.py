"""The unconditional DDPM baseline (``ddpm``): the program's training step
on seeded weights and the same steps on the plain reference."""

from __future__ import annotations

import torch

from .. import inputs
from ..programs import PortTrain
from ..reference import ddpm_unet as ref_unet
from ..reference import diffusion as ref_diffusion
from ..reference.layers import set_precision

UNET_PART = 20


def meta_unet(cfg):
    with torch.device("meta"):
        return ref_unet.build(cfg)


def weights(cfg, seed: int, device):
    return inputs.weights(meta_unet(cfg), inputs.mix(seed, UNET_PART), device)


unet_weights = weights


def eval_inputs(cfg, batch: int, device):
    x = torch.zeros(batch, cfg["image_channels"], cfg["image_size_h"], cfg["image_size_w"],
                    device=device)
    return x, torch.zeros(batch, dtype=torch.long, device=device)


class TrainProgram(PortTrain):
    """The port's training step (``train/step.py``) on ``tasks/ddpm.py``."""

    def __init__(self, cfg, traffic, seed: int, device):
        from polyffusion_tpu_torch.config import Params
        from polyffusion_tpu_torch.tasks.ddpm import DDPMTask
        from polyffusion_tpu_torch.train.state import create_state
        from polyffusion_tpu_torch.train.step import make_train_step

        self.task = DDPMTask(Params(cfg), device=device, training=True)
        self.task.load_unet_state(weights(cfg, seed, device))
        self.state = create_state(self.task.model, float(cfg["learning_rate"]),
                                  float(cfg["max_grad_norm"]), bf16=self.task.bf16)
        self.step_fn = make_train_step(self.task)
        self.fields = self.task.used_batch_fields

    def noise(self, draws):
        from polyffusion_tpu_torch.tasks.ddpm import DDPMNoise

        return DDPMNoise(draws["t"], draws["noise"])


def reference_models(cfg, seed: int, device, precision: str = "fp32"):
    unet = ref_unet.build(cfg).to(device)
    unet.load_state_dict(weights(cfg, seed, device), strict=True)
    return set_precision(unet, precision), None


def reference_step_loss(cfg, models, tab, batches, draws):
    def step_loss(model, i, rows):
        b, d = batches[i], draws[i]
        return ref_diffusion.loss(model, tab, b["prmat2c"][rows], None, d["t"][rows],
                                  d["noise"][rows], reduction="sum")

    return step_loss

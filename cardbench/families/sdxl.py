"""The SDXL family (``sdxl_base``): how the benchmark builds the program's
generation session from a configuration file and seeded weights, each
request's condition from the seed, and the same generation on the plain
reference. The program is ``polyffusion_tpu_torch`` (``tasks/sdxl.py``); the
reference is ``cardbench/reference/sdxl_unet.py``."""

from __future__ import annotations

import torch

from .. import inputs
from ..reference import diffusion as ref_diffusion
from ..reference import sdxl_unet as ref_unet
from ..reference.layers import set_precision
from ..reference.precision import strict_fp32

UNET_PART, SESSION_PART, COND_PART = 20, 21, 22


def meta_unet(cfg):
    with torch.device("meta"):
        return ref_unet.build(cfg)


def unet_weights(cfg, seed: int, device):
    """The UNet's float32 state dict, drawn on ``device`` from the seed, in
    the published names."""
    return inputs.weights(meta_unet(cfg), inputs.mix(seed, UNET_PART), device)


def eval_inputs(cfg, batch: int, device):
    """(x, t, context, y) of one UNet evaluation at ``batch``."""
    x = torch.zeros(batch, cfg["in_channels"], cfg["img_h"], cfg["img_w"], device=device)
    t = torch.zeros(batch, dtype=torch.long, device=device)
    context = torch.zeros(batch, cfg["n_ctx"], cfg["d_cond"], device=device)
    y = torch.zeros(batch, cfg["adm_in_channels"], device=device)
    return x, t, context, y


def request_condition(cfg, seed: int, r: int, batch: int, device) -> dict:
    """Request r's condition as the text encoders would hand it over:
    ``context`` (batch, n_ctx, d_cond) and ``pooled`` (batch, pooled_dim),
    N(0, 1) from the seed and r, and the configuration's ``size_ids``
    (batch, 6)."""
    g = inputs.device_generator(device, seed, COND_PART, r)
    context = torch.randn((batch, cfg["n_ctx"], cfg["d_cond"]), generator=g, device=device)
    pooled = torch.randn((batch, cfg["pooled_dim"]), generator=g, device=device)
    ids = torch.tensor(cfg["size_ids"], dtype=torch.long, device=device).repeat(batch, 1)
    return {"context": context, "pooled": pooled, "size_ids": ids}


# -- the program ------------------------------------------------------------------


class GenProgram:
    """The port's ``InferenceSession`` over its SDXL task on seeded weights:
    DDIM with CFG."""

    def __init__(self, cfg, traffic, seed: int, device):
        from polyffusion_tpu_torch.config import Params
        from polyffusion_tpu_torch.inference import InferenceSession
        from polyffusion_tpu_torch.tasks.sdxl import SDXLTask

        self.cfg, self.device = cfg, device
        self.scale = float(traffic["cfg_scale"])
        self.task = SDXLTask(Params(cfg), unet_weights(cfg, seed, device), device=device)
        self.session = InferenceSession(self.task, use_ddim=True,
                                        ddim_steps=int(traffic["ddim_steps"]), ddim_eta=0.0,
                                        seed=inputs.mix(seed, SESSION_PART), device=device)

    def encode(self, condition: dict):
        return self.task.encode_cond(condition["context"], condition["pooled"],
                                     condition["size_ids"])

    def generate(self, condition: dict, noise_nhwc: torch.Tensor):
        """The window's call: (context, y), then ``predict`` from the given
        noise; latents (B, C, H, W) on the host."""
        return self.session.predict(self.encode(condition), uncond_scale=self.scale,
                                    noise=noise_nhwc)

    def warm(self, batch: int) -> None:
        """One UNet evaluation at the CFG batch."""
        x, t, context, y = eval_inputs(self.cfg, 2 * batch, self.device)
        with torch.inference_mode():
            self.task.apply_eps(x, t, (context, y))


# -- the reference ------------------------------------------------------------------


def reference_models(cfg, seed: int, device, precision: str = "fp32"):
    """The reference UNet with the seeded weights, built on the meta device
    and materialised on ``device``: no default initialisation of its 2.6 B
    parameters on the host."""
    unet = meta_unet(cfg).to_empty(device=device)
    unet.load_state_dict(unet_weights(cfg, seed, device), strict=True)
    return set_precision(unet, precision)


def reference_generate(cfg, traffic, seed: int, condition: dict, noise_nchw: torch.Tensor,
                       device, precision: str = "fp32", block: int = 2) -> torch.Tensor:
    """The reference's latents (B, C, H, W) for these conditions and start
    noise, in blocks of ``block`` rows, with TF32 off."""
    unet = reference_models(cfg, seed, device, precision)
    tab = ref_diffusion.schedule(cfg)
    out = []
    with torch.no_grad(), strict_fp32():
        for lo in range(0, noise_nchw.shape[0], block):
            rows = slice(lo, lo + block)
            context = condition["context"][rows].to(device).float()
            y = ref_unet.vector_condition(cfg, condition["pooled"][rows].to(device),
                                          condition["size_ids"][rows].to(device))
            out.append(ref_unet.generate(unet, tab, cfg, context, y, noise_nchw[rows],
                                         int(traffic["ddim_steps"]),
                                         float(traffic["cfg_scale"])))
    return torch.cat(out)

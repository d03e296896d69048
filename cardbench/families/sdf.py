"""The Polyffusion-SDF family (``sdf_chd8bar`` and its kin): how the
benchmark builds the program's generation session and training step from a
configuration file and seeded weights, and the same computations on the plain
reference. The program is ``polyffusion_tpu_torch``; the reference is
``cardbench/reference``."""

from __future__ import annotations

import numpy as np
import torch

from .. import inputs
from ..programs import PortTrain
from ..reference import chord_encoder as ref_chord
from ..reference import diffusion as ref_diffusion
from ..reference import sdf_unet as ref_unet
from ..reference.layers import set_precision
from ..reference.precision import strict_fp32

UNET_PART, ENC_PART = 10, 11


def _meta_models(cfg):
    with torch.device("meta"):
        return ref_unet.build(cfg), ref_chord.build(cfg)


def weights(cfg, seed: int, device):
    """The UNet's and the chord encoder's float32 state dicts, drawn on
    ``device`` from the seed, in the published names."""
    unet, enc = _meta_models(cfg)
    return (inputs.weights(unet, inputs.mix(seed, UNET_PART), device),
            inputs.weights(enc, inputs.mix(seed, ENC_PART), device))


def unet_weights(cfg, seed: int, device):
    return weights(cfg, seed, device)[0]


def eval_inputs(cfg, batch: int, device):
    """(x, t, cond) of one UNet evaluation at ``batch``."""
    x = torch.zeros(batch, cfg["in_channels"], cfg["img_h"], cfg["img_w"], device=device)
    t = torch.zeros(batch, dtype=torch.long, device=device)
    cond = torch.zeros(batch, 1, cfg["d_cond"], device=device)
    return x, t, cond


def meta_unet(cfg):
    return _meta_models(cfg)[0]


# -- the program ------------------------------------------------------------------


def _port_task(cfg, seed: int, device, training: bool):
    from polyffusion_tpu_torch.config import Params
    from polyffusion_tpu_torch.models.encoders import ChordEncoder
    from polyffusion_tpu_torch.tasks.sdf import SDFTask

    unet_sd, enc_sd = weights(cfg, seed, device)
    enc = ChordEncoder(cfg["chd_input_dim"], cfg["chd_hidden_dim"], cfg["chd_z_dim"])
    enc.load_state_dict(enc_sd, strict=True)
    task = SDFTask(Params(cfg), chord_enc=enc, device=device, training=training)
    task.load_unet_state(unet_sd)
    return task


class GenProgram:
    """The port's ``InferenceSession`` on seeded weights: DDIM with CFG."""

    def __init__(self, cfg, traffic, seed: int, device):
        from polyffusion_tpu_torch.inference import InferenceSession

        self.cfg, self.device = cfg, device
        self.scale = float(traffic["cfg_scale"])
        self.task = _port_task(cfg, seed, device, training=False)
        self.session = InferenceSession(self.task, use_ddim=True,
                                        ddim_steps=int(traffic["ddim_steps"]),
                                        ddim_eta=0.0, seed=inputs.mix(seed, 12), device=device)

    def encode(self, chords: np.ndarray) -> torch.Tensor:
        batch = (None, None, torch.from_numpy(chords), None)
        with torch.inference_mode():
            return self.task.encode_cond(batch)

    def generate(self, chords: np.ndarray, noise_nhwc: torch.Tensor) -> np.ndarray:
        """The window's call: condition, then ``predict`` from the given noise."""
        return self.session.predict(self.encode(chords), uncond_scale=self.scale,
                                    noise=noise_nhwc)

    def warm(self, batch: int) -> None:
        """The encoder at ``batch`` and one UNet evaluation at the CFG batch."""
        self.encode(np.zeros((batch, 32, self.cfg["chd_input_dim"]), np.float32))
        with torch.inference_mode():
            self.task.apply_eps(*eval_inputs(self.cfg, 2 * batch, self.device))


class TrainProgram(PortTrain):
    """The port's training step (``train/step.py``) on seeded fp32 weights."""

    def __init__(self, cfg, traffic, seed: int, device):
        from polyffusion_tpu_torch.train.state import create_state
        from polyffusion_tpu_torch.train.step import make_train_step

        self.task = _port_task(cfg, seed, device, training=True)
        self.state = create_state(self.task.model, float(cfg["learning_rate"]),
                                  float(cfg["max_grad_norm"]), bf16=self.task.bf16)
        self.step_fn = make_train_step(self.task)
        self.fields = self.task.used_batch_fields

    def noise(self, draws):
        from polyffusion_tpu_torch.tasks.sdf import StepNoise

        return StepNoise(draws["t"], draws["noise"], draws["drop"])


# -- the reference ------------------------------------------------------------------


def reference_models(cfg, seed: int, device, precision: str = "fp32"):
    unet, enc = ref_unet.build(cfg).to(device), ref_chord.build(cfg).to(device)
    unet_sd, enc_sd = weights(cfg, seed, device)
    unet.load_state_dict(unet_sd, strict=True)
    enc.load_state_dict(enc_sd, strict=True)
    return set_precision(unet, precision), set_precision(enc, precision)


def reference_generate(cfg, traffic, seed: int, chords: np.ndarray, noise_nchw: torch.Tensor,
                       device, precision: str = "fp32", block: int = 16) -> torch.Tensor:
    """The reference's samples (B, C, H, W) for these chords and start noise,
    in blocks of ``block`` rows, with TF32 off."""
    unet, enc = reference_models(cfg, seed, device, precision)
    tab = ref_diffusion.schedule(cfg)
    out = []
    with torch.no_grad(), strict_fp32():
        for lo in range(0, len(chords), block):
            cond = enc(torch.from_numpy(chords[lo:lo + block]).to(device))
            out.append(ref_diffusion.generate(unet, tab, cond, noise_nchw[lo:lo + block],
                                              int(traffic["ddim_steps"]),
                                              float(traffic["cfg_scale"])))
    return torch.cat(out)


def reference_condition(cfg, models, batch, draw) -> torch.Tensor:
    """The condition of a step's batch as the UNet gets it: the chord
    encoder's of the step's chords, all -1 where the step's CFG coin drops it
    (``cond_mode`` mix) or where the mode is unconditional."""
    _, enc = models
    mix = cfg.get("cond_mode") in ("mix", "mix2")
    with torch.no_grad():
        cond = enc(batch["chord"])
    if cfg.get("cond_mode") == "uncond" or (mix and bool(draw["drop"])):
        cond = -torch.ones_like(cond)
    return cond


def reference_step_loss(cfg, models, tab, batches, draws):
    """``step_loss(model, i, rows)`` of ``reference/train.py`` for this family:
    ``reference_condition`` of the step's rows, and the eps-MSE sum over
    them."""

    def step_loss(model, i, rows):
        b, d = batches[i], draws[i]
        cond = reference_condition(cfg, models, {"chord": b["chord"][rows]}, d)
        return ref_diffusion.loss(model, tab, b["prmat2c"][rows], cond, d["t"][rows],
                                  d["noise"][rows], reduction="sum")

    return step_loss

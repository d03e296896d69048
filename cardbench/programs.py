"""What a driver drives: the program's entry points as the configuration's
family builds them, or, with ``spec.control`` set to a precision, the plain
reference computed in that precision in the program's place (the control,
which the comparison that decides ``correct`` has to fail). The benchmark's
command never sets ``spec.control``; ``control.py`` and the tests do.

The train driver reads a training state through ``PortTrain``'s accessors,
which ``ReferenceTrain`` offers too."""

from __future__ import annotations

import numpy as np
import torch

from .reference import diffusion as ref_diffusion
from .reference import train as ref_train
from .reference.precision import strict_fp32


def image_shape(cfg):
    if "image_size_h" in cfg:
        return cfg["image_channels"], cfg["image_size_h"], cfg["image_size_w"]
    return cfg["in_channels"], cfg["img_h"], cfg["img_w"]


# -- the program ------------------------------------------------------------------


class PortTrain:
    """The accessors of the program's training state that the train driver
    reads; a family's ``TrainProgram`` sets ``task``, ``state``, ``step_fn``
    and ``fields``."""

    conditions = None

    @property
    def names(self):
        return [n for n, _ in self.task.model.named_parameters()]

    def step(self, batch, seed, noise):
        return self.step_fn(self.state, batch, seed, noise=noise)

    def first_moment(self):
        """Adam's first moment of each leaf (after step 1: (1 - b1) x the
        clipped gradient as the optimizer got it)."""
        adam = self.state.optimizer.adam.state
        return [adam[m]["exp_avg"] for m in self.state.weights.masters]

    def masters(self):
        return list(self.state.weights.masters)

    def working(self):
        """The parameters the forward and backward compute with."""
        return list(self.state.weights.working)

    def watch_conditions(self, on: bool) -> None:
        """Record the condition each step hands the UNet (``conditions``),
        or stop."""
        task = self.task
        task.__dict__.pop("encode_cond", None)
        self.conditions = None
        if not on or not hasattr(task, "encode_cond"):
            return
        self.conditions = []
        orig = task.encode_cond

        def recorded(*args, **kwargs):
            cond = orig(*args, **kwargs)
            self.conditions.append(cond.detach().float().clone())
            return cond

        task.encode_cond = recorded


def train_program(spec, seed: int, device):
    if spec.control:
        return ReferenceTrain(spec, seed, device, spec.control)
    return spec.family.TrainProgram(spec.config, spec.traffic, seed, device)


def gen_program(spec, seed: int, device):
    if spec.control:
        return ReferenceGen(spec, seed, device, spec.control)
    return spec.family.GenProgram(spec.config, spec.traffic, seed, device)


# -- the reference in the program's place ----------------------------------------------


class ReferenceGen:
    """``GenProgram``'s calls on the reference in ``precision``."""

    def __init__(self, spec, seed: int, device, precision: str):
        self.spec, self.seed, self.device, self.precision = spec, seed, device, precision

    def generate(self, chords: np.ndarray, noise_nhwc: torch.Tensor) -> np.ndarray:
        s = self.spec
        return s.family.reference_generate(s.config, s.traffic, self.seed, chords,
                                           noise_nhwc.permute(0, 3, 1, 2), self.device,
                                           self.precision).cpu().numpy()

    def warm(self, batch: int) -> None:
        pass


def serve_reference(spec, seed: int, device, worker) -> None:
    """The served worker's encoder and its session's ``predict`` become the
    reference in ``spec.control``'s precision; the start noise is drawn from
    the session's generator as the program draws it."""
    cfg, traffic = spec.config, spec.traffic
    unet, enc = spec.family.reference_models(cfg, seed, device, spec.control)
    tab = ref_diffusion.schedule(cfg)
    session = worker.session

    def encode(chord):
        with torch.no_grad(), strict_fp32():
            x = torch.as_tensor(np.asarray(chord), dtype=torch.float32, device=device)
            return enc(x).float().cpu().numpy()

    def predict(cond, cond_mid=None, uncond_scale=1.0, autoreg=False, **_):
        shape = (cond.shape[0], cfg["img_h"], cfg["img_w"], cfg["out_channels"])
        noise = torch.randn(shape, generator=session.generator, device=device)
        with torch.no_grad(), strict_fp32():
            c = torch.as_tensor(np.asarray(cond), dtype=torch.float32, device=device)
            x = ref_diffusion.generate(unet, tab, c, noise.permute(0, 3, 1, 2),
                                       int(traffic["ddim_steps"]), float(uncond_scale))
        return x.cpu().numpy()

    worker._encode = encode
    session.predict = predict


class ReferenceTrain:
    """``PortTrain``'s calls on the reference's step in ``precision``: the
    feeder's batch, the step's draws, the loss in blocks of rows, clip and
    Adam on float32 parameters, with TF32 off. Its working copy is its
    parameters in the types the configuration states."""

    def __init__(self, spec, seed: int, device, precision: str):
        cfg, fam = spec.config, spec.family
        self.cfg, self.fam, self.device = cfg, fam, device
        self.models = fam.reference_models(cfg, seed, device, precision)
        self.model = self.models[0]
        self.tab = ref_diffusion.schedule(cfg)
        self.names = [n for n, _ in self.model.named_parameters()]
        self.params = [p for _, p in self.model.named_parameters()]
        self.opt = ref_train.Adam([p.data for p in self.params], float(cfg["learning_rate"]),
                                  float(cfg["max_grad_norm"]))
        dtypes = ref_train.working_dtypes(self.model, cfg["precision"])
        self.dtypes = [dtypes[n] for n in self.names]
        self.block = int(spec.traffic["reference_block"])
        conditioned = hasattr(fam, "reference_condition")
        self.fields = {"prmat2c", "chord"} if conditioned else {"prmat2c"}
        self.conditions = None

    def noise(self, draws):
        return draws

    def step(self, batch, seed, noise):
        b = {"prmat2c": batch.prmat2c.float(), "chord": batch.chord.float()}
        rows = b["prmat2c"].shape[0]
        terms = rows * int(np.prod(image_shape(self.cfg)))
        step_loss = self.fam.reference_step_loss(self.cfg, self.models, self.tab, [b], [noise])
        with strict_fp32():
            if self.conditions is not None:
                with torch.no_grad():
                    self.conditions.append(
                        self.fam.reference_condition(self.cfg, self.models, b, noise))
            loss = ref_train.one_step(self.model, self.opt, step_loss, 0, rows, terms,
                                      self.block)
        return {"loss": torch.tensor(loss)}

    def first_moment(self):
        return list(self.opt.m)

    def masters(self):
        return [p.detach() for p in self.params]

    def working(self):
        return [p.detach().to(dt) for p, dt in zip(self.params, self.dtypes)]

    def watch_conditions(self, on: bool) -> None:
        self.conditions = [] if on and hasattr(self.fam, "reference_condition") else None

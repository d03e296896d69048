"""The distillation task (counterpart of ``polyffusion_tpu/tasks/distill.py``):
train a v-prediction student against a frozen teacher.

Two modes (``diffusion/progressive.py`` has the math and the papers):

- ``mode="guided"`` (stage A): the student's single pass regresses the
  teacher's classifier-free-guided epsilon at a fixed scale ``w``, at t drawn
  uniformly in [0, T): CFG's double batch folded into the weights.
- ``mode="halve"`` (stage B): on a fine tau grid, the student learns the x0
  whose one DDIM step equals the teacher's two; each phase halves the grid.

Both losses are the truncated-SNR-weighted x0-MSE (max(SNR, 1)), the weighting
progressive distillation needs so that the high-noise region still trains.

The student is the base task's UNet (``task.model``), trained by the usual
trainer (fp32 masters, a bf16 working copy where the preset is bf16). The
teacher is a separate frozen UNet that shares no parameter with it, cast for
sampling like any bf16 session, and run without gradients.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from ..data.loader import decompress_batch
from ..diffusion.progressive import (
    PhaseTables,
    ddim_jump,
    make_v_to_eps_apply,
    solve_x0_target,
    x0_from_v,
)
from ..diffusion.sampler import make_eps_fn
from ..models.unet import UNetModel
from ..utils.precision import cast_sampling_params
from .sdf import SDFTask

MODES = ("guided", "halve")
TEACHER_KINDS = ("eps_guided", "v")


class DistillNoise(NamedTuple):
    """One loss evaluation's randomness: ``index``, per sample the timestep t
    (guided) or the phase table's row j (halve), and the noise (NCHW)."""

    index: torch.Tensor
    noise: torch.Tensor


def _b(v: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, 1, 1)."""
    return v.view(-1, 1, 1, 1)


class DistillTask:
    """Wraps a base ``SDFTask`` built for training (its UNet, frozen condition
    encoders and schedule) and a frozen teacher.

    ``teacher_state``: the teacher's fp32 UNet state dict (reference names).
    ``teacher_kind``: "eps_guided", the original CFG teacher (eps, one double
    batch at ``guide_scale``, the unconditional condition -1s of the
    condition's shape), or "v", an already guided v-student of an earlier
    stage or phase (one pass). ``tables``: the halving phase's
    ``PhaseTables`` (padded or not) and ``m``, the rows drawn from (all of
    them by default)."""

    name = "distill"

    def __init__(self, base: SDFTask, teacher_state: Mapping[str, torch.Tensor],
                 guide_scale: float, mode: str, teacher_kind: str = "eps_guided",
                 tables: Optional[PhaseTables] = None, m: Optional[int] = None):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} is not one of {MODES}")
        if teacher_kind not in TEACHER_KINDS:
            raise ValueError(f"teacher_kind {teacher_kind!r} is not one of {TEACHER_KINDS}")
        if base.v_prediction:
            raise ValueError("the base task must be the eps-parameterized teacher config")
        if base.concat_blurry:
            raise NotImplementedError("distillation of concat_blurry models")
        if mode == "halve" and tables is None:
            raise ValueError("mode 'halve' needs the phase's tables")
        self.base = base
        self.device = base.device
        self.guide_scale = float(guide_scale)
        self.mode = mode
        self.teacher_kind = teacher_kind
        self.schedule = base.schedule
        self.teacher = self._frozen_teacher(teacher_state)
        self.m = None
        self.tables = None
        if tables is not None:
            self.m = tables.m if m is None else int(m)
            self.tables = PhaseTables(*(torch.from_numpy(v).to(self.device) for v in tables))

    def _frozen_teacher(self, state: Mapping[str, torch.Tensor]) -> UNetModel:
        teacher = self.base.make_unet()
        teacher.load_state_dict(state, strict=True)
        if self.base.bf16:
            cast_sampling_params(teacher)
        teacher.to(self.device).eval().requires_grad_(False)
        teacher.prepare_gn_conv()
        return teacher

    # -- the trainer's interface (the student is the base task's UNet) ----------

    @property
    def model(self) -> UNetModel:
        return self.base.unet

    @property
    def bf16(self) -> bool:
        return self.base.bf16

    @property
    def used_batch_fields(self):
        return self.base.used_batch_fields

    def draw_noise(self, batch, generator: torch.Generator, sched=None) -> DistillNoise:
        """Per sample t in [0, T) (guided) or the row j in [0, m) (halve), then
        the noise, from ``generator`` on its device (``sched`` steers
        nothing)."""
        shape = tuple(batch[0].shape)
        high = self.schedule.n_steps if self.mode == "guided" else self.m
        index = torch.randint(0, high, (shape[0],), generator=generator, device=generator.device)
        noise = torch.randn(shape, generator=generator, device=generator.device)
        return DistillNoise(index, noise)

    def _teacher_eps(self, cond: torch.Tensor):
        """eps(x, t, cond) of the frozen teacher."""
        if self.teacher_kind == "v":
            # already guided: one pass through the v->eps adapter
            return make_v_to_eps_apply(self.teacher, self.base._schedule_dev)
        return make_eps_fn(self.teacher, self.guide_scale, -torch.ones_like(cond))

    def loss_fn(self, batch, noise: DistillNoise) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The truncated-SNR-weighted x0-MSE of the student's v against the
        teacher's target, for the given draws."""
        batch = decompress_batch(batch)
        cond = self.base.encode_cond(batch)  # no CFG dropout: always guided
        x0 = batch[0].to(self.device, torch.float32)
        eps = noise.noise.to(self.device)
        index = noise.index.to(self.device)
        teacher_eps = self._teacher_eps(cond)
        with torch.no_grad():
            if self.mode == "guided":
                sch = self.base._schedule_dev
                t = index
                a_t, s_t = _b(sch.sqrt_alpha_bar[t]), _b(sch.sqrt_1m_alpha_bar[t])
                x_t = a_t * x0 + s_t * eps
                eps_g = teacher_eps(x_t, t, cond).to(x_t.dtype)
                x0_tgt = (x_t - s_t * eps_g) / a_t
                weight = torch.clamp(a_t**2 / s_t**2, min=1.0)
            else:
                tab, j = self.tables, index
                t = tab.tau[j]
                a_t, s_t = _b(tab.a_t[j]), _b(tab.s_t[j])
                a_m, s_m = _b(tab.a_m[j]), _b(tab.s_m[j])
                a_p, s_p = _b(tab.a_p[j]), _b(tab.s_p[j])
                x_t = a_t * x0 + s_t * eps
                # the teacher: two fine-grid DDIM(eta=0) steps
                e1 = teacher_eps(x_t, t, cond).to(x_t.dtype)
                x_mid = ddim_jump(x_t, e1, a_t, s_t, a_m, s_m)
                e2 = teacher_eps(x_mid, tab.tau_mid[j], cond).to(x_t.dtype)
                x_prev = ddim_jump(x_mid, e2, a_m, s_m, a_p, s_p)
                x0_tgt = solve_x0_target(x_t, x_prev, _b(tab.coef_xt[j]), _b(tab.denom[j]))
                weight = _b(tab.weight[j])
        v = self.base.apply_raw(x_t, t, cond).to(x_t.dtype)
        x0_pred = x0_from_v(x_t, v, a_t, s_t)
        loss = torch.mean(weight * (x0_pred - x0_tgt) ** 2)
        return loss, {"loss": loss}

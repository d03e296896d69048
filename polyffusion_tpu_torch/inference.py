"""Generation and inpainting (counterpart of ``polyffusion_tpu/inference.py``:
``get_mask`` and the DDIM path of ``InferenceSession``).

``predict`` keeps the JAX package's layouts: conditions (B, 1, d_cond), images
(B, 2, H, W) in and out, optional starting ``noise`` NHWC (B, H, W, C).
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .diffusion.sampler import ddim_paint, ddim_q_sample
from .diffusion.schedule import make_ddim_schedule
from .tasks.sdf import SDFTask
from .utils.midi_io import prmat2c_to_midi_file


def _forward_fill(vals: np.ndarray, empty_marker: int) -> np.ndarray:
    """Replace ``empty_marker`` entries with the previous valid value; leading
    entries take the first valid value."""
    valid = vals != empty_marker
    if not valid.any():
        return vals.copy()
    idx = np.maximum.accumulate(np.where(valid, np.arange(len(vals)), -1))
    idx = np.where(idx < 0, np.argmax(valid), idx)
    return vals[idx]


def get_mask(orig: np.ndarray, inpaint_type: str, bar_list=None) -> np.ndarray:
    """Inpainting masks over (B, 2, 128, 128); mask == 1 marks the *kept* region."""
    b, _, n_step, n_pitch = orig.shape
    if inpaint_type == "remaining":
        return orig.copy()
    if inpaint_type in ("below", "above"):
        onset = orig[:, 0].reshape(b * n_step, n_pitch)
        cols = np.arange(n_pitch)[None, :]
        if inpaint_type == "below":
            pitch = _forward_fill(onset.argmax(axis=1), 0)  # lowest sounding pitch
            mask2d = (cols >= pitch[:, None]).astype(np.float32)
        else:
            pitch = _forward_fill(n_pitch - 1 - onset[:, ::-1].argmax(axis=1), n_pitch - 1)
            mask2d = (cols <= pitch[:, None]).astype(np.float32)
        return np.broadcast_to(mask2d.reshape(b, 1, n_step, n_pitch), orig.shape).copy()
    if inpaint_type == "bars":
        if bar_list is None:
            raise ValueError("bars inpainting needs a bar_list")
        mask = np.ones_like(orig)
        for bar in bar_list:
            mask[:, :, bar * 16 : bar * 16 + 16, :] = 0
        return mask
    raise NotImplementedError(inpaint_type)


class InferenceSession:
    """A task plus the DDIM sampler, answering generate / inpaint requests."""

    def __init__(
        self,
        task: SDFTask,
        *,
        ddim_steps: int = 50,
        ddim_eta: float = 0.0,
        ddim_discretize: str = "uniform",
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        if self.device != task.device:
            raise ValueError(f"task lies on {task.device}, session asked for {self.device}")
        self.task = task
        self.cfg = task.cfg
        self.schedule = task.schedule
        self.ddim = make_ddim_schedule(self.schedule, ddim_steps, ddim_discretize, ddim_eta)
        self.ddim_label = f"ddim{ddim_steps}_eta{ddim_eta}_{ddim_discretize}"
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    @property
    def t_idx(self) -> int:
        return self.ddim.n_steps - 1

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32).to(self.device)

    def predict(
        self,
        cond,
        uncond_scale: float = 1.0,
        orig: Optional[np.ndarray] = None,
        mask: Optional[np.ndarray] = None,
        noise=None,
    ) -> np.ndarray:
        """Generate (or, with ``orig`` and ``mask``, inpaint) (B, 2, H, W) images.

        Starts from q_sample(orig, tau_last) and paints with ``mask`` (all zero
        for plain generation) under the same noise. ``noise``: optional explicit
        NHWC starting noise; drawn from the session's generator when omitted."""
        cond = self._tensor(cond)
        b = cond.shape[0]
        h, w, c = self.cfg.img_h, self.cfg.img_w, self.cfg.out_channels
        uncond_cond = -torch.ones((b, 1, self.cfg.d_cond), device=self.device)
        if orig is None or mask is None:
            orig = np.zeros((b, c, h, w), np.float32)
            mask = np.zeros_like(orig)
        orig_nhwc = self._tensor(orig).permute(0, 2, 3, 1)
        mask_nhwc = self._tensor(mask).permute(0, 2, 3, 1)
        if noise is None:
            noise = torch.randn((b, h, w, c), generator=self.generator, device=self.device)
        noise = self._tensor(noise)
        xt = ddim_q_sample(self.ddim, orig_nhwc, self.t_idx, noise)
        gen = ddim_paint(
            self.task.apply_eps,
            self.ddim,
            xt,
            cond,
            self.t_idx,
            self.generator,
            orig=orig_nhwc,
            mask=mask_nhwc,
            orig_noise=noise,
            uncond_scale=uncond_scale,
            uncond_cond=uncond_cond,
        )
        return gen.permute(0, 3, 1, 2).cpu().numpy()

    def _stamp(self, head: str, uncond_scale: float) -> str:
        return (
            f"{head}[scale={uncond_scale},{self.ddim_label}]"
            f"_{datetime.now().strftime('%y-%m-%d_%H%M%S')}"
        )

    def generate(
        self,
        cond,
        uncond_scale: float = 1.0,
        output_dir: Optional[str] = None,
        model_label: str = "sdf",
    ) -> np.ndarray:
        """(B, 2, H, W) prmat2c images; with ``output_dir``, also one .mid."""
        gen = self.predict(cond, uncond_scale)
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            path = os.path.join(output_dir, self._stamp(model_label, uncond_scale) + ".mid")
            prmat2c_to_midi_file(gen, path)
        return gen

    def inpaint(
        self,
        orig: np.ndarray,
        inpaint_type: str,
        cond,
        uncond_scale: float = 1.0,
        bar_list=None,
        output_dir: Optional[str] = None,
        model_label: str = "sdf",
    ):
        """Regenerate the region ``get_mask`` leaves free; returns (gen, mask)."""
        mask = get_mask(orig, inpaint_type, bar_list)
        gen = self.predict(cond, uncond_scale, orig, mask)
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            head = f"{model_label}_inp_{inpaint_type}"
            path = os.path.join(output_dir, self._stamp(head, uncond_scale) + ".mid")
            prmat2c_to_midi_file(gen, path, inp_mask=mask)
        return gen, mask

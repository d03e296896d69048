"""DDIM sampling with classifier-free guidance and mask-blend inpainting
(counterpart of the DDIM part of ``polyffusion_tpu/diffusion/sampler.py``).

The JAX package runs the loop as one ``lax.scan``; here it is a Python loop over
the reversed tau grid, each per-step coefficient taken from the float32 NumPy
tables on the host. The public functions take and return NHWC tensors, as the
JAX ones do; the UNet sees NCHW.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .schedule import DDIMSchedule

EpsFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]  # (x NCHW, t, cond)


def make_eps_fn(apply_fn: EpsFn, uncond_scale: float = 1.0, uncond_cond: Optional[torch.Tensor] = None):
    """Classifier-free-guidance epsilon. s == 1 (or no uncond condition) runs
    one conditional pass, s == 0 one unconditional pass; any other scale runs
    ONE double batch [uncond, cond] and returns e_u + s * (e_c - e_u)."""

    def eps(x, t, cond):
        if uncond_cond is None or uncond_scale == 1.0:
            return apply_fn(x, t, cond)
        if uncond_scale == 0.0:
            return apply_fn(x, t, uncond_cond)
        e = apply_fn(torch.cat([x, x]), torch.cat([t, t]), torch.cat([uncond_cond, cond]))
        e_uncond, e_cond = e.chunk(2)
        return e_uncond + uncond_scale * (e_cond - e_uncond)

    return eps


def _f(a) -> float:
    """A float32 table value as the Python float that torch multiplies by."""
    return float(np.float32(a))


def _ddim_step(dd: DDIMSchedule, eps_fn, x, cond, step: int, index: int, noise):
    """One DDIM update on NCHW ``x``; ``noise`` is only read when sigma > 0."""
    ts = torch.full((x.shape[0],), int(step), dtype=torch.int32, device=x.device)
    e_t = eps_fn(x, ts, cond).to(x.dtype)
    one = np.float32(1.0)
    alpha, alpha_prev, sigma = dd.alpha[index], dd.alpha_prev[index], dd.sigma[index]
    pred_x0 = (x - _f(dd.sqrt_one_minus_alpha[index]) * e_t) / _f(np.sqrt(alpha))
    x_prev = _f(np.sqrt(alpha_prev)) * pred_x0 + _f(np.sqrt(one - alpha_prev - sigma * sigma)) * e_t
    if sigma != 0.0:
        x_prev = x_prev + _f(sigma) * noise()
    return x_prev


def ddim_q_sample(dd: DDIMSchedule, x0: torch.Tensor, index: int, noise: torch.Tensor) -> torch.Tensor:
    """q_sample at DDIM index (any layout)."""
    return _f(dd.alpha_sqrt[index]) * x0 + _f(dd.sqrt_one_minus_alpha[index]) * noise


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _step_noise(noise_override, k: int, shape, generator, device):
    if noise_override is not None:
        return lambda: _nchw(noise_override[k])
    return lambda: torch.randn(shape, generator=generator, device=device)


@torch.inference_mode()
def ddim_sample(
    apply_fn: EpsFn,
    dd: DDIMSchedule,
    x_last: torch.Tensor,
    cond: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    uncond_scale: float = 1.0,
    uncond_cond: Optional[torch.Tensor] = None,
    t_start: int = 0,
    noise_override: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """DDIM sampling over the reversed tau grid, skipping the first ``t_start``
    steps. ``noise_override``: (S, B, H, W, C) per-step noises for replay."""
    eps_fn = make_eps_fn(apply_fn, uncond_scale, uncond_cond)
    n = dd.n_steps
    x = _nchw(x_last)
    steps = dd.time_steps[::-1][t_start:]
    indices = range(n - 1 - t_start, -1, -1)
    for k, (step, index) in enumerate(zip(steps, indices)):
        noise = _step_noise(noise_override, k, x.shape, generator, x.device)
        x = _ddim_step(dd, eps_fn, x, cond, step, index, noise)
    return _nhwc(x).contiguous()


@torch.inference_mode()
def ddim_paint(
    apply_fn: EpsFn,
    dd: DDIMSchedule,
    x: torch.Tensor,
    cond: torch.Tensor,
    t_start: int,
    generator: Optional[torch.Generator] = None,
    *,
    orig: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    orig_noise: Optional[torch.Tensor] = None,
    uncond_scale: float = 1.0,
    uncond_cond: Optional[torch.Tensor] = None,
    noise_override: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mask-blend DDIM inpainting from tau_{t_start} down to tau_1, NHWC in and
    out: after each update the known region (mask == 1) is replaced with
    ``q_sample(orig, index)`` under the fixed ``orig_noise``. With ``orig is
    None`` this is plain conditional generation."""
    eps_fn = make_eps_fn(apply_fn, uncond_scale, uncond_cond)
    xc = _nchw(x)
    masked = orig is not None
    if masked:
        if mask is None:
            raise ValueError("ddim_paint: orig needs a mask")
        if orig_noise is None:
            orig_noise = torch.randn(orig.shape, generator=generator, device=orig.device)
        orig, mask, orig_noise = _nchw(orig), _nchw(mask), _nchw(orig_noise)
    steps = dd.time_steps[: t_start + 1][::-1]
    n = len(steps)
    for k, (step, index) in enumerate(zip(steps, range(n - 1, -1, -1))):
        noise = _step_noise(noise_override, k, xc.shape, generator, xc.device)
        xc = _ddim_step(dd, eps_fn, xc, cond, step, index, noise)
        if masked:
            orig_t = ddim_q_sample(dd, orig, index, orig_noise)
            xc = orig_t * mask + xc * (1.0 - mask)
    return _nhwc(xc).contiguous()

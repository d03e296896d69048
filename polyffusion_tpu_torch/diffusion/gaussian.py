"""Forward (q) process and the simplified diffusion training loss (counterpart
of ``polyffusion_tpu/diffusion/gaussian.py``).

Semantics follow the reference ``LatentDiffusion`` (``stable_diffusion/
latent_diffusion.py:149-240``): per-sample uniform t, q_sample, eps-prediction
MSE. The JAX ``diffusion_loss`` draws t and the noise from its key inside; here
they are arguments (``draw_t_noise`` draws them from a ``torch.Generator``), so
that a test can hand both packages the same ones. Images are NCHW; a schedule's
tables may be NumPy arrays or tensors already on the image's device.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .schedule import NoiseSchedule

ApplyFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]  # (x, t, cond) -> eps


def _table(a, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(a, device=device)


def q_sample(
    schedule: NoiseSchedule, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor
) -> torch.Tensor:
    """Sample x_t ~ q(x_t | x_0) with per-sample timesteps ``t`` (B,)."""
    shape = (-1,) + (1,) * (x0.dim() - 1)
    sab = _table(schedule.sqrt_alpha_bar, x0.device)[t].view(shape)
    s1m = _table(schedule.sqrt_1m_alpha_bar, x0.device)[t].view(shape)
    return sab * x0 + s1m * noise


def q_sample_step(
    schedule: NoiseSchedule, x0: torch.Tensor, step: int, noise: torch.Tensor
) -> torch.Tensor:
    """q_sample at a single scalar step index (SDFSampler.q_sample, sampler_sdf.py:173-192)."""
    sab = _table(schedule.sqrt_alpha_bar, x0.device)[step]
    s1m = _table(schedule.sqrt_1m_alpha_bar, x0.device)[step]
    return sab * x0 + s1m * noise


def draw_t_noise(
    n_steps: int, shape: Tuple[int, ...], generator: torch.Generator
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample t uniform in [0, n_steps) and fp32 standard normal noise of
    ``shape``, both drawn on the generator's device."""
    t = torch.randint(0, n_steps, (shape[0],), generator=generator, device=generator.device)
    noise = torch.randn(shape, generator=generator, device=generator.device)
    return t, noise


def diffusion_loss(
    apply_fn: ApplyFn,
    schedule: NoiseSchedule,
    x0: torch.Tensor,
    cond: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
    cond_concat: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Simplified eps-MSE loss (latent_diffusion.py:203-240). ``cond_concat``
    (extra input channels, NCHW) is concatenated to x_t before the net."""
    xt = q_sample(schedule, x0, t, noise)
    if cond_concat is not None:
        xt = torch.cat([xt, cond_concat.to(xt.dtype)], dim=1)
    eps_theta = apply_fn(xt, t, cond)
    return torch.mean((noise - eps_theta.to(noise.dtype)) ** 2)

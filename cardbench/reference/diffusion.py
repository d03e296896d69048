"""Noise schedules, the eps-MSE loss and DDIM sampling with classifier-free
guidance, plain PyTorch in float32 (Polyffusion's ``stable_diffusion``
``latent_diffusion.py`` and ``sampler/ddim.py``, labml's ``ddpm``).

``generate`` is the program's generation entry as the published sampler
defines it: the start is ``q_sample`` of an all-zero image at the last tau
under the given noise, then DDIM with eta 0 down the uniform tau grid
(``arange(0, T, T // S) + 1``); each eps is e_u + s (e_c - e_u), where the
unconditional condition is all -1.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


class Tables(NamedTuple):
    alpha_bar: torch.Tensor  # (T,) float32


def schedule(cfg) -> Tables:
    """alpha_bar of the configuration's schedule: ``linear_sqrt`` (the
    latent-diffusion betas, linspace of square roots, squared, in float64) or
    ``linear`` (the DDPM baseline's linspace(1e-4, 0.02))."""
    n = cfg["n_steps"]
    if cfg.get("schedule", "linear_sqrt") == "linear":
        beta = np.linspace(1e-4, 0.02, n, dtype=np.float64)
    else:
        beta = np.linspace(cfg["linear_start"] ** 0.5, cfg["linear_end"] ** 0.5, n,
                           dtype=np.float64) ** 2
    return Tables(torch.from_numpy(np.cumprod(1.0 - beta).astype(np.float32)))


def q_sample(tab: Tables, x0, t, noise):
    ab = tab.alpha_bar.to(x0.device)[t].view(-1, 1, 1, 1)
    return ab.sqrt() * x0 + (1.0 - ab).sqrt() * noise


def loss(eps_model: Callable, tab: Tables, x0, cond, t, noise, reduction="mean"):
    """The simplified objective: mean of (noise - eps(q_sample(x0, t), t))^2;
    with ``reduction="sum"`` the sum (for a mean taken over blocks of rows)."""
    err = (noise - eps_model(q_sample(tab, x0, t, noise), t, cond)) ** 2
    return err.sum() if reduction == "sum" else err.mean()


def ddim_tables(tab: Tables, n_ddim: int):
    n = tab.alpha_bar.shape[0]
    steps = np.arange(0, n, n // n_ddim) + 1
    ab = tab.alpha_bar.numpy()
    alpha = ab[steps]
    alpha_prev = np.concatenate([ab[:1], ab[steps[:-1]]])
    return steps, alpha, alpha_prev


@torch.no_grad()
def generate(eps_model: Callable, tab: Tables, cond, noise, n_ddim: int, scale: float):
    """DDIM (eta 0) with CFG from ``noise`` (B, C, H, W) under ``cond``
    (B, 1, d); returns the last x (B, C, H, W)."""
    steps, alpha, alpha_prev = ddim_tables(tab, n_ddim)
    last = len(steps) - 1
    x = float(np.sqrt(1.0 - alpha[last])) * noise
    uncond = -torch.ones_like(cond)
    for i in range(last, -1, -1):
        t = torch.full((x.shape[0],), int(steps[i]), dtype=torch.long, device=x.device)
        e = eps_model(torch.cat([x, x]), torch.cat([t, t]), torch.cat([uncond, cond]))
        e_u, e_c = e.float().chunk(2)
        e = e_u + scale * (e_c - e_u)
        pred_x0 = (x - float(np.sqrt(1.0 - alpha[i])) * e) / float(np.sqrt(alpha[i]))
        x = float(np.sqrt(alpha_prev[i])) * pred_x0 + float(np.sqrt(1.0 - alpha_prev[i])) * e
    return x

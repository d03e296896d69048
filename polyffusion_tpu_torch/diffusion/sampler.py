"""DDPM ancestral sampling with RePaint inpainting, DDIM, and DPM-Solver++,
with classifier-free guidance (counterpart of
``polyffusion_tpu/diffusion/sampler.py``).

The JAX package runs each loop as one ``lax.scan``; here it is a Python loop
over the steps, each per-step coefficient taken from the float32 NumPy tables
on the host, so that no step waits for the card. The public functions take and
return NHWC tensors, as the JAX ones do; the UNet sees NCHW. On a CUDA tensor
the masked DDPM body's post-eps update is the RePaint epilogue kernel
(``ops/repaint_epilogue.py``); on a CPU tensor its plain version.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..ops.repaint_epilogue import fused_repaint_epilogue
from .schedule import DDIMSchedule, NoiseSchedule

EpsFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]  # (x NCHW, t, cond)


def make_eps_fn(apply_fn: EpsFn, uncond_scale: float = 1.0,
                uncond_cond: Optional[torch.Tensor] = None, cfg_fork: bool = False):
    """Classifier-free-guidance epsilon ``eps(x, t, cond, cond_concat=None)``
    on NCHW ``x``. s == 1 (or no uncond condition) runs one conditional pass,
    s == 0 one unconditional pass; any other scale runs ONE double batch
    [uncond, cond] and returns e_u + s * (e_c - e_u). ``cond_concat`` (extra
    input channels, NCHW) is concatenated to the net's input on the channel
    axis, repeated over the double batch.

    ``cfg_fork`` (JAX's ``POLYFF_CFG_FORK=1``): where ``apply_fn`` advertises
    ``supports_cfg_fork`` (``SDFTask.apply_eps``; a distilled student's
    v-adapter does not), the double batch is forked inside the net instead:
    ``x``, ``t`` and ``cond_concat`` at batch B, the condition at 2B, and the
    net duplicates its activations before its first cross-attention (the
    UNet's ``cfg_fork``). The same function up to float reassociation.

    A condition may be a tuple of tensors (SDXL's (context, y):
    ``tasks/sdxl.py``), as may ``uncond_cond``; the double batch stacks each
    part."""
    fork = cfg_fork and getattr(apply_fn, "supports_cfg_fork", False)

    def run(x, t, cond, cond_concat):
        if cond_concat is not None:
            rep = x.shape[0] // cond_concat.shape[0]
            cat = torch.cat([cond_concat] * rep) if rep > 1 else cond_concat
            x = torch.cat([x, cat.to(x.dtype)], dim=1)
        return apply_fn(x, t, cond)

    def eps(x, t, cond, cond_concat=None):
        if uncond_cond is None or uncond_scale == 1.0:
            return run(x, t, cond, cond_concat)
        if uncond_scale == 0.0:
            return run(x, t, uncond_cond, cond_concat)
        c_in = (tuple(torch.cat(parts) for parts in zip(uncond_cond, cond))
                if isinstance(cond, tuple) else torch.cat([uncond_cond, cond]))
        if fork:
            if cond_concat is not None:
                x = torch.cat([x, cond_concat.to(x.dtype)], dim=1)
            e = apply_fn(x, t, c_in, cfg_fork=True)
        else:
            e = run(torch.cat([x, x]), torch.cat([t, t]), c_in, cond_concat)
        e_uncond, e_cond = e.chunk(2)
        return e_uncond + uncond_scale * (e_cond - e_uncond)

    return eps


def _f(a) -> float:
    """A float32 table value as the Python float that torch multiplies by."""
    return float(np.float32(a))


def _timesteps(x: torch.Tensor, step: int) -> torch.Tensor:
    return torch.full((x.shape[0],), int(step), dtype=torch.int32, device=x.device)


def _ddim_step(dd: DDIMSchedule, eps_fn, x, cond, step: int, index: int, noise, cond_concat=None):
    """One DDIM update on NCHW ``x``; ``noise`` is only read when sigma > 0."""
    e_t = eps_fn(x, _timesteps(x, step), cond, cond_concat).to(x.dtype)
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


def _nchw_or_none(x):
    return None if x is None else _nchw(x)


def _step_noise(noise_override, k: int, shape, generator, device):
    if noise_override is not None:
        return lambda: _nchw(noise_override[k])
    return lambda: torch.randn(shape, generator=generator, device=device)


def _ddpm_step(sch: NoiseSchedule, eps_fn, x, cond, step: int, noise, cond_concat=None):
    """One ancestral step x_t -> x_{t-1} on NCHW ``x`` (SDFSampler.p_sample);
    ``noise`` is only read when step > 0."""
    e_t = eps_fn(x, _timesteps(x, step), cond, cond_concat).to(x.dtype)
    x0 = _f(sch.sqrt_recip_alpha_bar[step]) * x - _f(sch.sqrt_recip_m1_alpha_bar[step]) * e_t
    mean = _f(sch.mean_x0_coef[step]) * x0 + _f(sch.mean_xt_coef[step]) * x
    if step == 0:
        return mean
    return mean + _f(np.exp(np.float32(0.5) * sch.log_var[step])) * noise()


def ddpm_sample(
    apply_fn: EpsFn,
    schedule: NoiseSchedule,
    x_last: torch.Tensor,
    cond: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    uncond_scale: float = 1.0,
    uncond_cond: Optional[torch.Tensor] = None,
    cfg_fork: bool = False,
    t_start: int = 0,
    noise_override: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full ancestral DDPM sampling from step T-1-t_start down to 0, NHWC in
    and out. ``noise_override``: (S, B, H, W, C) per-step noises for replay."""
    return ddpm_paint(
        apply_fn, schedule, x_last, cond, schedule.n_steps - 1 - t_start, generator,
        uncond_scale=uncond_scale, uncond_cond=uncond_cond, cfg_fork=cfg_fork,
        noise_override=noise_override,
    )


def _epilogue_scalars(sch: NoiseSchedule, step: int):
    """The epilogue's a..g at ``step``; e and g are 0 at step 0, where the
    ancestral step and the known region take no noise."""
    return (
        _f(sch.sqrt_recip_alpha_bar[step]),
        _f(sch.sqrt_recip_m1_alpha_bar[step]),
        _f(sch.mean_x0_coef[step]),
        _f(sch.mean_xt_coef[step]),
        _f(np.exp(np.float32(0.5) * sch.log_var[step])) if step > 0 else 0.0,
        _f(sch.sqrt_alpha_bar[step]),
        _f(sch.sqrt_1m_alpha_bar[step]) if step > 0 else 0.0,
    )


@torch.inference_mode()
def ddpm_paint(
    apply_fn: EpsFn,
    schedule: NoiseSchedule,
    x: torch.Tensor,
    cond: torch.Tensor,
    t_start: int,
    generator: Optional[torch.Generator] = None,
    *,
    orig: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    uncond_scale: float = 1.0,
    uncond_cond: Optional[torch.Tensor] = None,
    cfg_fork: bool = False,
    cond_concat: Optional[torch.Tensor] = None,
    repaint_n: int = 1,
    noise_override: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """RePaint inpainting from step ``t_start`` down to 0 (SDFSampler.paint),
    NHWC in and out; ``cond_concat`` (NHWC) is the net's extra input channels.

    Per step, ``repaint_n`` times: the ancestral update of the unknown region
    and ``q_sample(orig, step)`` of the known one (mask == 1), blended by the
    epilogue; between inner iterations a one-step re-noise back,
    ``sqrt(1 - beta) x + beta * noise`` (the reference's beta, not sqrt(beta)).
    With ``orig is None`` this is plain conditional generation from ``x``.
    ``noise_override``: (S, B, H, W, C) noises when ``orig is None``, else
    (S, repaint_n, 3, B, H, W, C) noises [q, p, renoise]."""
    eps_fn = make_eps_fn(apply_fn, uncond_scale, uncond_cond, cfg_fork)
    cc = _nchw_or_none(cond_concat)
    steps = range(t_start, -1, -1)
    if orig is None:
        xc = _nchw(x)
        for k, step in enumerate(steps):
            noise = _step_noise(noise_override, k, xc.shape, generator, xc.device)
            xc = _ddpm_step(schedule, eps_fn, xc, cond, step, noise, cc)
        return _nhwc(xc).contiguous()

    if mask is None:
        raise ValueError("ddpm_paint: orig needs a mask")
    # the epilogue reads raw pointers: every operand contiguous NCHW, once
    xc, orig, mask = (_nchw(v).contiguous() for v in (x, orig, mask))
    nshape = (repaint_n, 3, *xc.shape)
    for k, step in enumerate(steps):
        if noise_override is None:
            nz = torch.randn(nshape, generator=generator, device=xc.device, dtype=xc.dtype)
        else:
            nz = noise_override[k].permute(0, 1, 2, 5, 3, 4).contiguous()
        scalars = _epilogue_scalars(schedule, step)
        ts = _timesteps(xc, step)
        for u in range(repaint_n):
            e_t = eps_fn(xc, ts, cond, cc).to(xc.dtype).contiguous()
            x_out = fused_repaint_epilogue(xc, e_t, nz[u, 1], orig, nz[u, 0], mask, scalars)
            if u < repaint_n - 1 and step > 0:
                beta = schedule.beta[step - 1]
                xc = _f((np.float32(1.0) - beta) ** np.float32(0.5)) * x_out + _f(beta) * nz[u, 2]
            else:
                xc = x_out
    return _nhwc(xc).contiguous()


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
    cfg_fork: bool = False,
    t_start: int = 0,
    noise_override: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """DDIM sampling over the reversed tau grid, skipping the first ``t_start``
    steps. ``noise_override``: (S, B, H, W, C) per-step noises for replay."""
    eps_fn = make_eps_fn(apply_fn, uncond_scale, uncond_cond, cfg_fork)
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
    cfg_fork: bool = False,
    cond_concat: Optional[torch.Tensor] = None,
    noise_override: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mask-blend DDIM inpainting from tau_{t_start} down to tau_1, NHWC in and
    out: after each update the known region (mask == 1) is replaced with
    ``q_sample(orig, index)`` under the fixed ``orig_noise``. With ``orig is
    None`` this is plain conditional generation. ``cond_concat`` (NHWC): the
    net's extra input channels."""
    eps_fn = make_eps_fn(apply_fn, uncond_scale, uncond_cond, cfg_fork)
    cc = _nchw_or_none(cond_concat)
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
        xc = _ddim_step(dd, eps_fn, xc, cond, step, index, noise, cc)
        if masked:
            orig_t = ddim_q_sample(dd, orig, index, orig_noise)
            xc = orig_t * mask + xc * (1.0 - mask)
    return _nhwc(xc).contiguous()


def _dpmpp_tables(dd: DDIMSchedule):
    """Per-index (a, s, a_prev, s_prev, h), float32, from lambda-space in
    float64 on the host: a = sqrt(alpha_bar), s = sqrt(1 - alpha_bar),
    h = lambda_prev - lambda with lambda = log(a / s)."""
    a2 = dd.alpha.astype(np.float64)
    ap2 = dd.alpha_prev.astype(np.float64)
    a_t, s_t = np.sqrt(a2), np.sqrt(1.0 - a2)
    a_p, s_p = np.sqrt(ap2), np.sqrt(1.0 - ap2)
    h_t = np.log(a_p / s_p) - np.log(a_t / s_t)
    return tuple(v.astype(np.float32) for v in (a_t, s_t, a_p, s_p, h_t))


@torch.inference_mode()
def dpmpp_paint(
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
    cfg_fork: bool = False,
    cond_concat: Optional[torch.Tensor] = None,
    order: int = 2,
) -> torch.Tensor:
    """DPM-Solver++ multistep ODE sampling (Lu et al., arXiv:2211.01095,
    "2M") over the DDIM tau grid from tau_{t_start} down, NHWC in and out.

    One transition is ``x <- (s_prev / s) x - a_prev expm1(-h) D``, where D is
    the x0 prediction (``order`` 1, the DDIM eta = 0 update) or, from the
    second transition on, ``(1 + 1/(2r)) x0 - 1/(2r) x0_prev`` with
    r = h_prev / h (``order`` 2). Deterministic: ``generator`` only draws
    ``orig_noise`` when a mask is given without one. Masked inpainting blends
    in ``q_sample(orig, index)`` under the fixed ``orig_noise`` after each
    transition, as ``ddim_paint`` does; the x0 history follows the blended
    trajectory. ``cond_concat`` (NHWC): the net's extra input channels."""
    if order not in (1, 2):
        raise ValueError(f"dpmpp order must be 1 or 2, got {order}")
    eps_fn = make_eps_fn(apply_fn, uncond_scale, uncond_cond, cfg_fork)
    cc = _nchw_or_none(cond_concat)
    a_t, s_t, a_p, s_p, h_t = _dpmpp_tables(dd)
    xc = _nchw(x)
    masked = orig is not None
    if masked:
        if mask is None:
            raise ValueError("dpmpp_paint: orig needs a mask")
        if orig_noise is None:
            orig_noise = torch.randn(orig.shape, generator=generator, device=orig.device)
        orig, mask, orig_noise = _nchw(orig), _nchw(mask), _nchw(orig_noise)
    steps = dd.time_steps[: t_start + 1][::-1]
    n = len(steps)
    x0_prev, h_prev = None, None
    for k, (step, index) in enumerate(zip(steps, range(n - 1, -1, -1))):
        e_t = eps_fn(xc, _timesteps(xc, step), cond, cc).to(xc.dtype)
        x0 = (xc - _f(s_t[index]) * e_t) / _f(a_t[index])
        h = h_t[index]
        if order == 2 and k > 0:
            c = np.float32(0.5) / (h_prev / h)
            d = _f(np.float32(1.0) + c) * x0 - _f(c) * x0_prev
        else:
            d = x0
        xc = _f(s_p[index] / s_t[index]) * xc - _f(a_p[index] * np.expm1(-h)) * d
        if masked:
            orig_t = ddim_q_sample(dd, orig, index, orig_noise)
            xc = orig_t * mask + xc * (1.0 - mask)
        x0_prev, h_prev = x0, h
    return _nhwc(xc).contiguous()


def dpmpp_sample(
    apply_fn: EpsFn,
    dd: DDIMSchedule,
    x_last: torch.Tensor,
    cond: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    uncond_scale: float = 1.0,
    uncond_cond: Optional[torch.Tensor] = None,
    cfg_fork: bool = False,
    t_start: int = 0,
    order: int = 2,
) -> torch.Tensor:
    """Plain DPM-Solver++ generation over the reversed tau grid; ``t_start``
    skips leading transitions as in ``ddim_sample``."""
    return dpmpp_paint(
        apply_fn, dd, x_last, cond, dd.n_steps - 1 - t_start, generator,
        uncond_scale=uncond_scale, uncond_cond=uncond_cond, cfg_fork=cfg_fork, order=order,
    )

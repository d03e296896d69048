"""Diffusion noise schedules and precomputed sampler tables (a NumPy copy of the
JAX package's ``diffusion/schedule.py``; the tables are equal bit for bit).

All tables are computed on host in NumPy float64 and cast to float32, bit-matching
the reference's torch float64 pipeline (``stable_diffusion/latent_diffusion.py:90-103``,
``sampler_sdf.py:52-78``, ``sampler_ddim.py:63-102``).  The samplers read each
per-step coefficient from them on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class NoiseSchedule(NamedTuple):
    """Linear-sqrt beta schedule + DDPM ancestral-sampler tables, all (T,) float32."""

    beta: np.ndarray
    alpha: np.ndarray
    alpha_bar: np.ndarray
    # q(x_t | x_0)
    sqrt_alpha_bar: np.ndarray
    sqrt_1m_alpha_bar: np.ndarray
    # x0 reconstruction from eps
    sqrt_recip_alpha_bar: np.ndarray
    sqrt_recip_m1_alpha_bar: np.ndarray
    # posterior q(x_{t-1} | x_t, x_0)
    log_var: np.ndarray  # log of clamped posterior variance
    mean_x0_coef: np.ndarray
    mean_xt_coef: np.ndarray

    @property
    def n_steps(self) -> int:
        return int(self.beta.shape[0])


def linear_sqrt_betas(
    n_steps: int = 1000, linear_start: float = 0.00085, linear_end: float = 0.012
) -> np.ndarray:
    """``beta = linspace(sqrt(start), sqrt(end), T; float64) ** 2`` (reference :90-95)."""
    return (
        np.linspace(linear_start**0.5, linear_end**0.5, n_steps, dtype=np.float64) ** 2
    )


def linear_betas(
    n_steps: int = 1000, beta_start: float = 1e-4, beta_end: float = 0.02
) -> np.ndarray:
    """Plain linear schedule used by the unconditional DDPM stack (``ddpm/__init__.py:25``)."""
    return np.linspace(beta_start, beta_end, n_steps, dtype=np.float64)


def make_schedule(
    n_steps: int = 1000,
    linear_start: float = 0.00085,
    linear_end: float = 0.012,
    kind: str = "linear_sqrt",
) -> NoiseSchedule:
    if kind == "linear_sqrt":
        beta64 = linear_sqrt_betas(n_steps, linear_start, linear_end)
    elif kind == "linear":
        beta64 = linear_betas(n_steps, linear_start, linear_end)
    else:
        raise ValueError(f"unknown schedule kind: {kind}")

    alpha64 = 1.0 - beta64
    alpha_bar64 = np.cumprod(alpha64)

    # Cast the *base* tables first, then derive sampler tables from the float32
    # values — exactly the reference order of operations (float32 nn.Parameters in
    # latent_diffusion.py:100-102; sampler_sdf.py derives from those at :52-78).
    beta = beta64.astype(np.float32)
    alpha = alpha64.astype(np.float32)
    alpha_bar = alpha_bar64.astype(np.float32)

    # Derived tables: float32 arithmetic over the float32 base tables, mirroring the
    # reference's torch ops exactly (sampler_sdf.py:52-78) — trajectory parity beats
    # extra precision here.  pow rounding may differ from torch by <= 1 ulp
    # (verified in tests/test_schedule.py).
    one = np.float32(1.0)
    alpha_bar_prev = np.concatenate([np.ones(1, np.float32), alpha_bar[:-1]])
    variance = beta * (one - alpha_bar_prev) / (one - alpha_bar)

    return NoiseSchedule(
        beta=beta,
        alpha=alpha,
        alpha_bar=alpha_bar,
        sqrt_alpha_bar=alpha_bar**0.5,
        sqrt_1m_alpha_bar=(one - alpha_bar) ** 0.5,
        sqrt_recip_alpha_bar=alpha_bar**-0.5,
        sqrt_recip_m1_alpha_bar=(one / alpha_bar - one) ** 0.5,
        log_var=np.log(np.clip(variance, np.float32(1e-20), None)),
        mean_x0_coef=beta * (alpha_bar_prev**0.5) / (one - alpha_bar),
        mean_xt_coef=(one - alpha_bar_prev) * ((one - beta) ** 0.5) / (one - alpha_bar),
    )


class DDIMSchedule(NamedTuple):
    """DDIM tau-subsequence tables (reference ``sampler_ddim.py:63-102``).

    ``time_steps`` are the tau values in *ascending* order; samplers iterate them in
    reverse.  All arrays are (S,) float32 except ``time_steps`` (int32).
    """

    time_steps: np.ndarray
    alpha: np.ndarray
    alpha_sqrt: np.ndarray
    alpha_prev: np.ndarray
    sigma: np.ndarray
    sqrt_one_minus_alpha: np.ndarray

    @property
    def n_steps(self) -> int:
        return int(self.time_steps.shape[0])


def make_ddim_schedule(
    schedule: NoiseSchedule,
    n_ddim_steps: int = 50,
    discretize: str = "uniform",
    eta: float = 0.0,
    time_steps=None,
) -> DDIMSchedule:
    """``time_steps``: optional EXPLICIT ascending tau grid (overrides
    ``n_ddim_steps``/``discretize``) — progressively-distilled students must be
    sampled on exactly the grid they were distilled onto (``distill_grid`` in
    their run's params.yaml; diffusion/progressive.py)."""
    n_steps = schedule.n_steps
    if time_steps is not None:
        time_steps = np.asarray(time_steps, np.int64)
        assert time_steps.ndim == 1 and (np.diff(time_steps) > 0).all()
        assert 0 <= time_steps[0] and time_steps[-1] < n_steps
    elif discretize == "uniform":
        c = n_steps // n_ddim_steps
        time_steps = np.arange(0, n_steps, c, dtype=np.int64) + 1
    elif discretize == "quad":
        time_steps = (
            np.linspace(0, np.sqrt(n_steps * 0.8), n_ddim_steps) ** 2
        ).astype(np.int64) + 1
    else:
        raise NotImplementedError(discretize)

    alpha_bar = schedule.alpha_bar
    # NOTE reference quirk kept for trajectory parity: tau values are offset by +1,
    # so the last tau can equal T and would index out of bounds; torch gather of
    # alpha_bar[time_steps] relies on time_steps < T, which holds for the default
    # uniform/quad grids (max tau = T - c + 1).
    ddim_alpha = alpha_bar[time_steps].astype(np.float32)
    ddim_alpha_prev = np.concatenate([alpha_bar[0:1], alpha_bar[time_steps[:-1]]])
    sigma = (
        eta
        * (
            (1 - ddim_alpha_prev)
            / (1 - ddim_alpha)
            * (1 - ddim_alpha / ddim_alpha_prev)
        )
        ** 0.5
    )
    return DDIMSchedule(
        time_steps=time_steps.astype(np.int32),
        alpha=ddim_alpha,
        alpha_sqrt=np.sqrt(ddim_alpha),
        alpha_prev=ddim_alpha_prev.astype(np.float32),
        sigma=sigma.astype(np.float32),
        sqrt_one_minus_alpha=((1.0 - ddim_alpha) ** 0.5).astype(np.float32),
    )

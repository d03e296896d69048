"""Progressive distillation math (counterpart of
``polyffusion_tpu/diffusion/progressive.py``): the v-parameterization, the
halving tau grids and the two-step-teacher -> one-step-student targets.

Two stages, after Salimans & Ho (arXiv:2202.00512) and Meng et al.
(arXiv:2210.03142):

- **Stage A, guided distillation**: a student learns to predict in ONE pass
  the classifier-free-guided epsilon its teacher computes with a double batch
  at a fixed guidance scale ``w``; it samples at ``uncond_scale=1``.
- **Stage B, step halving**: on a tau grid G (even size N), the student grid
  is ``G[1::2]`` and the student learns the x0 whose single DDIM(eta=0) step
  reproduces the teacher's TWO fine-grid steps: 64 -> 32 -> ... -> 4 evals.

The student predicts **v** = a*eps - s*x0 (a = sqrt(alpha_bar), s =
sqrt(1 - alpha_bar)); ``make_v_to_eps_apply`` adapts a v-model back into the
eps contract, so every sampler takes a student unchanged. The grids and the
phase tables are NumPy on the host (float64, then float32), equal bit for bit
to the JAX package's; the algebra is torch.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple

import numpy as np
import torch

from .schedule import NoiseSchedule

# ---------------------------------------------------------------------------
# v-parameterization (Salimans & Ho, appendix D)
#
# With x_t = a*x0 + s*eps and v := a*eps - s*x0 (a^2 + s^2 = 1):
#   eps = a*v + s*x_t          x0 = a*x_t - s*v
# ---------------------------------------------------------------------------


def eps_from_v(x, v, a, s):
    return a * v + s * x


def x0_from_v(x, v, a, s):
    return a * x - s * v


def v_from_eps_x0(eps, x0, a, s):
    return a * eps - s * x0


def make_v_to_eps_apply(apply_fn: Callable, schedule: NoiseSchedule) -> Callable:
    """Wrap a v-prediction net ``apply_fn(x, t, cond) -> v`` (NCHW) into the eps
    contract ``(x, t, cond) -> eps``. ``t`` is the per-sample (B,) step
    vector; a and s are gathered from the schedule's tables on ``t``'s device
    (pass tables already there, e.g. ``SDFTask``'s device copies, so that no
    call copies them)."""

    def apply_eps(x, t, cond):
        v = apply_fn(x, t, cond)
        bshape = (-1,) + (1,) * (x.dim() - 1)
        a = torch.as_tensor(schedule.sqrt_alpha_bar, device=t.device)[t].view(bshape)
        s = torch.as_tensor(schedule.sqrt_1m_alpha_bar, device=t.device)[t].view(bshape)
        return eps_from_v(x, v, a.to(x.dtype), s.to(x.dtype))

    return apply_eps


# ---------------------------------------------------------------------------
# halving grids
# ---------------------------------------------------------------------------


def halving_grids(n_steps: int, base: int, end: int = 2) -> List[np.ndarray]:
    """Chain of ascending tau grids [G0 (size base), G1 = G0[1::2], ...] down to
    size ``end``. ``base`` must be ``end * 2**k``. Each grid keeps the TOP tau
    (the from-noise starting level), so every phase's student still starts at
    the same noise level; the bottom element's implicit "previous" level is
    alpha_bar[0], matching ``make_ddim_schedule``'s alpha_prev convention.
    """
    if base % end or (base // end) & (base // end - 1):
        raise ValueError(f"base ({base}) must be end ({end}) * a power of 2")
    # evenly spaced over [1, T - T//base + 1]: the uniform-DDIM span without
    # the reference's size quirk (arange(0, T, T//S) overshoots S for S∤T)
    top = n_steps - n_steps // base
    g = np.round(np.linspace(0, top, base)).astype(np.int64) + 1
    if not (g[-1] < n_steps and len(np.unique(g)) == base):
        raise ValueError(f"no {base}-step grid of distinct levels below {n_steps}")
    grids = [g]
    while len(g) > end:
        g = g[1::2]
        grids.append(g)
    return grids


class PhaseTables(NamedTuple):
    """Per-student-index coefficient tables for one halving phase, all (M,).

    For student index j (ascending grid S = G[1::2], M = N/2):
      tau[j]   = S[j]          (a_t, s_t)   the level the student is called at
      tau_mid[j] = G[2j]       (a_m, s_m)   the teacher's intermediate level
      prev                      (a_p, s_p)   the target level = S[j-1]
                                             (alpha_bar[0] for j = 0)
      coef_xt = s_p / s_t;  denom = a_p - coef_xt * a_t
        so  x0_target = (x_prev - coef_xt * x_t) / denom
      weight  = max(SNR, 1) = max(a_t^2 / s_t^2, 1)   (truncated-SNR loss weight)
    """

    tau: np.ndarray
    a_t: np.ndarray
    s_t: np.ndarray
    tau_mid: np.ndarray
    a_m: np.ndarray
    s_m: np.ndarray
    a_p: np.ndarray
    s_p: np.ndarray
    coef_xt: np.ndarray
    denom: np.ndarray
    weight: np.ndarray

    @property
    def m(self) -> int:
        return int(self.tau.shape[0])


def _a_s(alpha_bar64: np.ndarray, taus: np.ndarray):
    ab = alpha_bar64[taus]
    return np.sqrt(ab), np.sqrt(1.0 - ab)


def phase_tables(schedule: NoiseSchedule, fine_grid: np.ndarray) -> PhaseTables:
    """Coefficient tables for distilling the ``fine_grid`` (size N, even) teacher
    into its ``fine_grid[1::2]`` student. float64 on the host, cast float32."""
    g = np.asarray(fine_grid, np.int64)
    if not (g.ndim == 1 and len(g) % 2 == 0 and (np.diff(g) > 0).all()):
        raise ValueError("a phase's fine grid is ascending and of even size")
    ab = schedule.alpha_bar.astype(np.float64)
    student = g[1::2]
    a_t, s_t = _a_s(ab, student)
    a_m, s_m = _a_s(ab, g[0::2])
    prev_ab = np.concatenate([ab[0:1], ab[student[:-1]]])
    a_p, s_p = np.sqrt(prev_ab), np.sqrt(1.0 - prev_ab)
    coef_xt = s_p / s_t
    denom = a_p - coef_xt * a_t
    if not (denom > 1e-5).all():
        raise ValueError("degenerate grid: x0-target solve ill-conditioned")
    weight = np.maximum(a_t**2 / s_t**2, 1.0)
    f = lambda v: v.astype(np.float32)  # noqa: E731
    return PhaseTables(
        tau=student.astype(np.int32),
        a_t=f(a_t), s_t=f(s_t),
        tau_mid=g[0::2].astype(np.int32),
        a_m=f(a_m), s_m=f(s_m),
        a_p=f(a_p), s_p=f(s_p),
        coef_xt=f(coef_xt), denom=f(denom), weight=f(weight),
    )


def pad_tables(tbl: PhaseTables, m_max: int):
    """Edge-pad every table to ``m_max`` rows; returns them and the true row
    count. The port draws rows below that count only, so padding changes no
    result (the JAX package pads so that every phase shares one compiled
    step)."""
    m = tbl.m
    if m > m_max:
        raise ValueError(f"cannot pad {m} rows to {m_max}")
    pad = lambda v: np.concatenate([v, np.repeat(v[-1:], m_max - m, 0)])  # noqa: E731
    return PhaseTables(*(pad(v) for v in tbl)), m


# ---------------------------------------------------------------------------
# targets (pure, unit-testable algebra)
# ---------------------------------------------------------------------------


def ddim_jump(x, eps, a_from, s_from, a_to, s_to):
    """One deterministic DDIM(eta=0) transition in (a, s) coordinates."""
    x0 = (x - s_from * eps) / a_from
    return a_to * x0 + s_to * eps


def solve_x0_target(x_t, x_prev, coef_xt, denom):
    """The x0 prediction whose single student DDIM step from ``x_t`` lands
    exactly on the teacher's two-step result ``x_prev``:

        x' = a_p*x0 + s_p*(x_t - a_t*x0)/s_t  ==  x_prev
        =>  x0 = (x_prev - (s_p/s_t)*x_t) / (a_p - (s_p/s_t)*a_t)
    """
    return (x_prev - coef_xt * x_t) / denom

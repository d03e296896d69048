"""Noise schedules and the DDIM sampler."""

from .schedule import DDIMSchedule, NoiseSchedule, make_ddim_schedule, make_schedule  # noqa: F401

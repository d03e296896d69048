"""Noise schedules and the DDPM, DDIM and DPM-Solver++ samplers."""

from .schedule import DDIMSchedule, NoiseSchedule, make_ddim_schedule, make_schedule  # noqa: F401

"""Training-time parameter schedulers (a copy of the JAX package's
``train/schedulers.py``): sigmoid-annealed scheduled sampling for teacher
forcing, constant schedules, and a named bundle of them with train and eval
modes (reference ``train/scheduler.py:6-104``). Values are plain Python
floats; the trainer hands the current step's values to the task's
``draw_noise``, which turns them into teacher-forcing coins.
"""

from __future__ import annotations

from typing import Dict


def scheduled_sampling(i: float) -> float:
    """Sigmoid decay x = 10^(3(1-2i)); y = x/(1+x) (reference scheduler.py:6-11)."""
    x = 10 ** (3 * (1 - 2 * i))
    return x / (1 + x)


class ConstantScheduler:
    def __init__(self, value: float):
        self.value = value

    def step(self, global_step: int) -> float:
        return self.value


class TeacherForcingScheduler:
    """Anneal from ``high`` to ``low`` over ``scaled_steps`` via scheduled_sampling
    (reference scheduler.py:47-61)."""

    def __init__(self, high: float, low: float, scaled_steps: int = 40000):
        self.high = high
        self.low = low
        self.scaled_steps = scaled_steps

    def step(self, global_step: int) -> float:
        ratio = scheduled_sampling(global_step / self.scaled_steps)
        return self.low + (self.high - self.low) * ratio


class ParameterScheduler:
    """Named bundle of schedulers; eval mode pins teacher forcing to its floor
    (reference scheduler.py:83-104)."""

    def __init__(self, **schedulers):
        self.schedulers = schedulers
        self.training = True

    def train(self):
        self.training = True

    def eval(self):
        self.training = False

    def keys(self):
        return tuple(self.schedulers.keys())

    def step(self, global_step: int) -> Dict[str, float]:
        out = {}
        for name, sch in self.schedulers.items():
            if not self.training and isinstance(sch, TeacherForcingScheduler):
                out[name] = sch.low
            else:
                out[name] = sch.step(global_step)
        return out


TFR_KEYS = ("tfr_chd", "tfr_pnt1", "tfr_pnt2")


def make_param_scheduler(cfg):
    """The teacher-forcing schedulers of a preset's ``tfr_*`` keys (each
    ``[high, low]``), as the JAX training CLI builds them (``main.py:120-125``);
    None when the preset has none."""
    keys = [k for k in TFR_KEYS if k in cfg]
    if not keys:
        return None
    return ParameterScheduler(**{k: TeacherForcingScheduler(*cfg[k]) for k in keys})

"""Faults planted in the program's timed path, each of which the comparison
that decides ``correct`` has to catch in the cells it names. Not used by the
benchmark's runs: ``control.py --as <fault>`` reads them on the card, and the CPU
tests see each turn a tiny run's ``correct`` false.

    with planted("half_batch", spec):
        run_cell(spec, ...)
"""

from __future__ import annotations

from contextlib import contextmanager
from unittest import mock

import torch

from .programs import PortTrain


def _answer_altered(spec):
    """gen: every answer scaled by 1.1 where ``generate`` returns it."""
    orig = spec.family.GenProgram.generate

    def altered(self, chords, noise):
        return orig(self, chords, noise) * 1.1

    return mock.patch.object(spec.family.GenProgram, "generate", altered)


def _rows_swapped(spec):
    """serve: a pass's rows handed to the callers in reverse order."""
    from polyffusion_tpu_torch.inference import InferenceSession

    orig = InferenceSession.predict

    def altered(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        out[:] = out[::-1].copy()
        return out

    return mock.patch.object(InferenceSession, "predict", altered)


def _state_unchanged(spec):
    """train: each step computes its loss and leaves the weights as they were
    (Adam's first moment at zero, as a step that moved nothing)."""

    def step(self, batch, seed, noise):
        with torch.no_grad():
            _, metrics = self.task.loss_fn(batch, noise)
        for m in self.state.weights.masters:
            self.state.optimizer.adam.state.setdefault(m, {}).setdefault(
                "exp_avg", torch.zeros_like(m))
        self.state.step += 1
        return metrics

    return mock.patch.object(PortTrain, "step", step)


def _half_batch(spec):
    """train: each step's loss is the mean over the first half of its rows."""
    cls = spec.family.TrainProgram
    orig = cls.__init__

    def init(self, *args, **kwargs):
        orig(self, *args, **kwargs)
        loss_fn = self.task.loss_fn

        def half(batch, noise):
            h = noise.t.shape[0] // 2
            return loss_fn(type(batch)(*[v[:h] for v in batch]),
                           type(noise)(*[v[:h] if k in ("t", "noise") else v
                                         for k, v in zip(noise._fields, noise)]))

        self.task.loss_fn = half

    return mock.patch.object(cls, "__init__", init)


def _refresh_skipped(spec):
    """train, bf16 on fp32 masters: Adam moves the masters, and the working
    copy that the forward and backward compute with is never refreshed from
    them."""
    from polyffusion_tpu_torch.train.state import MasterWeights

    return mock.patch.object(MasterWeights, "refresh", lambda self: None)


FAULTS = {
    "answer_altered": ("generate", _answer_altered),
    "rows_swapped": ("serve", _rows_swapped),
    "state_unchanged": ("train", _state_unchanged),
    "half_batch": ("train", _half_batch),
    "refresh_skipped": ("train", _refresh_skipped),
}


@contextmanager
def planted(name: str, spec):
    """The fault ``name`` planted in the program for the block."""
    driver, make = FAULTS[name]
    if spec.traffic["driver"] != driver:
        raise ValueError(f"fault {name} is for the {driver} driver, not {spec.traffic['driver']}")
    with make(spec):
        yield

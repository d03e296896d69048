"""The task contract (counterpart of the JAX package's ``tasks/base.py``).

A task bundles a model family for the trainer (``train/step.py``,
``train/loop.py``): a trainable module, the randomness of one loss
evaluation drawn apart from the loss itself (JAX's loss draws from its key
inside; here the draws are a value that a test can hand both packages), and
the loss:

    task.draw_noise(batch, generator, sched) -> noise  # e.g. StepNoise, AENoise
    task.loss_fn(batch, noise)              -> (loss, metrics dict)

``sched`` holds the step's scheduled values (teacher-forcing rates) and
``"global_step"``. Tasks may also offer ``load_*`` methods that load weights
strictly (``SDFTask.load_unet_state``). This module is documentation: no task
derives from it.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Protocol, Tuple

import torch
from torch import nn


class Task(Protocol):
    name: str
    #: the batch fields the loss reads (the feeder sends placeholders for the rest)
    used_batch_fields: frozenset
    #: where the module, the loss and the draws live
    device: torch.device
    #: train in bf16 over fp32 masters (``utils/precision.py:MasterWeights``)
    bf16: bool
    #: the trainable module (frozen parts stay outside it)
    model: nn.Module

    def draw_noise(self, batch, generator: torch.Generator,
                   sched: Optional[Mapping[str, Any]] = None) -> Any:
        """One loss evaluation's randomness, from ``generator`` on its device."""

    def loss_fn(self, batch, noise: Any) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The scalar loss and its metrics (``"loss"`` among them)."""

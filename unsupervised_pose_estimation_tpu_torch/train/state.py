"""Train state: the Adam optimizer, the learning-rate schedule and the step
counter.

Port of ``unsupervised_pose_estimation_tpu/train/state.py``. There the state
is one pytree that the jitted step replaces; here the parameters and
BatchNorm statistics live in the bundle's modules (the step function holds
the bundle) and the Adam moments in the optimizer, which the step updates
in place, and ``TrainState`` holds the optimizer with the step counter
that the schedule and the automask noise read, and with
``adversarial_prior`` the discriminator's own Adam.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Optional

import torch

from ..config import Options
from .bundle import ModelBundle

Schedule = Callable[[int], float]


def lr_schedule(cfg: Options, steps_per_epoch: int = 1) -> Schedule:
    """-> learning rate as a function of the optimizer step count.

    "none": constant ``cfg.learning_rate``. "step": torch StepLR(
    scheduler_step_size epochs, gamma 0.1) counted in optimizer steps,
    staircase, as optax ``exponential_decay`` in the reference."""
    lr = cfg.learning_rate
    if cfg.lr_scheduler == "none":
        return lambda count: lr
    if cfg.lr_scheduler == "step":
        every = max(1, cfg.scheduler_step_size * steps_per_epoch)
        return lambda count: lr * 0.1 ** math.floor(count / every)
    raise ValueError(f"unknown lr_scheduler '{cfg.lr_scheduler}'")


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   learning_rate: float) -> torch.optim.Adam:
    """Adam with betas (0.9, 0.999) and eps 1e-8: the arithmetic of optax
    ``adam`` (and of torch's Adam defaults, the reference trainer's
    optimizer). The step sets the rate of each update from the schedule."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8)


def make_disc_optimizer(params: Iterable[torch.nn.Parameter],
                        cfg: Options) -> torch.optim.Adam:
    """The discriminator's Adam: rate ``cfg.discriminator_lr``, betas
    (``cfg.b1``, ``cfg.b2``), eps 1e-8, no schedule."""
    return torch.optim.Adam(params, lr=cfg.discriminator_lr,
                            betas=(cfg.b1, cfg.b2), eps=1e-8)


@dataclasses.dataclass
class TrainState:
    """``step`` counts optimizer updates; ``schedule(step)`` is the rate of
    the next one. ``disc_optimizer`` is the discriminator's Adam, or
    None without one."""

    step: int
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    disc_optimizer: Optional[torch.optim.Optimizer] = None


def create_train_state(bundle: ModelBundle,
                       steps_per_epoch: int = 1) -> TrainState:
    """A fresh state at step 0: Adam over ``bundle.main_parameters()``
    (the reference's ``params``: the frozen generator and the
    discriminator are not in it) and, with a discriminator, its own
    Adam."""
    schedule = lr_schedule(bundle.cfg, steps_per_epoch)
    optimizer = make_optimizer(bundle.main_parameters(), schedule(0))
    disc = bundle.discriminator
    return TrainState(step=0, optimizer=optimizer, schedule=schedule,
                      disc_optimizer=None if disc is None else
                      make_disc_optimizer(disc.parameters(), bundle.cfg))

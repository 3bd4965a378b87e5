"""Exponential moving average of the parameters (PyTorch counterpart of
``magvit2_pytorch_tpu/training/ema.py``; the reference's
``ema_pytorch.EMA``): no decay before ``update_after_step`` (the EMA copies
the parameters), then an update every ``update_every`` steps with the decay
ramp ``1 - (1 + k / inv_gamma)^(-power)`` clamped to ``[min_value,
beta]``. The update is in place on the EMA module's parameters under
``torch.no_grad()`` (``copy_``), which bumps their version counters, so the
fused ResidualUnit re-lays an EMA weight after it changed."""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EMAConfig:
    beta: float = 0.9999
    update_after_step: int = 100
    update_every: int = 10
    inv_gamma: float = 1.0
    power: float = 2.0 / 3.0
    min_value: float = 0.0


def ema_decay(step: int, config: EMAConfig) -> float:
    """The decay at global ``step``, in float32 as the JAX package takes
    it."""
    k = np.float32(step - config.update_after_step - 1)
    if k <= 0:
        return 0.0
    value = np.float32(1.0) - (np.float32(1.0) + k / np.float32(
        config.inv_gamma)) ** np.float32(-config.power)
    return float(np.clip(value, np.float32(config.min_value),
                         np.float32(config.beta)))


def effective_decay(step: int, config: EMAConfig) -> float:
    """1 (no change) off the cadence, else :func:`ema_decay`."""
    update = (step <= config.update_after_step
              or step % config.update_every == 0)
    return ema_decay(step, config) if update else 1.0


@torch.no_grad()
def ema_update(ema_params: Iterable[torch.Tensor],
               params: Iterable[torch.Tensor], step: int,
               config: EMAConfig = EMAConfig()):
    """``e = e * decay + p * (1 - decay)`` in float32, in place, for the
    global ``step``."""
    decay = effective_decay(step, config)
    if decay == 1.0:
        return
    keep = float(np.float32(1.0) - np.float32(decay))
    for e, p in zip(ema_params, params):
        e.copy_((e.float() * decay + p.float() * keep).to(e.dtype))

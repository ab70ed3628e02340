"""The Qwen-Image flow-match schedule, worked out in NumPy (float64, then
float32), as DiffSynth-Studio's ``FlowMatchScheduler`` defines it for
Qwen-Image: ``sigma_min 0, sigma_max 1, extra_one_step, exponential_shift``
with the resolution-dynamic ``mu`` at inference and ``mu = 0.8`` otherwise,
``shift_terminal 0.02``; timesteps are ``1000 * sigma``; the Euler step's
next sigma is 0 past the end."""

from __future__ import annotations

import math

import numpy as np


def _mu_for(image_seq_len: int) -> float:
    m = (0.9 - 0.5) / (8192 - 256)
    return image_seq_len * m + (0.5 - m * 256)


def schedule(steps: int, image_seq_len: int | None = None):
    """(sigmas, sigmas_next, timesteps), float32 [steps]."""
    sigmas = np.linspace(1.0, 0.0, steps + 1, dtype=np.float64)[:-1]
    mu = 0.8 if image_seq_len is None else _mu_for(image_seq_len)
    with np.errstate(divide="ignore"):
        sigmas = math.exp(mu) / (math.exp(mu) + (1.0 / sigmas - 1.0))
    one_minus = 1.0 - sigmas
    scale = one_minus[-1] / (1.0 - 0.02)
    if scale > 0.0:
        sigmas = 1.0 - one_minus / scale
    timesteps = sigmas * 1000.0
    nxt = np.concatenate([sigmas[1:], np.array([0.0])])
    return sigmas.astype(np.float32), nxt.astype(np.float32), timesteps.astype(np.float32)


def adapter_t_range() -> tuple[float, float]:
    """(t_min, t_max) of the dual adapter's alpha: the timesteps of the
    scheduler PhysicEdit builds with its default 100 steps."""
    _, _, t = schedule(100)
    return float(t.min()), float(t.max())

"""Karras-style continuous-ODE scheduler: the port's own copy of
``physicedit_tpu/sampling/continuous_ode.py`` (NumPy only), a pluggable legacy sampler.

Feature-parity port of the reference ContinuousODEScheduler
(diffsynth/schedulers/continuous_ode.py): rho-spaced sigma ramp
(sigma_max 700 -> sigma_min 0.002, rho 7), timesteps = log(sigma)/4,
EDM-preconditioned Euler step.  Unused by the PhysicEdit path (flow
matching is the production sampler); kept for sampler-interface
completeness.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ContinuousODESchedule:
    sigmas: np.ndarray
    sigmas_next: np.ndarray   # sigma at step i+1 (last entry unused)
    timesteps: np.ndarray
    is_last: np.ndarray


def build_ode_schedule(num_inference_steps: int = 100, sigma_max: float = 700.0,
                       sigma_min: float = 0.002, rho: float = 7.0,
                       denoising_strength: float = 1.0) -> ContinuousODESchedule:
    ramp = np.linspace(1 - denoising_strength, 1, num_inference_steps)
    min_ir, max_ir = sigma_min ** (1 / rho), sigma_max ** (1 / rho)
    sigmas = (max_ir + ramp * (min_ir - max_ir)) ** rho
    sigmas_next = np.concatenate([sigmas[1:], sigmas[-1:]])
    is_last = np.zeros(num_inference_steps, bool)
    is_last[-1] = True
    return ContinuousODESchedule(
        sigmas.astype(np.float32), sigmas_next.astype(np.float32),
        (np.log(sigmas) * 0.25).astype(np.float32), is_last)


def ode_step(sample, model_output, sigma, sigma_next, is_last: bool):
    """EDM-preconditioned Euler update (continuous_ode.py:21-33)."""
    c = np.sqrt(sigma * sigma + 1.0)
    sample = sample * c
    estimated = (-sigma / c) * model_output + sample / (c * c)
    if is_last:
        return estimated
    derivative = (sample - estimated) / sigma
    prev = sample + derivative * (sigma_next - sigma)
    return prev / np.sqrt(sigma_next * sigma_next + 1.0)


def ode_add_noise(x0, noise, sigma):
    return (x0 + noise * sigma) / np.sqrt(sigma * sigma + 1.0)


def ode_training_target(x0, noise, sigma):
    c = np.sqrt(sigma * sigma + 1.0)
    return (-c / sigma + 1.0 / (c * sigma)) * x0 + noise / c


def ode_training_weight(sigma):
    return np.sqrt(1 + sigma * sigma) / sigma

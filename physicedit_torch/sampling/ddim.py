"""DDIM scheduler as pure functions: the port's own copy of
``physicedit_tpu/sampling/ddim.py`` (NumPy only), a pluggable legacy sampler.

PhysicEdit itself only exercises flow matching (sampling/flow_match.py);
DDIM is kept for sampler-interface completeness, matching the behaviour of
the reference EnhancedDDIMScheduler (diffsynth/schedulers/ddim.py):
timesteps aligned to 999...0, epsilon / v-prediction steps expressed in
alpha-bar products, optional zero-terminal-SNR rescale.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    timesteps: np.ndarray       # [T] descending integer timesteps
    alpha_prod: np.ndarray      # [T] alpha-bar at each step
    alpha_prod_prev: np.ndarray  # [T] alpha-bar at the next (less-noisy) step
    alphas_cumprod: np.ndarray  # [num_train_timesteps] full table


def _alphas_cumprod(num_train_timesteps=1000, beta_start=0.00085,
                    beta_end=0.012, beta_schedule="scaled_linear",
                    rescale_zero_terminal_snr=False) -> np.ndarray:
    if beta_schedule == "scaled_linear":
        betas = np.linspace(np.sqrt(beta_start), np.sqrt(beta_end),
                            num_train_timesteps, dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps,
                            dtype=np.float64)
    else:
        raise NotImplementedError(beta_schedule)
    acp = np.cumprod(1.0 - betas)
    if rescale_zero_terminal_snr:
        s = np.sqrt(acp)
        s = (s - s[-1]) * (s[0] / (s[0] - s[-1]))
        acp = s ** 2
    return acp


def build_ddim_schedule(num_inference_steps: int, num_train_timesteps=1000,
                        denoising_strength: float = 1.0,
                        **beta_kwargs) -> DDIMSchedule:
    acp = _alphas_cumprod(num_train_timesteps, **beta_kwargs)
    max_t = max(round(num_train_timesteps * denoising_strength) - 1, 0)
    n = min(num_inference_steps, max_t + 1)
    if n == 1:
        ts = np.array([max_t])
    else:
        step = max_t / (n - 1)
        ts = np.array([round(max_t - i * step) for i in range(n)])
    a_t = acp[ts.astype(int)]
    a_prev = np.concatenate([acp[ts[1:].astype(int)], [1.0]])
    return DDIMSchedule(ts.astype(np.float32), a_t.astype(np.float32),
                        a_prev.astype(np.float32), acp.astype(np.float32))


def ddim_step(sample, model_output, alpha_prod_t, alpha_prod_t_prev,
              prediction_type: str = "epsilon"):
    """Deterministic DDIM update in alpha-bar form (ddim.py:53-64)."""
    if prediction_type == "epsilon":
        w_e = np.sqrt(1 - alpha_prod_t_prev) - np.sqrt(
            alpha_prod_t_prev * (1 - alpha_prod_t) / alpha_prod_t)
        w_x = np.sqrt(alpha_prod_t_prev / alpha_prod_t)
    elif prediction_type == "v_prediction":
        w_e = (-np.sqrt(alpha_prod_t_prev * (1 - alpha_prod_t))
               + np.sqrt(alpha_prod_t * (1 - alpha_prod_t_prev)))
        w_x = (np.sqrt(alpha_prod_t * alpha_prod_t_prev)
               + np.sqrt((1 - alpha_prod_t) * (1 - alpha_prod_t_prev)))
    else:
        raise NotImplementedError(prediction_type)
    return sample * w_x + model_output * w_e


def ddim_add_noise(x0, noise, alpha_prod_t):
    return np.sqrt(alpha_prod_t) * x0 + np.sqrt(1 - alpha_prod_t) * noise


def ddim_training_target(x0, noise, alpha_prod_t,
                         prediction_type: str = "epsilon"):
    if prediction_type == "epsilon":
        return noise
    return np.sqrt(alpha_prod_t) * noise - np.sqrt(1 - alpha_prod_t) * x0

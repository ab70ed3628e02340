"""Flow-matching scheduler as pure functions: the port's own copy of
``physicedit_tpu/sampling/flow_match.py`` (NumPy only).

Reimplements the math of the reference's FlowMatchScheduler
(DiffSynth-Studio ``diffsynth/schedulers/flow_match.py:34-125``) as stateless
functions.  The schedule (sigmas / timesteps / training weights) is
precomputed on the host as NumPy arrays; the per-step update and noising
rules are plain array expressions.

Qwen-Image configuration (qwen_image_physical.py:192):
    sigma_min=0, sigma_max=1, extra_one_step=True,
    exponential_shift=True, exponential_shift_mu=0.8, shift_terminal=0.02
and at inference the shift mu is resolution-dynamic:
    mu = calculate_shift((h/16)*(w/16))   (qwen_image_physical.py:600)
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

NUM_TRAIN_TIMESTEPS = 1000


@dataclasses.dataclass(frozen=True)
class FlowMatchConfig:
    """Static scheduler configuration (mirrors the reference constructor args)."""

    num_train_timesteps: int = NUM_TRAIN_TIMESTEPS
    shift: float = 3.0
    sigma_max: float = 1.0
    sigma_min: float = 0.003 / 1.002
    inverse_timesteps: bool = False
    extra_one_step: bool = False
    reverse_sigmas: bool = False
    exponential_shift: bool = False
    exponential_shift_mu: float | None = None
    shift_terminal: float | None = None


# The configuration used by the Qwen-Image / PhysicEdit pipeline.
QWEN_IMAGE_CONFIG = FlowMatchConfig(
    sigma_min=0.0,
    sigma_max=1.0,
    extra_one_step=True,
    exponential_shift=True,
    exponential_shift_mu=0.8,
    shift_terminal=0.02,
)


@dataclasses.dataclass(frozen=True)
class FlowMatchSchedule:
    """A fully-resolved schedule: arrays consumed by the denoise scan / loss.

    sigmas[i]     noise level at step i (descending for the standard direction)
    timesteps[i]  sigmas[i] * num_train_timesteps  (the value fed to the DiT)
    sigmas_next[i] the "next" sigma used by the Euler step at step i
                   (terminal value is 0, or 1 for inverse/reversed schedules)
    weights       per-timestep training loss weights (only when training=True)
    """

    sigmas: np.ndarray
    timesteps: np.ndarray
    sigmas_next: np.ndarray
    weights: np.ndarray | None = None

    @property
    def num_steps(self) -> int:
        return int(self.sigmas.shape[0])

    @property
    def t_min(self) -> float:
        return float(self.timesteps.min())

    @property
    def t_max(self) -> float:
        return float(self.timesteps.max())


def calculate_shift(
    image_seq_len: int,
    base_seq_len: int = 256,
    max_seq_len: int = 8192,
    base_shift: float = 0.5,
    max_shift: float = 0.9,
) -> float:
    """Resolution-dynamic exponential-shift mu (flow_match.py:114-125)."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return image_seq_len * m + b


def build_schedule(
    num_inference_steps: int,
    config: FlowMatchConfig = QWEN_IMAGE_CONFIG,
    denoising_strength: float = 1.0,
    training: bool = False,
    shift: float | None = None,
    dynamic_shift_len: int | None = None,
    exponential_shift_mu: float | None = None,
) -> FlowMatchSchedule:
    """Build the sigma/timestep schedule (flow_match.py:34-69, exact math)."""
    shift = config.shift if shift is None else shift
    sigma_start = config.sigma_min + (config.sigma_max - config.sigma_min) * denoising_strength
    if config.extra_one_step:
        sigmas = np.linspace(sigma_start, config.sigma_min, num_inference_steps + 1, dtype=np.float64)[:-1]
    else:
        sigmas = np.linspace(sigma_start, config.sigma_min, num_inference_steps, dtype=np.float64)
    if config.inverse_timesteps:
        sigmas = sigmas[::-1].copy()

    if config.exponential_shift:
        if exponential_shift_mu is not None:
            mu = exponential_shift_mu
        elif dynamic_shift_len is not None:
            mu = calculate_shift(dynamic_shift_len)
        else:
            mu = config.exponential_shift_mu
        with np.errstate(divide="ignore"):
            sigmas = math.exp(mu) / (math.exp(mu) + (1.0 / sigmas - 1.0))
    else:
        sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)

    if config.shift_terminal is not None:
        one_minus_z = 1.0 - sigmas
        scale_factor = one_minus_z[-1] / (1.0 - config.shift_terminal)
        # Guard the degenerate terminal: with num_inference_steps == 1 (and
        # extra_one_step) the single sigma is exactly 1, so one_minus_z[-1]
        # is 0 and the rescale would be 0/0 -> a NaN schedule that poisons
        # the whole denoise.  The rescale's purpose is to pin the final
        # sigma at shift_terminal; when the schedule is a single pure-noise
        # step there is nothing to rescale, so skip it.
        if scale_factor > 0.0:
            sigmas = 1.0 - (one_minus_z / scale_factor)

    if config.reverse_sigmas:
        sigmas = 1.0 - sigmas

    timesteps = sigmas * config.num_train_timesteps

    # Precompute the Euler-step "next sigma" (flow_match.py:77-80): the value
    # past the end of the schedule is 0 (or 1 for inverse/reversed schedules).
    terminal = 1.0 if (config.inverse_timesteps or config.reverse_sigmas) else 0.0
    sigmas_next = np.concatenate([sigmas[1:], np.array([terminal])])

    weights = None
    if training:
        # Gaussian-bell timestep weighting (flow_match.py:61-67).  Note the
        # reference centres the bell at num_inference_steps/2 over the
        # *timestep values* (0..1000), matching its use with
        # num_inference_steps == num_train_timesteps at train time.
        x = timesteps
        y = np.exp(-2 * ((x - num_inference_steps / 2) / num_inference_steps) ** 2)
        y_shifted = y - y.min()
        weights = y_shifted * (num_inference_steps / y_shifted.sum())

    return FlowMatchSchedule(
        sigmas=sigmas.astype(np.float32),
        timesteps=timesteps.astype(np.float32),
        sigmas_next=sigmas_next.astype(np.float32),
        weights=None if weights is None else weights.astype(np.float32),
    )


def qwen_inference_schedule(num_inference_steps: int, height: int, width: int,
                            denoising_strength: float = 1.0,
                            exponential_shift_mu: float | None = None) -> FlowMatchSchedule:
    """The schedule used by the edit pipeline (qwen_image_physical.py:600)."""
    return build_schedule(
        num_inference_steps,
        QWEN_IMAGE_CONFIG,
        denoising_strength=denoising_strength,
        dynamic_shift_len=(height // 16) * (width // 16),
        exponential_shift_mu=exponential_shift_mu,
    )


def flux_schedule(num_inference_steps: int, image_seq_len: int) -> FlowMatchSchedule:
    """FLUX.1's schedule (diffusers' ``FluxKontextPipeline`` over
    ``FlowMatchEulerDiscreteScheduler`` with dynamic shifting): sigmas
    ``linspace(1, 1/N, N)``, the exponential shift with ``mu`` from the
    target's token count (0.5 at 256 tokens to 1.15 at 4,096), no terminal
    shift; timesteps ``1000 * sigma``; the Euler step's next sigma 0 past
    the end.  Worked out in float64 and stored as float32 (diffusers shifts
    float32 sigmas)."""
    sigmas = np.linspace(1.0, 1.0 / num_inference_steps, num_inference_steps,
                         dtype=np.float64)
    mu = calculate_shift(image_seq_len, base_seq_len=256, max_seq_len=4096, base_shift=0.5,
                         max_shift=1.15)
    sigmas = math.exp(mu) / (math.exp(mu) + (1.0 / sigmas - 1.0))
    return FlowMatchSchedule(
        sigmas=sigmas.astype(np.float32),
        timesteps=(sigmas * NUM_TRAIN_TIMESTEPS).astype(np.float32),
        sigmas_next=np.concatenate([sigmas[1:], [0.0]]).astype(np.float32))


def qwen_training_schedule() -> FlowMatchSchedule:
    """The 1000-step training schedule (trainers/utils.py:861)."""
    return build_schedule(NUM_TRAIN_TIMESTEPS, QWEN_IMAGE_CONFIG, training=True)


def adapter_t_range() -> tuple[float, float]:
    """(t_min, t_max) for the VisualThinkingDualAdapter alpha mixing.

    The reference derives these from the scheduler constructed with its
    default 100 inference steps (qwen_image_physical.py:192,224).
    """
    sched = build_schedule(100, QWEN_IMAGE_CONFIG)
    return sched.t_min, sched.t_max


# ---------------------------------------------------------------------------
# Per-step rules, for any array type; `sigma` may be a python float
# or a traced scalar.
# ---------------------------------------------------------------------------

def euler_step(sample, model_output, sigma, sigma_next):
    """x_{t'} = x_t + v * (sigma' - sigma)   (flow_match.py:72-82)."""
    return sample + model_output * (sigma_next - sigma)


def add_noise(original_samples, noise, sigma):
    """(1 - sigma) * x0 + sigma * eps   (flow_match.py:94-100)."""
    return (1.0 - sigma) * original_samples + sigma * noise


def training_target(sample, noise):
    """v-target = eps - x0   (flow_match.py:103-105)."""
    return noise - sample


def return_to_timestep(sample, sample_stabilized, sigma):
    """Implied model output from a stabilised sample (flow_match.py:85-91)."""
    return (sample - sample_stabilized) / sigma

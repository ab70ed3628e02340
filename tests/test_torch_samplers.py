"""The port's NumPy copies of the legacy samplers (``sampling/ddim.py``,
``sampling/continuous_ode.py``) against the JAX package's: the same numpy
inputs give the same arrays, exactly."""

import numpy as np
import pytest

from physicedit_tpu.sampling import continuous_ode as j_ode
from physicedit_tpu.sampling import ddim as j_ddim
from physicedit_torch.sampling import continuous_ode as t_ode
from physicedit_torch.sampling import ddim as t_ddim


def _equal(a, b):
    for f in ("timesteps", "alpha_prod", "alpha_prod_prev", "alphas_cumprod", "sigmas",
              "sigmas_next", "is_last"):
        if hasattr(a, f):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("steps,strength,zsnr,schedule", [
    (50, 1.0, False, "scaled_linear"), (20, 0.7, False, "scaled_linear"),
    (30, 1.0, True, "scaled_linear"), (7, 0.35, True, "linear"), (1, 0.5, False, "linear"),
    # Python's round() takes halves to even: 5 steps from max_t 499 put one on
    # 249.5 (-> 250); round(1000 * 0.0625) = round(62.5) = 62, and 9 steps from
    # 61 put one on 30.5 (-> 30)
    (4, 0.5, False, "scaled_linear"), (5, 0.5, False, "scaled_linear"),
    (9, 0.0625, False, "scaled_linear"),
])
@pytest.mark.parametrize("prediction", ["epsilon", "v_prediction"])
def test_ddim_trajectory_matches_jax(steps, strength, zsnr, schedule, prediction):
    kw = dict(denoising_strength=strength, rescale_zero_terminal_snr=zsnr,
              beta_schedule=schedule)
    js, ts = j_ddim.build_ddim_schedule(steps, **kw), t_ddim.build_ddim_schedule(steps, **kw)
    _equal(js, ts)
    rng = np.random.default_rng(steps)
    x_j = x_t = rng.normal(size=(2, 4, 8, 8)).astype(np.float32)
    for i in range(len(ts.timesteps)):
        out = rng.normal(size=x_t.shape).astype(np.float32)
        x_j = j_ddim.ddim_step(x_j, out, js.alpha_prod[i], js.alpha_prod_prev[i], prediction)
        x_t = t_ddim.ddim_step(x_t, out, ts.alpha_prod[i], ts.alpha_prod_prev[i], prediction)
        np.testing.assert_array_equal(x_t, x_j)
    x0, noise = (rng.normal(size=(3, 5)).astype(np.float32) for _ in range(2))
    a = ts.alpha_prod[len(ts.timesteps) // 2]
    np.testing.assert_array_equal(t_ddim.ddim_add_noise(x0, noise, a),
                                  j_ddim.ddim_add_noise(x0, noise, a))
    np.testing.assert_array_equal(t_ddim.ddim_training_target(x0, noise, a, prediction),
                                  j_ddim.ddim_training_target(x0, noise, a, prediction))


def test_ddim_rejects_what_jax_rejects():
    for mod in (j_ddim, t_ddim):
        with pytest.raises(NotImplementedError):
            mod.build_ddim_schedule(10, beta_schedule="cosine")
        with pytest.raises(NotImplementedError):
            mod.ddim_step(np.zeros(2), np.zeros(2), 0.5, 0.6, "sample")


@pytest.mark.parametrize("steps,strength,sigma_max,rho", [
    (100, 1.0, 700.0, 7.0), (10, 0.6, 700.0, 7.0), (25, 1.0, 80.0, 5.0), (1, 1.0, 700.0, 7.0),
])
def test_ode_trajectory_matches_jax(steps, strength, sigma_max, rho):
    kw = dict(sigma_max=sigma_max, rho=rho, denoising_strength=strength)
    js, ts = j_ode.build_ode_schedule(steps, **kw), t_ode.build_ode_schedule(steps, **kw)
    _equal(js, ts)
    rng = np.random.default_rng(steps)
    x_j = x_t = rng.normal(size=(2, 3, 4)).astype(np.float32)
    for i in range(steps):          # the last step returns the estimate itself
        out = rng.normal(size=x_t.shape).astype(np.float32)
        args = (ts.sigmas[i], ts.sigmas_next[i], bool(ts.is_last[i]))
        x_j = j_ode.ode_step(x_j, out, *args)
        x_t = t_ode.ode_step(x_t, out, *args)
        np.testing.assert_array_equal(x_t, x_j)
    assert ts.is_last[-1] and not ts.is_last[:-1].any()
    x0, noise = (rng.normal(size=(3, 5)).astype(np.float32) for _ in range(2))
    s = ts.sigmas[0]
    for name in ("ode_add_noise", "ode_training_target"):
        np.testing.assert_array_equal(getattr(t_ode, name)(x0, noise, s),
                                      getattr(j_ode, name)(x0, noise, s))
    np.testing.assert_array_equal(t_ode.ode_training_weight(ts.sigmas),
                                  j_ode.ode_training_weight(js.sigmas))

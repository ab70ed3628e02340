"""Port VAE (image mode) against physicedit_tpu/models/vae.py, fp32 on the
CPU, with the same random weights carried by io/from_jax.py."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from physicedit_tpu.models import vae as j_vae
from physicedit_tpu.models.vae_init import init_vae_params
from physicedit_torch.io.from_jax import vae_from_jax
from physicedit_torch.models import vae as t_vae

torch.set_num_threads(2)

TOL = 1e-4  # fp32 conv stacks; only the summation order differs

CFG = j_vae.VAEConfig(base_dim=8)


def random_vae_params(seed=0):
    """The zero tree of vae_init filled with random weights (torch-default
    conv scale, gains near one), so that every layer matters."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, init_vae_params(CFG))

    def fill(path, x):
        name = path[-1].key
        if name == "gamma":
            return (1.0 + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
        if name == "w":
            fan_in = x.shape[0] * x.shape[1] * x.shape[2]
            return (rng.uniform(-1, 1, size=x.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.05 * rng.normal(size=x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


@pytest.fixture(scope="module")
def vaes():
    params = random_vae_params()
    return params, vae_from_jax(params, CFG, device="cpu")


@pytest.mark.parametrize("hw", [(32, 32), (48, 64)])
def test_vae_encode_matches_jax(vaes, hw):
    params, model = vaes
    x = np.random.default_rng(1).uniform(-1, 1, size=(1, *hw, 3)).astype(np.float32)
    want = j_vae.encode(params, jnp.asarray(x), CFG)
    got = t_vae.encode(model, torch.from_numpy(x))
    assert got.shape == (1, hw[0] // 8, hw[1] // 8, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("hw", [(4, 4), (6, 8)])
def test_vae_decode_matches_jax(vaes, hw):
    params, model = vaes
    z = np.random.default_rng(2).normal(size=(1, *hw, 16)).astype(np.float32)
    want = j_vae.decode(params, jnp.asarray(z), CFG)
    got = t_vae.decode(model, torch.from_numpy(z))
    assert got.shape == (1, hw[0] * 8, hw[1] * 8, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_vae_random_init_is_not_constant():
    from physicedit_torch.core.params import init_random_, materialize

    model = init_random_(materialize(t_vae.VAE(t_vae.VAEConfig(base_dim=8)), "cpu"),
                         torch.Generator().manual_seed(0))
    img = t_vae.decode(model, torch.randn(1, 4, 4, 16, generator=torch.Generator().manual_seed(1)))
    assert torch.isfinite(img).all() and img.std() > 0

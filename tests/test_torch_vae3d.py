"""Port video VAE (``models/vae3d.py``) against physicedit_tpu/models/vae3d.py,
fp32 on the CPU: base_dim 8, a clip of 1 x 5 x 32 x 32.  The weights are a
reference-layout state dict drawn from a numpy seed (with the published
``time_conv`` keys), read by the JAX package's ``vae_video_from_torch`` and
by the port's ``vae3d_from_state_dict``."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from physicedit_tpu.io.convert import vae_video_from_torch
from physicedit_tpu.models import vae as j_vae
from physicedit_tpu.models import vae3d as j_vae3d
from physicedit_torch.core.params import materialize
from physicedit_torch.io import convert as tconv
from physicedit_torch.io.from_jax import vae3d_from_jax
from physicedit_torch.models import vae as t_vae
from physicedit_torch.models import vae3d as t_vae3d

torch.set_num_threads(2)

TOL = 1e-4  # fp32 conv stacks; only the summation order differs
CFG = j_vae.VAEConfig(base_dim=8)


def reference_state_dict(seed=0) -> dict:
    """A reference-layout video VAE state dict (full kt = 3 taps, time_conv
    keys too) with numpy-drawn weights: torch-default conv scale, gains
    near one."""
    rng = np.random.default_rng(seed)
    model = materialize(t_vae3d.VideoVAE(t_vae.VAEConfig(base_dim=8)), "cpu")
    sd = {}
    for key, t in tconv.module_state_dict(model, tconv.vae_key_map(model.cfg),
                                          tconv.vae_extra_keys(model.cfg)).items():
        if key.endswith("gamma"):
            arr = 1.0 + 0.1 * rng.normal(size=t.shape)
        elif t.dim() >= 2:
            arr = rng.uniform(-1, 1, size=t.shape) / np.sqrt(t[0].numel())
        else:
            arr = 0.05 * rng.normal(size=t.shape)
        sd[key] = torch.from_numpy(arr.astype(np.float32))
    return sd


@pytest.fixture(scope="module")
def vaes():
    sd = reference_state_dict()
    jparams = vae_video_from_torch(sd, dtype=jnp.float32)
    return sd, jparams, tconv.vae3d_from_state_dict(sd, torch.float32, "cpu")


def _clip(seed, t=5, hw=32):
    return np.random.default_rng(seed).uniform(-1, 1, size=(1, t, hw, hw, 3)).astype(np.float32)


def test_state_dict_has_full_taps_and_time_conv(vaes):
    sd, _, model = vaes
    assert any("time_conv" in k for k in sd)
    conv = model.encoder["stages"][0]["res"][0]["conv1"]
    assert isinstance(conv, t_vae.CausalConv3d) and tuple(conv.weight.shape[2:]) == (3, 3, 3)
    torch.testing.assert_close(conv.weight, sd["encoder.down_blocks.0.conv1.weight"],
                               rtol=0, atol=0)


def test_encode_matches_jax(vaes):
    _, jparams, model = vaes
    x = _clip(1)
    want = np.asarray(j_vae3d.encode(jparams, jnp.asarray(x), CFG))
    got = t_vae3d.encode(model, torch.from_numpy(x))
    assert got.shape == (1, 5, 4, 4, 16)     # no temporal compression
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_decode_matches_jax(vaes):
    _, jparams, model = vaes
    z = np.random.default_rng(2).normal(size=(1, 3, 4, 4, 16)).astype(np.float32)
    want = np.asarray(j_vae3d.decode(jparams, jnp.asarray(z), CFG))
    got = t_vae3d.decode(model, torch.from_numpy(z))
    assert got.shape == (1, 3, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_one_frame_is_the_image_vae_on_its_last_tap(vaes):
    """T = 1: only the last temporal tap meets the frame, which is the image
    VAE that the image key map builds from the same file."""
    sd, _, model = vaes
    image_vae = tconv.vae_from_state_dict(sd, torch.float32, "cpu")
    x = _clip(3, t=1)
    z3 = t_vae3d.encode(model, torch.from_numpy(x))[:, 0]
    z2 = t_vae.encode(image_vae, torch.from_numpy(x[:, 0]))
    torch.testing.assert_close(z3, z2, rtol=1e-5, atol=1e-5)
    d3 = t_vae3d.decode(model, z2[:, None])[:, 0]
    d2 = t_vae.decode(image_vae, z2)
    torch.testing.assert_close(d3, d2, rtol=1e-5, atol=1e-5)


def test_causality(vaes):
    """The latents of a 3-frame prefix equal the first 3 of the whole clip's."""
    _, _, model = vaes
    x = torch.from_numpy(_clip(4))
    full = t_vae3d.encode(model, x)
    prefix = t_vae3d.encode(model, x[:, :3])
    torch.testing.assert_close(prefix, full[:, :3], rtol=1e-5, atol=1e-5)
    changed = x.clone()
    changed[:, 3:] = -changed[:, 3:]
    assert (t_vae3d.encode(model, changed)[:, 3:] - full[:, 3:]).abs().max() > 1e-3


def test_state_dict_loader_equals_jax_carry(vaes):
    """``vae3d_from_state_dict`` gives the module that the ``from_jax``
    carry of JAX ``vae_video_from_torch`` of the same dict gives, bit for
    bit, and writes the same file back."""
    sd, jparams, model = vaes
    carried = vae3d_from_jax(jparams, CFG, device="cpu")
    mine, theirs = dict(model.named_parameters()), dict(carried.named_parameters())
    assert mine.keys() == theirs.keys()
    for name, p in mine.items():
        torch.testing.assert_close(p, theirs[name], rtol=0, atol=0, msg=name)
    back = tconv.vae_to_state_dict(model)
    for key, t in back.items():
        if "time_conv" not in key:
            torch.testing.assert_close(t, sd[key], rtol=0, atol=0, msg=key)

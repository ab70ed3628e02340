"""Port DiT, adapter and denoise loop against the JAX package, fp32 on the
CPU, with the same weights (carried by io/from_jax.py) and numpy inputs."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from physicedit_tpu.models import adapters as j_ad
from physicedit_tpu.models import dit as j_dit
from physicedit_tpu.ops import rope as j_rope
from physicedit_tpu.sampling import flow_match as fm
from physicedit_tpu.sampling.denoise import denoise as j_denoise
from physicedit_torch.io.from_jax import dit_from_jax, dual_adapter_from_jax
from physicedit_torch.models import adapters as t_ad
from physicedit_torch.models import dit as t_dit
from physicedit_torch.ops import rope as t_rope
from physicedit_torch.sampling.denoise import denoise as t_denoise

torch.set_num_threads(2)

TOL = 1e-4  # fp32 through a few blocks; matmul summation order differs


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_timestep_embedding_matches_jax(dtype):
    t = np.array([0.0, 0.0123, 0.5, 0.987, 1.0], np.float32)
    want = j_dit.timestep_embedding(jnp.asarray(t), 256, jnp.dtype(dtype))
    got = t_dit.timestep_embedding(torch.from_numpy(t), 256, getattr(torch, dtype))
    # fp32: the angles are bitwise equal, cos/sin differ by an ulp; bf16: one ulp
    tol = 1e-6 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), atol=tol, rtol=0)


@pytest.mark.parametrize("interp", [False, True])
def test_build_rope_tables_matches_jax(interp):
    shapes = [(1, 6, 4), (1, 3, 5)]
    want = j_rope.build_rope_tables(shapes, 37, edit_rope_interpolation=interp)
    got = t_rope.build_rope_tables(shapes, 37, edit_rope_interpolation=interp)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_rope.text_rope_tables(9, 4)[0],
                                  j_rope.text_rope_tables(9, 4)[0])


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 10, 16)).astype(np.float32)
    ang = rng.uniform(-3, 3, size=(10, 8))
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    want = j_rope.apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))
    got = t_rope.apply_rope(*_t(x, cos, sin))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def _dit_inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(1, 4, 4), (1, 4, 4)]
    s_i, s_t = 32, 24
    axes = (16, 24, 24) if cfg.head_dim == 64 else (8, 12, 12)
    img = rng.normal(size=(2, s_i, cfg.patch_dim)).astype(np.float32)
    txt = rng.normal(size=(2, s_t, cfg.txt_in_dim)).astype(np.float32)
    mask = np.ones((2, s_t), bool)
    mask[1, 16:] = False
    ropes = j_rope.build_rope_tables(shapes, s_t, axes_dim=axes)
    return img, txt, np.array([0.7, 0.7], np.float32), ropes, mask


@pytest.mark.parametrize("slim", [0, 16])
def test_dit_forward_matches_jax(slim):
    cfg = j_dit.TINY_CONFIG
    params = _np_tree(j_dit.init_dit_params(jax.random.PRNGKey(0), cfg))
    img, txt, t, ropes, mask = _dit_inputs(cfg)
    want = j_dit.dit_forward(params, cfg, jnp.asarray(img), jnp.asarray(txt), jnp.asarray(t),
                             *map(jnp.asarray, ropes), txt_key_mask=jnp.asarray(mask),
                             attn_impl="xla", slim_last=slim)
    model = dit_from_jax(params, cfg)
    with torch.no_grad():
        got = model(*_t(img, txt, t), *_t(*ropes), txt_key_mask=torch.from_numpy(mask),
                    slim_last=slim, attn_clamp=True)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_attn_clamp_needed_matches_jax():
    cfg = j_dit.DiTConfig(num_layers=2, dim=64, num_heads=2, head_dim=32,
                          txt_in_dim=48, patch_dim=64, time_dim=32)
    params = _np_tree(j_dit.init_dit_params(jax.random.PRNGKey(0), cfg))
    assert t_dit.attn_clamp_needed(dit_from_jax(params, cfg)) is False
    params["blocks"]["attn"]["norm_q"]["scale"] = params["blocks"]["attn"]["norm_q"]["scale"] * 100.0
    assert j_dit.attn_clamp_needed(params) is True
    assert t_dit.attn_clamp_needed(dit_from_jax(params, cfg)) is True


def test_dual_adapter_forward_matches_jax():
    params = _np_tree(j_ad.init_dual_adapter_params(jax.random.PRNGKey(1), 64, 48))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 64, 64)).astype(np.float32)
    t = np.array([950.0, 120.0], np.float32)
    t_min, t_max = fm.adapter_t_range()
    want = j_ad.dual_adapter_forward(params, jnp.asarray(x), jnp.asarray(t), t_min, t_max)
    with torch.no_grad():
        got = t_ad.dual_adapter_forward(dual_adapter_from_jax(params), *_t(x, t), t_min, t_max)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


DENOISE_CASES = {
    # name: (cfg_scale, cfg_truncate_after, attn_clamp, with adapter)
    "cfg_special_tokens": (4.0, None, True, True),
    "cfg_truncate_after_1": (4.0, 1, False, True),
    "no_cfg_no_adapter": (1.0, None, True, False),
}


@pytest.mark.parametrize("case", list(DENOISE_CASES))
def test_denoise_matches_jax(case):
    cfg_scale, trunc, clamp, with_adapter = DENOISE_CASES[case]
    cfg = j_dit.DiTConfig(num_layers=2, dim=64, num_heads=2, head_dim=32,
                          txt_in_dim=64, patch_dim=64, time_dim=32)
    params = _np_tree(j_dit.init_dit_params(jax.random.PRNGKey(2), cfg))
    adapter = _np_tree(j_ad.init_dual_adapter_params(jax.random.PRNGKey(3), 64, 64))
    rng = np.random.default_rng(2)
    b = 2 if cfg_scale != 1.0 else 1
    latents = rng.normal(size=(1, 8, 8, 16)).astype(np.float32)
    extra = rng.normal(size=(1, 16, 64)).astype(np.float32)
    prompt = rng.normal(size=(b, 80, 64)).astype(np.float32)
    mask = np.zeros((b, 80), bool)
    special = np.stack([np.arange(5, 69), np.arange(1, 65)])[:b].astype(np.int32)
    for i, n in enumerate((76, 66)[:b]):
        mask[i, :n] = True
    ropes = j_rope.build_rope_tables([(1, 4, 4), (1, 4, 4)], 80, axes_dim=(8, 12, 12))
    sched = fm.build_schedule(3, fm.QWEN_IMAGE_CONFIG, dynamic_shift_len=16)
    t_min, t_max = fm.adapter_t_range()
    want = j_denoise(params, cfg, jnp.asarray(latents), jnp.asarray(extra),
                     jnp.asarray(prompt), jnp.asarray(mask), *map(jnp.asarray, ropes),
                     jnp.asarray(sched.sigmas), jnp.asarray(sched.sigmas_next),
                     jnp.asarray(sched.timesteps), jnp.asarray(cfg_scale),
                     latent_hw=(8, 8), adapter_params=adapter if with_adapter else None,
                     special_idx=jnp.asarray(special) if with_adapter else None,
                     t_min=t_min, t_max=t_max, attn_clamp=clamp,
                     cfg_truncate_after=trunc)
    got = t_denoise(dit_from_jax(params, cfg), *_t(latents, extra, prompt, mask),
                    *_t(*ropes), *_t(sched.sigmas, sched.sigmas_next, sched.timesteps),
                    cfg_scale, latent_hw=(8, 8),
                    adapter=dual_adapter_from_jax(adapter) if with_adapter else None,
                    special_idx=torch.from_numpy(special).long() if with_adapter else None,
                    t_min=t_min, t_max=t_max, attn_clamp=clamp, cfg_truncate_after=trunc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_denoise_rejects_negative_truncation():
    cfg = t_dit.DiTConfig(num_layers=1, dim=64, num_heads=2, head_dim=32,
                          txt_in_dim=64, patch_dim=64, time_dim=32)
    z = torch.zeros(1)
    with pytest.raises(ValueError, match="cfg_truncate_after"):
        t_denoise(None, torch.zeros(1, 8, 8, 16), None, torch.zeros(2, 4, 64),
                  torch.ones(2, 4, dtype=torch.bool), z, z, z, z, z, z, z, 4.0,
                  latent_hw=(8, 8), cfg_truncate_after=-1)
    assert cfg.mlp_dim == 256

"""Port Qwen2.5-VL (vision tower, text forward, prefill, greedy decode)
against the JAX package, fp32 on the CPU, same weights and inputs."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from PIL import Image

from physicedit_tpu.models import qwen_vl as j_text
from physicedit_tpu.models import qwen_vl_vision as j_vis
from physicedit_tpu.pipeline import vl_host
from physicedit_tpu.pipeline.testing import _rand_text_params, _rand_vision_params
from physicedit_torch.io.from_jax import text_from_jax, vision_from_jax
from physicedit_torch.models import qwen_vl as t_text
from physicedit_torch.models import qwen_vl_vision as t_vis

torch.set_num_threads(2)

TOL = 1e-4  # fp32 through two layers; matmul summation order differs


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def text_models():
    cfg = j_text.TINY_TEXT
    params = _np_tree(_rand_text_params(jax.random.PRNGKey(0), cfg))
    return cfg, params, text_from_jax(params, cfg)


@pytest.fixture(scope="module")
def patches():
    rng = np.random.default_rng(0)
    img = Image.fromarray(rng.integers(0, 255, (84, 56, 3), dtype=np.uint8))
    return vl_host.images_to_patches([img])


def test_vision_geometry_matches_jax():
    for grid in ([(1, 6, 4)], [(1, 8, 12), (1, 4, 4)]):
        want = j_vis.vision_geometry(j_vis.TINY_VISION, grid)
        got = t_vis.vision_geometry(t_vis.TINY_VISION, grid)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


def test_vision_features_match_jax(patches):
    flat, grids = patches
    cfg = j_vis.TINY_VISION
    params = _np_tree(_rand_vision_params(jax.random.PRNGKey(1), cfg))
    want = j_vis.run_vision(params, cfg, jnp.asarray(flat), grids)
    got = vision_from_jax(params, cfg)(torch.from_numpy(flat), grids)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def _text_inputs(cfg, left_pad):
    rng = np.random.default_rng(3)
    b, s = 2, 20
    emb = (rng.normal(size=(b, s, cfg.hidden_size)) * 0.5).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None, None], (3, b, s)).copy()
    mask = np.ones((b, s), bool)
    if left_pad:
        mask[1, :6] = False
    else:
        mask[1, 15:] = False
    return emb, pos, mask


def test_text_forward_matches_jax(text_models):
    cfg, params, model = text_models
    emb, pos, mask = _text_inputs(cfg, left_pad=False)
    want = j_text.text_forward(params, cfg, jnp.asarray(emb), jnp.asarray(pos),
                               jnp.asarray(mask))
    got = model.text_forward(*(torch.from_numpy(a) for a in (emb, pos, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_mrope_matches_jax(text_models):
    cfg = j_text.QWEN25_VL_7B_TEXT
    pos = np.random.default_rng(4).integers(0, 900, size=(3, 2, 7))
    for a, b in zip(t_text.mrope_cos_sin(torch.from_numpy(pos), cfg),
                    j_text.mrope_cos_sin(jnp.asarray(pos), cfg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4, rtol=0)


def _prefill_both(text_models, max_total):
    cfg, params, model = text_models
    emb, pos, mask = _text_inputs(cfg, left_pad=True)
    want = j_text.prefill(params, cfg, jnp.asarray(emb), jnp.asarray(pos),
                          jnp.asarray(mask), max_total_len=max_total)
    got = model.prefill(*(torch.from_numpy(a) for a in (emb, pos, mask)), max_total)
    return want, got, pos, mask


def test_prefill_matches_jax(text_models):
    (lw, cw, hw), (lg, cg, hg), _, _ = _prefill_both(text_models, 32)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lw), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(hg.numpy(), np.asarray(hw), atol=TOL, rtol=TOL)
    for a, b in zip(cg, cw):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)


def test_greedy_decode_tokens_identical(text_models):
    cfg, params, model = text_models
    (lw, cw, _), (lg, cg, _), pos, mask = _prefill_both(text_models, 32)
    s, new = mask.shape[1], 12
    key_mask = np.concatenate([mask, np.zeros((2, 32 - s), bool)], axis=1)
    start_rope = pos.max(axis=(0, 2)) + 1
    want, _ = j_text.greedy_decode(params, cfg, cw, jnp.argmax(lw, -1).astype(jnp.int32),
                                   s, jnp.asarray(start_rope), new,
                                   key_mask=jnp.asarray(key_mask))
    got, steps = model.greedy_decode(cg, lg.argmax(-1), s, torch.from_numpy(start_rope),
                                     new, key_mask=torch.from_numpy(key_mask))
    assert steps == new
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_decode_stops_when_every_row_has_eos(text_models):
    cfg, params, model = text_models
    caches = model.prefill(torch.zeros(2, 4, cfg.hidden_size),
                           torch.zeros(3, 2, 4, dtype=torch.long),
                           torch.ones(2, 4, dtype=torch.bool), 16)[1]
    eos = torch.full((2,), cfg.eos_token_id)
    toks, steps = model.greedy_decode(caches, eos, 4, torch.zeros(2, dtype=torch.long), 8)
    assert steps == 0 and bool((toks == cfg.eos_token_id).all())

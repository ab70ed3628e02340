"""The port's FastBlend (``physicedit_torch/extensions/fastblend.py``) against
the JAX package's, fp32 on the CPU, on the same numpy frames: the three
gather primitives (also against the numpy transliterations of the
reference's CUDA kernels in ``tests/test_fastblend.py``), the pyramid's
resamplers, the NNFs of both matchers under the same seed, and every
runner's frames within one uint8 level."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from physicedit_tpu.extensions import fastblend as jfb
from physicedit_torch.extensions import fastblend as tfb
from tests.test_fastblend import _np_patch_error, _np_remap

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def case():
    """[0, 255] images at batch 2, 12 x 10, patch 5 in a pad of 3, a random NNF."""
    rng = np.random.default_rng(0)
    b, h, w, c, patch, pad = 2, 12, 10, 3, 5, 3

    def padded():
        img = rng.uniform(0, 255, size=(b, h, w, c)).astype(np.float32)
        return np.pad(img, ((0, 0), (pad, pad), (pad, pad), (0, 0)))

    src, tgt = padded(), padded()
    nnf = np.stack([rng.integers(0, h, (b, h, w)), rng.integers(0, w, (b, h, w))],
                   axis=-1).astype(np.int32)
    return src, tgt, nnf, patch, pad


def test_remap_matches_jax_and_the_kernel(case):
    src, _, nnf, patch, pad = case
    got = tfb._remap(_t(src), _t(nnf).long(), patch, pad).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfb._remap(src, nnf, patch, pad)))
    np.testing.assert_allclose(got, _np_remap(src, nnf, patch, pad), rtol=1e-5, atol=1e-3)


# XLA-CPU sums the three squared channel differences as a chain of fmas, the
# port as products and adds: the error sums agree within a few ulps (fp32),
# and exactly on integer images, whose sums are exact
ERR_RTOL = 1e-6


def test_patch_error_matches_jax_and_the_kernel(case):
    src, tgt, nnf, patch, pad = case
    got = tfb._patch_error(_t(src), _t(nnf).long(), _t(tgt), patch, pad).numpy()
    want = np.asarray(jfb._patch_error(src, nnf, tgt, patch, pad))
    np.testing.assert_allclose(got, want, rtol=ERR_RTOL, atol=0)
    np.testing.assert_allclose(got, _np_patch_error(src, nnf, tgt, patch, pad), rtol=1e-5)
    src_i, tgt_i = np.floor(src), np.floor(tgt)
    np.testing.assert_array_equal(
        tfb._patch_error(_t(src_i), _t(nnf).long(), _t(tgt_i), patch, pad).numpy(),
        np.asarray(jfb._patch_error(src_i, nnf, tgt_i, patch, pad)))


def test_pairwise_patch_error_matches_jax(case):
    src, tgt, nnf, patch, pad = case
    nnf_b = nnf[::-1].copy()
    got = tfb._pairwise_patch_error(_t(src), _t(nnf).long(), _t(tgt), _t(nnf_b).long(),
                                    patch, pad).numpy()
    want = jfb._pairwise_patch_error(src, nnf, tgt, nnf_b, patch, pad)
    np.testing.assert_allclose(got, np.asarray(want), rtol=ERR_RTOL, atol=0)


@pytest.mark.parametrize("size", [(6, 10), (13, 21), (5, 7)])
def test_area_resize_matches_jax(size):
    x = np.random.default_rng(2).uniform(0, 255, size=(2, 13, 21, 3)).astype(np.float32)
    got = tfb._area_resize(_t(x), *size).numpy()
    np.testing.assert_allclose(got, np.asarray(jfb._area_resize(x, *size)), rtol=1e-6,
                               atol=1e-4)


@pytest.mark.parametrize("src,dst", [((11, 16), (23, 33)), ((22, 16), (23, 16)),
                                     ((12, 20), (12, 21))])
def test_nnf_resize_equals_jax_image_resize(src, dst):
    """update_nnf's fix-up to an odd level size: jax.image.resize bilinear
    then a cast to int32, value for value."""
    rng = np.random.default_rng(3)
    nnf = np.stack([rng.integers(0, 2 * src[0], (2,) + src),
                    rng.integers(0, 2 * src[1], (2,) + src)], -1).astype(np.int32)
    nnf[0, :, :4] = 7        # runs of equal values: 7 * (w0 + w1) must stay 7
    want = jax.image.resize(jnp.asarray(nnf, jnp.float32), (2,) + dst + (2,),
                            method="bilinear").astype(jnp.int32)
    got = tfb._resize_nnf(_t(nnf).long(), *dst)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _translation(h=64, w=64, seed=3):
    """A smooth image and its (4, 6) translation (tests/test_fastblend.py's case)."""
    from scipy.signal import convolve

    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, size=(h + 8, w + 8, 3)).astype(np.float32)
    base = convolve(base, np.ones((3, 3, 1)) / 9.0, mode="same").astype(np.float32)
    return base[:h, :w], base[4:4 + h, 6:6 + w]


def test_patch_matcher_nnf_equals_jax():
    src, tgt = _translation(32, 32)
    kw = dict(height=32, width=32, channel=3, minimum_patch_size=5, num_iter=2)
    jm = jfb.PatchMatcher(**kw, rng=np.random.default_rng(7))
    tm = tfb.PatchMatcher(**kw, rng=np.random.default_rng(7))
    ident = np.stack(np.meshgrid(np.arange(32), np.arange(32), indexing="ij"), -1)[None]
    want_nnf, want_style = jm.estimate_nnf(src[None], tgt[None], src[None],
                                           jnp.asarray(ident.astype(np.int32)))
    got_nnf, got_style = tm.estimate_nnf(_t(src[None]), _t(tgt[None]), _t(src[None]),
                                         _t(ident).long())
    np.testing.assert_array_equal(got_nnf.numpy(), np.asarray(want_nnf))
    np.testing.assert_allclose(got_style.numpy(), np.asarray(want_style), atol=1e-3)


def test_pyramid_nnf_equals_jax_and_recovers_the_translation():
    src, tgt = _translation()
    kw = dict(image_height=64, image_width=64, channel=3, minimum_patch_size=5, num_iter=3)
    want_nnf, want_style = jfb.PyramidPatchMatcher(**kw).estimate_nnf(
        src[None], tgt[None], src[None])
    engine = tfb.PyramidPatchMatcher(**kw, device="cpu")
    assert engine.pyramid_level == 2
    got_nnf, got_style = engine.estimate_nnf(_t(src[None]), _t(tgt[None]), _t(src[None]))
    np.testing.assert_array_equal(got_nnf.numpy(), want_nnf)
    np.testing.assert_allclose(got_style.numpy(), want_style, atol=1e-3)
    err = np.abs(got_style.numpy()[0] - tgt).mean()
    assert err < np.abs(src - tgt).mean() * 0.35


def _clip(n=5, h=24, w=32, seed=4):
    """A guide that drifts a pixel a frame and a flickering style."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(60, 200, size=(h, w + n, 3)).astype(np.float32)
    guide = [base[:, i:i + w].clip(0, 255).astype(np.uint8) for i in range(n)]
    style = [(g + rng.normal(scale=12.0, size=g.shape)).clip(0, 255).astype(np.uint8)
             for g in guide]
    return guide, style


@pytest.mark.parametrize("mode", ["Fast", "Balanced", "Accurate"])
def test_smooth_video_matches_jax(mode):
    guide, style = _clip()
    kw = dict(mode=mode, window_size=3, batch_size=4, minimum_patch_size=5, num_iter=2)
    want = jfb.smooth_video(guide, style, **kw)
    got = tfb.smooth_video(guide, style, **kw, device="cpu")
    assert len(got) == 5 and all(g.dtype == np.uint8 and g.shape == (24, 32, 3) for g in got)
    for g, w in zip(got, want):
        assert np.abs(g.astype(np.int16) - w.astype(np.int16)).max() <= 1


@pytest.mark.parametrize("keys", [[0, 4], [0]])
def test_interpolate_video_matches_jax(keys):
    guide, style = _clip(n=5)
    keyframes = [style[k] for k in keys]
    kw = dict(batch_size=4, minimum_patch_size=5, num_iter=2,
              tracking_window_size=1 if len(keys) == 1 else 0)
    want = jfb.interpolate_video(guide, keyframes, keys, **kw)
    got = tfb.interpolate_video(guide, keyframes, keys, **kw, device="cpu")
    assert sum(f is not None for f in got) == 5
    for g, w in zip(got, want):
        assert np.abs(g.astype(np.int16) - w.astype(np.int16)).max() <= 1


def test_smoother_requires_guide_frames_as_jax_does():
    with pytest.raises(ValueError, match="original_frames"):
        jfb.FastBlendSmoother()([np.zeros((32, 32, 3), np.uint8)])
    with pytest.raises(ValueError, match="original_frames"):
        tfb.FastBlendSmoother("cpu")([np.zeros((32, 32, 3), np.uint8)])

"""The port's tiler, ESRGAN and RIFE (``physicedit_torch/extensions``) against
the JAX package's (``physicedit_tpu/extensions``), fp32 on the CPU, the
same numpy inputs and the same weights: a reference-layout state dict drawn
from a numpy seed, read by both packages' converters (and carried from the
JAX tree by ``io/from_jax``)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax.numpy as jnp
from PIL import Image

from physicedit_tpu.extensions import esrgan as j_esrgan
from physicedit_tpu.extensions import rife as j_rife
from physicedit_tpu.extensions import tiler as j_tiler
from physicedit_torch.extensions import esrgan as t_esrgan
from physicedit_torch.extensions import rife as t_rife
from physicedit_torch.extensions import tiler as t_tiler
from physicedit_torch.io import safetensors_io as tst
from physicedit_torch.io.from_jax import esrgan_from_jax, ifnet_from_jax, load_tree_

torch.set_num_threads(2)

TOL = 1e-4      # fp32 conv stacks; only the summation order differs


def _frames(n, h, w, seed):
    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)) for _ in range(n)]


def _levels(a, b):
    return np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16)).max()


# ---------------------------------------------------------------------------
# Tiler: the same numpy model through both packages' tiling and blending
# ---------------------------------------------------------------------------

def _blur_np(x):
    """A 3x3 box blur over the H, W axes (the two before the last), edge
    replicated, and a per-channel gain: every output pixel sees its window."""
    pad = [(0, 0)] * x.ndim
    pad[-3], pad[-2] = (1, 1), (1, 1)
    xp = np.pad(x, pad, mode="edge")
    h, w = x.shape[-3], x.shape[-2]
    out = sum(xp[..., i:i + h, j:j + w, :] for i in range(3) for j in range(3)) / 9.0
    return (out * (1.0 + np.arange(x.shape[-1]))).astype(np.float32)


def _up2_np(x):
    return _blur_np(x.repeat(2, axis=-3).repeat(2, axis=-2))


def _torch_fn(fn):
    return lambda t: torch.from_numpy(fn(t.numpy()))


@pytest.mark.parametrize("case", ["2d", "2d_scale", "3d"])
def test_tiler_matches_jax(case):
    rng = np.random.default_rng(0)
    if case == "3d":
        # ragged: 41 x 30 under tiles (16, 12) at strides (12, 8), edge tiles clamp inward
        x = rng.normal(size=(1, 3, 41, 30, 2)).astype(np.float32)
        want = j_tiler.tiled_forward_3d(_blur_np, x, (16, 12), (12, 8))
        got = t_tiler.tiled_forward_3d(_torch_fn(_blur_np), torch.from_numpy(x), (16, 12),
                                       (12, 8))
        assert (41 - 16) % 12 and (30 - 12) % 8     # neither axis tiles evenly
    else:
        x = rng.normal(size=(2, 50, 37, 3)).astype(np.float32)
        fn, scales = (_blur_np, (1, 1, 1)) if case == "2d" else (_up2_np, (1, 2, 2))
        want = j_tiler.tiled_forward(fn, x, 16, 12, scales=scales)
        got = t_tiler.tiled_forward(_torch_fn(fn), torch.from_numpy(x), 16, 12, scales=scales)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_tile_tasks_clamp_edge_tiles_inward():
    assert t_tiler._tile_tasks(50, 16, 12) == j_tiler._tile_tasks(50, 16, 12) \
        == [(0, 16), (12, 28), (24, 40), (34, 50)]
    np.testing.assert_array_equal(t_tiler.build_mask(9, 7, (True, False, False, True), 3),
                                  j_tiler.build_mask(9, 7, (True, False, False, True), 3))


# ---------------------------------------------------------------------------
# ESRGAN
# ---------------------------------------------------------------------------

def esrgan_state_dict(num_feat=16, num_block=2, num_grow_ch=8, seed=0) -> dict:
    """A Real-ESRGAN-layout state dict with numpy-drawn weights."""
    rng = np.random.default_rng(seed)
    shapes = {"conv_first": (num_feat, 3)}
    for b in range(num_block):
        for j in range(1, 4):
            for i in range(5):
                shapes[f"body.{b}.rdb{j}.conv{i + 1}"] = (
                    num_grow_ch if i < 4 else num_feat, num_feat + i * num_grow_ch)
    for name in ("conv_body", "conv_up1", "conv_up2", "conv_hr"):
        shapes[name] = (num_feat, num_feat)
    shapes["conv_last"] = (3, num_feat)
    sd = {}
    for name, (o, i) in shapes.items():
        sd[f"{name}.weight"] = (rng.normal(size=(o, i, 3, 3)) * 0.05).astype(np.float32)
        sd[f"{name}.bias"] = (rng.normal(size=(o,)) * 0.01).astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def esrgans():
    sd = esrgan_state_dict()
    jparams = j_esrgan.esrgan_from_torch(sd)
    return sd, jparams, t_esrgan.esrgan_from_state_dict(sd, device="cpu")


def test_esrgan_forward_matches_jax(esrgans):
    sd, jparams, net = esrgans
    x = np.random.default_rng(1).uniform(0, 1, size=(2, 16, 24, 3)).astype(np.float32)
    want = np.asarray(j_esrgan.rrdbnet_forward(jparams, jnp.asarray(x)))
    got = t_esrgan.rrdbnet_forward(net, torch.from_numpy(x))
    assert tuple(got.shape) == (2, 64, 96, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    # the carry of the JAX scan layout (body stacked) gives the same module
    carried = esrgan_from_jax(jparams, device="cpu")
    for (name, p), q in zip(net.named_parameters(), carried.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=name)


def test_esrgan_upscale_matches_jax_within_one_level(esrgans):
    _, jparams, net = esrgans
    ims = _frames(3, 20, 16, 2)
    want = j_esrgan.upscale(jparams, ims, batch_size=2)
    got = t_esrgan.upscale(net, ims, batch_size=2)
    assert [g.size for g in got] == [(64, 80)] * 3
    assert max(_levels(g, w) for g, w in zip(got, want)) <= 1
    single = t_esrgan.upscale(net, ims[0])
    assert isinstance(single, Image.Image) and single.size == (64, 80)


def test_esrgan_upscale_truncates_to_uint8():
    """upscale converts by clip then truncation (0.999 -> 254), not rounding."""
    net = t_esrgan.RRDBNet(num_feat=4, num_block=1, num_grow_ch=2).to_empty(device="cpu")
    with torch.no_grad():
        for p in net.parameters():
            p.zero_()
        net.conv_last.bias.fill_(254.9 / 255.0)
    out = np.asarray(t_esrgan.upscale(net, _frames(1, 8, 8, 3)[0]))
    assert (out == 254).all()


def test_load_esrgan_reads_a_reference_file(esrgans, tmp_path):
    sd, _, net = esrgans
    path = str(tmp_path / "esrgan.safetensors")
    tst.save_safetensors(sd, path)
    assert tst.detect_model_name(tst.load_state_dict(path)) == "esrgan"
    loaded = t_esrgan.load_esrgan(path, device="cpu")
    jloaded = esrgan_from_jax(j_esrgan.load_esrgan(path), device="cpu")
    for (name, p), q, r in zip(loaded.named_parameters(), net.parameters(),
                               jloaded.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=name)
        torch.testing.assert_close(p, r, rtol=0, atol=0, msg=name)


# ---------------------------------------------------------------------------
# RIFE
# ---------------------------------------------------------------------------

def ifnet_state_dict(c=16, seed=0, prefix="module.") -> dict:
    """A reference-layout IFNet state dict (``module.`` prefixed, with a
    training-only ``block_tea`` key) with numpy-drawn weights."""
    rng = np.random.default_rng(seed)
    net = t_rife.IFNet(c).to_empty(device="cpu")
    sd = {}
    for key, t in t_rife.ifnet_to_state_dict(net).items():
        if key.endswith(".1.weight"):           # a PReLU slope
            arr = rng.uniform(0.1, 0.4, size=t.shape)
        elif t.dim() > 1:
            arr = rng.normal(size=t.shape) * 0.05
        else:
            arr = rng.normal(size=t.shape) * 0.01
        sd[prefix + key] = arr.astype(np.float32)
    sd[prefix + "block_tea.conv0.0.0.weight"] = np.zeros((2, 2, 3, 3), np.float32)
    return sd


@pytest.fixture(scope="module")
def ifnets():
    sd = ifnet_state_dict()
    jparams = j_rife.ifnet_from_torch(sd)
    return sd, jparams, t_rife.ifnet_from_state_dict(sd, device="cpu")


@pytest.mark.parametrize("size", [(8, 12), (13, 21), (64, 96), (37, 50)])
def test_resize_bilinear_matches_jax(size):
    x = np.random.default_rng(3).normal(size=(2, 32, 48, 5)).astype(np.float32)
    want = np.asarray(j_rife._resize_bilinear(jnp.asarray(x), *size))
    got = t_rife._resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), *size)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5, atol=1e-5)


def test_warp_matches_jax_with_flows_past_every_border():
    rng = np.random.default_rng(4)
    img = rng.normal(size=(2, 16, 24, 3)).astype(np.float32)
    flow = (rng.normal(size=(2, 16, 24, 2)) * 3).astype(np.float32)
    flow[0, :4, :, 1] = -40.0      # above the top
    flow[0, -4:, :, 1] = 40.0      # below the bottom
    flow[1, :, :4, 0] = -60.0      # left of the left edge
    flow[1, :, -4:, 0] = 60.0      # right of the right edge
    flow[1, 5, 5] = [-1e3, 1e3]
    want = np.asarray(j_rife.warp(jnp.asarray(img), jnp.asarray(flow)))
    got = t_rife.warp(torch.from_numpy(img).permute(0, 3, 1, 2),
                      torch.from_numpy(flow).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6, atol=1e-6)
    # the reference's own call, grid_sample on the normalised grid
    h, w = img.shape[1:3]
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    grid = np.stack([(gx + flow[..., 0]) / ((w - 1) / 2) - 1,
                     (gy + flow[..., 1]) / ((h - 1) / 2) - 1], -1).astype(np.float32)
    ref = F.grid_sample(torch.from_numpy(img).permute(0, 3, 1, 2), torch.from_numpy(grid),
                        mode="bilinear", padding_mode="border", align_corners=True)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def test_deconv_carry_with_an_asymmetric_kernel():
    """JAX's HWIO kernel applied with transpose_kernel=True, carried into an
    nn.ConvTranspose2d: a kernel with no symmetry, 5 -> 3 channels."""
    rng = np.random.default_rng(5)
    p = {"w": rng.normal(size=(4, 4, 3, 5)).astype(np.float32),
         "b": rng.normal(size=(3,)).astype(np.float32)}
    assert not np.allclose(p["w"], p["w"][::-1, ::-1])
    x = rng.normal(size=(2, 6, 7, 5)).astype(np.float32)
    want = np.asarray(j_rife._deconv({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    deconv = t_rife._deconv(5, 3).to_empty(device="cpu")
    holder = torch.nn.Module()
    holder.d = deconv
    load_tree_(holder, {"d": p})
    got = deconv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert tuple(got.shape) == (2, 12, 14, 3)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)


def test_ifnet_forward_matches_jax(ifnets):
    sd, jparams, net = ifnets
    rng = np.random.default_rng(6)
    img0, img1 = (rng.random((1, 64, 64, 3)).astype(np.float32) for _ in range(2))
    want = j_rife.ifnet_forward(jparams, jnp.asarray(img0), jnp.asarray(img1))
    got = t_rife.ifnet_forward(net, torch.from_numpy(img0), torch.from_numpy(img1))
    for name, g, w in zip(("flow", "mask", "merged"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL, err_msg=name)
    # the carry of the JAX tree gives the same module
    carried = ifnet_from_jax(jparams, device="cpu")
    for (name, p), q in zip(net.named_parameters(), carried.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=name)


def test_rife_drivers_match_jax(ifnets):
    _, jparams, net = ifnets
    frames = _frames(3, 64, 64, 7)
    want = j_rife.RIFEInterpolater(jparams).interpolate(frames, batch_size=2)
    got = t_rife.RIFEInterpolater(net).interpolate(frames, batch_size=2)
    assert len(got) == len(want) == 5 and got[0].size == (64, 64)
    assert max(_levels(g, w) for g, w in zip(got, want)) <= 1
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(frames[0]))
    # a size that is not a multiple of 32 rounds up and back; the smoother
    frames48 = _frames(4, 48, 40, 8)
    want = j_rife.RIFESmoother(jparams)(frames48, batch_size=2)
    got = t_rife.RIFESmoother(net)(frames48, batch_size=2)
    assert len(got) == 4 and got[1].size == (40, 48)
    assert max(_levels(g, w) for g, w in zip(got, want)) <= 1


def test_load_rife_reads_a_reference_file(ifnets, tmp_path):
    sd, jparams, net = ifnets
    path = str(tmp_path / "flownet.safetensors")
    tst.save_safetensors(sd, path)
    assert tst.detect_model_name(tst.load_state_dict(path)) == "rife"
    loaded = t_rife.load_rife(path, device="cpu")
    jloaded = ifnet_from_jax(j_rife.load_rife(path), device="cpu")
    for (name, p), q, r in zip(loaded.named_parameters(), net.parameters(),
                               jloaded.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=name)
        torch.testing.assert_close(p, r, rtol=0, atol=0, msg=name)
    back = t_rife.ifnet_to_state_dict(loaded)
    assert set(back) == {k.replace("module.", "") for k in sd if "block_tea" not in k}

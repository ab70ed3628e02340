"""The port's training slice against the JAX package on the CPU, in fp32
and, once, in the card lanes' bf16.

The same numpy inputs and the same weights (carried by io/from_jax.py) go
through the JAX function and its counterpart in physicedit_torch.  The JAX
Pallas kernels run in interpret mode, so the attention backward (K8) and the
W4 input gradient (K9) of the JAX side are the kernels themselves; the
port's wrappers take their plain versions on CPU tensors.  Tolerances are
stated beside each comparison.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from PIL import Image

from physicedit_tpu import lora as j_lora
from physicedit_tpu.kernels import flash_attention as jfa
from physicedit_tpu.kernels import quant_matmul as jqm
from physicedit_tpu.models import adapters as j_ad
from physicedit_tpu.models import dinov2 as j_dino
from physicedit_tpu.models import dit as j_dit
from physicedit_tpu.ops import rope as j_rope
from physicedit_tpu.pipeline import visual_prior as j_vp
from physicedit_tpu.pipeline.testing import build_tiny_pipeline
from physicedit_tpu.sampling import flow_match as j_fm
from physicedit_tpu.train import checkpoint as j_ckpt
from physicedit_tpu.train import loss as j_loss
from physicedit_tpu.train import train_step as j_ts
from physicedit_tpu.train import trainer as j_trainer
from physicedit_torch.io.from_jax import (dinov2_from_jax, dit_from_jax, lora_from_jax,
                                          pipeline_from_jax, to_jax_tree, trainable_from_jax)
from physicedit_torch.kernels import flash_attention as tfa
from physicedit_torch.kernels import quant_matmul as tqm
from physicedit_torch.lora import export_dit_lora, lora_delta, lora_delta_fused
from physicedit_torch.models import adapters as t_ad
from physicedit_torch.models import dinov2 as t_dino
from physicedit_torch.models.dit import DiTConfig as TDiTConfig
from physicedit_torch.pipeline import visual_prior as t_vp
from physicedit_torch.train import checkpoint as t_ckpt
from physicedit_torch.train import loss as t_loss
from physicedit_torch.train import train_step as t_ts
from physicedit_torch.train import trainer as t_trainer

torch.set_num_threads(2)

FP32_TOL = 2e-5     # fp32 on both sides; only the summation order differs
LOSS_TOL = 1e-4     # a loss through a few DiT blocks and the adapters, fp32
GRAD_TOL = 1e-3     # rel-L2 of each gradient leaf over the same path
BF16_LOSS_TOL = 1e-3  # the same loss with a bf16 frozen DiT and bf16 activations
BF16_GRAD_TOL = 1e-1  # rel-L2 of each gradient leaf there (worst leaf ~3e-2: img_mod's A)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    """Run pallas_call in interpreter mode on the CPU (as the JAX tests do)."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _assert_trees_close(got, want, tol, path=""):
    """Every leaf of two nests of dicts / lists within rel-L2 ``tol``."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_trees_close(got[k], want[k], tol, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_close(g, w, tol, f"{path}/{i}")
    else:
        assert np.shape(got) == np.shape(want), (path, np.shape(got), np.shape(want))
        rel = _rel_l2(got, want)
        assert rel <= tol, f"{path}: rel-L2 {rel:.3e} > {tol}"


def _leaves_nonzero(tree):
    """Every leaf nonzero but the two whose gradient cancels by construction
    (``train.trainer.ZERO_GRAD_PARAMS``)."""
    zero = {("adapters", n.split(".")[1], "fc2", "b") for n in t_trainer.ZERO_GRAD_PARAMS}
    for path, x in jax.tree_util.tree_leaves_with_path(tree):
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        if (np.abs(np.asarray(x)).max() > 0) == (key in zero):
            return False
    return True


# ---------------------------------------------------------------------------
# K8: the fixed-max attention backward
# ---------------------------------------------------------------------------

def _bnsd(rng, b, n, s, scale=1.0):
    x = rng.normal(size=(b, n, s, 128)).astype(np.float32)
    return x / np.sqrt((x ** 2).mean(-1, keepdims=True)) * scale


K8_CASES = {
    # name: (b, n, sq, sk, q/k scale, clamp, masked spans per batch row)
    "masked_keys": (2, 2, 256, 256, 1.0, True, [(200, 256), (30, 90)]),
    "clamp_binds": (1, 2, 128, 128, 8.0, True, []),
    "noclamp_sq_ne_sk": (1, 2, 128, 256, 1.0, False, [(250, 256)]),
    "fully_masked_row": (2, 1, 128, 128, 1.0, True, [(0, 0), (0, 128)]),
    # the card kernel's 128-row own tiles and 64-row stream tiles: a ragged
    # length, a key-mask hole across key 128, S_q < S_k both ragged
    "tile_edge_s_129": (1, 2, 129, 129, 1.0, True, [(100, 129)]),
    "tile_edge_s_300_hole_across_key_128": (2, 2, 300, 300, 1.0, True, [(100, 160), (0, 0)]),
    "tile_edge_sq_130_lt_sk_385": (1, 2, 130, 385, 1.0, False, [(350, 385)]),
}


def _pad_rows(x, axis, to, value=0.0):
    """x padded with ``value`` along ``axis`` to a multiple of ``to`` (the
    JAX kernels take block multiples)."""
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, (-x.shape[axis]) % to)
    return np.pad(x, widths, constant_values=value)


@pytest.mark.parametrize("case", list(K8_CASES))
def test_fixedmax_bwd_plain_matches_pallas(case):
    """K8's plain twin against the JAX package's _fm_bwd (Pallas, interpret
    mode) on the same prescaled q', l and D.  Ragged lengths are padded to
    the JAX blocks: padded keys masked, padded query rows with g = 0 and
    D = 0 (their dS is 0, so they add nothing to dk or dv)."""
    b, n, sq, sk, scale, clamp, spans = K8_CASES[case]
    rng = np.random.default_rng(sorted(K8_CASES).index(case))
    q = _bnsd(rng, b, n, sq, scale) * np.float32(jfa.LOG2E / np.sqrt(128))
    k = _bnsd(rng, b, n, sk, scale)
    v = rng.normal(size=(b, n, sk, 128)).astype(np.float32)
    g = rng.normal(size=(b, n, sq, 128)).astype(np.float32)
    mask = np.ones((b, sk), bool)
    for row, (lo, hi) in enumerate(spans):
        mask[row, lo:hi] = False
    if case == "clamp_binds":
        assert (np.einsum("bnqd,bnkd->bnqk", q, k) > jfa.CLAMP).mean() > 0.01
    tq, tk, tv, tg, tm = (_t(a) for a in (q, k, v, g, mask))
    out, l = tfa._fixedmax_prescaled_reference(tq, tk, tv, tm, clamp)
    got = tfa.fixedmax_attention_bwd_reference(tq, tk, tv, tm, tg, out, l, clamp)

    key_bias = jnp.where(jnp.asarray(_pad_rows(mask, 1, 128)), 0.0,
                         jfa.NEG_INF)[:, None, :].astype(jnp.float32)
    dd = _pad_rows(tfa.attention_bwd_rowdot(tg, out).numpy(), 2, 128)
    lp = _pad_rows(l.numpy(), 2, 128, 1.0)
    want = jfa._fm_bwd(jnp.asarray(_pad_rows(q, 2, 128)), jnp.asarray(_pad_rows(k, 2, 128)),
                       jnp.asarray(_pad_rows(v, 2, 128)), key_bias,
                       jnp.asarray(_pad_rows(g, 2, 128)),
                       jnp.broadcast_to(jnp.asarray(dd)[..., None], dd.shape + (8,)),
                       jnp.broadcast_to(jnp.asarray(lp)[..., None], lp.shape + (8,)),
                       128, 128, clamp=clamp, prescaled=True)
    for x, y, s in zip(got, want, (sq, sk, sk)):
        assert torch.isfinite(x).all()
        np.testing.assert_allclose(x.numpy(), np.asarray(y)[:, :, :s], rtol=1e-4, atol=1e-4)
    if case == "fully_masked_row":
        for x in got:
            np.testing.assert_array_equal(x[1].numpy(), 0.0)


@pytest.mark.parametrize("ragged", [False, True])
def test_fixedmax_autograd_matches_jax_vjp(ragged):
    """Gradients of the port's differentiable K1 (prescale, forward, K8's
    plain twin) against jax.vjp of flash_attention_bnsd (Pallas forward and
    backward, interpret mode), raw q included; S = 200 is not a block
    multiple."""
    s = 200 if ragged else 256
    rng = np.random.default_rng(5 + ragged)
    q, k = _bnsd(rng, 1, 2, s), _bnsd(rng, 1, 2, s)
    v = rng.normal(size=(1, 2, s, 128)).astype(np.float32)
    g = rng.normal(size=(1, 2, s, 128)).astype(np.float32)
    mask = np.ones((1, s), bool)
    mask[0, 150:180] = False
    fn = functools.partial(jfa.flash_attention_bnsd, key_mask=jnp.asarray(mask), block_q=128,
                           block_k=128, clamp=True)
    out_j, vjp = jax.vjp(lambda a, b_, c: fn(a, b_, c), jnp.asarray(q), jnp.asarray(k),
                         jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = tfa.fixedmax_attention(tq, tk, tv, _t(mask), clamp=True)
    out.backward(_t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=FP32_TOL,
                               atol=FP32_TOL)
    for x, y in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-4, atol=1e-4)


def test_fixedmax_bwd_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    q = _t(_bnsd(rng, 1, 1, 64))
    mask = torch.ones((1, 64), dtype=torch.bool)
    out, l = tfa._fixedmax_prescaled_reference(q, q, q, mask, True)
    before = dict(tfa.LAUNCHES)
    got = tfa.fixedmax_attention_bwd(q, q, q, mask, q, out, l)
    want = tfa.fixedmax_attention_bwd_reference(q, q, q, mask, q, out, l)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tfa.LAUNCHES == before


# ---------------------------------------------------------------------------
# K9: the W4 input gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(37, 256, 384), (2, 512, 256), (9, 96, 256),
                                   # the card kernel's tile edges: 128 dx rows, 128
                                   # packed columns, 64 n a stage
                                   (17, 256, 384), (129, 1280, 128), (255, 1280, 384),
                                   (1000, 18944, 128)],
                         ids=["kernel_route", "kernel_route_m2", "dense_fallback",
                              "tile_edge_m17", "tile_edge_m129", "tile_edge_m255",
                              "tile_edge_m1000"])
def test_w4_bwd_matches_jax(shape):
    """dx of the port's differentiable W4 linear (K9's plain twin, or the
    dense fallback where K/2 % 128) against the JAX package's
    _w4a8_linear_bwd (its Pallas kernel in interpret mode)."""
    m, k, n = shape
    rng = np.random.default_rng(m)
    w = rng.normal(size=(k, n)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    leaf = jqm.quantize_weight_int4(jnp.asarray(w))
    leaf["b"] = jnp.asarray(b)
    g = rng.normal(size=(m, n)).astype(np.float32)
    _, want = jqm._w4a8_linear_bwd((leaf,), jnp.asarray(g))

    lin = tqm.W4Linear(k, n, bias=True, dtype=torch.float32, device="cpu")
    lin.w4.copy_(_t(np.asarray(leaf["w4"]).T))
    lin.w_scale.copy_(_t(leaf["w_scale"]))
    lin.bias.copy_(_t(b))
    x = _t(rng.normal(size=(m, k)).astype(np.float32)).requires_grad_(True)
    y = tqm.w4a8_linear(lin, x)
    y.backward(_t(g))
    # fp32 sums of bf16-rounded g * w_scale (or fp32 products) in another order
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    if k // 2 % 128 == 0:
        np.testing.assert_array_equal(
            tqm.w4_bwd_dx_reference(_t(g), lin.w4, lin.w_scale).numpy(), x.grad.numpy())


# ---------------------------------------------------------------------------
# Adapters, resamplers, DINOv2, the visual prior
# ---------------------------------------------------------------------------

def _perceiver(dim, media, seed):
    params = _np_tree(j_ad.init_perceiver_params(jax.random.PRNGKey(seed), dim,
                                                 max_num_media_tokens=media))
    rng = np.random.default_rng(seed)
    # non-trivial LayerNorm affines
    for layer in params["layers"]:
        for ln in (layer["attn"]["norm_media"], layer["attn"]["norm_latents"],
                   layer["ff"]["norm"]):
            ln["scale"] = (1 + 0.1 * rng.normal(size=ln["scale"].shape)).astype(np.float32)
            ln["bias"] = (0.1 * rng.normal(size=ln["bias"].shape)).astype(np.float32)
    return params


def _load(module, tree):
    from physicedit_torch.core.params import materialize
    from physicedit_torch.io.from_jax import load_tree_

    module = materialize(module, "cpu")
    load_tree_(module, tree)
    return module


@pytest.mark.parametrize("masked", [False, True])
def test_perceiver_resampler_matches_jax(masked):
    params = _perceiver(48, 512, 1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 300, 48)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((2, 300), bool)
        mask[0, 200:] = False
        mask[1, :50] = False
    want = j_ad.perceiver_resampler(params, jnp.asarray(x),
                                    media_mask=None if mask is None else jnp.asarray(mask))
    model = _load(t_ad.PerceiverResampler(48, max_num_media_tokens=512), params)
    got = model(_t(x), media_mask=None if mask is None else _t(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_visual_thinking_and_dual_loss_match_jax():
    rng = np.random.default_rng(4)
    head = _np_tree(j_ad.init_visual_thinking_params(jax.random.PRNGKey(3), 48, 64))
    x = rng.normal(size=(2, 64, 48)).astype(np.float32)
    want = j_ad.visual_thinking_adapter(head, jnp.asarray(x))
    got = t_ad.visual_thinking_adapter(_load(t_ad.visual_thinking_head(48, 64), head), _t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # a bf16 input against fp32 weights is promoted to fp32, as jnp promotes
    got16 = t_ad.visual_thinking_adapter(_load(t_ad.visual_thinking_head(48, 64), head),
                                         _t(x).bfloat16())
    assert got16.dtype == torch.float32

    preds = [rng.normal(size=(3, 64, 32)).astype(np.float32) for _ in range(4)]
    t = np.array([10.0, 500.0, 990.0], np.float32)
    t_min, t_max = j_fm.adapter_t_range()
    want = j_ad.dual_adapter_loss(*(jnp.asarray(p) for p in preds), jnp.asarray(t), t_min, t_max)
    got = t_ad.dual_adapter_loss(*(_t(p) for p in preds), _t(t), t_min, t_max)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _jax_dinov2_params(cfg, grid, seed):
    """A JAX DINOv2 tree from numpy (the layout of io/convert.dinov2_from_torch)."""
    rng = np.random.default_rng(seed)
    d, L = cfg.hidden_size, cfg.num_layers

    def lin(i, o):
        return {"w": (rng.normal(size=(L, i, o)) / np.sqrt(i)).astype(np.float32),
                "b": (0.02 * rng.normal(size=(L, o))).astype(np.float32)}

    def ln():
        return {"scale": (1 + 0.1 * rng.normal(size=(L, d))).astype(np.float32),
                "bias": (0.1 * rng.normal(size=(L, d))).astype(np.float32)}

    return {
        "cls_token": rng.normal(size=(1, 1, d)).astype(np.float32),
        "register_tokens": rng.normal(size=(1, cfg.num_register_tokens, d)).astype(np.float32),
        "pos_emb": rng.normal(size=(1, 1 + grid * grid, d)).astype(np.float32),
        "patch_embed": {"w": (rng.normal(size=(14, 14, 3, d)) / 24).astype(np.float32),
                        "b": (0.02 * rng.normal(size=(d,))).astype(np.float32)},
        "layers": {"norm1": ln(), "qkv": lin(d, 3 * d), "out": lin(d, d),
                   "ls1": (0.5 + 0.1 * rng.normal(size=(L, d))).astype(np.float32),
                   "norm2": ln(), "fc1": lin(d, 4 * d), "fc2": lin(4 * d, d),
                   "ls2": (0.5 + 0.1 * rng.normal(size=(L, d))).astype(np.float32)},
    }


@pytest.mark.parametrize("grid_in,grid_out", [(37, 16), (20, 16), (9, 12)])
def test_pos_embed_resize_matches_jax_image_resize(grid_in, grid_out):
    """The host-built weights reproduce jax.image.resize('bicubic'), which
    antialiases when it shrinks (37 -> 16 is the real DINOv2-B table at 224)."""
    rng = np.random.default_rng(grid_in)
    pos = rng.normal(size=(1, 1 + grid_in * grid_in, 24)).astype(np.float32)
    want = j_dino.interpolate_pos_embed(jnp.asarray(pos), grid_out, grid_out)
    got = t_dino.interpolate_pos_embed(_t(pos), grid_out, grid_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_dinov2_features_match_jax():
    cfg = j_dino.DinoV2Config(hidden_size=48, num_layers=2, num_heads=3)
    params = _jax_dinov2_params(cfg, 37, 0)     # the 37 x 37 table shrinks to 16 x 16
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 224, 224, 3)).astype(np.float32)
    want = j_dino.dinov2_features(params, cfg, jnp.asarray(x))
    got = dinov2_from_jax(params, cfg, device="cpu")(_t(x))
    assert got.shape == (2, 256, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_dino_preprocess_bitwise():
    rng = np.random.default_rng(0)
    frames = [Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
              for h, w in ((480, 832), (300, 200), (240, 240))]
    want = j_vp.dino_preprocess(frames, np.random.default_rng(7))
    got = t_vp.dino_preprocess(frames, np.random.default_rng(7))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# LoRA, the DiT with LoRA
# ---------------------------------------------------------------------------

TRAIN_DIT = j_dit.DiTConfig(num_layers=2, dim=256, num_heads=2, head_dim=128, txt_in_dim=64,
                            patch_dim=64, time_dim=32)


def _lora_tree(cfg, rank, seed):
    """JAX LoRA factors with a nonzero B, so every factor moves the output."""
    lora = _np_tree(j_lora.init_dit_lora(jax.random.PRNGKey(seed), cfg, rank=rank))
    rng = np.random.default_rng(seed)
    for leaf in lora.values():
        leaf["B"] = (0.05 * rng.normal(size=leaf["B"].shape)).astype(np.float32)
    return lora


def test_lora_deltas_and_export_match_jax():
    lora = _lora_tree(TRAIN_DIT, 4, 0)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 256)).astype(np.float32)
    port = lora_from_jax(lora, TRAIN_DIT, device="cpu")
    lay = port.layers()[1]
    np.testing.assert_allclose(
        lora_delta_fused(lay["img_qkv"], _t(x)).detach().numpy(),
        np.asarray(j_lora.lora_delta_fused(jax.tree_util.tree_map(lambda a: a[1],
                                                                  lora["img_qkv"]),
                                           jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        lora_delta(lay["to_out"], _t(x)).detach().numpy(),
        np.asarray(j_lora.lora_delta(jax.tree_util.tree_map(lambda a: a[1], lora["to_out"]),
                                     jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    # a bf16 activation against fp32 factors: fp32, as jnp promotes
    assert lora_delta(lay["to_out"], _t(x).bfloat16()).dtype == torch.float32
    want = j_lora.export_dit_lora(lora)
    got = export_dit_lora(port)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def _dit_inputs(cfg, s_img=16, s_edit=16, s_txt=24, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(1, s_img + s_edit, cfg.patch_dim)).astype(np.float32)
    txt = rng.normal(size=(1, s_txt, cfg.txt_in_dim)).astype(np.float32)
    mask = np.ones((1, s_txt), bool)
    mask[0, 19:] = False
    ropes = j_rope.build_rope_tables([(1, 4, 4), (1, 4, 4)], s_txt, axes_dim=(16, 56, 56))
    return img, txt, np.array([0.37], np.float32), mask, ropes


@pytest.mark.parametrize("quantize", [False, True])
def test_dit_forward_with_lora_matches_jax(quantize):
    params = _np_tree(j_dit.init_dit_params(jax.random.PRNGKey(2), TRAIN_DIT))
    if quantize:
        params = _np_tree(jqm.quantize_tree_int4(params, skip_top=jqm.DIT_OUTER_KEYS))
    lora = _lora_tree(TRAIN_DIT, 4, 3)
    img, txt, t, mask, ropes = _dit_inputs(TRAIN_DIT)
    want = j_dit.dit_forward(params, TRAIN_DIT, jnp.asarray(img), jnp.asarray(txt),
                             jnp.asarray(t), *(jnp.asarray(r) for r in ropes),
                             txt_key_mask=jnp.asarray(mask), attn_impl="pallas", lora=lora)
    model = dit_from_jax(params, TRAIN_DIT, device="cpu")
    got = model(_t(img), _t(txt), _t(t), *(_t(r) for r in ropes), txt_key_mask=_t(mask),
                lora=lora_from_jax(lora, TRAIN_DIT, device="cpu"), slim_last=16)
    assert got.shape == want.shape      # the slim last block is off with LoRA
    tol = 1e-4 if not quantize else 2e-3    # int8 codes of the activations may flip
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# The loss and its gradients, the AdamW step
# ---------------------------------------------------------------------------

def _jax_trainable(cfg, dino_dim, seed=0, rank=4):
    ks = iter(jax.random.split(jax.random.PRNGKey(seed), 8))
    adapters = {
        "visual_thinking_adapter": j_ad.init_dual_adapter_params(next(ks), cfg.txt_in_dim,
                                                                 cfg.txt_in_dim),
        "dino_resampler": j_ad.init_perceiver_params(next(ks), dino_dim),
        "dino_resampler_adapter": j_ad.init_visual_thinking_params(next(ks), dino_dim,
                                                                   cfg.txt_in_dim),
        "dino_time_embed": jax.random.normal(next(ks), (6, dino_dim)) * 0.02,
        "vae_resampler": j_ad.init_perceiver_params(next(ks), 64, max_num_media_tokens=10240),
        "vae_resampler_adapter": j_ad.init_visual_thinking_params(next(ks), 64, cfg.txt_in_dim),
        "vae_time_embed": jax.random.normal(next(ks), (6, 64)) * 0.02,
    }
    return {"lora": _lora_tree(cfg, rank, seed + 1), "adapters": _np_tree(adapters)}


def _batch(cfg, dino_dim, seed=0, frames=3):
    rng = np.random.default_rng(seed)
    s_txt, n_dino, s_vae = 80, 16, 16
    prompt = rng.normal(size=(1, s_txt, cfg.txt_in_dim)).astype(np.float32)
    mask = np.ones((1, s_txt), bool)
    mask[0, 72:] = False
    special = np.arange(3, 67)[None].astype(np.int32)
    ropes = j_rope.build_rope_tables([(1, 4, 4), (1, 4, 4)], s_txt, axes_dim=(16, 56, 56))
    sched = j_fm.qwen_training_schedule()
    tid = 611
    fmask = np.arange(6) < frames
    dino_mid = rng.normal(size=(1, 6, n_dino, dino_dim)).astype(np.float32) * fmask[None, :, None, None]
    vae_mid = rng.normal(size=(1, 6, s_vae, 64)).astype(np.float32) * fmask[None, :, None, None]
    return {
        "input_latents": rng.normal(size=(1, 8, 8, 16)).astype(np.float32),
        "noise": rng.normal(size=(1, 8, 8, 16)).astype(np.float32),
        "sigma": np.array([sched.sigmas[tid]], np.float32),
        "timestep": np.array([sched.timesteps[tid]], np.float32),
        "weight": np.array([sched.weights[tid]], np.float32),
        "edit_tokens": rng.normal(size=(1, 16, 64)).astype(np.float32),
        "prompt_emb": prompt, "txt_mask": mask, "special_idx": special,
        "dino_mid_feats": dino_mid,
        "dino_src_feats": rng.normal(size=(1, 1, n_dino, dino_dim)).astype(np.float32),
        "vae_mid_tokens": vae_mid,
        "vae_src_tokens": rng.normal(size=(1, 1, s_vae, 64)).astype(np.float32),
        "mid_frame_mask": fmask[None],
        "img_cos": ropes[0], "img_sin": ropes[1], "txt_cos": ropes[2], "txt_sin": ropes[3],
    }


def _torch_batch(batch):
    out = {k: _t(v) for k, v in batch.items()}
    out["special_idx"] = out["special_idx"].long()
    return out


def _frozen(quantize, seed=2):
    params = _np_tree(j_dit.init_dit_params(jax.random.PRNGKey(seed), TRAIN_DIT))
    if quantize:
        params = _np_tree(jqm.quantize_tree_int4(params, skip_top=jqm.DIT_OUTER_KEYS))
    return params


def _loss_and_grads_both(params, dit_dtype=torch.float32):
    """physic_training_loss and its gradients by jax.value_and_grad (Pallas
    K1/K8, and K3/K9 on a W4 DiT, in interpret mode) and by the port, on
    the same frozen DiT ``params``, trainable tree and batch, remat on both
    sides; the batch's prompt_emb in ``dit_dtype``.  Returns (JAX loss,
    metrics, gradients; the port's loss, metrics, gradients as JAX trees)."""
    tree = _jax_trainable(TRAIN_DIT, 32)
    batch = _batch(TRAIN_DIT, 32)
    t_min, t_max = j_fm.adapter_t_range()
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jbatch["prompt_emb"] = jbatch["prompt_emb"].astype(
        {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dit_dtype])

    def loss_fn(tr):
        return j_loss.physic_training_loss(tr, {"dit": params}, TRAIN_DIT, jbatch, t_min,
                                           t_max, attn_impl="pallas", use_remat=True)

    (want, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, tree))

    trainable = trainable_from_jax(tree, TRAIN_DIT, device="cpu")
    dit = dit_from_jax(params, TRAIN_DIT, dit_dtype, device="cpu")
    tbatch = _torch_batch(batch)
    tbatch["prompt_emb"] = tbatch["prompt_emb"].to(dit_dtype)
    got, got_metrics = t_loss.physic_training_loss(trainable, dit, tbatch, t_min, t_max,
                                                   use_remat=True)
    got.backward()
    port_grads = {"lora": to_jax_tree(trainable.lora, grads=True),
                  "adapters": to_jax_tree(trainable.adapters, grads=True)}
    return want, metrics, _np_tree(grads), got.detach(), got_metrics, port_grads


@pytest.mark.parametrize("quantize", [False, True], ids=["float_frozen", "w4_frozen"])
def test_training_loss_and_grads_match_jax(quantize):
    """physic_training_loss and the gradient of every LoRA and adapter leaf
    against jax.value_and_grad, in fp32."""
    want, metrics, grads, got, got_metrics, port_grads = _loss_and_grads_both(_frozen(quantize))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL)
    np.testing.assert_allclose(float(got_metrics["special_token_loss"]),
                               float(metrics["special_token_loss"]), rtol=LOSS_TOL)
    assert _leaves_nonzero(grads)
    _assert_trees_close(port_grads, grads, GRAD_TOL)


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16_frozen", "w4_frozen"])
def test_training_loss_and_grads_match_jax_bf16(quantize):
    """The card lanes' dtypes: a bf16 frozen DiT and a bf16 prompt_emb, so
    the DiT's activations (and K1 / K8) are bf16 on both sides; LoRA and
    adapter factors stay fp32.  Loss and the gradient of every leaf against
    jax.value_and_grad, within bf16 tolerances: each side rounds to bf16 at
    its own points (the JAX package's matmuls and norms keep fp32 in places
    where torch's round), so the two agree to bf16 noise, not to fp32."""
    params = jax.tree_util.tree_map(lambda a: np.asarray(a).astype(jnp.bfloat16),
                                    _frozen(False))
    if quantize:
        params = _np_tree(jqm.quantize_tree_int4(params, skip_top=jqm.DIT_OUTER_KEYS))
    want, _, grads, got, _, port_grads = _loss_and_grads_both(params, torch.bfloat16)
    np.testing.assert_allclose(float(got), float(want), rtol=BF16_LOSS_TOL)
    _assert_trees_close(port_grads, grads, BF16_GRAD_TOL)


@pytest.mark.parametrize("state_dtype", [None, "bfloat16"])
def test_train_step_matches_jax(state_dtype):
    """One train_step against the JAX package's (lr 1e-3), with fp32 and with
    bf16 moments: the same loss; then the AdamW arithmetic alone, fed the
    JAX gradients, against optax's update: parameters and moments within
    fp32 rounding.  (Whole-step parameters are not compared leaf by leaf: at
    step one the update is about lr * g / (|g| + eps), so an element whose
    gradient is near eps moves with its gradient's last digits.)"""
    params = _frozen(False)
    tree = _jax_trainable(TRAIN_DIT, 32, seed=4)
    batch = _batch(TRAIN_DIT, 32, seed=5)
    t_min, t_max = j_fm.adapter_t_range()
    jopt = j_ts.make_optimizer(1e-3, 1e-2, state_dtype=None if state_dtype is None
                               else jnp.bfloat16)
    jtr = jax.tree_util.tree_map(jnp.asarray, tree)     # donated to the step
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    _, _, metrics = j_ts.train_step(jtr, {"dit": params}, jopt.init(jtr), jbatch, TRAIN_DIT,
                                    jopt, t_min, t_max, attn_impl="pallas", use_remat=True)
    topt = t_ts.make_optimizer(1e-3, 1e-2, state_dtype=None if state_dtype is None
                               else torch.bfloat16)
    trainable = trainable_from_jax(tree, TRAIN_DIT, device="cpu")
    state = topt.init(trainable)
    got = t_ts.train_step(trainable, dit_from_jax(params, TRAIN_DIT, device="cpu"), topt,
                          state, _torch_batch(batch), t_min, t_max, use_remat=True)
    np.testing.assert_allclose(got["loss"], float(metrics["loss"]), rtol=LOSS_TOL)
    assert state.count == 1

    # the optimizer alone, on the same gradients (random, some near eps)
    rng = np.random.default_rng(8)
    grads = jax.tree_util.tree_map(
        lambda x: (rng.normal(size=x.shape) * 10.0 ** rng.integers(-9, 0, size=x.shape))
        .astype(np.float32), tree)
    jtr = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.init(jtr)
    for _ in range(2):
        updates, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jtr)
        jtr = optax_apply(jtr, updates)
    trainable = trainable_from_jax(tree, TRAIN_DIT, device="cpu")
    state = topt.init(trainable)
    port_grads = trainable_from_jax(grads, TRAIN_DIT, device="cpu")
    for _ in range(2):
        for p, g in zip(trainable.parameters(), port_grads.parameters()):
            p.grad = g.detach().clone()
        topt.step(trainable, state)
    port = {"lora": to_jax_tree(trainable.lora), "adapters": to_jax_tree(trainable.adapters)}
    for p, a in zip(jax.tree_util.tree_leaves(port), jax.tree_util.tree_leaves(_np_tree(jtr))):
        np.testing.assert_allclose(p, a, rtol=1e-6, atol=1e-8)
    want_dtype = torch.float32 if state_dtype is None else torch.bfloat16
    want_mu = dict(zip(_jax_leaf_names(tree), jax.tree_util.tree_leaves(jstate[0].mu)))
    for name, m in state.mu.items():
        assert m.dtype == want_dtype
        want = np.asarray(want_mu[name].astype(jnp.float32))
        want = want.T if name.endswith(".weight") and want.ndim == 2 else want
        np.testing.assert_allclose(m.float().numpy(), want, rtol=1e-6, atol=1e-12,
                                   err_msg=name)


def optax_apply(params, updates):
    import optax

    return optax.apply_updates(params, updates)


def _jax_leaf_names(tree):
    """The port's parameter names of a JAX trainable tree's leaves, in JAX's
    leaf order (linear ``w`` -> ``weight``, ``b`` -> ``bias``)."""
    names = []
    for path, _ in jax.tree_util.tree_leaves_with_path(tree):
        parts = [str(getattr(k, "key", getattr(k, "idx", None))) for k in path]
        parts[-1] = {"w": "weight", "b": "bias"}.get(parts[-1], parts[-1])
        names.append(".".join(parts))
    return names


# ---------------------------------------------------------------------------
# The trainer: preprocess, steps, checkpoint, the W4 lane
# ---------------------------------------------------------------------------

def SyntheticDataset(n=3, frames=3):
    """Random 64 x 64 'video' samples (tests/test_trainer.py's, by the
    profiler's generator)."""
    from physicedit_torch.profile_train import SyntheticVideo

    return SyntheticVideo(n=n, width=64, height=64, frames=frames)


@pytest.fixture(scope="module")
def tiny_pipes():
    jpipe = build_tiny_pipeline()
    jpipe.dinov2_cfg = j_dino.DinoV2Config(hidden_size=32, num_layers=1, num_heads=2)
    jpipe.dinov2_params = _jax_dinov2_params(jpipe.dinov2_cfg, 20, 3)
    # a random VAE, so the latents are not constant
    rng = np.random.default_rng(0)

    def fill(path, x):
        x = np.asarray(x)
        if path[-1].key == "gamma":
            return np.ones_like(x)
        if path[-1].key == "w":
            return (rng.uniform(-1, 1, x.shape) / np.sqrt(np.prod(x.shape[:3]))).astype(x.dtype)
        return (0.05 * rng.normal(size=x.shape)).astype(x.dtype)

    jpipe.vae_params = jax.tree_util.tree_map_with_path(fill, jpipe.vae_params)
    return jpipe, pipeline_from_jax(jpipe, device="cpu")


def _train_cfg(**kw):
    cfg = dict(learning_rate=1e-3, num_epochs=1, lora_rank=2, save_every_n_steps=0,
               height=64, width=64, txt_len_bucket=64)
    cfg.update(kw)
    return cfg


def test_trainer_preprocess_matches_jax(tiny_pipes):
    """Trainer.preprocess against the JAX trainer's on one synthetic sample:
    crops, timestep and noise from the same NumPy generator bitwise, the
    encoder outputs within fp32 tolerance."""
    jpipe, tpipe = tiny_pipes
    sample = SyntheticDataset(frames=2)[0]
    jt = j_trainer.Trainer(jpipe, SyntheticDataset(), j_trainer.TrainConfig(**_train_cfg()))
    tt = t_trainer.Trainer(tpipe, SyntheticDataset(), t_trainer.TrainConfig(**_train_cfg()),
                           device="cpu")
    want = {k: np.asarray(v) for k, v in jt.preprocess(sample).items()}
    got = {k: v.numpy() for k, v in tt.preprocess(sample).items()}
    assert sorted(got) == sorted(want)
    for key in ("noise", "sigma", "timestep", "weight", "special_idx", "txt_mask",
                "mid_frame_mask", "img_cos", "img_sin", "txt_cos", "txt_sin"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("input_latents", "edit_tokens", "prompt_emb", "dino_mid_feats",
                "dino_src_feats", "vae_mid_tokens", "vae_src_tokens"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4, err_msg=key)
    assert want["mid_frame_mask"].sum() == 2 and np.abs(got["dino_mid_feats"][0, 2:]).max() == 0


def test_compute_visual_priors_matches_jax(tiny_pipes):
    """The pseudo targets from raw frames (DINO crops from one generator,
    VAE encodes) against the JAX package's compute_visual_priors."""
    jpipe, tpipe = tiny_pipes
    tree = _jax_trainable(jpipe.dit_cfg, 32, seed=9)
    sample = SyntheticDataset()[2]
    want = j_vp.compute_visual_priors(
        jax.tree_util.tree_map(jnp.asarray, tree["adapters"]), jpipe.dinov2_params,
        jpipe.dinov2_cfg, jpipe.vae_params, jpipe.vae_cfg, sample["middle_key_frames"],
        sample["edit_image"], np.random.default_rng(4))
    adapters = trainable_from_jax(tree, jpipe.dit_cfg, device="cpu").adapters
    got = t_vp.compute_visual_priors(adapters, tpipe.dinov2, tpipe.vae,
                                     sample["middle_key_frames"], sample["edit_image"],
                                     np.random.default_rng(4))
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, 64, 64)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_trainer_loss_drops_and_leaves_move(tiny_pipes):
    """Three steps on one batch at lr 1e-3: the loss drops, every gradient
    is finite, and every leaf is nonzero by step two (LoRA B starts at 0,
    so A's gradient is exactly 0 at step one)."""
    _, tpipe = tiny_pipes
    tt = t_trainer.Trainer(tpipe, SyntheticDataset(), t_trainer.TrainConfig(**_train_cfg()),
                           device="cpu")
    batch = tt.preprocess(SyntheticDataset()[1])
    losses, nonzero = [], []
    for _ in range(3):
        losses.append(tt.step(batch)["loss"])
        grads = dict(tt.trainable.named_parameters())
        assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in grads.values())
        nonzero.append(all((p.grad.abs().max() > 0) != (n in t_trainer.ZERO_GRAD_PARAMS)
                           for n, p in grads.items()))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert not nonzero[0] and nonzero[1]
    assert tt.global_step == 3 and len(tt.history) == 3


def test_profile_train_step_runs_on_tiny_trainer(tiny_pipes):
    """The profiler of a full-width training step, at tiny size on the CPU
    (no device events here, so device-busy time is 0)."""
    from physicedit_torch.profile_train import profile_train_step

    _, tpipe = tiny_pipes
    tt = t_trainer.Trainer(tpipe, SyntheticDataset(), t_trainer.TrainConfig(**_train_cfg()),
                           device="cpu")
    batch = tt.preprocess(SyntheticDataset()[0])
    summary, table = profile_train_step(tt, batch)
    assert summary["wall_ms_profiled"] > 0 and summary["device_busy_ms"] == 0.0
    assert summary["joint_tokens"] == batch["prompt_emb"].shape[1] + 32
    assert tt.global_step == 1 and "aten::" in table


def test_checkpoint_matches_jax(tmp_path):
    """The port's safetensors export (written without the safetensors
    package) against the JAX save_checkpoint's file: the same keys, bitwise
    values, and the same sidecar fields."""
    from safetensors.numpy import load_file

    tree = _jax_trainable(TRAIN_DIT, 32, seed=6)
    want_path = j_ckpt.save_checkpoint(str(tmp_path / "jax"), jax.tree_util.tree_map(
        jnp.asarray, tree), 7, 1, batches_per_epoch=3, use_orbax=False, sample_index=2)
    got_path = t_ckpt.save_checkpoint(str(tmp_path / "port"),
                                      trainable_from_jax(tree, TRAIN_DIT, device="cpu"), 7, 1,
                                      batches_per_epoch=3, sample_index=2)
    want, got = load_file(want_path), load_file(got_path)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for name in ("step-7.json", "latest.json"):
        jm = json.load(open(tmp_path / "jax" / name))
        tm = json.load(open(tmp_path / "port" / name))
        jm.pop("timestamp"), tm.pop("timestamp")
        assert tm == jm


def test_trainer_train_saves_and_w4_lane_keeps_inference(tmp_path):
    """Trainer.train over a small dataset in the W4 lane (the DiT packed in
    place): three steps, the epoch-end checkpoint, and an edit through the
    same pipeline afterwards."""
    from physicedit_torch.pipeline.testing import random_pipeline, SIZES
    import dataclasses

    dims = dataclasses.replace(SIZES["tiny"], rope_axes=(16, 56, 56), dit=TDiTConfig(
        num_layers=2, dim=256, num_heads=2, head_dim=128, txt_in_dim=64, patch_dim=64,
        time_dim=32))
    pipe = random_pipeline(dims, "cpu", torch.float32, torch.Generator().manual_seed(3))
    tt = t_trainer.Trainer(pipe, SyntheticDataset(), t_trainer.TrainConfig(
        **_train_cfg(quantize_frozen="w4", output_path=str(tmp_path))), device="cpu")
    assert isinstance(pipe.dit.blocks[0].attn["img_qkv"], tqm.W4Linear)
    tt.train()
    assert tt.global_step == 3 and os.path.exists(tmp_path / "step-3.safetensors")
    out = pipe("tilt the cup", edit_image=SyntheticDataset()[0]["edit_image"], height=64,
               width=64, seed=1, num_inference_steps=2, have_text_reasoning=False,
               edit_image_auto_resize=False)
    assert out.size == (64, 64) and np.asarray(out).std() > 0


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16_lane", "w4_lane"])
def test_train_launch_structure(monkeypatch, quantize):
    """The launches chip_smoke.py demands of one training step are the ones
    the port makes: counted here at the plain versions' call sites, and at
    the call sites of the q/k and ``ln_mod`` wrappers, whose kernels have no
    backward, as those made with grad off."""
    import chip_smoke
    from physicedit_torch.models import dit as t_dit

    calls = dict.fromkeys(["fixedmax_attention", "fixedmax_attention_bwd", "w4a8_matmul",
                           "w4_bwd_dx", "qk_norm_rope", "ln_mod", "residual_ln_mod"], 0)
    no_backward = ("qk_norm_rope", "ln_mod", "residual_ln_mod")

    def count(module, attr):
        real = getattr(module, attr)

        def spy(*a, **k):
            # with grad on these wrappers run their plain versions and launch nothing
            if attr not in no_backward or not torch.is_grad_enabled():
                calls[attr] += 1
            return real(*a, **k)

        monkeypatch.setattr(module, attr, spy)

    count(t_dit, "fixedmax_attention")
    count(t_dit, "qk_norm_rope")
    count(t_dit, "ln_mod")
    count(t_dit, "residual_ln_mod")
    count(tfa, "fixedmax_attention_bwd")
    count(tqm, "w4a8_matmul")
    count(tqm, "w4_bwd_dx")
    params = _frozen(quantize)
    trainable = trainable_from_jax(_jax_trainable(TRAIN_DIT, 32), TRAIN_DIT, device="cpu")
    opt = t_ts.make_optimizer(1e-3)
    t_ts.train_step(trainable, dit_from_jax(params, TRAIN_DIT, device="cpu"), opt,
                    opt.init(trainable), _torch_batch(_batch(TRAIN_DIT, 32)),
                    *j_fm.adapter_t_range(), use_remat=True)
    assert calls == chip_smoke.train_launch_counts(TRAIN_DIT.num_layers, quantize)


def test_train_regime_launch_structure(monkeypatch):
    """K3's launches of one W4 training step by regime, as chip_smoke.py
    demands them: the modulations (M = 1) on the GEMV, the streams on the
    tiled GEMM, counted here at the plain version's call site."""
    import chip_smoke

    calls = {"w4a8_matmul_gemv": 0, "w4a8_matmul_tiled": 0}
    real = tqm.w4a8_matmul

    def spy(xq, *a, **k):
        calls["w4a8_matmul_gemv" if xq.shape[0] <= tqm.GEMV_MAX_ROWS
              else "w4a8_matmul_tiled"] += 1
        return real(xq, *a, **k)

    monkeypatch.setattr(tqm, "w4a8_matmul", spy)
    params = _frozen(True)
    trainable = trainable_from_jax(_jax_trainable(TRAIN_DIT, 32), TRAIN_DIT, device="cpu")
    opt = t_ts.make_optimizer(1e-3)
    t_ts.train_step(trainable, dit_from_jax(params, TRAIN_DIT, device="cpu"), opt,
                    opt.init(trainable), _torch_batch(_batch(TRAIN_DIT, 32)),
                    *j_fm.adapter_t_range(), use_remat=True)
    assert calls == chip_smoke.train_regime_counts(TRAIN_DIT.num_layers, True)

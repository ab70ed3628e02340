"""EliGen entity control in the port against the JAX package, fp32 on the
CPU with the same numpy inputs and weights: K7's plain version against the
Pallas kernel (interpret mode), the host-side entity bias bit for bit, the
DiT and the denoise loop with a bias and per-row text tables, and the tiny
EliGen edit through ``__call__`` (float and int4)."""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from PIL import Image

from physicedit_tpu.kernels import flash_attention as jfa
from physicedit_tpu.models import adapters as j_ad
from physicedit_tpu.models import dit as j_dit
from physicedit_tpu.ops import rope as j_rope
from physicedit_tpu.pipeline import eligen as j_el
from physicedit_tpu.pipeline.testing import build_tiny_pipeline
from physicedit_tpu.sampling import flow_match as fm
from physicedit_tpu.sampling.denoise import denoise as j_denoise
from physicedit_torch.io.from_jax import dit_from_jax, dual_adapter_from_jax, pipeline_from_jax
from physicedit_torch.kernels import flash_attention as tfa
from physicedit_torch.models import dit as t_dit
from physicedit_torch.ops import rope as t_rope
from physicedit_torch.pipeline import eligen as t_el
from physicedit_torch.sampling.denoise import denoise as t_denoise
from tests.test_torch_pipeline import _random_vae
from tests.test_torch_quant import _jax_pipeline, _jax_quantize_int4

torch.set_num_threads(2)

TOL = 1e-4   # fp32 on both sides; only the summation order differs
NEG = -1e30


@pytest.fixture
def interpret(monkeypatch):
    """Run pallas_call in interpreter mode on the CPU (as the JAX tests do)."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _bnsd(rng, b, n, s, d, scale=1.0):
    x = rng.normal(size=(b, n, s, d)).astype(np.float32)
    return x / np.sqrt((x ** 2).mean(-1, keepdims=True)) * scale


def _random_bias(rng, b, sq, sk, blocked=0.2):
    """0 / -1e30 entries with a little graded bias on the live ones."""
    bias = np.where(rng.random((b, sq, sk)) < blocked, NEG,
                    0.5 * rng.normal(size=(b, sq, sk))).astype(np.float32)
    bias[:, :, 0] = 0.0            # one live key per row unless a row is blocked on purpose
    return bias


K7_CASES = {
    # name: (b, n, sq, sk, q/k scale, key-mask spans per row, rows blocked, jax clamp)
    "head128_key_mask": (2, 2, 256, 256, 1.0, [(200, 256), (0, 0)], [], True),
    "ragged_300_blocked_row": (1, 2, 300, 300, 1.0, [(250, 300)], [7, 299], True),
    "sq_lt_sk": (1, 2, 128, 384, 1.0, [(300, 384)], [], True),
    "clamp_false_still_clamps": (1, 2, 128, 128, 12.0, [(100, 128)], [], False),
    # the card kernel's 128-row q tiles and 128-key stages: a ragged last
    # stage, a key-mask hole across key 128, S_q < S_k with a blocked row in
    # the second q tile
    "tile_edge_sk_129": (1, 2, 129, 129, 1.0, [(100, 129)], [], True),
    "tile_edge_sk_255": (2, 2, 255, 255, 1.0, [(0, 0), (200, 255)], [], True),
    "tile_edge_hole_across_key_128": (2, 2, 300, 300, 1.0, [(100, 160), (0, 0)], [], True),
    "tile_edge_sq_130_lt_sk_385_blocked_row_129": (1, 2, 130, 385, 1.0, [(350, 385)], [129],
                                                   True),
}


@pytest.mark.parametrize("case", list(K7_CASES))
def test_k7_plain_matches_pallas(case, interpret):
    b, n, sq, sk, scale, spans, blocked, clamp = K7_CASES[case]
    rng = np.random.default_rng(sorted(K7_CASES).index(case))
    q, k = _bnsd(rng, b, n, sq, 128, scale), _bnsd(rng, b, n, sk, 128, scale)
    v = rng.normal(size=(b, n, sk, 128)).astype(np.float32)
    bias = _random_bias(rng, b, sq, sk)
    bias[:, blocked] = NEG
    mask = np.ones((b, sk), bool)
    for row, (lo, hi) in enumerate(spans):
        mask[row, lo:hi] = False
    want = np.asarray(jfa.flash_attention_bnsd(
        *map(jnp.asarray, (q, k, v)), key_mask=jnp.asarray(mask), bias=jnp.asarray(bias),
        block_q=128, block_k=128, clamp=clamp))
    tq, tk, tv, tb, tm = _t(q, k, v, bias, mask)
    got = tfa.fixedmax_attention_bias_reference(tq, tk, tv, tfa.bias_log2(tb), tm).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert (got[:, :, blocked] == 0.0).all() and (want[:, :, blocked] == 0.0).all()
    if not clamp:      # the logits pass CLAMP: without the clamp the result differs
        logits = np.einsum("bnqd,bnkd->bnqk", q, k) * jfa.LOG2E / np.sqrt(128)
        assert (logits > jfa.CLAMP).any()
        unclamped = tfa.fixedmax_attention_reference(tq, tk, tv, tm, clamp=False).numpy()
        assert not np.isfinite(unclamped).all() or np.abs(unclamped - want).max() > 1e-2


def test_k7_wrapper_on_cpu_and_forward_only():
    rng = np.random.default_rng(12)
    q = torch.from_numpy(_bnsd(rng, 1, 2, 64, 128))
    bias = torch.from_numpy(_random_bias(rng, 1, 64, 64))
    before = dict(tfa.LAUNCHES)
    assert torch.equal(tfa.fixedmax_attention_bias(q, q, q, bias),
                       tfa.fixedmax_attention_bias_reference(q, q, q, bias))
    assert tfa.LAUNCHES == before              # no kernel launched on the CPU
    with pytest.raises(RuntimeError, match="forward only"):
        tfa.fixedmax_attention_bias(q.clone().requires_grad_(True), q, q, bias)
    with torch.no_grad():
        tfa.fixedmax_attention_bias(q.clone().requires_grad_(True), q, q, bias)


def test_k7_requires_a_bias():
    """K7 takes no null bias: a call without one is K1's."""
    q = torch.from_numpy(_bnsd(np.random.default_rng(14), 1, 2, 64, 128))
    with pytest.raises(ValueError, match="needs a bias"):
        tfa.fixedmax_attention_bias(q, q, q, None)


def _masks(rng, n, h, w):
    return [rng.random((h, w)) < 0.4 for _ in range(n)]


@pytest.mark.parametrize("entities,seq_lens,image_seq,base", [
    (2, [3, 5, 7], 32, 16),        # two entities, the mask tiled over an edit image
    (1, [4, 9], 16, 16),
])
def test_build_entity_bias_bitwise(entities, seq_lens, image_seq, base):
    rng = np.random.default_rng(entities)
    masks = _masks(rng, entities, 8, 8)
    want = j_el.build_entity_bias(masks, seq_lens, image_seq, base)
    got = t_el.build_entity_bias(masks, seq_lens, image_seq, base)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t_el.patch_presence(masks[0]), j_el.patch_presence(masks[0]))
    with pytest.raises(ValueError, match="whole multiple"):
        t_el.build_entity_bias(masks, seq_lens, image_seq + 4, base)


def test_downsample_entity_mask_and_rope_helpers_match_jax():
    rng = np.random.default_rng(3)
    mask = Image.fromarray((rng.random((96, 64)) * 255).astype(np.uint8))
    np.testing.assert_array_equal(t_el.downsample_entity_mask(mask, 12, 8),
                                  j_el.downsample_entity_mask(mask, 12, 8))
    shapes = [(1, 6, 4), (1, 5, 9)]
    assert t_rope.max_vid_index_of(shapes) == j_rope.max_vid_index_of(shapes) == 4
    assert t_rope.max_vid_index_of(shapes, False) == j_rope.max_vid_index_of(shapes, False)
    # a text table per batch row, [B, 1, S, D/2], broadcast over the heads
    x = rng.normal(size=(2, 3, 10, 16)).astype(np.float32)
    ang = rng.uniform(-3, 3, size=(2, 1, 10, 8))
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    want = j_rope.apply_rope(*map(jnp.asarray, (x, cos, sin)))
    np.testing.assert_allclose(t_rope.apply_rope(*_t(x, cos, sin)).numpy(), np.asarray(want),
                               atol=1e-6, rtol=0)


def _entity_setup(seed, s_t, seq_lens_p, img_shapes, axes, seq_lens_n=None):
    """A [2, S, S] bias of the bucketed layout (row 1 plain unless
    ``seq_lens_n``) and the per-row [2, 1, s_t, D/2] text tables."""
    rng = np.random.default_rng(seed)
    base = img_shapes[0][1] * img_shapes[0][2]
    img = sum(f * h * w for f, h, w in img_shapes)
    masks = _masks(rng, len(seq_lens_p) - 1, 2 * img_shapes[0][1], 2 * img_shapes[0][2])
    bias = np.zeros((2, s_t + img, s_t + img), np.float32)
    tables = []
    for row, lens in enumerate((seq_lens_p, seq_lens_n)):
        lens = lens or [s_t - 5]
        if row == 0 or seq_lens_n is not None:
            b = j_el.build_entity_bias(masks, lens, img, base)
            t = sum(lens)
            bias[row, :t, :t], bias[row, :t, s_t:] = b[:t, :t], b[:t, t:]
            bias[row, s_t:, :t], bias[row, s_t:, s_t:] = b[t:, :t], b[t:, t:]
        mvi = j_rope.max_vid_index_of(img_shapes)
        cs = [j_rope.text_rope_tables(n, mvi, axes) for n in lens]
        tc, ts = np.concatenate([c for c, _ in cs]), np.concatenate([s for _, s in cs])
        pad = s_t - tc.shape[0]
        tables.append((np.concatenate([tc, np.ones((pad, tc.shape[1]), np.float32)]),
                       np.concatenate([ts, np.zeros((pad, ts.shape[1]), np.float32)])))
    txt_cos = np.stack([c for c, _ in tables])[:, None]
    txt_sin = np.stack([s for _, s in tables])[:, None]
    return bias, txt_cos, txt_sin


@pytest.mark.parametrize("slim", [0, 16])
def test_dit_with_entity_bias_matches_jax(slim, monkeypatch):
    """Every block, the slim last block included, goes through K7 (its plain
    version here) and never through K1."""
    cfg = j_dit.TINY_CONFIG
    params = jax.tree_util.tree_map(np.asarray, j_dit.init_dit_params(jax.random.PRNGKey(4), cfg))
    rng = np.random.default_rng(4)
    s_t, shapes, axes = 24, [(1, 4, 4), (1, 4, 4)], (16, 24, 24)
    img = rng.normal(size=(2, 32, cfg.patch_dim)).astype(np.float32)
    txt = rng.normal(size=(2, s_t, cfg.txt_in_dim)).astype(np.float32)
    mask = np.ones((2, s_t), bool)
    mask[:, 20:] = False
    bias, txt_cos, txt_sin = _entity_setup(4, s_t, [6, 8, 6], shapes, axes)
    img_cos, img_sin, _, _ = j_rope.build_rope_tables(shapes, s_t, axes_dim=axes)
    t = np.array([0.6, 0.6], np.float32)
    want = j_dit.dit_forward(params, cfg, *map(jnp.asarray, (img, txt, t, img_cos, img_sin,
                                                              txt_cos, txt_sin)),
                             txt_key_mask=jnp.asarray(mask), attn_impl="xla",
                             attn_bias=jnp.asarray(bias), slim_last=slim)
    calls = {"k1": 0, "k7": 0}

    def spy(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(t_dit, "fixedmax_attention", spy("k1", t_dit.fixedmax_attention))
    monkeypatch.setattr(t_dit, "fixedmax_attention_bias", spy("k7", t_dit.fixedmax_attention_bias))
    with torch.no_grad():
        got = dit_from_jax(params, cfg, device="cpu")(
            *_t(img, txt, t, img_cos, img_sin, txt_cos, txt_sin),
            txt_key_mask=torch.from_numpy(mask),
            attn_bias_log2=tfa.bias_log2(torch.from_numpy(bias)), slim_last=slim)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    assert calls == {"k1": 0, "k7": cfg.num_layers}


@pytest.mark.parametrize("trunc,negative", [(None, True), (1, False)])
def test_denoise_with_entity_bias_matches_jax(trunc, negative):
    """CFG rows with their own bias and text tables; under cfg_truncate_after
    the bias and the 4-D tables are cut to the positive rows."""
    cfg = j_dit.DiTConfig(num_layers=2, dim=64, num_heads=2, head_dim=32,
                          txt_in_dim=64, patch_dim=64, time_dim=32)
    params = jax.tree_util.tree_map(np.asarray, j_dit.init_dit_params(jax.random.PRNGKey(5), cfg))
    adapter = jax.tree_util.tree_map(np.asarray,
                                     j_ad.init_dual_adapter_params(jax.random.PRNGKey(6), 64, 64))
    rng = np.random.default_rng(5)
    s_t, shapes, axes = 128, [(1, 4, 4), (1, 4, 4)], (8, 12, 12)
    latents = rng.normal(size=(1, 8, 8, 16)).astype(np.float32)
    extra = rng.normal(size=(1, 16, 64)).astype(np.float32)
    prompt = rng.normal(size=(2, s_t, 64)).astype(np.float32)
    seq_p = [10, 14, 90]
    seq_n = [30, 30, 30] if negative else None
    mask = np.zeros((2, s_t), bool)
    mask[0, :sum(seq_p)] = True
    mask[1, :sum(seq_n or [s_t - 5])] = True
    special = np.stack([np.arange(40, 104), np.arange(10, 74)]).astype(np.int32)
    bias, txt_cos, txt_sin = _entity_setup(5, s_t, seq_p, shapes, axes, seq_n)
    img_cos, img_sin, _, _ = j_rope.build_rope_tables(shapes, s_t, axes_dim=axes)
    sched = fm.build_schedule(3, fm.QWEN_IMAGE_CONFIG, dynamic_shift_len=16)
    t_min, t_max = fm.adapter_t_range()
    want = j_denoise(params, cfg, *map(jnp.asarray, (latents, extra, prompt, mask, img_cos,
                                                     img_sin, txt_cos, txt_sin)),
                     *map(jnp.asarray, (sched.sigmas, sched.sigmas_next, sched.timesteps)),
                     jnp.asarray(4.0), latent_hw=(8, 8), adapter_params=adapter,
                     special_idx=jnp.asarray(special), t_min=t_min, t_max=t_max,
                     attn_bias=jnp.asarray(bias), cfg_truncate_after=trunc)
    got = t_denoise(dit_from_jax(params, cfg, device="cpu"),
                    *_t(latents, extra, prompt, mask, img_cos, img_sin, txt_cos, txt_sin),
                    *_t(sched.sigmas, sched.sigmas_next, sched.timesteps), 4.0,
                    latent_hw=(8, 8), adapter=dual_adapter_from_jax(adapter, device="cpu"),
                    special_idx=torch.from_numpy(special).long(), t_min=t_min, t_max=t_max,
                    attn_bias_log2=tfa.bias_log2(torch.from_numpy(bias)),
                    cfg_truncate_after=trunc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.fixture(scope="module")
def eligen_pipes():
    jpipe = build_tiny_pipeline()
    jpipe.vae_params = _random_vae(jpipe.vae_params)
    return jpipe, pipeline_from_jax(jpipe, device="cpu")


def _entity_inputs(seed, size=64):
    rng = np.random.default_rng(seed)
    edit = Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8))
    quads = [np.array([[1, 0], [0, 0]]), np.array([[0, 0], [1, 1]])]
    masks = [Image.fromarray((np.kron(q, np.ones((size // 2, size // 2))) * 255).astype(np.uint8))
             for q in quads]
    return edit, ["a red cup on the wooden table", "a blue plate beside it"], masks


ELIGEN_CASES = {
    "positive_only": {},
    "on_negative": dict(eligen_enable_on_negative=True),
    "cfg_truncate": dict(cfg_truncate_step=1, eligen_enable_on_negative=True),
}


@pytest.mark.parametrize("case", list(ELIGEN_CASES))
def test_eligen_call_matches_jax(eligen_pipes, case):
    jpipe, tpipe = eligen_pipes
    edit, prompts, masks = _entity_inputs(1)
    kw = dict(edit_image=edit, height=64, width=64, seed=5, num_inference_steps=2,
              have_text_reasoning=False, edit_image_auto_resize=False,
              eligen_entity_prompts=prompts, eligen_entity_masks=masks, **ELIGEN_CASES[case])
    want = np.asarray(jpipe("move the cup to the left", **kw), np.int16)
    got = np.asarray(tpipe("move the cup to the left", **kw), np.int16)
    assert tpipe.timings["eligen_bias"] > 0
    plain = np.asarray(tpipe("move the cup to the left", **{
        k: v for k, v in kw.items() if not k.startswith("eligen")}), np.int16)
    assert want.std() > 0 and got.shape == want.shape == (64, 64, 3)
    assert np.abs(got - want).max() <= 1                 # within one uint8 level
    assert np.abs(got - plain).max() > 1                 # the entities change the edit


def test_eligen_call_int4_matches_jax(interpret):
    """The quantized JAX pipeline carried into the port: the entity bias and
    the per-row text tables through the fused W4 DiT (K4-K6 and K3 around
    K7's plain version)."""
    jq = _jax_quantize_int4(_jax_pipeline())
    tpipe = pipeline_from_jax(jq, device="cpu")
    edit, prompts, masks = _entity_inputs(2)
    kw = dict(edit_image=edit, height=64, width=64, seed=6, num_inference_steps=2,
              have_text_reasoning=False, edit_image_auto_resize=False,
              eligen_entity_prompts=prompts, eligen_entity_masks=masks)
    want = np.asarray(jq("swap the mug", **kw), np.int16)
    got = np.asarray(tpipe("swap the mug", **kw), np.int16)
    assert want.std() > 0 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1

"""The port's W4A8 lane (packed-int4 weights, int8 activations, int8 KV
cache) against the JAX package's, on the CPU.

Inputs come from numpy seeds; JAX's Pallas kernels run in interpret mode
(as tests/test_quant_matmul.py runs them) and the port's wrappers take their
plain versions.  Widths are at least 256 wherever a layer should reach the
kernels: a W4 layer needs K/2 % 128 == 0 and N % 128 == 0, and narrower ones
take the dense fallback.  Tolerances are stated beside each comparison.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from PIL import Image

from physicedit_tpu.kernels import fused_quant as jfq
from physicedit_tpu.kernels import quant_matmul as jqm
from physicedit_tpu.models import dit as j_dit
from physicedit_tpu.models import qwen_vl as j_text
from physicedit_tpu.models import qwen_vl_vision as j_vis
from physicedit_tpu.ops import rope as j_rope
from physicedit_tpu.pipeline import vl_host
from physicedit_tpu.pipeline.testing import _rand_text_params, _rand_vision_params
from physicedit_torch.io.from_jax import (dit_from_jax, pipeline_from_jax, text_from_jax,
                                          vision_from_jax)
from physicedit_torch.core.params import load_linear_
from physicedit_torch.kernels import fused_quant as tfq
from physicedit_torch.kernels import quant_matmul as tqm
from physicedit_torch.models import qwen_vl as t_text
from physicedit_torch.models.dit import DiTConfig as TDiTConfig
from physicedit_torch.models.qwen_vl_vision import QwenVLVisionConfig as TVisionConfig
from physicedit_torch.pipeline.testing import (SIZES, PipelineDims, build_random_pipeline,
                                               random_pipeline)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _w4_leaf(lin):
    """A port W4Linear as the JAX leaf it came from."""
    leaf = {"w4": lin.w4.numpy().T, "w_scale": lin.w_scale.numpy()}
    if lin.bias is not None:
        leaf["b"] = lin.bias.detach().numpy()
    return leaf


# ---------------------------------------------------------------------------
# Packing, row quantization, the linear's three routes
# ---------------------------------------------------------------------------

def test_quantize_weight_int4_bitwise():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(384, 256)).astype(np.float32)
    w[:, 3] = 0.0                                    # an all-zero channel: scale 1e-8
    w[5, 7] = 3.5 * np.abs(w[:, 7]).max() / 7.0      # ties round half to even
    want = jqm.quantize_weight_int4(jnp.asarray(w))
    w4, w_scale = tqm.quantize_weight_int4(torch.from_numpy(w.T.copy()))
    assert w4.dtype == torch.int8 and w4.shape == (256, 192)
    np.testing.assert_array_equal(w4.numpy().T, np.asarray(want["w4"]))
    np.testing.assert_array_equal(w_scale.numpy(), np.asarray(want["w_scale"]))


def test_quantize_module_int4_stacked_leaves_bitwise():
    """A ModuleList is the JAX package's stacked [L, ...] leaf: a layer is
    packed when its weight counted over all L layers reaches min_size."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(3, 128, 256)).astype(np.float32)
    b = rng.normal(size=(3, 256)).astype(np.float32)
    small = rng.normal(size=(16, 16)).astype(np.float32)
    tree = {"blocks": {"proj": {"w": jnp.asarray(w), "b": jnp.asarray(b)}},
            "small": {"w": jnp.asarray(small)}}
    min_size = 2 * 128 * 256            # above one layer's size, below three
    want = jqm.quantize_tree_int4(tree, min_size=min_size)

    blocks = torch.nn.ModuleList(torch.nn.ModuleDict({"proj": torch.nn.Linear(128, 256)})
                                 for _ in range(3))
    module = torch.nn.ModuleDict({"blocks": blocks, "small": torch.nn.Linear(16, 16, bias=False)})
    with torch.no_grad():
        for i, blk in enumerate(blocks):
            blk["proj"].weight.copy_(torch.from_numpy(w[i].T))
            blk["proj"].bias.copy_(torch.from_numpy(b[i]))
    tqm.quantize_module_int4(module, min_size=min_size)
    assert isinstance(module["small"], torch.nn.Linear) and "w" in want["small"]
    for i, blk in enumerate(blocks):
        got = _w4_leaf(blk["proj"])
        for key in ("w4", "w_scale", "b"):
            np.testing.assert_array_equal(got[key], np.asarray(want["blocks"]["proj"][key][i]))


def test_quantize_rows_bitwise():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(3, 5, 256)) * 2).astype(np.float32)
    x[0, 0, :6] = [127.0, 0.5, 1.5, 2.5, -2.5, 126.5]   # scale 1: exact half steps
    want_q, want_s = jqm.quantize_rows(jnp.asarray(x))
    got_q, got_s = tqm.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_q[0, 0, :6].tolist() == [127, 0, 2, 2, -2, 126]


LINEAR_ROUTES = {
    # name: (x shape, K, N, bias)
    "dense_fallback": ((2, 3, 200), 200, 96, True),      # K/2 % 128: fp32 dequant
    "kernel": ((3, 5, 256), 256, 384, True),             # M < 8192: K3, Pallas in JAX
    "kernel_no_bias": ((1, 512), 512, 128, False),       # the decode GEMV shape class
    "int_mm": ((8192, 256), 256, 128, True),             # M >= 8192: K3, an XLA int8 dot in JAX
    # the edges of the card kernel's tiles (128 weight rows by 128 or 256 x
    # rows, 128 packed bytes of k a stage): M 17, 129, 255, 1000 and 16384,
    # K/2 128, 640 and 9472
    "tile_edge_m17": ((17, 256), 256, 384, True),
    "tile_edge_m129": ((129, 1280), 1280, 128, True),
    "tile_edge_m255": ((255, 1280), 1280, 384, False),
    "tile_edge_m1000": ((1000, 18944), 18944, 128, True),
    "tile_edge_m16384": ((16384, 256), 256, 384, True),
}


@pytest.mark.parametrize("route", list(LINEAR_ROUTES))
def test_w4a8_linear_routes_match_jax(route):
    shape, k, n, bias = LINEAR_ROUTES[route]
    rng = np.random.default_rng(sorted(LINEAR_ROUTES).index(route))
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32) / np.sqrt(k)
    leaf = dict(jqm.quantize_weight_int4(jnp.asarray(w)))
    if bias:
        leaf["b"] = jnp.asarray(rng.normal(size=(n,)).astype(np.float32))
    want = np.asarray(jqm.w4a8_linear(leaf, jnp.asarray(x)))
    lin = tqm.W4Linear(k, n, bias=bias, dtype=torch.float32, device="cpu")
    load_linear_(lin, _np_tree(leaf))
    got = lin(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (*shape[:-1], n)
    # the int8 codes and int32 accumulators are equal on both sides, so only
    # the fp32 epilogue (or the dense fallback's fp32 matmul) may differ
    tol = 1e-5 if route == "dense_fallback" else 1e-6
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_w4a8_linear_hostile_weights_match_jax():
    """Log-normal per-channel weight scales with a few 10-100x outlier
    columns, and activation rows with outliers: the packed bytes stay
    bitwise JAX's and the outputs agree as on benign weights."""
    rng = np.random.default_rng(12)
    k, n = 512, 256
    w = rng.normal(size=(k, n)) * np.exp(rng.normal(size=(1, n)) * 1.5)
    w[:, [3, 77, 200]] *= np.array([10.0, 40.0, 100.0])
    w = (w / np.sqrt(k)).astype(np.float32)
    x = rng.normal(size=(6, k)).astype(np.float32)
    x[2, 5] = 300.0
    leaf = dict(jqm.quantize_weight_int4(jnp.asarray(w)))
    want = np.asarray(jqm.w4a8_linear(leaf, jnp.asarray(x)))
    lin = tqm.W4Linear.from_linear(_torch_linear(w))
    np.testing.assert_array_equal(lin.w4.numpy().T, np.asarray(leaf["w4"]))
    np.testing.assert_allclose(lin(torch.from_numpy(x)).numpy(), want, rtol=1e-6, atol=1e-6)


def _torch_linear(w):
    lin = torch.nn.Linear(w.shape[0], w.shape[1], bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
    return lin


def test_w4a8_linear_q_rejects_layers_the_kernel_cannot_tile():
    lin = tqm.W4Linear(200, 128, bias=False, device="cpu")
    with pytest.raises(ValueError, match="kernel-sized"):
        tqm.w4a8_linear_q(lin, torch.zeros(4, 200, dtype=torch.int8), torch.ones(4, 1),
                          torch.float32)


# ---------------------------------------------------------------------------
# K4-K6 and their tiling predicates
# ---------------------------------------------------------------------------

FUSED = {
    # name: (input shape, dtype)
    "ln_mod_quant_fp32": ((2, 64, 256), "float32"),
    "ln_mod_quant_bf16": ((2, 32, 384), "bfloat16"),
    "gelu_quant_fp32": ((2, 32, 512), "float32"),
    "gelu_quant_bf16": ((1, 64, 256), "bfloat16"),
    "transpose_quant_fp32": ((2, 2, 40, 128), "float32"),
    "transpose_quant_bf16": ((1, 3, 16, 128), "bfloat16"),
}


@pytest.mark.parametrize("case", list(FUSED))
def test_fused_quant_matches_jax(case):
    shape, dtype = FUSED[case]
    name = case.rsplit("_", 1)[0]
    rng = np.random.default_rng(sorted(FUSED).index(case))
    x = (rng.normal(size=shape) * 1.5).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    args = [x]
    if name == "ln_mod_quant":
        args += [(rng.normal(size=(shape[0], shape[2])) * 0.3).astype(np.float32)
                 for _ in range(2)]
    want = getattr(jfq, name)(*(jnp.asarray(a, jdt) for a in args))
    got = getattr(tfq, name)(*(torch.from_numpy(a).to(tdt) for a in args))
    if case == "ln_mod_quant_bf16":
        # the port rounds each bf16 step of the affine as the TPU kernel does;
        # XLA on the CPU keeps fp32 through that chain, so a code may move by
        # one step and the scale by a bf16 rounding
        diff = np.abs(got[0].numpy().astype(int) - np.asarray(want[0]).astype(int))
        assert diff.max() <= 1
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=8e-3, atol=0)
        return
    # int8 codes identical; scales within a few fp32 ulps (the port sums the
    # LN statistics in fp64, the JAX kernel in fp32)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", [(2, 100, 120), (2, 13, 256), (2, 24, 256), (1, 8, 12288),
                                   (1, 24, 12288), (2, 1001, 3072)])
def test_fused_quant_none_predicates_match_jax(shape):
    x = np.zeros(shape, np.float32)
    mod = np.zeros((shape[0], shape[2]), np.float32)
    for name, args in (("ln_mod_quant", (x, mod, mod)), ("gelu_quant", (x,))):
        want = getattr(jfq, name)(*map(jnp.asarray, args)) is None
        got = getattr(tfq, name)(*map(torch.from_numpy, args)) is None
        assert got == want, (name, shape)
    heads = np.zeros((shape[0], 2, shape[1], 128), np.float32)
    assert (tfq.transpose_quant(torch.from_numpy(heads)) is None) == \
        (jfq.transpose_quant(jnp.asarray(heads)) is None)
    assert tfq.transpose_quant(torch.zeros(1, 2, 8, 64)) is None   # head_dim 64


# ---------------------------------------------------------------------------
# The W4 DiT
# ---------------------------------------------------------------------------

W4_DIT = j_dit.DiTConfig(num_layers=2, dim=256, num_heads=2, head_dim=128, txt_in_dim=256,
                         patch_dim=64, time_dim=64)


@pytest.fixture(scope="module")
def w4_dit_params():
    params = _np_tree(j_dit.init_dit_params(jax.random.PRNGKey(4), W4_DIT))
    return params, _np_tree(jqm.quantize_tree_int4(params, skip_top=jqm.DIT_OUTER_KEYS))


def test_quantize_module_int4_matches_quantize_tree_int4(w4_dit_params):
    """Quantizing the port's DiT in place packs the same leaves, bit for
    bit, as quantize_tree_int4 with skip_top=DIT_OUTER_KEYS (carried into
    the port by io/from_jax.py), and leaves the outer layers float."""
    params, qparams = w4_dit_params
    got = tqm.quantize_module_int4(dit_from_jax(params, W4_DIT, device="cpu"),
                                   skip_top=tqm.DIT_OUTER_KEYS)
    want = dit_from_jax(qparams, W4_DIT, device="cpu")
    kinds = {n: type(m).__name__ for n, m in got.named_modules()}
    assert kinds == {n: type(m).__name__ for n, m in want.named_modules()}
    assert kinds["blocks.0.attn.img_qkv"] == "W4Linear" and kinds["img_in"] == "Linear"
    got_state, want_state = got.state_dict(), want.state_dict()
    assert got_state.keys() == want_state.keys()
    for key, val in want_state.items():
        assert got_state[key].dtype == val.dtype, key
        assert torch.equal(got_state[key], val), key


def _dit_inputs(s_t, seed=0):
    rng = np.random.default_rng(seed)
    s_i = 32
    img = rng.normal(size=(2, s_i, 64)).astype(np.float32)
    txt = rng.normal(size=(2, s_t, 256)).astype(np.float32)
    mask = np.ones((2, s_t), bool)
    mask[1, s_t // 2:] = False
    ropes = j_rope.build_rope_tables([(1, 4, 4), (1, 4, 4)], s_t, axes_dim=(16, 56, 56))
    return img, txt, np.array([0.6, 0.6], np.float32), ropes, mask


W4_DIT_CASES = {
    # name: (text tokens, slim_last)
    "fused": (24, 0),
    "fused_slim": (24, 16),
    "text_stream_unfused": (13, 0),     # S_t and the joint S have no row block
}


@pytest.mark.parametrize("case", list(W4_DIT_CASES))
def test_w4_dit_forward_matches_jax(case, w4_dit_params, monkeypatch):
    s_t, slim = W4_DIT_CASES[case]
    _, qparams = w4_dit_params
    img, txt, t, ropes, mask = _dit_inputs(s_t)
    want = j_dit.dit_forward(qparams, W4_DIT, jnp.asarray(img), jnp.asarray(txt),
                             jnp.asarray(t), *map(jnp.asarray, ropes),
                             txt_key_mask=jnp.asarray(mask), attn_impl="xla", slim_last=slim)
    calls = {"ln_mod_quant": 0, "gelu_quant": 0, "transpose_quant": 0}
    for name in calls:
        real = getattr(tfq, f"_{name}")

        def spy(*a, _name=name, _real=real):
            calls[_name] += 1
            return _real(*a)

        monkeypatch.setattr(tfq, f"_{name}", spy)
    model = dit_from_jax(qparams, W4_DIT, device="cpu")
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (img, txt, t)), *map(torch.from_numpy, ropes),
                    txt_key_mask=torch.from_numpy(mask), slim_last=slim)
    assert got.shape == want.shape
    # the fused path per block: K4 on both streams' QKV and fc1 inputs (the
    # slim block's text fc1 is skipped), K5 on fc2, K6 on the attention
    # output; a text stream that does not tile takes the unfused path there
    want_calls = {"fused": (8, 4, 2), "fused_slim": (7, 3, 2), "text_stream_unfused": (4, 2, 0)}
    assert tuple(calls.values()) == want_calls[case]
    # both sides quantize the same activations to int8; an fp32 rounding
    # difference upstream can move a code by one step, which bounds this
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=2e-3)


def test_w4_dit_slim_block_that_does_not_tile_fails_as_in_jax(w4_dit_params):
    """A slim last block of 4 rows has no transpose_quant row block: the
    JAX package fails on the None, and the port raises rather than take an
    unfused path JAX does not have."""
    _, qparams = w4_dit_params
    img, txt, t, ropes, mask = _dit_inputs(24)
    with pytest.raises(TypeError):
        j_dit.dit_forward(qparams, W4_DIT, jnp.asarray(img), jnp.asarray(txt), jnp.asarray(t),
                          *map(jnp.asarray, ropes), txt_key_mask=jnp.asarray(mask),
                          attn_impl="xla", slim_last=4)
    model = dit_from_jax(qparams, W4_DIT, device="cpu")
    with torch.no_grad(), pytest.raises(ValueError, match="cannot tile the slim last block"):
        model(*map(torch.from_numpy, (img, txt, t)), *map(torch.from_numpy, ropes),
              txt_key_mask=torch.from_numpy(mask), slim_last=4)


# ---------------------------------------------------------------------------
# The W4 VL text model and ViT
# ---------------------------------------------------------------------------

W4_TEXT = j_text.QwenVLTextConfig(hidden_size=256, num_layers=2, num_heads=2, num_kv_heads=1,
                                  head_dim=128, intermediate_size=512, vocab_size=512)


@pytest.fixture(scope="module")
def w4_text():
    params = _np_tree(_rand_text_params(jax.random.PRNGKey(5), W4_TEXT))
    # the JAX package's int4 serving layout (edit_pipeline.py's quantize branch)
    qparams = _np_tree(j_text.split_layers(j_text.quantize_embedding_int8(
        j_text.fuse_decode_projections(jqm.quantize_tree_int4(params)))))
    return params, qparams


def _same_state(a: torch.nn.Module, b: torch.nn.Module) -> None:
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for key in sa:
        assert sa[key].dtype == sb[key].dtype and torch.equal(sa[key], sb[key]), key


@pytest.mark.parametrize("packed", [False, True])
def test_fuse_decode_projections_bitwise(w4_text, packed):
    """Fusing the port's q/k/v and gate/up gives the JAX package's fused
    leaves bit for bit, float and packed alike."""
    params, _ = w4_text
    src = jqm.quantize_tree_int4(params) if packed else params
    want = text_from_jax(_np_tree(j_text.fuse_decode_projections(src)), W4_TEXT, device="cpu")
    got = text_from_jax(params, W4_TEXT, device="cpu")
    if packed:
        tqm.quantize_module_int4(got)
    t_text.fuse_decode_projections(got)
    assert "qkv" in got.layers[0]._modules and "gate_up" in got.layers[0].mlp
    _same_state(got, want)


def test_int8_embedding_matches_jax(w4_text):
    params, qparams = w4_text
    text = t_text.quantize_embedding_int8(text_from_jax(params, W4_TEXT, device="cpu"))
    np.testing.assert_array_equal(text.embed.e8.numpy(), np.asarray(qparams["embed"]["e8"]))
    np.testing.assert_array_equal(text.embed.e_scale.float().numpy(),
                                  np.asarray(qparams["embed"]["e_scale"], np.float32))
    ids = np.array([[0, 7, 300, 511], [96, 95, 1, 2]])
    want = j_text.embed_tokens(qparams, jnp.asarray(ids))
    got = text.embed_tokens(torch.from_numpy(ids))
    # the rows come back in the scales' dtype (bf16) in an fp32 model, as in JAX
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def _text_inputs(b=2, s=20):
    # random weights give top-2 logit margins down to ~0.2 %, and one int8
    # code a step off (an fp32 rounding difference) moves the logits by
    # ~0.5 %: the decode below uses inputs whose 12 tokens have no such tie
    rng = np.random.default_rng(1)
    emb = (rng.normal(size=(b, s, 256)) * 0.5).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None, None], (3, b, s)).copy()
    mask = np.ones((b, s), bool)
    mask[1, :6] = False
    return emb, pos, mask


def test_kv_int8_prefill_and_greedy_decode_match_jax(w4_text):
    _, qparams = w4_text
    emb, pos, mask = _text_inputs()
    max_total, new = 40, 12
    lw, cw, _ = j_text.prefill(qparams, W4_TEXT, jnp.asarray(emb), jnp.asarray(pos),
                               jnp.asarray(mask), max_total, kv_int8=True)
    model = text_from_jax(qparams, W4_TEXT, device="cpu")
    lg, cg, _ = model.prefill(*map(torch.from_numpy, (emb, pos, mask)), max_total,
                              kv_int8=True)
    assert len(cg) == len(cw) == 4
    assert [c.dtype for c in cg] == [torch.int8, torch.bfloat16, torch.int8, torch.bfloat16]
    # logits: an fp32 rounding difference upstream can move one int8
    # activation code by a step, which moves the logits by ~0.5 % rel-L2
    # (the W4 lane's own distance from the float model is ~13 % here)
    lw = np.asarray(lw)
    assert np.linalg.norm(lg.numpy() - lw) / np.linalg.norm(lw) < 2e-2
    np.testing.assert_array_equal(lg.numpy().argmax(-1), lw.argmax(-1))
    # the caches dequantize to the same k/v, to the same bound as the logits
    for i in (0, 2):
        got = t_text._kv_dequantize(cg[i], cg[i + 1], torch.float32).numpy()
        want = np.asarray(cw[i], np.float32) * np.asarray(cw[i + 1], np.float32)[..., None]
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-2
        assert not got[:, :, 20:].any()          # the zero tail stays zero
        np.testing.assert_array_equal(cg[i + 1][:, :, 20:].float().numpy(),
                                      np.asarray(cw[i + 1][:, :, 20:], np.float32))
    s = mask.shape[1]
    key_mask = np.concatenate([mask, np.zeros((2, max_total - s), bool)], axis=1)
    start_rope = pos.max(axis=(0, 2)) + 1
    want, _ = j_text.greedy_decode(qparams, W4_TEXT, cw, jnp.argmax(jnp.asarray(lw), -1).astype(jnp.int32),
                                   s, jnp.asarray(start_rope), new,
                                   key_mask=jnp.asarray(key_mask))
    got, steps = model.greedy_decode(cg, lg.argmax(-1), s, torch.from_numpy(start_rope), new,
                                     key_mask=torch.from_numpy(key_mask))
    assert steps == new
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_w4_vision_features_match_jax():
    """The ViT with W4 block and merger linears.  The JAX package's ViT reads
    ``patch_embed["w"]`` directly, so it cannot run a packed patch embed;
    both sides keep it float here (the port packs it in quantize_, where it
    takes the dense fallback tested above)."""
    cfg = j_vis.QwenVLVisionConfig(depth=2, hidden_size=256, num_heads=2, intermediate_size=512,
                                   window_size=56, fullatt_block_indexes=(1,),
                                   out_hidden_size=256)
    params = _np_tree(_rand_vision_params(jax.random.PRNGKey(7), cfg))
    qparams = _np_tree(jqm.quantize_tree_int4(params, skip_top=("patch_embed",)))
    img = Image.fromarray(np.random.default_rng(8).integers(0, 255, (84, 56, 3), dtype=np.uint8))
    flat, grids = vl_host.images_to_patches([img])
    want = j_vis.run_vision(qparams, cfg, jnp.asarray(flat), grids)
    model = tqm.quantize_module_int4(vision_from_jax(params, cfg, device="cpu"), skip_top=("patch_embed",))
    _same_state(model, vision_from_jax(qparams, cfg, device="cpu"))
    assert type(model.blocks[0].qkv).__name__ == "W4Linear"
    got = model(torch.from_numpy(flat), grids)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=2e-3)


# ---------------------------------------------------------------------------
# The W4 pipeline as a whole
# ---------------------------------------------------------------------------

def _jax_pipeline():
    """A 256-wide JAX pipeline: DiT blocks, VL text model and lm_head all
    reach the W4 kernels once quantized; the ViT stays below the quantize
    size threshold (hidden 32), because the JAX package's ViT cannot run a
    packed patch embed."""
    from physicedit_tpu.models import adapters as j_ad
    from physicedit_tpu.models import vae as j_vae
    from physicedit_tpu.models.vae_init import init_vae_params
    from physicedit_tpu.pipeline.edit_pipeline import PhysicEditPipeline
    from physicedit_tpu.pipeline.testing import FakeTokenizer

    vis_cfg = j_vis.QwenVLVisionConfig(depth=2, hidden_size=32, num_heads=2,
                                       intermediate_size=64, window_size=56,
                                       fullatt_block_indexes=(1,), out_hidden_size=256)
    vae_cfg = j_vae.VAEConfig(base_dim=8)
    ks = iter(jax.random.split(jax.random.PRNGKey(9), 4))
    rng = np.random.default_rng(9)

    def fill(path, x):      # a random VAE, so the comparison sees the decode
        x = np.asarray(x)
        if path[-1].key == "gamma":
            return np.ones_like(x)
        if path[-1].key == "w":
            return (rng.uniform(-1, 1, x.shape) / np.sqrt(np.prod(x.shape[:3]))).astype(x.dtype)
        return (0.05 * rng.normal(size=x.shape)).astype(x.dtype)

    pipe = PhysicEditPipeline(
        dit_params=_np_tree(j_dit.init_dit_params(next(ks), W4_DIT)),
        vae_params=jax.tree_util.tree_map_with_path(fill, init_vae_params(vae_cfg, jnp.float32)),
        text_params=_np_tree(_rand_text_params(next(ks), W4_TEXT)),
        vision_params=_np_tree(_rand_vision_params(next(ks), vis_cfg)),
        adapters={"visual_thinking_adapter": _np_tree(
            j_ad.init_dual_adapter_params(next(ks), 256, 256))},
        dit_cfg=W4_DIT, vae_cfg=vae_cfg, text_cfg=W4_TEXT, vision_cfg=vis_cfg,
        tokenizer=FakeTokenizer(), dtype=jnp.float32, image_pad_id=99, vision_start_id=98,
        edit_drop_idx=2, t2i_drop_idx=2, rope_axes=(16, 56, 56))
    pipe.boi_token_id, pipe.eoi_token_id = 96, 95
    return pipe


def _jax_quantize_int4(pipe):
    """The body of the JAX package's from_pretrained(quantize="int4")."""
    import copy

    q = copy.copy(pipe)
    q.dit_params = jqm.quantize_tree_int4(pipe.dit_params, skip_top=jqm.DIT_OUTER_KEYS)
    q.text_params = j_text.split_layers(j_text.quantize_embedding_int8(
        j_text.fuse_decode_projections(jqm.quantize_tree_int4(pipe.text_params))))
    q.kv_int8 = True
    q.vision_params = jqm.quantize_tree_int4(pipe.vision_params)
    return q


@pytest.fixture(scope="module")
def w4_pipes():
    jpipe = _jax_pipeline()
    return _jax_quantize_int4(jpipe), pipeline_from_jax(jpipe, device="cpu").quantize_("int4")


def test_pipeline_from_jax_carries_the_w4_lane_bitwise(w4_pipes):
    """A JAX pipeline quantized by its own branch (split layers, fused
    projections, int8 table, kv_int8) carries into the port with the bytes
    the port's quantize_ makes from the float weights."""
    jq, tpipe = w4_pipes
    carried = pipeline_from_jax(jq, device="cpu")
    assert carried.kv_int8 and tpipe.kv_int8
    for name in ("dit", "text", "vision"):
        _same_state(getattr(carried, name), getattr(tpipe, name))
    assert type(tpipe.dit.blocks[1].img_mlp["fc2"]).__name__ == "W4Linear"
    assert type(tpipe.dit.img_in).__name__ == "Linear"
    assert type(tpipe.text.lm_head).__name__ == "W4Linear"


def test_w4_pipeline_matches_jax(w4_pipes):
    jq, tpipe = w4_pipes
    rng = np.random.default_rng(10)
    edit = Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8))
    kw = dict(edit_image=edit, height=64, width=64, seed=3, num_inference_steps=2,
              have_text_reasoning=False, edit_image_auto_resize=False)
    want = np.asarray(jq("tilt the cup", **kw), np.int16)
    got = np.asarray(tpipe("tilt the cup", **kw), np.int16)
    assert want.std() > 0 and got.shape == want.shape == (64, 64, 3)
    # the W4 products see the same int8 codes but for the rare code an fp32
    # rounding difference moves by a step: within 2 uint8 levels
    assert np.abs(got - want).max() <= 2
    text_want = jq.reason_physical_batch(["tilt the cup"], [edit], max_new_tokens=8)
    text_got = tpipe.reason_physical_batch(["tilt the cup"], [edit], max_new_tokens=8)
    assert text_got == text_want and len(text_got[0]) > 0


# 256-wide port dims in the full width's structure: every DiT block and VL
# text linear reaches K3, the ViT's qkv, proj and merger do, and its MLP
# (intermediate 200) and patch embed take the dense fallback
W4_DIMS = PipelineDims(
    dit=TDiTConfig(num_layers=2, dim=256, num_heads=2, head_dim=128, txt_in_dim=256,
                   patch_dim=64, time_dim=64),
    text=t_text.QwenVLTextConfig(hidden_size=256, num_layers=2, num_heads=2, num_kv_heads=1,
                                 head_dim=128, intermediate_size=512, vocab_size=512),
    vision=TVisionConfig(depth=2, hidden_size=256, num_heads=2, intermediate_size=200,
                         window_size=56, fullatt_block_indexes=(1,), out_hidden_size=256),
    vae=SIZES["tiny"].vae, adapter_dim=256, rope_axes=(16, 56, 56), edit_drop_idx=2)


def test_to_keeps_quantized_buffers():
    """Moving a quantized bf16 pipeline keeps the fp32 weight scales, the
    int8 weights and the bf16 table scales as they are."""
    pipe = random_pipeline(W4_DIMS, "cpu", torch.bfloat16,
                           torch.Generator().manual_seed(0)).quantize_("int4")
    before = {k: v.clone() for k, v in pipe.dit.state_dict().items()}
    scale = pipe.text.embed.e_scale.clone()
    pipe.to("cpu")
    lin = pipe.dit.blocks[0].attn["img_qkv"]
    assert lin.w_scale.dtype == torch.float32 and lin.w4.dtype == torch.int8
    for key, val in pipe.dit.state_dict().items():
        assert val.dtype == before[key].dtype and torch.equal(val, before[key]), key
    assert torch.equal(pipe.text.embed.e_scale, scale)


def test_quantize_modes():
    pipe = build_random_pipeline("tiny", device="cpu")
    w8 = random_pipeline(W4_DIMS, "cpu", torch.float32,
                         torch.Generator().manual_seed(0)).quantize_("int8")
    assert type(w8.dit.blocks[0].attn["img_qkv"]).__name__ == "Int8Linear"
    assert not w8.kv_int8
    with pytest.raises(ValueError, match="unknown quantize mode"):
        pipe.quantize_("fp8")
    assert pipe.quantize_("w4").kv_int8


def test_w4_edit_launch_structure(monkeypatch):
    """The launches chip_smoke.py demands of a W4 edit (reasoner on, CFG 4)
    are the ones the port makes: counted here at the plain versions' call
    sites."""
    import chip_smoke
    from physicedit_torch.models import dit as t_dit

    calls = dict.fromkeys(["fixedmax_attention", "w4a8_matmul", "ln_mod_quant",
                           "gelu_quant", "transpose_quant", "qk_norm_rope", "ln_mod",
                           "residual_ln_mod"], 0)

    def count(module, attr, name):
        real = getattr(module, attr)

        def spy(*a, **k):
            calls[name] += 1
            return real(*a, **k)

        monkeypatch.setattr(module, attr, spy)

    count(t_dit, "fixedmax_attention", "fixedmax_attention")
    count(t_dit, "qk_norm_rope", "qk_norm_rope")
    count(t_dit, "ln_mod", "ln_mod")
    count(t_dit, "residual_ln_mod", "residual_ln_mod")
    count(tqm, "w4a8_matmul", "w4a8_matmul")
    for name in ("ln_mod_quant", "gelu_quant", "transpose_quant"):
        count(tfq, f"_{name}", name)
    pipe = random_pipeline(W4_DIMS, "cpu", torch.float32,
                           torch.Generator().manual_seed(1)).quantize_("int4")
    edit = Image.fromarray(np.random.default_rng(11).integers(0, 255, (64, 64, 3),
                                                              dtype=np.uint8))
    pipe("tilt the cup", edit_image=edit, height=64, width=64, seed=2, num_inference_steps=2,
         edit_image_auto_resize=False)
    want = chip_smoke.w4_launch_counts(pipe.timings, 2, 2, 2, 2)
    del want["gqa_causal_attention"]            # K2 runs only on the card
    assert calls == want
    assert 0 < calls["w4a8_matmul"] and pipe.timings["decode_tokens"] == 1000


def test_w4_edit_regime_launch_structure(monkeypatch):
    """K3's launches of a W4 edit by regime, as chip_smoke.py demands them:
    the GEMV where M <= 16, the tiled GEMM above, counted here at the plain
    version's call site."""
    import chip_smoke

    calls = {"w4a8_matmul_gemv": 0, "w4a8_matmul_tiled": 0}
    real = tqm.w4a8_matmul

    def spy(xq, *a, **k):
        calls["w4a8_matmul_gemv" if xq.shape[0] <= tqm.GEMV_MAX_ROWS
              else "w4a8_matmul_tiled"] += 1
        return real(xq, *a, **k)

    monkeypatch.setattr(tqm, "w4a8_matmul", spy)
    pipe = random_pipeline(W4_DIMS, "cpu", torch.float32,
                           torch.Generator().manual_seed(1)).quantize_("int4")
    edit = Image.fromarray(np.random.default_rng(11).integers(0, 255, (64, 64, 3),
                                                              dtype=np.uint8))
    pipe("tilt the cup", edit_image=edit, height=64, width=64, seed=2, num_inference_steps=2,
         edit_image_auto_resize=False)
    assert calls == chip_smoke.w4_regime_counts(pipe.timings, 2, 2, 2, 2)
    assert min(calls.values()) > 0

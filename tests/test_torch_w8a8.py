"""The port's W8A8 lane (``physicedit_torch/ops/quant.py``, ``quantize="int8"``)
against the JAX package's (``physicedit_tpu/ops/quant.py``), on the CPU.

Weights and inputs come from numpy seeds; the JAX trees are carried into the
port by ``io/from_jax.py``.  The int8 codes, the scales and the int32
accumulators must be equal bit for bit; ``int8_linear`` within 1e-6 relative
in fp32 (both compute the same fp32 epilogue); a whole tiny DiT or pipeline
within the tolerance stated beside it, since an fp32 rounding difference
upstream can move an activation's int8 code by one step.  The tiny models'
layers are under the default 65,536-element threshold, so most cases pass
``min_size=1024`` to both packages, as tests/test_quant.py does.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from PIL import Image

from physicedit_tpu.core.params import linear as j_linear
from physicedit_tpu.models import dit as j_dit
from physicedit_tpu.ops import quant as jq
from physicedit_tpu.ops import rope as j_rope
from physicedit_tpu.pipeline.testing import build_tiny_pipeline
from physicedit_torch.core.params import load_linear_
from physicedit_torch.io.from_jax import dit_from_jax, pipeline_from_jax, text_from_jax
from physicedit_torch.ops import quant as tq
from tests.test_torch_pipeline import _random_vae

torch.set_num_threads(2)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _hostile(rng, k, n):
    """[K, N] weights with an all-zero channel (scale 1e-8), a channel whose
    codes tie at x.5 (round half to even) and a wide range of scales."""
    w = rng.normal(size=(k, n)).astype(np.float32) * np.geomspace(1e-3, 10, n).astype(np.float32)
    w[:, 3] = 0.0
    w[:, 5] = np.float32(2.0)
    w[:4, 5] = np.float32(2.0) * np.array([0.5, 1.5, 2.5, -0.5], np.float32) / 127.0
    return w


# ---------------------------------------------------------------------------
# The quantizers and the linear
# ---------------------------------------------------------------------------

def test_quantize_weight_bitwise():
    """Codes and per-output-channel scales equal JAX's bit for bit."""
    w = _hostile(np.random.default_rng(0), 256, 384)
    want = jq.quantize_weight(jnp.asarray(w))
    w_q, w_scale = tq.quantize_weight(torch.from_numpy(w.T.copy()))
    assert w_q.dtype == torch.int8 and w_q.shape == (384, 256) and w_scale.shape == (384,)
    np.testing.assert_array_equal(w_q.numpy().T, np.asarray(want["w_q"]))
    np.testing.assert_array_equal(w_scale.numpy(), np.asarray(want["w_scale"]))
    assert w_scale[3].item() == np.float32(1e-8) and (w_q[3] == 0).all()


def test_quantize_rows_bitwise():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 7, 96)).astype(np.float32) * 5
    x[0, 0] = 0.0                                       # a zero row: scale 1e-8, codes 0
    x[1, 2, :3] = np.array([0.5, 1.5, 127.0], np.float32)
    x[1, 2, 3:] = 0.0                                   # codes at exact ties
    want_q, want_s = jq.quantize_rows(jnp.asarray(x))
    got_q, got_s = tq.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def _linear_pair(w, b):
    p = dict(jq.quantize_weight(jnp.asarray(w)), b=jnp.asarray(b))
    lin = tq.Int8Linear(w.shape[0], w.shape[1], device="cpu")
    load_linear_(lin, _np_tree(p))
    return p, lin


def test_int8_linear_accuracy():
    """The JAX package's case: ~1 % W8A8 error against the float product."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(256, 512)).astype(np.float32) / 16
    b = rng.normal(size=(512,)).astype(np.float32) * 0.01
    x = rng.normal(size=(4, 64, 256)).astype(np.float32)
    ref = x @ w + b
    _, lin = _linear_pair(w, b)
    out = lin(torch.from_numpy(x)).numpy()
    rel = np.abs(out - ref) / (np.abs(ref).mean() + 1e-6)
    assert rel.mean() < 0.02, rel.mean()


@pytest.mark.parametrize("rows", [1, 5, 16, 17, 300])
def test_int8_linear_matches_jax(rows):
    """The int32 accumulators equal JAX's (the same int8 codes through
    ``lax.dot_general``); the output within 1e-6 relative in fp32, and the
    bf16 output bit for bit."""
    rng = np.random.default_rng(2 + rows)
    w = _hostile(rng, 192, 128)
    b = rng.normal(size=(128,)).astype(np.float32)
    x = rng.normal(size=(rows, 192)).astype(np.float32)
    p, lin = _linear_pair(w, b)
    xq, _ = jq.quantize_rows(jnp.asarray(x))
    want_acc = np.asarray(jax.lax.dot_general(xq, p["w_q"], (((1,), (0,)), ((), ())),
                                              preferred_element_type=jnp.int32))
    got_acc = tq.int_mm(tq.quantize_rows(torch.from_numpy(x))[0], lin.w_q)
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.numpy(), want_acc)
    want = np.asarray(jq.int8_linear(p, jnp.asarray(x)))
    got = lin(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    # bf16 activations and bias, the scales fp32: the same epilogue, one rounding
    p16 = {**p, "b": p["b"].astype(jnp.bfloat16)}
    lin16 = tq.Int8Linear(192, 128, dtype=torch.bfloat16, device="cpu")
    load_linear_(lin16, _np_tree(p16))
    assert lin16.w_scale.dtype == torch.float32 and lin16.bias.dtype == torch.bfloat16
    got16 = lin16(torch.from_numpy(x).bfloat16()).float().numpy()
    want16 = np.asarray(jq.int8_linear(p16, jnp.asarray(x, jnp.bfloat16)), np.float32)
    np.testing.assert_array_equal(got16, want16)


def test_linear_dispatches_on_quant_leaf():
    """A JAX ``w_q`` leaf loads into an Int8Linear whose forward is JAX's
    ``linear`` on that leaf; a float layer refuses it."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(32, 64)).astype(np.float32)
    x = rng.normal(size=(2, 32)).astype(np.float32)
    p_q = jq.quantize_weight(jnp.asarray(w))
    lin = tq.Int8Linear(32, 64, bias=False, device="cpu")
    load_linear_(lin, _np_tree(p_q))
    np.testing.assert_allclose(lin(torch.from_numpy(x)).numpy(),
                               np.asarray(j_linear(p_q, jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="does not fit"):
        load_linear_(torch.nn.Linear(32, 64, bias=False), _np_tree(p_q))


def test_int_mm_count_and_reset():
    lin = tq.Int8Linear.from_linear(torch.nn.Linear(64, 32))
    tq.reset_call_counts()
    lin(torch.ones(3, 5, 64))
    lin(torch.ones(1, 64))
    assert tq.CALLS["int_mm"] == 2
    tq.reset_call_counts()
    assert tq.CALLS["int_mm"] == 0


# ---------------------------------------------------------------------------
# The module walk against quantize_tree
# ---------------------------------------------------------------------------

SMALL_DIT = j_dit.DiTConfig(num_layers=2, dim=128, num_heads=2, head_dim=64, txt_in_dim=64,
                            patch_dim=64, time_dim=32)


@pytest.fixture(scope="module")
def dit_params():
    return _np_tree(j_dit.init_dit_params(jax.random.PRNGKey(0), SMALL_DIT, jnp.float32))


def _kinds(module):
    return {n: type(m).__name__ for n, m in module.named_modules()
            if type(m).__name__ in ("Linear", "Int8Linear")}


def _same_state(a: torch.nn.Module, b: torch.nn.Module) -> None:
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for key, val in sb.items():
        assert sa[key].dtype == val.dtype and torch.equal(sa[key], val), key


@pytest.mark.parametrize("min_size", [1024, 1 << 16])
def test_quantize_module_int8_matches_quantize_tree(dit_params, min_size):
    """The port's in-place walk quantizes exactly the leaves JAX's
    ``quantize_tree`` does (a stacked [L, K, N] leaf counts all L layers;
    at the default threshold the small ones stay float), with the same
    bytes; the layers left alone keep their float weights."""
    got = tq.quantize_module_int8(dit_from_jax(dit_params, SMALL_DIT, device="cpu"), min_size)
    want = dit_from_jax(_np_tree(jq.quantize_tree(dit_params, min_size=min_size)), SMALL_DIT,
                        device="cpu")
    kinds = _kinds(got)
    assert kinds == _kinds(want)
    if min_size == 1024:
        assert set(kinds.values()) == {"Int8Linear"}
    else:
        # img_qkv over 2 layers is 98,304 elements, to_out 32,768, img_in 4,096
        assert kinds["blocks.0.attn.img_qkv"] == "Int8Linear"
        assert kinds["blocks.0.attn.to_out"] == kinds["img_in"] == "Linear"
    _same_state(got, want)


def _dit_inputs(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(1, 16, 64)).astype(np.float32)
    txt = rng.normal(size=(1, 6, 64)).astype(np.float32)
    ropes = j_rope.build_rope_tables([(1, 4, 4)], 6, axes_dim=(16, 24, 24))
    return img, txt, np.array([0.4], np.float32), ropes


def test_quantized_dit_forward_matches_jax(dit_params):
    """A W8A8 DiT forward against JAX's on the same int8 tree (the JAX
    package's own case, which holds it within 0.1 mean relative of fp32)."""
    qparams = jq.quantize_tree(dit_params, min_size=1024)
    img, txt, t, ropes = _dit_inputs()
    args = (jnp.asarray(img), jnp.asarray(txt), jnp.asarray(t), *map(jnp.asarray, ropes))
    ref = np.asarray(j_dit.dit_forward(dit_params, SMALL_DIT, *args))
    want = np.asarray(j_dit.dit_forward(qparams, SMALL_DIT, *args))
    model = dit_from_jax(_np_tree(qparams), SMALL_DIT, device="cpu")
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (img, txt, t)), *map(torch.from_numpy, ropes))
    got = got.numpy()
    assert np.abs(got - ref).mean() / np.abs(ref).mean() < 0.1
    # an fp32 rounding difference can move an activation's code by one step
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)


# ---------------------------------------------------------------------------
# The W8A8 pipeline
# ---------------------------------------------------------------------------

def _jax_quantize_int8(pipe, min_size):
    """The body of the JAX package's from_pretrained(quantize="int8")."""
    import copy

    q = copy.copy(pipe)
    q.dit_params = jq.quantize_tree(pipe.dit_params, min_size=min_size)
    q.text_params = jq.quantize_tree(pipe.text_params, min_size=min_size)
    return q


@pytest.fixture(scope="module")
def w8_pipes():
    jpipe = build_tiny_pipeline()
    jpipe.vae_params = _random_vae(jpipe.vae_params)
    jq8 = _jax_quantize_int8(jpipe, 1024)
    tpipe = pipeline_from_jax(jpipe, device="cpu")
    for model in (tpipe.dit, tpipe.text):      # quantize_("int8")'s body at min_size 1024
        tq.quantize_module_int8(model, 1024)
    return jq8, tpipe


def test_pipeline_from_jax_carries_the_w8a8_lane_bitwise(w8_pipes):
    """A JAX pipeline quantized by its own int8 branch carries into the port
    with the bytes the port's quantization makes; the ViT, the token table
    and the KV cache stay float."""
    jq8, tpipe = w8_pipes
    carried = pipeline_from_jax(jq8, device="cpu")
    for name in ("dit", "text", "vision"):
        _same_state(getattr(carried, name), getattr(tpipe, name))
    assert type(tpipe.dit.blocks[1].img_mlp["fc2"]).__name__ == "Int8Linear"
    assert type(tpipe.text.lm_head).__name__ == "Int8Linear"
    assert type(tpipe.text.layers[0].q).__name__ == "Int8Linear"
    assert "Int8Linear" not in {type(m).__name__ for m in tpipe.vision.modules()}
    assert isinstance(tpipe.text.embed, torch.nn.Parameter) and not tpipe.kv_int8


def test_quantized_pipeline_edit(w8_pipes):
    """A tiny edit with the W8A8 DiT and text model (JAX's
    test_quantized_pipeline_edit, here against JAX's image): within 2 uint8
    levels; and the W8A8 reasoner's text equal to JAX's."""
    jq8, tpipe = w8_pipes
    rng = np.random.default_rng(0)
    edit = Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8))
    kw = dict(edit_image=edit, height=64, width=64, seed=1, num_inference_steps=2,
              have_text_reasoning=False, edit_image_auto_resize=False)
    want = np.asarray(jq8("nudge the box", **kw), np.int16)
    tq.reset_call_counts()
    got = np.asarray(tpipe("nudge the box", **kw), np.int16)
    assert tq.CALLS["int_mm"] > 0
    assert got.shape == want.shape == (64, 64, 3) and want.std() > 0
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 2
    text_want = jq8.reason_physical(["nudge the box"][0], edit, max_new_tokens=8)
    text_got = tpipe.reason_physical("nudge the box", edit, max_new_tokens=8)
    assert text_got == text_want and len(text_got) > 0


def test_w8a8_int_mm_calls_per_denoise_step(w8_pipes, monkeypatch):
    """The torch._int_mm calls that chip_smoke.py demands of a W8A8 denoise
    step: one per quantized DiT linear the step runs (the slim last block
    skips its text stream's three), CFG rows batched, with and without a
    CFG truncation."""
    import chip_smoke
    from physicedit_torch.pipeline.edit_pipeline import PhysicEditPipeline

    _, tpipe = w8_pipes
    per_step = []
    real = PhysicEditPipeline._run_denoise

    def spy(self, *a, **kw):
        before = tq.CALLS["int_mm"]
        out = real(self, *a, **kw)
        per_step.append(tq.CALLS["int_mm"] - before)
        return out

    monkeypatch.setattr(PhysicEditPipeline, "_run_denoise", spy)
    edit = Image.fromarray(np.random.default_rng(5).integers(0, 255, (64, 64, 3),
                                                             dtype=np.uint8))
    for trunc in (None, 1):
        tpipe("tilt", edit_image=edit, height=64, width=64, seed=2, num_inference_steps=3,
              have_text_reasoning=False, edit_image_auto_resize=False, cfg_truncate_step=trunc)
    want = 3 * chip_smoke.w8a8_int_mm_per_step(tpipe.dit)
    assert per_step == [want, want]
    n_int8 = sum(type(m).__name__ == "Int8Linear" for m in tpipe.dit.modules())
    assert chip_smoke.w8a8_int_mm_per_step(tpipe.dit) == n_int8 - 3


def test_text_model_w8a8_prefill_and_decode_match_jax():
    """The W8A8 VL text model's prefill logits and greedy tokens against
    JAX's on the same int8 tree."""
    from physicedit_tpu.models import qwen_vl as j_text
    from physicedit_tpu.pipeline.testing import _rand_text_params

    cfg = j_text.TINY_TEXT
    params = jq.quantize_tree(_rand_text_params(jax.random.PRNGKey(3), cfg), min_size=1024)
    model = text_from_jax(_np_tree(params), cfg, device="cpu")
    rng = np.random.default_rng(4)
    s = 24
    emb = rng.normal(size=(1, s, cfg.hidden_size)).astype(np.float32) * 0.1
    pos = np.tile(np.arange(s), (3, 1, 1)).astype(np.int32)
    mask = np.ones((1, s), bool)
    lj, cj, _ = j_text.prefill(params, cfg, jnp.asarray(emb), jnp.asarray(pos),
                               jnp.asarray(mask), max_total_len=s + 6)
    lt, ct, _ = model.prefill(torch.from_numpy(emb), torch.from_numpy(pos).long(),
                              torch.from_numpy(mask), s + 6)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-4, rtol=2e-3)
    first_j = jnp.argmax(lj, -1).astype(jnp.int32)
    toks_j, _ = j_text.greedy_decode(params, cfg, cj, first_j, s, jnp.asarray([s], jnp.int32), 6)
    toks_t, _ = model.greedy_decode(ct, lt.argmax(-1), s, torch.tensor([s]), 6)
    assert toks_t.numpy().tolist() == np.asarray(toks_j).tolist()


# ---------------------------------------------------------------------------
# Loading and the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from tests.test_torch_io import build_tree

    return build_tree(str(tmp_path_factory.mktemp("synth_w8")))


def test_from_pretrained_int8_matches_jax(tree):
    """``from_pretrained(quantize="int8")`` on a 256-wide tree at the default
    threshold: the linears JAX's int8 load quantizes, with its bytes
    (carried across), the same as ``quantize_("int8")`` after a float load;
    some layers stay float at this width (img_in, 16,384 elements)."""
    from physicedit_tpu.pipeline.edit_pipeline import PhysicEditPipeline as JPipe
    from physicedit_torch.pipeline.edit_pipeline import PhysicEditPipeline as TPipe

    tp = TPipe.from_pretrained(tree["paths"], dtype=torch.float32, device="cpu",
                               quantize="int8")
    ref = TPipe.from_pretrained(tree["paths"], dtype=torch.float32,
                                device="cpu").quantize_("int8")
    jp = pipeline_from_jax(JPipe.from_pretrained(tree["paths"], dtype=jnp.float32,
                                                 quantize="int8"), device="cpu")
    for name in ("dit", "text", "vision"):
        _same_state(getattr(tp, name), getattr(ref, name))
        _same_state(getattr(tp, name), getattr(jp, name))
    kinds = _kinds(tp.dit)
    assert kinds["blocks.0.attn.img_qkv"] == "Int8Linear" and kinds["img_in"] == "Linear"
    assert type(tp.text.lm_head).__name__ == "Int8Linear" and not tp.kv_int8


@pytest.mark.parametrize("impl", ["dense", "kernels"])
def test_validate_cli_int8_matches_jax(tree, tmp_path, monkeypatch, impl):
    """``cli.validate --quantize int8`` in both packages on the same tree
    (fp32, the fake tokenizer, a 64 x 64 resize; as tests/test_torch_cli.py
    runs int4): within 2 uint8 levels, an activation code being able to
    move by one step."""
    import functools

    from jax.experimental import pallas as pl

    import physicedit_tpu.cli.validate as j_cli
    import physicedit_torch.cli.validate as t_cli
    from physicedit_tpu.pipeline.edit_pipeline import PhysicEditPipeline as JPipe
    from physicedit_torch.pipeline.edit_pipeline import PhysicEditPipeline as TPipe
    from tests.test_torch_io import fake_tokenizer

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    for cls, fp32 in ((JPipe, jnp.float32), (TPipe, torch.float32)):
        monkeypatch.setattr(cls, "load_tokenizer", lambda self, path: fake_tokenizer(self))
        load = cls.from_pretrained.__func__
        monkeypatch.setattr(cls, "from_pretrained", classmethod(
            lambda c, *a, _load=load, _dt=fp32, **kw: _load(c, *a, dtype=_dt, **kw)))
    for cli in (j_cli, t_cli):
        monkeypatch.setattr(cli, "resize_image", lambda im, target_area=0: im.resize((64, 64)))
    image = str(tmp_path / "in.png")
    Image.fromarray(np.random.default_rng(1).integers(0, 255, (80, 72, 3),
                                                      dtype=np.uint8)).save(image)
    common = ["--prompt", "the ball rolls off the table", "--image_path", image,
              "--base_model_path", tree["base"], "--seed", "3", "--num_inference_steps", "2",
              "--no_text_reasoning", "--quantize", "int8"]
    outs = {}
    for name, cli, extra in (
            ("jax", j_cli, ["--attn_impl", {"dense": "xla", "kernels": "pallas"}[impl]]),
            ("port", t_cli, ["--attn_impl", impl, "--device", "cpu"])):
        path = str(tmp_path / name / "out.png")
        pipe = cli.main(common + extra + ["--save_path", path])
        outs[name] = np.asarray(Image.open(path), np.int16)
    assert type(pipe.dit.blocks[0].attn["img_qkv"]).__name__ == "Int8Linear"
    assert outs["port"].shape == outs["jax"].shape == (64, 64, 3) and outs["jax"].std() > 0
    assert np.abs(outs["port"] - outs["jax"]).max() <= 2


def test_chip_smoke_w8a8_faults_differ_from_the_route():
    """The faults ``chip_smoke.py`` runs beside the W8A8 edit are faults: on
    the same seeded activations the per-tensor scale and the truncated
    codes give codes other than ``quantize_rows``'s (and JAX's), and the
    int4-grid control leaves each channel 15 levels whose dequantized
    weights lie within half a step of the int8 ones."""
    import chip_smoke

    rng = np.random.default_rng(21)
    x = (rng.normal(size=(64, 256)) * np.geomspace(0.1, 10, 64)[:, None]).astype(np.float32)
    want, want_s = jq.quantize_rows(jnp.asarray(x))
    codes, scales = tq.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(want_s))
    for fault in (chip_smoke._per_tensor_rows, chip_smoke._truncated_rows):
        f_codes, f_scales = fault(torch.from_numpy(x))
        assert f_codes.dtype == torch.int8 and f_scales.shape == (64, 1)
        assert not torch.equal(f_codes, codes)
    lin = torch.nn.Linear(256, 32)
    model = tq.quantize_module_int8(torch.nn.Sequential(lin), min_size=1)
    w8 = model[0].w_q.float() * model[0].w_scale[:, None]
    chip_smoke._int4_grid_(model)
    assert model[0].w_q.abs().max() <= 7
    assert all(len(row.unique()) <= 15 for row in model[0].w_q)
    w4 = model[0].w_q.float() * model[0].w_scale[:, None]
    assert bool(((w4 - w8).abs() <= model[0].w_scale[:, None] / 2 * (1 + 1e-6)).all())

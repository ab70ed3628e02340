"""Nexus-Gen (``models/nexus_gen.py``), its projector
(``models/nexus_gen_projector.py``) and the Qwen2.5-VL prompt-enhancement
embedder (``models/qwenvl_embedder.py``) of the port against the JAX
package, fp32 on the CPU, same carried weights and seed-made inputs; and the
scorers and Nexus-Gen in a process with no JAX."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from physicedit_tpu.models import nexus_gen as JNG
from physicedit_tpu.models import nexus_gen_projector as JP
from physicedit_tpu.models import qwen_vl as JVL
from physicedit_tpu.models import qwen_vl_vision as j_vis
from physicedit_tpu.models import qwenvl_embedder as JE
from physicedit_tpu.pipeline.testing import _rand_vision_params
from physicedit_torch.io.from_jax import (adapter_from_jax, config_from_jax, merger_from_jax,
                                          nexus_gen_from_jax, text_from_jax, vision_from_jax)
from physicedit_torch.models import nexus_gen as NG
from physicedit_torch.models import nexus_gen_projector as P
from physicedit_torch.models import qwen_vl as TVL
from physicedit_torch.models import qwen_vl_vision as t_vis
from physicedit_torch.models import qwenvl_embedder as E

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4          # the repo's fp32 tolerance

# the JAX tests' tiny decoder: vocabulary past the image-token ids
CFG = JVL.QwenVLTextConfig(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2,
                           head_dim=16, intermediate_size=96, vocab_size=151700,
                           mrope_section=(2, 3, 3), rope_theta=1e4)
# the merger at a small width (MERGER_CFG is 3584 wide)
MERGER_SMALL = dataclasses.replace(CFG, vocab_size=64)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def nexus():
    params = _np_tree(JNG.init_nexus_params(jax.random.PRNGKey(0), CFG, jnp.float32))
    return params, nexus_gen_from_jax(params, CFG, device="cpu")


def _ids(n_in, n_target=JNG.NUM_IMG_TOKENS):
    ids = [5, JNG.VISION_START_ID] + [JNG.IMAGE_TOKEN_ID] * n_in + [JNG.VISION_END_ID, 7]
    if n_target:
        ids += [JNG.VISION_START_ID] + [JNG.IMAGE_TOKEN_ID] * n_target + [JNG.VISION_END_ID]
    return np.asarray([ids + [9]], np.int32)


@pytest.mark.parametrize("case", ["table_fits", "more_pads_than_rows"])
def test_nexus_forward_matches_jax(nexus, case):
    """Logits and vision_head embeddings; with more image pads than table
    rows the ordinal gather clips to the last row."""
    params, model = nexus
    rng = np.random.default_rng(1)
    ids = _ids(4)
    n_rows = 4 + JNG.NUM_IMG_TOKENS - (30 if case == "more_pads_than_rows" else 0)
    table = (rng.normal(size=(1, n_rows, 64)) * 0.1).astype(np.float32)
    pos = np.broadcast_to(np.arange(ids.shape[1]), (3, 1, ids.shape[1])).copy()
    attn = np.ones(ids.shape, bool)
    jl, je = JNG.nexus_forward(params, CFG, jnp.asarray(ids), jnp.asarray(attn),
                               jnp.asarray(pos), jnp.asarray(table))
    tl, te = NG.nexus_forward(model, torch.from_numpy(ids.astype(np.int64)),
                              torch.from_numpy(attn), torch.from_numpy(pos),
                              torch.from_numpy(table))
    _close(te, je)
    _close(tl, jl)


@pytest.mark.parametrize("reference", [True, False])
def test_target_embeddings_match_jax(nexus, reference):
    """With a reference image (grids (1,4,4) and the 18x18 target) and for
    text-to-image (no input features)."""
    params, model = nexus
    if reference:
        ids = _ids(4)
        vis = (np.random.default_rng(3).normal(size=(4, 64)) * 0.1).astype(np.float32)
        grids = [(1, 4, 4), (1, 18, 18)]
    else:
        ids = np.asarray([[5, JNG.VISION_START_ID] + [JNG.IMAGE_TOKEN_ID] * JNG.NUM_IMG_TOKENS
                          + [JNG.VISION_END_ID, 9]], np.int32)
        vis = np.zeros((0,), np.float32)
        grids = [(1, 18, 18)]
    want = JNG.target_embeddings(params, CFG, ids, vis, grids)
    got = NG.target_embeddings(model, ids, vis, grids)
    assert got.shape == (JNG.NUM_IMG_TOKENS, 64)
    _close(got, want)


def test_target_embeddings_read_the_position_before_each_target_token(nexus):
    """The shift by one: row i is vision_head at the position just before
    the i-th target-image token."""
    _, model = nexus
    ids = _ids(4)
    vis = np.zeros((4, 64), np.float32)
    grids = [(1, 4, 4), (1, 18, 18)]
    from physicedit_torch.pipeline.vl_host import get_rope_index

    pos = torch.from_numpy(get_rope_index(ids[0], grids, NG.IMAGE_TOKEN_ID,
                                          NG.VISION_START_ID))[:, None]
    table = torch.cat([torch.from_numpy(vis), model.image_prefill_embeds])[None]
    _, emb = NG.nexus_forward(model, torch.from_numpy(ids.astype(np.int64)),
                              torch.ones(ids.shape, dtype=torch.bool), pos, table)
    first_target = ids.shape[1] - 2 - JNG.NUM_IMG_TOKENS
    got = NG.target_embeddings(model, ids, vis, grids)
    torch.testing.assert_close(got, emb[0, first_target - 1:first_target - 1 + 81],
                               rtol=1e-6, atol=1e-6)


def test_messages_match_jax():
    for instruction in ("make it red", "<image> tilt the cup", ""):
        assert NG.editing_messages(instruction) == JNG.editing_messages(instruction)
        assert NG.generation_messages(instruction) == JNG.generation_messages(instruction)


@pytest.fixture(scope="module")
def raw_checkpoint(nexus):
    """A reference-layout Nexus-Gen state dict written by the port (tiny
    text model, JAX's tiny ViT)."""
    _, model = nexus
    vcfg = j_vis.TINY_VISION
    vparams = _np_tree(_rand_vision_params(jax.random.PRNGKey(5), vcfg))
    vision = vision_from_jax(vparams, vcfg, device="cpu")
    sd = {k: v.clone() for k, v in NG.nexus_gen_state_dict(model, vision).items()}
    return sd, vcfg


def test_nexus_converters_round_trip(nexus, raw_checkpoint):
    """The raw key layout (``model.layers.*``, ``visual.*``, ``lm_head.*``,
    ``vision_head.*``, ``image_prefill_embeds.*``) through the port's and
    JAX's converters: the port writes back the same tensors, and both give
    the same forward and the same ViT features."""
    params, model = nexus
    sd, vcfg = raw_checkpoint
    tcfg = config_from_jax(CFG, TVL.QwenVLTextConfig)
    tvcfg = config_from_jax(vcfg, t_vis.QwenVLVisionConfig)
    loaded = NG.nexus_llm_from_torch(sd, tcfg, torch.float32, "cpu")
    vision = NG.nexus_vision_from_torch(sd, tvcfg, torch.float32, "cpu")
    again = NG.nexus_gen_state_dict(loaded, vision)
    assert set(again) == set(sd)
    for k in sd:
        torch.testing.assert_close(again[k], sd[k], rtol=0, atol=0, msg=k)

    sd_np = {k: v.numpy() for k, v in sd.items()}
    jtree = JNG.nexus_llm_from_torch(sd_np, jnp.float32)
    np.testing.assert_array_equal(np.asarray(jtree["vision_head"]["w"]),
                                  sd_np["vision_head.weight"].T)
    ids = _ids(4)
    vis = (np.random.default_rng(4).normal(size=(4, 64)) * 0.1).astype(np.float32)
    grids = [(1, 4, 4), (1, 18, 18)]
    _close(NG.target_embeddings(loaded, ids, vis, grids),
           JNG.target_embeddings(jtree, CFG, ids, vis, grids))

    from physicedit_tpu.pipeline import vl_host
    from PIL import Image

    img = Image.fromarray(np.random.default_rng(6).integers(0, 255, (56, 84, 3), np.uint8))
    flat, g = vl_host.images_to_patches([img])
    jvis = JNG.nexus_vision_from_torch(sd_np, jnp.float32)
    _close(vision(torch.from_numpy(flat), g), j_vis.run_vision(jvis, vcfg, jnp.asarray(flat), g))


def test_nexus_text_config_reads_the_shapes(raw_checkpoint):
    """cfg=None infers widths and depth and keeps Qwen2.5-VL's head_dim 128
    (the tiny file's 16-wide heads need the explicit cfg above)."""
    sd, _ = raw_checkpoint
    cfg = NG.nexus_text_config(sd)
    assert (cfg.hidden_size, cfg.vocab_size, cfg.num_layers, cfg.intermediate_size,
            cfg.head_dim) == (64, 151700, 2, 96, 128)


# ---------------------------------------------------------------------------
# Projector
# ---------------------------------------------------------------------------

def test_adapter_matches_jax():
    params = _np_tree(JP.init_adapter_params(jax.random.PRNGKey(2), 16, 24))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: (a + rng.normal(size=a.shape) * 0.2).astype(np.float32), params)
    x = rng.normal(size=(3, 7, 16)).astype(np.float32)
    want = JP.adapter_forward(params, jnp.asarray(x))
    got = P.adapter_forward(adapter_from_jax(params, device="cpu"), torch.from_numpy(x))
    _close(got, want)


def _adapter_sd(rng, d_in=16, d_out=24):
    sd = {}
    for i, (o, n) in ((0, (d_out, d_in)), (3, (d_out, d_out))):
        sd[f"adapter.{i}.weight"] = rng.normal(size=(o, n)).astype(np.float32) * 0.2
        sd[f"adapter.{i}.bias"] = rng.normal(size=(o,)).astype(np.float32) * 0.2
    for i in (1, 4):
        sd[f"adapter.{i}.weight"] = (1 + rng.normal(size=(d_out,)) * 0.1).astype(np.float32)
        sd[f"adapter.{i}.bias"] = rng.normal(size=(d_out,)).astype(np.float32) * 0.1
    return sd


def test_adapter_converter_matches_jax():
    """``adapter.{0,1,3,4}`` (Sequential indices) through both converters."""
    rng = np.random.default_rng(1)
    sd = _adapter_sd(rng)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    want = JP.adapter_forward(JP.adapter_from_torch(sd), jnp.asarray(x))
    _close(P.adapter_forward(P.adapter_from_torch(sd, device="cpu"), torch.from_numpy(x)), want)


@pytest.fixture(scope="module")
def merger():
    params = _np_tree(JP.init_merger_params(jax.random.PRNGKey(3), MERGER_SMALL, num_layers=2,
                                            out_channel=32, expand_ratio=2))
    rng = np.random.default_rng(2)
    # random gains, so the norms are checked too
    params = jax.tree_util.tree_map(
        lambda a: (a * (1 + rng.normal(size=a.shape) * 0.1)).astype(np.float32), params)
    return params, merger_from_jax(params, MERGER_SMALL, device="cpu")


@pytest.mark.parametrize("grid", [(1, 36, 36), (1, 12, 16), (2, 10, 14), (1, 28, 28)])
def test_merger_position_ids_match_jax_exactly(grid):
    """Float positions, fractional where 72 is not a multiple of the grid."""
    got = P.merger_position_ids(grid)
    want = JP.merger_position_ids(grid)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    fractional = not np.array_equal(got, np.round(got))
    assert fractional == bool(72 % grid[1] or 72 % grid[2])


@pytest.mark.parametrize("with_reference", [False, True])
def test_merger_matches_jax(merger, with_reference):
    params, module = merger
    rng = np.random.default_rng(4)
    grid, ref_grid = (1, 12, 12), (1, 16, 16)
    e = (rng.normal(size=(1, 36, 64)) * 0.5).astype(np.float32)
    r = (rng.normal(size=(1, 64, 64)) * 0.5).astype(np.float32)
    kw = dict(ref_embeds=jnp.asarray(r), ref_grid=ref_grid) if with_reference else {}
    want = JP.merger_forward(params, jnp.asarray(e), grid, cfg=MERGER_SMALL, **kw)
    tkw = dict(ref_embeds=torch.from_numpy(r), ref_grid=ref_grid) if with_reference else {}
    got = P.merger_forward(module, torch.from_numpy(e), grid, **tkw)
    assert got.shape == (1, 36 + (64 if with_reference else 0), 32)
    _close(got, want)


def test_merger_is_bidirectional(merger):
    """Changing the last embedding changes the first output row (a causal
    mask would leave it)."""
    _, module = merger
    e = torch.from_numpy(np.random.default_rng(5).normal(size=(1, 36, 64)).astype(np.float32))
    f = e.clone()
    f[0, -1] += 1.0
    a = P.merger_forward(module, e, (1, 12, 12))
    b = P.merger_forward(module, f, (1, 12, 12))
    assert (a[0, 0] - b[0, 0]).abs().max() > 1e-4


def test_merger_converter_matches_jax():
    """``embedding_merger.layers.*`` + ``projector.{0,1,2,4,5}`` through both
    converters."""
    rng = np.random.default_rng(6)
    d, kvd, inter, mid, out = 64, 32, 96, 64, 32
    sd = {}
    shapes = {"self_attn.q_proj": (d, d, True), "self_attn.k_proj": (kvd, d, True),
              "self_attn.v_proj": (kvd, d, True), "self_attn.o_proj": (d, d, False),
              "mlp.gate_proj": (inter, d, False), "mlp.up_proj": (inter, d, False),
              "mlp.down_proj": (d, inter, False)}
    for name, (o, i, bias) in shapes.items():
        sd[f"embedding_merger.layers.0.{name}.weight"] = (rng.normal(size=(o, i)) * 0.1
                                                          ).astype(np.float32)
        if bias:
            sd[f"embedding_merger.layers.0.{name}.bias"] = (rng.normal(size=(o,)) * 0.1
                                                            ).astype(np.float32)
    for name in ("input_layernorm", "post_attention_layernorm"):
        sd[f"embedding_merger.layers.0.{name}.weight"] = (1 + rng.normal(size=(d,)) * 0.1
                                                          ).astype(np.float32)
    for i, n in ((0, d), (2, mid), (5, out)):
        sd[f"embedding_merger.projector.{i}.weight"] = (1 + rng.normal(size=(n,)) * 0.1
                                                        ).astype(np.float32)
    for i, (o, n) in ((1, (mid, d)), (4, (out, mid))):
        sd[f"embedding_merger.projector.{i}.weight"] = (rng.normal(size=(o, n)) * 0.1
                                                        ).astype(np.float32)
        sd[f"embedding_merger.projector.{i}.bias"] = (rng.normal(size=(o,)) * 0.1
                                                      ).astype(np.float32)
    e = rng.normal(size=(1, 16, d)).astype(np.float32)
    want = JP.merger_forward(JP.merger_from_torch(sd, MERGER_SMALL), jnp.asarray(e),
                             (1, 8, 8), cfg=MERGER_SMALL)
    module = P.merger_from_torch(sd, config_from_jax(MERGER_SMALL, TVL.QwenVLTextConfig),
                                 device="cpu")
    _close(P.merger_forward(module, torch.from_numpy(e), (1, 8, 8)), want)


# ---------------------------------------------------------------------------
# Embedder
# ---------------------------------------------------------------------------

SPLIT_CASES = ["x" * 156 + 'say "hi t" end', 'a "quoted" prompt', "it's",
               "y" * 160 + "“curly” and 'single' quotes" + 'then "open', "no quotes at all", ""]


@pytest.mark.parametrize("i", range(len(SPLIT_CASES)))
def test_split_string_matches_jax(i):
    assert E.split_string(SPLIT_CASES[i]) == JE.split_string(SPLIT_CASES[i])


def _fake_tokenize(s):
    """chars as ord(); "<VE>" -> vision_end; CJK-quoted chars as [2073, c, 854]."""
    out, i = [], 0
    while i < len(s):
        if s.startswith("<VE>", i):
            out.append(E.VISION_END_ID)
            i += 4
        elif s.startswith("“", i) and i + 2 < len(s) and s[i + 2] == "”":
            out.extend([2073, ord(s[i + 1]), 854])
            i += 3
        else:
            out.append(ord(s[i]))
            i += 1
    return out


@pytest.mark.parametrize("text", ["prefix<VE>tail", "y" * 156 + '"q r"<VE>z', "a<VE>b<VE>c"])
def test_retokenize_with_quote_splice_matches_jax(text):
    old = [1, 2, 3, E.VISION_END_ID, 9, 9]
    got = E.retokenize_with_quote_splice(old, text, _fake_tokenize)
    assert got == JE.retokenize_with_quote_splice(old, text, _fake_tokenize)
    assert 2073 not in got and 854 not in got


def test_constants_match_jax():
    assert E.QWEN25VL_7B_PREFIX == JE.QWEN25VL_7B_PREFIX
    assert (E.MAX_LENGTH, E.PREFIX_TOKEN_OFFSET, E.VISION_END_ID) == (
        JE.MAX_LENGTH, JE.PREFIX_TOKEN_OFFSET, JE.VISION_END_ID) == (640, 217, 151653)


@pytest.mark.parametrize("max_length", [64, 32, 100])
def test_extract_embeddings_matches_jax(max_length):
    """A short input (zero tail, partial mask) and truncation."""
    hidden = np.random.default_rng(0).normal(size=(1, 300, 8)).astype(np.float32)
    jemb, jmask = JE.extract_embeddings(jnp.asarray(hidden), max_length=max_length)
    emb, mask = E.extract_embeddings(torch.from_numpy(hidden), max_length=max_length)
    np.testing.assert_array_equal(emb.numpy(), np.asarray(jemb))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert mask.dtype == torch.int32 and int(mask.sum()) == min(max_length, 300 - 217)


def test_embed_matches_jax():
    cfg = JVL.QwenVLTextConfig(num_layers=2, hidden_size=32, num_heads=2, num_kv_heads=1,
                               head_dim=16, intermediate_size=48, vocab_size=151700,
                               mrope_section=(2, 3, 3), rope_theta=1e4)
    params = _np_tree(JVL.init_text_params(jax.random.PRNGKey(0), cfg, jnp.float32))
    text = text_from_jax(params, cfg, device="cpu")
    ids = np.asarray([[5, 151652] + [151655] * 4 + [151653] + [7] * 230], np.int32)
    vis = np.random.default_rng(1).normal(size=(4, 32)).astype(np.float32)
    jemb, jmask = JE.embed(params, cfg, ids, vis, [(1, 4, 4)], max_length=64)
    emb, mask = E.embed(text, ids, vis, [(1, 4, 4)], max_length=64)
    _close(emb, jemb)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert int(mask.sum()) == ids.shape[1] - E.PREFIX_TOKEN_OFFSET


def _tiny_embedder():
    cfg = JVL.QwenVLTextConfig(num_layers=2, hidden_size=32, num_heads=2, num_kv_heads=1,
                               head_dim=16, intermediate_size=48, vocab_size=151700,
                               mrope_section=(2, 3, 3), rope_theta=1e4)
    params = _np_tree(JVL.init_text_params(jax.random.PRNGKey(0), cfg, jnp.float32))
    return cfg, params, text_from_jax(params, cfg, device="cpu")


def test_embed_text_only_matches_jax():
    """No image pads and no features: the gather leaves every row alone."""
    cfg, params, text = _tiny_embedder()
    ids = np.asarray([[5] + [7] * 240], np.int32)
    vis = np.zeros((0, 32), np.float32)
    jemb, jmask = JE.embed(params, cfg, ids, vis, [], max_length=64)
    emb, mask = E.embed(text, ids, vis, [], max_length=64)
    _close(emb, jemb)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


@pytest.mark.parametrize("n_features", [3, 5])
def test_embed_refuses_a_feature_count_other_than_the_pads(n_features):
    """Both packages refuse features that do not match the 4 image pads."""
    cfg, params, text = _tiny_embedder()
    ids = np.asarray([[5, 151652] + [151655] * 4 + [151653] + [7] * 230], np.int32)
    vis = np.random.default_rng(1).normal(size=(n_features, 32)).astype(np.float32)
    with pytest.raises(AssertionError, match="4 image tokens"):
        JE.embed(params, cfg, ids, vis, [(1, 4, 4)], max_length=64)
    with pytest.raises(AssertionError, match="4 image tokens"):
        E.embed(text, ids, vis, [(1, 4, 4)], max_length=64)


# ---------------------------------------------------------------------------
# No JAX in the process
# ---------------------------------------------------------------------------

def test_scorers_and_nexus_gen_run_without_jax(tmp_path):
    """ImageReward and HPSv2 (the port's BPE over a written merge list)
    score, and Nexus-Gen computes target embeddings, in a fresh process that
    loads neither JAX nor the JAX package."""
    code = textwrap.dedent(f"""
        import gzip, sys
        import numpy as np
        import torch
        from PIL import Image
        torch.set_num_threads(2)
        from physicedit_torch.core.params import materialize
        from physicedit_torch.extensions import quality_metric as qm
        from physicedit_torch.io.safetensors_io import save_safetensors
        from physicedit_torch.models import blip, nexus_gen, openclip
        from physicedit_torch.models.qwen_vl import QwenVLTextConfig
        gen = torch.Generator().manual_seed(0)
        folder = {str(tmp_path)!r}
        ir = blip.init_imagereward_(materialize(blip.ImageReward(
            blip.BlipViTConfig(image_size=32, width=64, depth=1, num_heads=1),
            blip.BlipTextConfig(vocab_size=50, hidden_size=64, num_layers=1, num_heads=1,
                                intermediate_size=64, max_position=40, encoder_width=64),
            (64, 16, 8, 4, 2, 1)), "cpu"), gen)
        save_safetensors(blip.imagereward_state_dict(ir), folder + "/ir.safetensors")
        class Tok:
            def __call__(self, text, padding=None, truncation=None, max_length=35):
                ids = [2, 3, 4] + [0] * (max_length - 3)
                return {{"input_ids": ids, "attention_mask": [1] * 3 + [0] * (max_length - 3)}}
        img = Image.fromarray(np.random.default_rng(0).integers(0, 255, (40, 30, 3), np.uint8))
        scorer = qm.ImageRewardScore(folder + "/ir.safetensors", tokenizer=Tok(), device="cpu")
        s = scorer.score([img, img], "a cup")
        assert np.isfinite(s).all() and abs(s[0] - scorer.score(img, "a cup")) < 1e-5, s
        with gzip.open(folder + "/bpe.txt.gz", "wt") as f:
            f.write("#v\\nc u\\ncu p</w>\\n")
        clip = openclip.init_openclip_(materialize(openclip.OpenClip(
            openclip.OpenClipTowerConfig(width=64, layers=1, heads=1, patch_size=8,
                                         image_size=16, output_dim=16),
            openclip.OpenClipTowerConfig(width=64, layers=1, heads=1, context_length=8,
                                         output_dim=16), 516), "cpu"), gen)
        save_safetensors(openclip.openclip_state_dict(clip), folder + "/hps.safetensors")
        hps = qm.load_preference_model("HPSv2", device="cpu", path={{
            "hpsv2": folder + "/hps.safetensors", "open_clip_bpe": folder + "/bpe.txt.gz"}})
        s = hps.score([img, img], "a cup")
        assert np.isfinite(s).all() and abs(s[1] - hps.score(img, "a cup")) < 1e-5, s
        cfg = QwenVLTextConfig(num_layers=1, hidden_size=32, num_heads=2, num_kv_heads=1,
                               head_dim=16, intermediate_size=48, vocab_size=151700,
                               mrope_section=(2, 3, 3), rope_theta=1e4)
        model = nexus_gen.init_nexus_gen_(materialize(nexus_gen.NexusGen(cfg), "cpu"), gen)
        ids = np.asarray([[5, 151652] + [151655] * 81 + [151653, 9]])
        out = nexus_gen.target_embeddings(model, ids, np.zeros((0,), np.float32), [(1, 18, 18)])
        assert out.shape == (81, 32) and torch.isfinite(out).all()
        assert "jax" not in sys.modules, "the port imported jax"
        assert "physicedit_tpu" not in sys.modules, "the port imported the JAX package"
        print("NO_JAX_OK")
    """)
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout

"""The quality scorers of the port (``models/openclip.py``, ``models/blip.py``,
``extensions/quality_metric.py``) against the JAX package, fp32 on the CPU,
on the JAX tests' tiny open_clip / ImageReward key spaces (built from HF
``transformers`` models) and the same seed-made inputs."""

import gzip
import os

import numpy as np
import pytest
import torch
from PIL import Image
from safetensors.numpy import save_file

from physicedit_tpu.extensions import quality_metric as jqm
from physicedit_tpu.models import blip as jblip
from physicedit_tpu.models import openclip as jclip
from physicedit_torch.extensions import quality_metric as tqm
from physicedit_torch.io.from_jax import imagereward_from_jax, openclip_from_jax
from physicedit_torch.models import blip as tblip
from physicedit_torch.models import openclip as tclip
from tests.test_quality_metric import (_FixedTokenizer, _np, _openclip_sd_from_hf,
                                       _tiny_blip_text, _tiny_blip_vision, _tiny_hf_clip,
                                       _vit_sd_from_hf)

torch.set_num_threads(2)

TOL = 1e-4          # the repo's fp32 tolerance


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


def _image(seed, w, h):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


# ---------------------------------------------------------------------------
# OpenCLIP
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def clip_sd():
    return _openclip_sd_from_hf(_tiny_hf_clip())


@pytest.fixture(scope="module")
def clip_pair(clip_sd):
    jparams, jv, jt = jclip.openclip_from_state_dict(clip_sd, text_heads=2)
    model, tv, tt = tclip.openclip_from_state_dict(clip_sd, text_heads=2, device="cpu")
    return (jparams, jv, jt), (model, tv, tt)


def _clip_inputs():
    rng = np.random.default_rng(3)
    pixels = rng.normal(size=(2, 24, 24, 3)).astype(np.float32)
    ids = rng.integers(1, 60, (2, 12)).astype(np.int32)
    ids[0, 7] = 63          # EOT, the largest id, once per row
    ids[0, 8:] = 0
    ids[1, 11] = 63
    return pixels, ids


def test_openclip_config_matches_jax(clip_pair):
    (_, jv, jt), (_, tv, tt) = clip_pair
    for j, t in ((jv, tv), (jt, tt)):
        for field in ("width", "layers", "heads", "patch_size", "context_length",
                      "quick_gelu", "eps"):
            assert getattr(t, field) == getattr(j, field), field
    assert (tv.image_size, tv.mlp_ratio, tv.output_dim, tt.output_dim) == (24, 2, 32, 32)


@pytest.mark.parametrize("carry", ["state_dict", "from_jax"])
def test_openclip_features_match_jax(clip_pair, carry):
    """clip_image_features / clip_text_features / clip_similarity, with the
    port loaded from the open_clip file and carried from JAX's tree."""
    (jparams, jv, jt), (model, _, _) = clip_pair
    if carry == "from_jax":
        model = openclip_from_jax(jparams, jv, jt, device="cpu")
    pixels, ids = _clip_inputs()
    px, it = torch.from_numpy(pixels), torch.from_numpy(ids)
    _close(tclip.clip_image_features(model.visual, px),
           jclip.clip_image_features(jparams["visual"], jv, pixels))
    _close(tclip.clip_text_features(model.text, it),
           jclip.clip_text_features(jparams["text"], jt, ids))
    _close(tclip.clip_similarity(model, px, it),
           jclip.clip_similarity(jparams, jv, jt, pixels, ids))


def test_openclip_pools_at_the_argmax_id(clip_pair):
    """The text feature is read at the largest id; what follows it in its
    row (causal attention) changes nothing."""
    _, (model, _, _) = clip_pair
    _, ids = _clip_inputs()
    other = ids.copy()
    other[0, 8:] = 5
    a = tclip.clip_text_features(model.text, torch.from_numpy(ids))
    b = tclip.clip_text_features(model.text, torch.from_numpy(other))
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())


def test_openclip_state_dict_round_trips(clip_sd, clip_pair):
    _, (model, _, _) = clip_pair
    sd = tclip.openclip_state_dict(model)
    assert set(sd) == set(clip_sd) - {"logit_scale"}
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), clip_sd[k], err_msg=k)


@pytest.mark.parametrize("size", [(40, 28), (224, 300), (31, 31), (500, 120)])
def test_preprocess_clip_is_exact(size):
    img = _image(sum(size), *size)
    for n in (24, 224):
        np.testing.assert_array_equal(tclip.preprocess_clip(img, n), jclip.preprocess_clip(img, n))


# ---------------------------------------------------------------------------
# BLIP / ImageReward
# ---------------------------------------------------------------------------

def test_blip_vit_matches_jax():
    sd = _vit_sd_from_hf(_tiny_blip_vision())
    jparams, jcfg = jblip.blip_vit_from_torch(sd)
    vit, cfg = tblip.blip_vit_from_torch(sd, device="cpu")
    assert cfg == tblip.BlipViTConfig(**vars(jcfg))
    pixels = np.random.default_rng(0).normal(size=(2, 24, 24, 3)).astype(np.float32)
    _close(tblip.blip_vit_forward(vit, torch.from_numpy(pixels)),
           jblip.blip_vit_forward(jparams, jcfg, pixels))


@pytest.mark.parametrize("encoder_mask", [False, True])
def test_blip_text_matches_jax(encoder_mask):
    """The med-BERT encoder with a padded row (the -10000 mask bias), and
    with a masked image token."""
    sd = {k: _np(v) for k, v in _tiny_blip_text().state_dict().items()}
    jparams, jcfg = jblip.blip_text_from_torch(sd, num_heads=2)
    text, cfg = tblip.blip_text_from_torch(sd, num_heads=2, device="cpu")
    assert cfg == tblip.BlipTextConfig(**vars(jcfg))
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 60, (2, 9)).astype(np.int32)
    mask = np.ones((2, 9), np.int32)
    mask[1, 6:] = 0
    enc = (rng.normal(size=(2, 10, 128)) * 0.5).astype(np.float32)
    enc_mask = None
    if encoder_mask:
        enc_mask = np.ones((2, 10), np.int32)
        enc_mask[0, 7:] = 0
    want = jblip.blip_text_forward(jparams, jcfg, ids, mask, enc, enc_mask)
    got = tblip.blip_text_forward(text, torch.from_numpy(ids), torch.from_numpy(mask),
                                  torch.from_numpy(enc),
                                  None if enc_mask is None else torch.from_numpy(enc_mask))
    _close(got, want)


def test_blip_mask_is_minus_10000_not_inf():
    bias = tblip._mask_bias(torch.tensor([[1, 0]]), torch.float32)
    assert bias.tolist() == [[[[0.0, -10000.0]]]]


@pytest.fixture(scope="module")
def ir_ckpt(tmp_path_factory):
    """The JAX test's synthetic ImageReward.safetensors (hidden 128)."""
    sd = _vit_sd_from_hf(_tiny_blip_vision(), prefix="blip.visual_encoder.")
    sd.update({"blip.text_encoder." + k: _np(v)
               for k, v in _tiny_blip_text(encoder_width=128, hidden=128).state_dict().items()})
    rng = np.random.default_rng(7)
    for idx, (d_in, d_out) in zip((0, 2, 4, 6, 7), [(128, 32), (32, 16), (16, 8), (8, 4),
                                                     (4, 1)]):
        sd[f"mlp.layers.{idx}.weight"] = rng.normal(size=(d_out, d_in)).astype(np.float32) * 0.1
        sd[f"mlp.layers.{idx}.bias"] = rng.normal(size=(d_out,)).astype(np.float32) * 0.1
    path = str(tmp_path_factory.mktemp("ir") / "ImageReward.safetensors")
    save_file(sd, path)
    return path, sd


@pytest.mark.parametrize("carry", ["state_dict", "from_jax"])
def test_imagereward_score_matches_jax(ir_ckpt, carry):
    _, sd = ir_ckpt
    jparams, jv, jt = jblip.imagereward_from_state_dict(sd)
    if carry == "from_jax":
        model = imagereward_from_jax(jparams, jv, jt, device="cpu")
    else:
        model, _, _ = tblip.imagereward_from_state_dict(sd, device="cpu")
    rng = np.random.default_rng(2)
    pixels = rng.normal(size=(2, 24, 24, 3)).astype(np.float32)
    ids = rng.integers(0, 60, (2, 35)).astype(np.int32)
    mask = np.ones((2, 35), np.int32)
    mask[0, 9:] = 0
    want = jblip.imagereward_score(jparams, jv, jt, pixels, ids, mask)
    got = tblip.imagereward_score(model, *(torch.from_numpy(a) for a in (pixels, ids, mask)))
    _close(got, want)


def test_imagereward_state_dict_round_trips(ir_ckpt):
    _, sd = ir_ckpt
    model, _, _ = tblip.imagereward_from_state_dict(sd, device="cpu")
    out = tblip.imagereward_state_dict(model)
    assert set(out) == set(sd)
    for k, v in out.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


@pytest.mark.parametrize("size", [(30, 40), (224, 224), (301, 97)])
def test_preprocess_blip_is_exact(size):
    img = _image(sum(size) + 1, *size)
    for n in (24, 224):
        np.testing.assert_array_equal(tblip.preprocess_blip(img, n), jblip.preprocess_blip(img, n))


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

def test_registry_names_and_paths_match_jax():
    assert tqm.model_dict == jqm.model_dict and tqm.MODEL_ID == jqm.MODEL_ID
    for name in tqm.model_dict:
        assert (tqm.download_preference_model(name, cache_dir="/tmp/qm")
                == jqm.download_preference_model(name, cache_dir="/tmp/qm"))


GATED = {  # name: (model name, path dict or None, message fragment)
    "clip_dir": ("CLIP", {"clip": "/nonexistent/clip"}, "CLIP checkpoint directory"),
    "pickscore_dir": ("PickScore", {"pickscore": "/nonexistent/p", "clip": "/nonexistent/c"},
                      "CLIP checkpoint directory"),
    "aesthetic_dir": ("Aesthetic", {"clip-large": "/nonexistent/l",
                                    "aesthetic_predictor": "/nonexistent/a"},
                      "CLIP checkpoint directory"),
    "imagereward_default": ("ImageReward", None, "ImageReward checkpoint"),
    "imagereward_bert": ("ImageReward", "IR", "bert tokenizer"),
    "hps_default": ("HPSv2", None, "HPS checkpoint"),
    "hps21_default": ("HPSv2.1", None, "HPS checkpoint"),
    "hps_bpe": ("HPSv2", "HPS", "CLIP BPE merges file"),
    "mps": ("MPS", None, "MPS cross-attention head"),
}


@pytest.mark.parametrize("case", sorted(GATED))
def test_gated_errors_match_jax(case, ir_ckpt, clip_sd, tmp_path):
    name, path, fragment = GATED[case]
    if path == "IR":
        path = {"imagereward": ir_ckpt[0], "bert_model_path": None}
    elif path == "HPS":
        hps = str(tmp_path / "HPS_v2_compressed.safetensors")
        save_file(clip_sd, hps)
        path = {"hpsv2": hps, "open_clip_bpe": str(tmp_path / "missing.txt.gz")}
    with pytest.raises(jqm.GatedMetricError) as want:
        jqm.load_preference_model(name, path=path)
    with pytest.raises(tqm.GatedMetricError) as got:
        tqm.load_preference_model(name, device="cpu", path=path)
    assert fragment in str(got.value)
    assert str(got.value) == str(want.value)


def test_imagereward_scorer_matches_jax(ir_ckpt):
    path, _ = ir_ckpt
    tok = _FixedTokenizer()
    jscorer = jqm.ImageRewardScore(path, tokenizer=tok)
    tscorer = tqm.ImageRewardScore(path, tokenizer=tok, device="cpu")
    imgs = [_image(5, 30, 40), _image(6, 64, 48)]
    prompt = "a glass tips over"
    want = jscorer.score(imgs, prompt)
    got = tscorer.score(imgs, prompt)
    _close(got, want)
    single = tscorer.score(imgs[0], prompt)
    assert isinstance(single, float)
    assert single == pytest.approx(got[0], abs=1e-5)
    assert single == pytest.approx(jscorer.score(imgs[0], prompt), rel=TOL, abs=TOL)


def _bpe_file(folder, merges):
    path = os.path.join(folder, "bpe_simple_vocab_16e6.txt.gz")
    with gzip.open(path, "wt") as f:
        f.write("#version: tiny\n" + "\n".join(merges) + "\n")
    return path


def test_hps_scorer_matches_jax(clip_sd, tmp_path):
    """The JAX test's HPS lane, an injected tokenizer and tiny towers."""
    ckpt = str(tmp_path / "HPS_v2_compressed.safetensors")
    save_file(clip_sd, ckpt)

    class Tok:
        def tokenize(self, texts, context_length=77):
            out = np.zeros((len(texts), 16), np.int32)
            for i, t in enumerate(texts):
                ids = [62] + [1 + (sum(map(ord, w)) % 58) for w in t.split()][:13] + [63]
                out[i, :len(ids)] = ids
            return out

    kw = dict(tokenizer=Tok(), vision_heads=2, text_heads=2)
    jscorer = jqm.HPScoreV2(ckpt, **kw)
    tscorer = tqm.HPScoreV2(ckpt, device="cpu", **kw)
    imgs = [_image(7, 40, 28), _image(8, 28, 60)]
    got = tscorer.score(imgs, "a falling cup")
    _close(got, jscorer.score(imgs, "a falling cup"))
    assert tscorer.score(imgs[0], "a falling cup") == pytest.approx(got[0], abs=1e-5)


def test_hps_registry_route_with_the_ports_bpe(tmp_path):
    """``load_preference_model("HPSv2", path=...)`` on a written open_clip
    file and a gzip'd merge list: the registry's head counts (width // 64)
    and the port's own BPE tokenizer, against JAX's route."""
    from physicedit_torch.extensions.clip_bpe import ClipBpeTokenizer

    merges = ["i n", "t h", "th e</w>", "a n", "c u", "cu p</w>", "f a", "fa l", "fal l"]
    bpe = _bpe_file(str(tmp_path), merges)
    n_vocab = len(ClipBpeTokenizer(bpe).encoder)
    vcfg = tclip.OpenClipTowerConfig(width=128, layers=2, heads=2, patch_size=8, image_size=24,
                                     mlp_ratio=2, output_dim=32)
    tcfg = tclip.OpenClipTowerConfig(width=64, layers=2, heads=1, context_length=16,
                                     mlp_ratio=2, output_dim=32)
    from physicedit_torch.core.params import materialize

    model = tclip.init_openclip_(materialize(tclip.OpenClip(vcfg, tcfg, n_vocab), "cpu"),
                                 torch.Generator().manual_seed(3))
    ckpt = str(tmp_path / "HPS_v2_compressed.safetensors")
    save_file({k: v.numpy() for k, v in tclip.openclip_state_dict(model).items()}, ckpt)
    path = {"hpsv2": ckpt, "open_clip_bpe": bpe}
    jscorer = jqm.load_preference_model("HPSv2", path=path)
    tscorer = tqm.load_preference_model("HPSv2", device="cpu", path=path)
    imgs = [_image(9, 50, 30), _image(10, 24, 24)]
    prompt = "The cup falls in the sink"
    np.testing.assert_array_equal(tscorer.tokenizer.tokenize([prompt], 16),
                                  jscorer.tokenizer.tokenize([prompt], 16))
    got = tscorer.score(imgs, prompt)
    _close(got, jscorer.score(imgs, prompt))
    assert tscorer.score(imgs[1], prompt) == pytest.approx(got[1], abs=1e-5)


@pytest.mark.parametrize("kind", ["PSNR", "SSIM", "LPIPS"])
def test_reference_free_scores_match_jax(kind):
    rng = np.random.default_rng(0)
    a = rng.random((32, 32, 3)).astype(np.float32)
    noisy = np.clip(a + rng.normal(size=a.shape).astype(np.float32) * 0.05, 0, 1)
    u8 = (noisy * 255).astype(np.uint8)
    for images, ref in ((a, a), ([a, noisy], a), ([u8, noisy], [a, a])):
        got = tqm.load_preference_model(kind).score(images, ref)
        want = jqm.load_preference_model(kind).score(images, ref)
        if want is None or (isinstance(want, list) and None in want):
            assert got == want
        else:
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# The transformers CLIP lane (already torch in both packages)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hf_clip_folder(tmp_path_factory):
    """A tiny HF CLIP folder (model, tokenizer files, image processor),
    written offline."""
    import json

    transformers = pytest.importorskip("transformers")
    from physicedit_torch.extensions.clip_bpe import ClipBpeTokenizer

    folder = tmp_path_factory.mktemp("hf_clip")
    merges = ["i n", "t h", "th e</w>", "a n", "c u", "cu p</w>"]
    bpe = _bpe_file(str(folder), merges)
    tok = ClipBpeTokenizer(bpe)
    with open(folder / "vocab.json", "w") as f:
        json.dump(tok.encoder, f)
    with open(folder / "merges.txt", "w") as f:
        f.write("#version: tiny\n" + "\n".join(merges) + "\n")
    n_vocab = len(tok.encoder)
    torch.manual_seed(0)
    cfg = transformers.CLIPConfig(
        text_config=dict(vocab_size=n_vocab, hidden_size=64, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=2,
                         max_position_embeddings=32, eos_token_id=tok.eot,
                         bos_token_id=tok.sot, pad_token_id=tok.eot, projection_dim=32),
        vision_config=dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                           num_attention_heads=2, image_size=32, patch_size=8,
                           projection_dim=32),
        projection_dim=32)
    transformers.CLIPModel(cfg).eval().save_pretrained(str(folder))
    hf_tok = transformers.CLIPTokenizer(str(folder / "vocab.json"), str(folder / "merges.txt"))
    image_proc = transformers.CLIPImageProcessor(size={"shortest_edge": 32},
                                                 crop_size={"height": 32, "width": 32})
    transformers.CLIPProcessor(image_processor=image_proc,
                               tokenizer=hf_tok).save_pretrained(str(folder))
    return str(folder)


def test_clip_score_matches_jax(hf_clip_folder):
    jscorer = jqm.load_preference_model("CLIP", path={"clip": hf_clip_folder})
    tscorer = tqm.load_preference_model("CLIP", device="cpu", path={"clip": hf_clip_folder})
    imgs = [_image(11, 40, 40), _image(12, 64, 32)]
    got = tscorer.score(imgs, "the cup in the sink")
    _close(got, jscorer.score(imgs, "the cup in the sink"))
    assert tscorer.score(imgs[0], "the cup") == pytest.approx(
        jscorer.score(imgs[0], "the cup"), rel=TOL, abs=TOL)


def test_aesthetic_score_matches_jax(hf_clip_folder, tmp_path):
    rng = np.random.default_rng(13)
    head = {}
    for idx, (d_in, d_out) in zip((0, 2, 4, 6, 7), [(32, 16), (16, 8), (8, 8), (8, 4), (4, 1)]):
        head[f"layers.{idx}.weight"] = rng.normal(size=(d_out, d_in)).astype(np.float32) * 0.3
        head[f"layers.{idx}.bias"] = rng.normal(size=(d_out,)).astype(np.float32) * 0.1
    head_path = str(tmp_path / "aesthetic.safetensors")
    save_file(head, head_path)
    path = {"clip-large": hf_clip_folder, "aesthetic_predictor": head_path}
    jscorer = jqm.load_preference_model("Aesthetic", path=path)
    tscorer = tqm.load_preference_model("Aesthetic", device="cpu", path=path)
    imgs = [_image(14, 40, 40), _image(15, 33, 70)]
    _close(tscorer.score(imgs), jscorer.score(imgs))

"""The port's checkpoint loader against the JAX package, on the CPU: the
safetensors reader and writer, key hashing and model detection, the
reference-layout tree that ``tools/make_synthetic_checkpoint`` writes through
the inverse key maps (JAX's own converters must give back the original JAX
trees from it bit for bit), ``from_pretrained`` (fp32 and bf16, a finetuned
export, int4, presets and its errors), ``load_lora``, and the published key
hashes of the full configs."""

import json
import os
import shutil

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from physicedit_tpu import lora as j_lora
from physicedit_tpu.io import convert as JC
from physicedit_tpu.io import safetensors_io as jst
from physicedit_tpu.io.model_config import qwen_image_preset as j_preset
from physicedit_tpu.models import dinov2 as j_dino
from physicedit_tpu.pipeline.edit_pipeline import (IMAGE_PAD_ID, VISION_START_ID,
                                                   PhysicEditPipeline as JPipe,
                                                   _remap_text_encoder_keys)
from physicedit_tpu.pipeline.testing import FakeTokenizer as JFakeTokenizer
from physicedit_torch.cli.validate import find_model_files
from physicedit_torch.io import convert as TC
from physicedit_torch.io import safetensors_io as tst
from physicedit_torch.io.from_jax import (dinov2_from_jax, pipeline_from_jax, to_jax_tree,
                                          trainable_from_jax)
from physicedit_torch.io.model_config import qwen_image_preset as t_preset
from physicedit_torch.pipeline.edit_pipeline import PhysicEditPipeline as TPipe
from physicedit_torch.pipeline.testing import SIZES, FakeTokenizer
from physicedit_torch.tools import make_synthetic_checkpoint as synth
from tests.test_torch_quant import W4_DIT, _jax_pipeline
from tests.test_torch_train import _jax_dinov2_params, _jax_trainable

torch.set_num_threads(2)

DINO = j_dino.DinoV2Config(hidden_size=48, num_layers=2, num_heads=3)
ADAPTER_GROUPS = {"visual_thinking_adapter", "dino_resampler", "dino_resampler_adapter",
                  "dino_time_embed", "vae_resampler", "vae_resampler_adapter",
                  "vae_time_embed"}


def _assert_tree_equal(got, want, path="root"):
    """Two trees of dicts / lists of arrays, equal bit for bit."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, sorted(got),
                                                                 sorted(want))
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{path}[{i}]")
    else:
        g, w = np.ascontiguousarray(got), np.ascontiguousarray(want)
        assert g.shape == w.shape and g.dtype == w.dtype, (path, g.shape, w.shape, g.dtype,
                                                           w.dtype)
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), path


def _assert_modules_equal(got: torch.nn.Module, want: torch.nn.Module, name: str):
    g, w = got.state_dict(), want.state_dict()
    assert set(g) == set(w), (name, sorted(set(g) ^ set(w))[:5])
    for k in w:
        assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), f"{name}.{k}"


def fake_tokenizer(pipe):
    """What the tests put in place of ``load_tokenizer`` (no tokenizer files)."""
    pipe.tokenizer = FakeTokenizer() if isinstance(pipe, TPipe) else JFakeTokenizer()
    pipe.boi_token_id, pipe.eoi_token_id = 96, 95
    pipe.edit_drop_idx = pipe.t2i_drop_idx = 2


def build_tree(base: str) -> dict:
    """A small head_dim-128 JAX pipeline (the W4 tests' one) with a DINOv2
    and a rank-4 trainable, carried into the port; the port writes its tree.
    Returns the JAX originals and the paths."""
    jpipe = _jax_pipeline()
    dino = _jax_dinov2_params(DINO, 16, 5)
    trainable = _jax_trainable(W4_DIT, DINO.hidden_size, seed=3, rank=4)
    tpipe = pipeline_from_jax(jpipe, device="cpu")
    tpipe.dinov2 = dinov2_from_jax(dino, DINO, device="cpu")
    info = synth.write_tree(tpipe, base, trainable_from_jax(trainable, W4_DIT, device="cpu"))
    return {"jpipe": jpipe, "dino": dino, "trainable": trainable, "base": base,
            "finetuned": info["paths"]["finetuned"],
            "paths": find_model_files(base)}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return build_tree(str(tmp_path_factory.mktemp("synth")))


# ---------------------------------------------------------------------------
# safetensors, hashes, detection
# ---------------------------------------------------------------------------

def _mixed_tensors():
    g = torch.Generator().manual_seed(0)
    return {"bf16": torch.randn(3, 5, generator=g).bfloat16(),
            "f16": torch.randn(7, generator=g).half(),
            "f32": torch.randn(2, 3, 4, generator=g),
            "i8": torch.randint(-128, 127, (9,), dtype=torch.int8, generator=g),
            "u8": torch.randint(0, 255, (4, 4), dtype=torch.uint8, generator=g),
            "i32": torch.randint(-9, 9, (6,), dtype=torch.int32, generator=g),
            "i64": torch.randint(-9, 9, (2, 2), dtype=torch.int64, generator=g),
            "bool": torch.rand(5, generator=g) > 0.5,
            "empty": torch.zeros(0, 3)}


def test_safetensors_reader_matches_the_package_and_jax(tmp_path):
    from safetensors.torch import load_file, save_file

    sd = _mixed_tensors()
    ours, theirs = str(tmp_path / "ours.safetensors"), str(tmp_path / "theirs.safetensors")
    save_file(sd, theirs, metadata={"format": "pt"})
    assert tst.save_safetensors(sd, ours) == sum(t.numel() * t.element_size()
                                                 for t in sd.values())
    for path in (ours, theirs):
        got, pkg = tst.load_state_dict(path), load_file(path)
        jx = jst.load_state_dict(path)
        assert set(got) == set(pkg) == set(jx) == set(sd)
        for k, t in sd.items():
            assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
            assert torch.equal(pkg[k], t), k
            want = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            assert np.array_equal(np.asarray(jx[k]).view(want.numpy().dtype), want.numpy()), k


def test_load_state_dict_takes_shards_lists_and_folders(tree):
    folder = os.path.join(tree["base"], "transformer")
    shards = sorted(os.path.join(folder, f) for f in os.listdir(folder)
                    if f.endswith(".safetensors"))
    assert len(shards) == 2
    whole = tst.load_state_dict(folder)
    assert set(tst.load_state_dict(shards)) == set(whole)
    with open(os.path.join(folder, "diffusion_pytorch_model.safetensors.index.json")) as f:
        assert set(json.load(f)["weight_map"]) == set(whole)


def _family_key_sets():
    """Small key/shape sets of every family the detectors know."""
    z = np.zeros
    return {
        "dit": {"transformer_blocks.0.attn.add_q_proj.weight": z((4, 4)), "img_in.weight": z(2)},
        "vae": {"encoder.down_blocks.0.conv1.weight": z(3), "quant_conv.weight": z(2)},
        "text": {"visual.blocks.0.attn.qkv.weight": z(2), "model.norm.weight": z(2)},
        "text_remapped": {"model.language_model.layers.0.mlp.up_proj.weight": z(2)},
        "controlnet": {"controlnet_blocks.0.weight": z((3, 3))},
        "esrgan": {"body.0.rdb1.conv1.weight": z(2)},
        "rife": {"module.block0.convblock.0.weight": z(2)},
        "unknown": {"foo.bar": z(2)},
    }


@pytest.mark.parametrize("family", list(_family_key_sets()))
def test_hash_and_detection_match_jax(family):
    sd = _family_key_sets()[family]
    assert tst.state_dict_keys_str(sd) == jst.state_dict_keys_str(sd)
    assert tst.hash_state_dict_keys(sd) == jst.hash_state_dict_keys(sd)
    assert tst.hash_state_dict_keys(sd, False) == jst.hash_state_dict_keys(sd, False)
    assert tst.detect_model_name(sd) == jst.detect_model_name(sd)
    assert tst.KNOWN_HASHES == jst.KNOWN_HASHES
    assert set(tst.EXTENSION_LOADERS) == set(jst.EXTENSION_LOADERS)


def _tiny_nexus_gen_file(path):
    """A tiny Nexus-Gen checkpoint in the raw key layout (``model.*``,
    ``visual.*``, ``lm_head``, ``vision_head``, ``image_prefill_embeds``),
    written by the port; returns the configs it needs."""
    from physicedit_torch.core.params import init_random_, materialize
    from physicedit_torch.models import nexus_gen as NG
    from physicedit_torch.models.qwen_vl import TINY_TEXT
    from physicedit_torch.models.qwen_vl_vision import TINY_VISION, QwenVLVision

    gen = torch.Generator().manual_seed(3)
    model = NG.init_nexus_gen_(materialize(NG.NexusGen(TINY_TEXT), "cpu"), gen)
    vision = init_random_(materialize(QwenVLVision(TINY_VISION), "cpu"), gen)
    sd = NG.nexus_gen_state_dict(model, vision)
    tst.save_safetensors(sd, path)
    return sd, {"text_cfg": TINY_TEXT, "vision_cfg": TINY_VISION}


@pytest.mark.parametrize("name", ["rife", "esrgan", "nexus_gen_llm"])
def test_extension_loaders_are_the_ports(name, tmp_path):
    """EXTENSION_LOADERS names the port's loaders: each resolves by import to
    a callable of physicedit_torch that loads a reference-layout file.  The
    RIFE and ESRGAN files are ones detect_model_name names ``name``.  A tiny
    Nexus-Gen file it cannot name: the hash of ``nexus_gen_llm`` matches only
    the published key shapes, and the ``visual.blocks.`` heuristic names such
    a file ``qwen_image_text_encoder``; so the loader is called on it
    directly, as the JAX package's test calls its converter."""
    import importlib

    from tests.test_torch_extensions import esrgan_state_dict, ifnet_state_dict

    target = tst.EXTENSION_LOADERS[name]
    assert target.startswith("physicedit_torch.")
    module, attr = target.rsplit(".", 1)
    loader = getattr(importlib.import_module(module), attr)
    assert callable(loader)
    path = str(tmp_path / f"{name}.safetensors")
    if name == "nexus_gen_llm":
        sd, cfgs = _tiny_nexus_gen_file(path)
        assert tst.detect_model_name(tst.load_state_dict(path)) == "qwen_image_text_encoder"
        nexus, vision = loader(path, dtype=torch.float32, device="cpu", **cfgs)
        assert sum(p.numel() for m in (nexus, vision) for p in m.parameters()) == sum(
            v.numel() for v in sd.values())
        assert torch.equal(nexus.vision_head.weight, sd["vision_head.weight"])
        return
    sd = ifnet_state_dict(c=16) if name == "rife" else esrgan_state_dict()
    tst.save_safetensors(sd, path)
    assert tst.detect_model_name(tst.load_state_dict(path)) == name
    net = loader(path, device="cpu")
    assert isinstance(net, torch.nn.Module)
    assert sum(p.numel() for p in net.parameters()) == sum(
        v.size for k, v in sd.items() if "block_tea" not in k)


def test_tree_families_are_detected(tree):
    for path, name in zip(tree["paths"], ("qwen_image_dit", "qwen_image_text_encoder",
                                          "qwen_image_vae")):
        sd = tst.load_state_dict(path)
        assert tst.detect_model_name(sd) == jst.detect_model_name(jst.load_state_dict(path)) \
            == name


# ---------------------------------------------------------------------------
# The tree the port writes is the layout JAX's converters read
# ---------------------------------------------------------------------------

def test_jax_converters_give_back_the_jax_trees(tree):
    """JAX's converters, reading the tree the port wrote through the inverse
    key maps, give back the original JAX trees bit for bit."""
    jp, base = tree["jpipe"], tree["base"]
    dit_sd = jst.load_state_dict(os.path.join(base, "transformer"))
    _assert_tree_equal(JC.dit_from_torch(dit_sd, dtype=jnp.float32), jp.dit_params)
    vae_sd = jst.load_state_dict(os.path.join(base, "vae"))
    _assert_tree_equal(JC.vae_from_torch(vae_sd, dtype=jnp.float32), jp.vae_params)
    text_sd = _remap_text_encoder_keys(jst.load_state_dict(os.path.join(base, "text_encoder")))
    _assert_tree_equal(JC.qwen_vl_text_from_torch(text_sd, dtype=jnp.float32), jp.text_params)
    _assert_tree_equal(JC.qwen_vl_vision_from_torch(text_sd, dtype=jnp.float32),
                       jp.vision_params)
    dino_sd = jst.load_state_dict(os.path.join(base, "dinov2", "model.safetensors"))
    _assert_tree_equal(JC.dinov2_from_torch(dino_sd), tree["dino"])
    ft = {k: np.asarray(v, np.float32) for k, v in
          jst.load_state_dict(tree["finetuned"]).items()}
    lora_sd, pipe_sd = j_lora.split_finetuned_checkpoint(ft)
    _assert_tree_equal(JC.physic_adapters_from_state_dict(pipe_sd), tree["trainable"]["adapters"])
    _assert_tree_equal(j_lora.import_dit_lora(lora_sd, W4_DIT), tree["trainable"]["lora"])
    # the configs beside the tensors
    with open(os.path.join(base, "text_encoder", "config.json")) as f:
        hf = json.load(f)
    assert JC.text_config_from_hf(hf) == jp.text_cfg.__class__(**{
        **vars(jp.text_cfg), "image_token_id": 99, "vision_start_token_id": 98})
    assert JC.vision_config_from_hf(hf) == jp.vision_cfg
    with open(os.path.join(base, "dinov2", "config.json")) as f:
        assert JC.dinov2_config_from_hf(json.load(f)) == DINO


def test_port_key_maps_read_back_what_they_wrote(tree):
    """The forward maps of the port read the tree into modules equal to the
    ones it was written from (the configs inferred from shapes and JSON)."""
    base = tree["base"]
    want = pipeline_from_jax(tree["jpipe"], device="cpu")
    dit = TC.dit_from_state_dict(tst.load_state_dict(os.path.join(base, "transformer")),
                                 torch.float32, "cpu")
    _assert_modules_equal(dit, want.dit, "dit")
    vae = TC.vae_from_state_dict(tst.load_state_dict(os.path.join(base, "vae")),
                                 torch.float32, "cpu")
    _assert_modules_equal(vae, want.vae, "vae")
    with open(os.path.join(base, "dinov2", "config.json")) as f:
        dino = TC.dinov2_from_state_dict(
            tst.load_state_dict(os.path.join(base, "dinov2")), json.load(f), device="cpu")
    _assert_modules_equal(dino, dinov2_from_jax(tree["dino"], DINO, device="cpu"), "dinov2")


# ---------------------------------------------------------------------------
# from_pretrained against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_pretrained_matches_jax_bitwise(tree, dtype):
    jp = JPipe.from_pretrained(tree["paths"], dtype=getattr(jnp, dtype))
    tp = TPipe.from_pretrained(tree["paths"], dtype=getattr(torch, dtype), device="cpu")
    want = pipeline_from_jax(jp, device="cpu")
    for name in ("dit", "vae", "text", "vision"):
        _assert_modules_equal(getattr(tp, name), getattr(want, name), name)
    assert (tp.image_pad_id, tp.vision_start_id) == (jp.image_pad_id, jp.vision_start_id) \
        == (99, 98)
    assert tp.text.cfg.num_layers == jp.text_cfg.num_layers == 2
    assert tp.attn_clamp == jp.attn_clamp
    assert tp.adapter is None and tp.attn_impl == "dense"     # no CUDA here


def test_text_encoder_config_is_read_inside_its_folder(tree):
    """J5: a text-encoder folder path (no trailing slash) whose config.json
    sets image_token_id / vision_start_token_id away from the 7B defaults.
    The port reads the ids from inside the folder; the JAX package looks for
    config.json in the folder's parent (its edit_pipeline.py:193-195), finds
    none there and keeps its defaults."""
    folder = os.path.join(tree["base"], "text_encoder")
    with open(os.path.join(folder, "config.json")) as f:
        hf = json.load(f)
    assert (hf["image_token_id"], hf["vision_start_token_id"]) == (99, 98)
    assert (99, 98) != (IMAGE_PAD_ID, VISION_START_ID)
    assert not os.path.exists(os.path.join(tree["base"], "config.json"))

    def in_folder(p):
        return os.path.dirname(p[0] if isinstance(p, (list, tuple)) else p) == folder

    paths = [p for p in tree["paths"] if not in_folder(p)] + [folder]
    assert len(paths) == len(tree["paths"]) and not folder.endswith(os.sep)
    tp = TPipe.from_pretrained(paths, dtype=torch.float32, device="cpu")
    jp = JPipe.from_pretrained(paths, dtype=jnp.float32)
    assert (tp.image_pad_id, tp.vision_start_id) == (99, 98)
    assert tp.text.cfg.num_layers == 2
    assert (jp.image_pad_id, jp.vision_start_id) == (IMAGE_PAD_ID, VISION_START_ID)


def test_from_pretrained_finetuned_matches_jax(tree):
    """A finetuned export written by ``save_checkpoint``: the merged DiT
    within fp32 rounding of JAX's merge, every adapter group bit for bit."""
    jp = JPipe.from_pretrained(tree["paths"], dtype=jnp.float32,
                               finetuned_path=tree["finetuned"])
    tp = TPipe.from_pretrained(tree["paths"], dtype=torch.float32, device="cpu",
                               finetuned_path=tree["finetuned"])
    want = pipeline_from_jax(jp, device="cpu")
    g, w = tp.dit.state_dict(), want.dit.state_dict()
    base = TPipe.from_pretrained(tree["paths"][:1], dtype=torch.float32, device="cpu")
    moved = 0
    for k in w:
        np.testing.assert_allclose(g[k].numpy(), w[k].numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
        moved += not torch.equal(g[k], base.dit.state_dict()[k])
    assert moved == 2 * 8       # the weights of 2 blocks x 8 adapted linears
    assert set(tp.adapters) == set(jp.adapters) == ADAPTER_GROUPS
    for name in ADAPTER_GROUPS:
        got = tp.adapters[name]
        got = got.numpy() if isinstance(got, torch.Tensor) else to_jax_tree(got)
        _assert_tree_equal(got, jax.tree_util.tree_map(np.asarray, jp.adapters[name]))
    assert tp.adapter is tp.adapters["visual_thinking_adapter"]


def test_from_pretrained_int4_is_quantize_int4(tree):
    """``quantize="int4"`` packs as ``quantize_("int4")`` of the loaded
    pipeline, and as the JAX package's own int4 load carried across."""
    tp = TPipe.from_pretrained(tree["paths"], dtype=torch.float32, device="cpu",
                               quantize="int4")
    ref = TPipe.from_pretrained(tree["paths"], dtype=torch.float32,
                                device="cpu").quantize_("int4")
    jq = pipeline_from_jax(JPipe.from_pretrained(tree["paths"], dtype=jnp.float32,
                                                 quantize="int4"), device="cpu")
    assert tp.kv_int8 and ref.kv_int8 and jq.kv_int8
    for name in ("dit", "text", "vision"):
        _assert_modules_equal(getattr(tp, name), getattr(ref, name), name)
        _assert_modules_equal(getattr(tp, name), getattr(jq, name), name)
    # the W8A8 lane loads too (tests/test_torch_w8a8.py holds it against JAX)
    w8 = TPipe.from_pretrained(tree["paths"][:1], device="cpu", quantize="int8")
    assert type(w8.dit.blocks[0].attn["img_qkv"]).__name__ == "Int8Linear"


def test_from_pretrained_by_preset_name(tree, tmp_path, monkeypatch):
    """``model_id`` presets resolve against a local hub tree with the hub gate
    closed (the Edit-2509 repo carries only the transformer); the errors
    are JAX's."""
    local = str(tmp_path / "hub")
    qi = os.path.join(local, "Qwen", "Qwen-Image")
    for sub in ("transformer", "text_encoder", "vae", "tokenizer"):
        shutil.copytree(os.path.join(tree["base"], sub), os.path.join(qi, sub))
    shutil.copytree(os.path.join(qi, "transformer"),
                    os.path.join(local, "Qwen", "Qwen-Image-Edit-2509", "transformer"))
    seen = {}

    def load_tokenizer(self, path):
        seen[type(self)] = path
        fake_tokenizer(self)

    monkeypatch.setattr(TPipe, "load_tokenizer", load_tokenizer)
    monkeypatch.setattr(JPipe, "load_tokenizer", load_tokenizer)
    kw = dict(model_id="Qwen/Qwen-Image-Edit-2509", local_model_path=local, skip_download=True)
    tp = TPipe.from_pretrained(dtype=torch.float32, device="cpu", **kw)
    jp = JPipe.from_pretrained(dtype=jnp.float32, **kw)
    assert tp.dit.cfg.num_layers == jp.dit_cfg.num_layers == 2
    assert tp.vae.cfg.base_dim == jp.vae_cfg.base_dim == 8
    assert seen[TPipe] == seen[JPipe] and seen[TPipe].rstrip("/").endswith(
        os.path.join("Qwen", "Qwen-Image", "tokenizer"))
    assert t_preset("Qwen/Qwen-Image")["processor_config"] is None
    for preset in (t_preset, j_preset):
        with pytest.raises(KeyError, match="Qwen-Image-Edit-2509"):
            preset("Qwen/No-Such-Model")
    for cls, kw in ((TPipe, dict(device="cpu")), (JPipe, {})):
        with pytest.raises(FileNotFoundError):
            cls.from_pretrained(model_id="Qwen/Qwen-Image", local_model_path=str(tmp_path / "x"),
                                skip_download=True, **kw)
        with pytest.raises(ValueError, match="model_id"):
            cls.from_pretrained(**kw)


def test_from_pretrained_rejects_what_jax_rejects(tree, tmp_path):
    """An unrecognised file and an extension checkpoint raise as in JAX."""
    odd = str(tmp_path / "odd.safetensors")
    tst.save_safetensors({"foo.weight": torch.zeros(2)}, odd)
    rife = str(tmp_path / "rife.safetensors")
    tst.save_safetensors({"block0.convblock.0.weight": torch.zeros(2)}, rife)
    for path, match in ((odd, "unrecognised"), (rife, "not a pipeline part")):
        with pytest.raises(ValueError, match=match):
            TPipe.from_pretrained([path], device="cpu")
        with pytest.raises(ValueError, match=match):
            JPipe.from_pretrained([path])


@pytest.mark.parametrize("hotload", [False, True])
def test_load_lora_matches_jax(tree, tmp_path, hotload):
    """``load_lora``: merged into the DiT (within fp32 rounding of JAX's
    merge) or hot-loaded as live factors (bit for bit), then cleared."""
    lora_only = str(tmp_path / "lora.safetensors")
    ft = tst.load_state_dict(tree["finetuned"])
    tst.save_safetensors({k: v for k, v in ft.items() if "lora_" in k}, lora_only)
    jp = JPipe.from_pretrained(tree["paths"], dtype=jnp.float32)
    tp = TPipe.from_pretrained(tree["paths"], dtype=torch.float32, device="cpu")
    jp.load_lora(lora_only, alpha=0.5, hotload=hotload)
    tp.load_lora(lora_only, alpha=0.5, hotload=hotload)
    if hotload:
        _assert_tree_equal(to_jax_tree(tp.dit_lora), jax.tree_util.tree_map(np.asarray,
                                                                            jp.dit_lora))
        tp.clear_lora()
        assert tp.dit_lora is None
    else:
        want = pipeline_from_jax(jp, device="cpu").dit.state_dict()
        for k, v in tp.dit.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# The published key hashes of the full configs
# ---------------------------------------------------------------------------

def test_published_key_hashes_of_the_full_configs():
    """Shape-only (``meta``) key/shape sets of Qwen-Image-Edit-2509's DiT (60
    blocks), the Qwen VAE and the Qwen2.5-VL-7B text encoder, written through
    the inverse key maps, hash to the published files' hashes."""
    sds = synth.shape_only_state_dicts(SIZES["full"])
    assert all(t.device.type == "meta" for sd in sds.values() for t in sd.values())
    assert sds["transformer"]["transformer_blocks.59.attn.to_q.weight"].shape == (3072, 3072)
    assert sds["text_encoder"]["model.embed_tokens.weight"].shape == (152064, 3584)
    want = {"transformer": "qwen_image_dit", "text_encoder": "qwen_image_text_encoder",
            "vae": "qwen_image_vae"}
    for family, sd in sds.items():
        assert tst.KNOWN_HASHES.get(tst.hash_state_dict_keys(sd)) == want[family], family
        assert tst.detect_model_name(sd) == jst.detect_model_name(sd) == want[family]

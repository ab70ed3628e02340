"""The port's pipeline as a whole: the JAX tiny pipeline carried into
physicedit_torch must give the same images (within one uint8 level) on
every path of ``__call__`` (the single-image edit, text-to-image, multi-image,
context image, input image with inpaint, the blockwise ControlNet) and of
batched serving, and the same reasoner text; the port must load no JAX.
EliGen's paths are in tests/test_torch_eligen.py."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from PIL import Image

from physicedit_tpu.pipeline.testing import build_tiny_pipeline
from physicedit_torch.io.from_jax import pipeline_from_jax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_vae(tree, seed=0):
    """The tiny pipeline's VAE is all zeros (a constant image); give it
    random weights so the comparison sees the decode."""
    rng = np.random.default_rng(seed)

    def fill(path, x):
        x = np.asarray(x)
        if path[-1].key == "gamma":
            return np.ones_like(x)
        if path[-1].key == "w":
            return (rng.uniform(-1, 1, x.shape) / np.sqrt(np.prod(x.shape[:3]))).astype(x.dtype)
        return (0.05 * rng.normal(size=x.shape)).astype(x.dtype)

    return jax.tree_util.tree_map_with_path(fill, tree)


@pytest.fixture(scope="module")
def pipes():
    jpipe = build_tiny_pipeline()
    jpipe.vae_params = _random_vae(jpipe.vae_params)
    return jpipe, pipeline_from_jax(jpipe, device="cpu")


def _edit(seed):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8))


def test_generate_noise_matches_jax_bitwise(pipes):
    jpipe, tpipe = pipes
    want = np.asarray(jpipe.generate_noise((1, 8, 6, 16), 5))
    got = tpipe.generate_noise((1, 8, 6, 16), 5).numpy()
    np.testing.assert_array_equal(got, want)


def test_call_matches_jax(pipes):
    jpipe, tpipe = pipes
    kw = dict(edit_image=_edit(0), height=64, width=64, seed=7, num_inference_steps=3,
              have_text_reasoning=False, edit_image_auto_resize=False)
    want = np.asarray(jpipe("make the ball fall", **kw), np.int16)
    got = np.asarray(tpipe("make the ball fall", **kw), np.int16)
    assert got.shape == want.shape == (64, 64, 3)
    assert want.std() > 0                            # the decode is not constant
    assert np.abs(got - want).max() <= 1             # within one uint8 level


def test_reason_physical_batch_matches_jax(pipes):
    jpipe, tpipe = pipes
    edit = _edit(2)
    want = jpipe.reason_physical_batch(["tilt the cup"], [edit], max_new_tokens=8)
    got = tpipe.reason_physical_batch(["tilt the cup"], [edit], max_new_tokens=8)
    assert got == want and len(got[0]) > 0
    assert tpipe.timings["decode_tokens"] == 8


def _image(seed, w=64, h=64):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


def _quadrant_mask():
    arr = np.zeros((64, 64), np.uint8)
    arr[:32, :40] = 255
    return Image.fromarray(arr)


CALL_PATHS = {
    # every path of __call__ besides the single-image edit and EliGen
    "text_to_image": dict(),
    "multi_image": dict(edit_image=[_image(20), _image(21, 48, 48)]),
    "context_image": dict(edit_image=_image(22), context_image=_image(23, 48, 48)),
    "input_image_inpaint_blur": dict(input_image=_image(24), inpaint_mask=_quadrant_mask(),
                                     inpaint_blur_size=2, inpaint_blur_sigma=1.5),
    "input_image_strength": dict(edit_image=_image(25), input_image=_image(26),
                                 denoising_strength=0.6),
    "edit_rope_interpolation": dict(edit_image=_image(27, 48, 48), edit_rope_interpolation=True),
    "no_cfg": dict(edit_image=_image(28), cfg_scale=1.0),
}


@pytest.mark.parametrize("case", list(CALL_PATHS))
def test_call_path_matches_jax(pipes, case):
    jpipe, tpipe = pipes
    kw = dict(height=64, width=64, seed=9, num_inference_steps=2, have_text_reasoning=False,
              edit_image_auto_resize=False, **CALL_PATHS[case])
    want = np.asarray(jpipe("paint the red ball blue", **kw), np.int16)
    got = np.asarray(tpipe("paint the red ball blue", **kw), np.int16)
    assert got.shape == want.shape == (64, 64, 3)
    assert want.std() > 0
    assert np.abs(got - want).max() <= 1             # within one uint8 level


@pytest.fixture(scope="module")
def control_params():
    """A JAX blockwise ControlNet for the tiny DiT, its zero-initialised
    output projections made random so that the residual shows."""
    from physicedit_tpu.models import controlnet as jcn

    cfg = build_tiny_pipeline().dit_cfg
    params = jax.tree_util.tree_map(np.asarray, jcn.init_controlnet_params(
        jax.random.PRNGKey(9), num_layers=cfg.num_layers, dim=cfg.dim))
    rng = np.random.default_rng(9)
    out = params["blocks"]["output_proj"]
    out["w"] = (rng.normal(size=out["w"].shape) * 0.1).astype(np.float32)
    out["b"] = (rng.normal(size=out["b"].shape) * 0.1).astype(np.float32)
    return params


def test_blockwise_controlnet_call_matches_jax(pipes, control_params):
    import copy

    jpipe, _ = pipes
    jc = copy.copy(jpipe)
    jc.controlnet_params = control_params
    tc = pipeline_from_jax(jc, device="cpu")
    kw = dict(edit_image=_image(30), height=64, width=64, seed=2, num_inference_steps=3,
              have_text_reasoning=False, edit_image_auto_resize=False,
              blockwise_controlnet_image=_image(31), blockwise_controlnet_start=1.0,
              blockwise_controlnet_end=0.4, blockwise_controlnet_scale=0.8)
    want = np.asarray(jc("guide it", **kw), np.int16)
    got = np.asarray(tc("guide it", **kw), np.int16)
    plain = np.asarray(tc("guide it", **{k: v for k, v in kw.items()
                                         if not k.startswith("blockwise")}), np.int16)
    assert np.abs(got - want).max() <= 1
    assert np.abs(got - plain).max() > 1             # the residual changes the edit


def test_control_block_matches_jax(control_params):
    from physicedit_tpu.models import controlnet as jcn
    from physicedit_torch.io.from_jax import controlnet_from_jax
    from physicedit_torch.models import controlnet as tcn

    rng = np.random.default_rng(4)
    cond_tokens = rng.normal(size=(2, 12, 64)).astype(np.float32)
    img = rng.normal(size=(2, 12, 64)).astype(np.float32)
    cond = jcn.process_conditioning(control_params, jnp.asarray(cond_tokens))
    want = jcn.control_block(jax.tree_util.tree_map(lambda x: x[1], control_params["blocks"]),
                             jnp.asarray(img), cond)
    cn = controlnet_from_jax(control_params, device="cpu")
    with torch.no_grad():
        t_cond = tcn.process_conditioning(cn, torch.from_numpy(cond_tokens))
        got = tcn.control_block(cn.blocks[1], torch.from_numpy(img), t_cond)
    np.testing.assert_allclose(t_cond.numpy(), np.asarray(cond), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("steps,start,end,scale", [(5, 1.0, 0.5, 2.0), (1, 1.0, 0.0, 1.0),
                                                   (7, 0.8, 0.2, 0.5)])
def test_controlnet_step_scales_match_jax(steps, start, end, scale):
    from physicedit_tpu.models import controlnet as jcn
    from physicedit_torch.models import controlnet as tcn

    want = jcn.controlnet_step_scales(steps, start, end, scale)
    got = tcn.controlnet_step_scales(steps, start, end, scale)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("trunc", [None, 1])
def test_denoise_with_control_matches_jax(pipes, control_params, trunc):
    """The ControlNet as one ``Control`` through the port's denoise (its
    conditioning cut to the positive rows under cfg_truncate_after) against
    the JAX loop's three control arguments, fp32, within 1e-4."""
    from physicedit_tpu.models import controlnet as jcn
    from physicedit_tpu.ops import rope as j_rope
    from physicedit_tpu.sampling import flow_match as jfm
    from physicedit_tpu.sampling.denoise import denoise as j_denoise
    from physicedit_torch.io.from_jax import controlnet_from_jax, dit_from_jax
    from physicedit_torch.models.controlnet import Control
    from physicedit_torch.sampling.denoise import denoise as t_denoise

    jpipe, _ = pipes
    cfg = jpipe.dit_cfg
    rng = np.random.default_rng(17)
    s_t, shapes = 16, [(1, 4, 4), (1, 4, 4)]
    latents = rng.normal(size=(1, 8, 8, 16)).astype(np.float32)
    extra = rng.normal(size=(1, 16, 64)).astype(np.float32)
    prompt = rng.normal(size=(2, s_t, cfg.txt_in_dim)).astype(np.float32)
    mask = np.ones((2, s_t), bool)
    mask[1, 11:] = False
    cond_tokens = rng.normal(size=(1, 16, 64)).astype(np.float32)
    cond = np.repeat(np.asarray(jcn.process_conditioning(control_params,
                                                         jnp.asarray(cond_tokens))), 2, axis=0)
    scales = jcn.controlnet_step_scales(3, 1.0, 0.4, 0.8)
    ropes = j_rope.build_rope_tables(shapes, s_t, axes_dim=jpipe.rope_axes)
    sched = jfm.build_schedule(3, jfm.QWEN_IMAGE_CONFIG, dynamic_shift_len=16)
    arrays = (latents, extra, prompt, mask, *ropes)
    steps = (sched.sigmas, sched.sigmas_next, sched.timesteps)
    want = j_denoise(jpipe.dit_params, cfg, *map(jnp.asarray, arrays + steps), jnp.asarray(4.0),
                     latent_hw=(8, 8), control_blocks=control_params["blocks"],
                     control_cond=jnp.asarray(cond), control_scales=jnp.asarray(scales),
                     cfg_truncate_after=trunc)
    control = Control(controlnet_from_jax(control_params, device="cpu"),
                      torch.from_numpy(cond), torch.from_numpy(scales))
    got = t_denoise(dit_from_jax(jpipe.dit_params, cfg, device="cpu"),
                    *[torch.from_numpy(np.asarray(a)) for a in arrays + steps], 4.0,
                    latent_hw=(8, 8), control=control, cfg_truncate_after=trunc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_edit_batch_matches_jax(pipes):
    jpipe, tpipe = pipes
    kw = dict(height=64, width=64, seeds=[5, 9], num_inference_steps=2,
              have_text_reasoning=False)
    prompts, ims = ["move the red box", "tilt the big cup now"], [_image(40), _image(41)]
    want = jpipe.edit_batch(prompts, ims, **kw)
    got = tpipe.edit_batch(prompts, ims, **kw)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        w = np.asarray(w, np.int16)
        assert w.std() > 0 and np.abs(np.asarray(g, np.int16) - w).max() <= 1


def test_edit_batch_mixed_matches_jax(pipes):
    jpipe, tpipe = pipes
    sizes = [(64, 64), (96, 64), (64, 64)]             # (w, h): two shape groups
    ims = [_image(50 + i, w, h) for i, (w, h) in enumerate(sizes)]
    kw = dict(seeds=[1, 2, 3], num_inference_steps=2, have_text_reasoning=False)
    want = jpipe.edit_batch_mixed(["a", "b b", "c"], ims, **kw)
    got = tpipe.edit_batch_mixed(["a", "b b", "c"], ims, **kw)
    assert [o.size for o in got] == [o.size for o in want] == sizes
    for g, w in zip(got, want):
        assert np.abs(np.asarray(g, np.int16) - np.asarray(w, np.int16)).max() <= 1


def test_reason_physical_batch_two_rows_matches_jax(pipes):
    jpipe, tpipe = pipes
    prompts = ["tilt the cup", "slide the very big red box to the left side"]
    ims = [_image(60), _image(61)]
    want = jpipe.reason_physical_batch(prompts, ims, max_new_tokens=6)
    got = tpipe.reason_physical_batch(prompts, ims, max_new_tokens=6)
    assert got == want and all(len(t) > 0 for t in got)


@pytest.mark.parametrize("option,error", [(dict(is_train=True), NotImplementedError),
                                          (dict(rand_device="cuda"), ValueError)])
def test_call_raises_where_jax_raises(pipes, option, error):
    jpipe, tpipe = pipes
    kw = dict(edit_image=_edit(3), height=64, width=64, num_inference_steps=1, **option)
    for pipe in (jpipe, tpipe):
        with pytest.raises(error):
            pipe("x", **kw)


def test_profile_edit_runs_on_tiny_pipeline():
    """The profiler of the full-width edit, at tiny size on the CPU (no
    device events here, so device-busy time is 0)."""
    from physicedit_torch.pipeline.testing import build_random_pipeline
    from physicedit_torch.profile_edit import profile_decode, profile_dit_step

    pipe = build_random_pipeline("tiny", generator=torch.Generator().manual_seed(0), device="cpu")
    dit, table = profile_dit_step(pipe, txt_len=8, grid=(4, 4))
    assert dit["joint_tokens"] == 2 * 16 + 8 and dit["wall_ms"] > 0
    assert dit["device_busy_ms"] == 0.0 and "aten::" in table
    dec, _ = profile_decode(pipe, prompt_len=8, tokens=3, profiled=2)
    assert 0 <= dec["tokens"] <= 3 and dec["ms_per_token"] >= 0


FORBIDDEN_IMPORTS = ("jax", "jaxlib", "optax", "flax", "physicedit_tpu")


def test_port_sources_import_no_jax():
    """Every module of the port, and chip_smoke.py, parsed: no import of JAX,
    its libraries or the JAX package, at any depth of the code."""
    import ast
    import glob

    files = sorted(glob.glob(os.path.join(REPO, "physicedit_torch", "**", "*.py"),
                             recursive=True)) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 30
    rel = {os.path.relpath(f, REPO) for f in files}
    assert {"physicedit_torch/io/safetensors_io.py", "physicedit_torch/io/convert.py",
            "physicedit_torch/io/model_config.py", "physicedit_torch/cli/validate.py",
            "physicedit_torch/tools/make_synthetic_checkpoint.py",
            "physicedit_torch/tools/_proto_int8.py", "physicedit_torch/tools/proto_int8_rate.py",
            "physicedit_torch/tools/proto_prefill_blocks.py",
            "physicedit_torch/tools/proto_w4_unpack.py", "physicedit_torch/tools/proto_w4_gemv.py",
            "physicedit_torch/tools/proto_attn_int8qk.py",
            "physicedit_torch/tools/proto_ew_rate.py",
            # the video path
            "physicedit_torch/sampling/ddim.py", "physicedit_torch/sampling/continuous_ode.py",
            "physicedit_torch/data/video.py", "physicedit_torch/models/vae3d.py",
            "physicedit_torch/extensions/__init__.py", "physicedit_torch/extensions/tiler.py",
            "physicedit_torch/extensions/esrgan.py", "physicedit_torch/extensions/rife.py",
            "physicedit_torch/extensions/fastblend.py",
            "physicedit_torch/extensions/processors.py",
            # the quality scorers and Nexus-Gen
            "physicedit_torch/extensions/clip_bpe.py",
            "physicedit_torch/extensions/quality_metric.py",
            "physicedit_torch/models/openclip.py", "physicedit_torch/models/blip.py",
            "physicedit_torch/models/qwenvl_embedder.py", "physicedit_torch/models/nexus_gen.py",
            "physicedit_torch/models/nexus_gen_projector.py"} <= rel
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(open(path).read(), path)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [(os.path.relpath(path, REPO), n) for n in names
                    if n.split(".")[0] in FORBIDDEN_IMPORTS]
    assert not bad, bad


def test_port_runs_without_jax():
    """The tiny slice end to end, in the float lane and after quantize_, a
    tiny EliGen edit, a tiny edit_batch, a tiny ControlNet edit, a tiny
    training step, and the validate CLI on a tree written by the port's
    synthetic-checkpoint tool, in a fresh process load neither JAX nor the
    JAX package."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        from PIL import Image
        torch.set_num_threads(2)
        from physicedit_torch.pipeline.testing import build_random_pipeline
        from physicedit_torch.train.trainer import TrainConfig, Trainer
        pipe = build_random_pipeline("tiny", device="cpu")
        edit = Image.fromarray(np.random.default_rng(0).integers(0, 255, (64, 64, 3), dtype=np.uint8))
        out = pipe("make the ball fall", edit_image=edit, height=64, width=64, seed=1,
                   num_inference_steps=2, edit_image_auto_resize=False)
        assert out.size == (64, 64), out.size
        print(pipe.reason_physical_batch(["tilt"], [edit], max_new_tokens=4)[0][:20])
        mask = Image.fromarray(np.kron(np.eye(2), np.ones((32, 32))).astype(np.uint8) * 255)
        out = pipe("move the cup", edit_image=edit, height=64, width=64, seed=2,
                   num_inference_steps=2, have_text_reasoning=False, edit_image_auto_resize=False,
                   eligen_entity_prompts=["a red cup on the table"], eligen_entity_masks=[mask])
        assert out.size == (64, 64) and pipe.timings["eligen_bias"] > 0, out.size
        outs = pipe.edit_batch(["tilt", "fall"], [edit, edit], height=64, width=64,
                               num_inference_steps=2, have_text_reasoning=False)
        assert [o.size for o in outs] == [(64, 64)] * 2
        from physicedit_torch.pipeline.testing import random_controlnet
        pipe.controlnet = random_controlnet(pipe.dit.cfg, device="cpu")
        out = pipe("guide it", edit_image=edit, height=64, width=64, seed=2,
                   num_inference_steps=2, have_text_reasoning=False,
                   blockwise_controlnet_image=edit)
        assert out.size == (64, 64), out.size
        trainer = Trainer(pipe, [], TrainConfig(lora_rank=2, txt_len_bucket=64), device="cpu")
        batch = trainer.preprocess({"image": edit, "edit_image": edit,
                                    "middle_key_frames": [edit, edit], "prompt": "fall"})
        print(trainer.step(batch))
        pipe.quantize_("int4")
        out = pipe("make the ball fall", edit_image=edit, height=64, width=64, seed=1,
                   num_inference_steps=2, edit_image_auto_resize=False)
        assert out.size == (64, 64) and pipe.kv_int8, out.size
        print(pipe.reason_physical_batch(["tilt"], [edit], max_new_tokens=4)[0][:20])
        # a reference-layout tree written by the port's tool, through the CLI
        import dataclasses, tempfile
        from physicedit_torch.cli import validate as cli
        from physicedit_torch.models.dit import DiTConfig
        from physicedit_torch.pipeline.edit_pipeline import PhysicEditPipeline
        from physicedit_torch.pipeline.testing import SIZES, FakeTokenizer, random_pipeline
        from physicedit_torch.tools import make_synthetic_checkpoint as synth
        dims = dataclasses.replace(SIZES["tiny"], rope_axes=(16, 56, 56), dit=DiTConfig(
            num_layers=2, dim=128, num_heads=1, head_dim=128, txt_in_dim=64, patch_dim=64,
            time_dim=32))
        small = random_pipeline(dims, "cpu", torch.float32, torch.Generator().manual_seed(1))
        base = tempfile.mkdtemp()
        info = synth.write_tree(small, base, synth.random_trainable(
            small, 2, 32, torch.Generator().manual_seed(2)))
        def fake_tokenizer(self, path):
            self.tokenizer = FakeTokenizer()
            self.boi_token_id, self.eoi_token_id = 96, 95
            self.edit_drop_idx = self.t2i_drop_idx = 2
        PhysicEditPipeline.load_tokenizer = fake_tokenizer
        cli.resize_image = lambda im, target_area=0: im.resize((64, 64))
        edit.save(base + "/in.png")
        loaded = cli.main(["--prompt", "tilt", "--image_path", base + "/in.png",
                           "--save_path", base + "/out.png", "--base_model_path", base,
                           "--lora_path", info["paths"]["finetuned"], "--device", "cpu",
                           "--num_inference_steps", "1", "--no_text_reasoning"])
        assert Image.open(base + "/out.png").size == (64, 64) and len(loaded.adapters) == 7
        assert "jax" not in sys.modules, "the port imported jax"
        assert "physicedit_tpu" not in sys.modules, "the port imported the JAX package"
        print("NO_JAX_OK")
    """)
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout

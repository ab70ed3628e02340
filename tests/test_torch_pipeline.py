"""The port's slice as a whole: the JAX tiny pipeline carried into
physicedit_torch must give the same edit (within one uint8 level) and the
same reasoner text; the port must load no JAX."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import jax
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


UNPORTED = {
    "input_image": dict(input_image=Image.new("RGB", (64, 64))),
    "context_image": dict(context_image=Image.new("RGB", (64, 64))),
    "inpaint_mask": dict(inpaint_mask=Image.new("RGB", (64, 64))),
    "eligen": dict(eligen_entity_prompts=["a cup"], eligen_entity_masks=[Image.new("RGB", (64, 64))]),
    "controlnet": dict(blockwise_controlnet_image=Image.new("RGB", (64, 64))),
    "multi_image": dict(edit_image=[Image.new("RGB", (64, 64))] * 2),
    "text_to_image": dict(edit_image=None),
}


@pytest.mark.parametrize("case", list(UNPORTED))
def test_call_raises_for_unported_paths(pipes, case):
    _, tpipe = pipes
    kw = dict(edit_image=_edit(3), height=64, width=64, num_inference_steps=1)
    kw.update(UNPORTED[case])
    with pytest.raises(NotImplementedError):
        tpipe("x", **kw)


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
    """The tiny slice end to end, in the float lane and after quantize_, and
    a tiny training step, in a fresh process load neither JAX nor the JAX
    package."""
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
        trainer = Trainer(pipe, [], TrainConfig(lora_rank=2, txt_len_bucket=64), device="cpu")
        batch = trainer.preprocess({"image": edit, "edit_image": edit,
                                    "middle_key_frames": [edit, edit], "prompt": "fall"})
        print(trainer.step(batch))
        pipe.quantize_("int4")
        out = pipe("make the ball fall", edit_image=edit, height=64, width=64, seed=1,
                   num_inference_steps=2, edit_image_auto_resize=False)
        assert out.size == (64, 64) and pipe.kv_int8, out.size
        print(pipe.reason_physical_batch(["tilt"], [edit], max_new_tokens=4)[0][:20])
        assert "jax" not in sys.modules, "the port imported jax"
        assert "physicedit_tpu" not in sys.modules, "the port imported the JAX package"
        print("NO_JAX_OK")
    """)
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout

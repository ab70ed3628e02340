"""``python -m physicedit_torch.cli.validate`` against the JAX package's
``cli.validate``: both read the same reference-layout tree (written by the
port's ``tools/make_synthetic_checkpoint``) and the same input image, with
the tokenizer replaced by the fake one and the resize by a 64 x 64 one on
both sides (as tests/test_cli_validate.py does), fp32 on the CPU.  Each
``--attn_impl`` (the port's names for JAX's), with and without
``--lora_path``, and ``--quantize int4``: the PNGs agree within one uint8
level.  Both CLIs load bf16; the tests make them load fp32."""

import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental import pallas as pl
from PIL import Image

import physicedit_tpu.cli.validate as j_cli
import physicedit_torch.cli.validate as t_cli
from physicedit_tpu.pipeline.edit_pipeline import PhysicEditPipeline as JPipe
from physicedit_torch.pipeline.edit_pipeline import PhysicEditPipeline as TPipe
from tests.test_torch_io import build_tree, fake_tokenizer

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return build_tree(str(tmp_path_factory.mktemp("synth")))


@pytest.fixture
def patched(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    for cls, fp32 in ((JPipe, jnp.float32), (TPipe, torch.float32)):
        monkeypatch.setattr(cls, "load_tokenizer", lambda self, path: fake_tokenizer(self))
        # fp32 where the CLIs load bf16: bf16 on the CPU rounds differently
        # in each package's op order, fp32 agrees within a level
        load = cls.from_pretrained.__func__
        monkeypatch.setattr(cls, "from_pretrained", classmethod(
            lambda c, *a, _load=load, _dt=fp32, **kw: _load(c, *a, dtype=_dt, **kw)))
    for cli in (j_cli, t_cli):
        monkeypatch.setattr(cli, "resize_image", lambda im, target_area=0: im.resize((64, 64)))


CASES = {  # name: (port --attn_impl, --lora_path, --quantize)
    "dense": ("dense", False, None),
    "kernels": ("kernels", False, None),
    "dense_lora": ("dense", True, None),
    "kernels_lora": ("kernels", True, None),
    "kernels_int4": ("kernels", False, "int4"),
}
JAX_IMPL = {"dense": "xla", "kernels": "pallas"}


@pytest.mark.parametrize("case", list(CASES))
def test_validate_cli_matches_jax(tree, patched, tmp_path, case):
    impl, lora, quantize = CASES[case]
    rng = np.random.default_rng(1)
    image = str(tmp_path / "in.png")
    Image.fromarray(rng.integers(0, 255, (80, 72, 3), dtype=np.uint8)).save(image)
    common = ["--prompt", "the ball rolls off the table", "--image_path", image,
              "--base_model_path", tree["base"], "--seed", "3", "--num_inference_steps", "2",
              "--no_text_reasoning"]
    if lora:
        common += ["--lora_path", tree["finetuned"]]
    if quantize:
        common += ["--quantize", quantize]
    outs = {}
    for name, cli, extra in (("jax", j_cli, ["--attn_impl", JAX_IMPL[impl]]),
                             ("port", t_cli, ["--attn_impl", impl, "--device", "cpu"])):
        path = str(tmp_path / name / "out.png")
        cli.main(common + extra + ["--save_path", path])
        outs[name] = np.asarray(Image.open(path), np.int16)
    assert outs["port"].shape == outs["jax"].shape == (64, 64, 3)
    assert outs["jax"].std() > 0
    assert np.abs(outs["port"] - outs["jax"]).max() <= 1     # within one uint8 level

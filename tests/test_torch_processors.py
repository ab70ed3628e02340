"""The port's processor chain (``physicedit_torch/extensions/processors.py``)
against the JAX package's: the registry, the chain's order and kwargs,
FastBlend's config forwarding, the errors, and a RIFE smoother in a chain
(the same numpy-drawn weights) within one uint8 level."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from PIL import Image, ImageEnhance

from physicedit_tpu.extensions import processors as jp
from physicedit_tpu.extensions import rife as j_rife
from physicedit_torch.extensions import processors as tp
from physicedit_torch.extensions import rife as t_rife
from tests.test_torch_extensions import ifnet_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frames(n=4, size=24, seed=0):
    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8))
            for _ in range(n)]


def test_pil_editors_and_registry_match_jax():
    frames = _frames()
    configs = [{"processor_type": "Contrast", "config": {"rate": 1.2}},
               {"processor_type": "Sharpness", "config": {"rate": 0.7}}]
    got = tp.SequencialProcessor.from_configs(configs)(frames)
    want = jp.SequencialProcessor.from_configs(configs)(frames)
    for g, w, f in zip(got, want, frames):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        np.testing.assert_array_equal(np.asarray(g), np.asarray(
            ImageEnhance.Sharpness(ImageEnhance.Contrast(f).enhance(1.2)).enhance(0.7)))


def test_chain_runs_in_order_and_forwards_kwargs():
    calls = []

    class Stub(tp.VideoProcessor):
        def __init__(self, tag):
            self.tag = tag
            self.default_kwargs = {"own": tag}

        def __call__(self, rendered_frames, **kwargs):
            calls.append((self.tag, kwargs.get("marker"), kwargs.get("own")))
            return rendered_frames + [self.tag]

    assert tp.SequencialProcessor([Stub("a"), Stub("b")])([], marker=7) == ["a", "b"]
    assert calls == [("a", 7, "a"), ("b", 7, "b")]


def test_fastblend_config_forwarding():
    got = tp.make_processor("FastBlend", batch_size=4, window_size=16, num_iter=2,
                            device="cpu")
    want = jp.make_processor("FastBlend", batch_size=4, window_size=16, num_iter=2)
    assert (got.batch_size, got.window_size) == (want.batch_size, want.window_size) == (4, 16)
    assert got.ebsynth_config == want.ebsynth_config and got.device == "cpu"


def test_unknown_types_and_missing_rife_weights_raise():
    for mod in (jp, tp):
        with pytest.raises(ValueError, match="invalid processor_type"):
            mod.make_processor("NotAThing")
        with pytest.raises(ValueError, match="RIFE"):
            mod.make_processor("RIFE")


def test_rife_smoother_in_a_chain_matches_jax(tmp_path):
    sd = ifnet_state_dict(c=16, seed=1)
    configs = [{"processor_type": "RIFE", "config": {"batch_size": 2, "num_iter": 1}},
               {"processor_type": "Contrast", "config": {"rate": 1.1}}]
    want_chain = jp.SequencialProcessor.from_configs(
        configs, models={"rife": j_rife.ifnet_from_torch(sd)})
    got_chain = tp.SequencialProcessor.from_configs(
        configs, models={"rife": t_rife.ifnet_from_state_dict(sd, device="cpu")},
        device="cpu")
    frames = _frames(n=4, size=32, seed=2)
    got, want = got_chain(frames), want_chain(frames)
    assert len(got) == 4 and got[0].size == frames[0].size
    for g, w in zip(got, want):
        assert np.abs(np.asarray(g, np.int16) - np.asarray(w, np.int16)).max() <= 1
    # a model_path loads the weights onto the device asked for
    from physicedit_torch.io.safetensors_io import save_safetensors

    path = str(tmp_path / "flownet.safetensors")
    save_safetensors(sd, path)
    proc = tp.make_processor("RIFE", model_path=path, device="cpu", batch_size=2)
    assert proc.default_kwargs == {"batch_size": 2}
    assert proc.net.block0.conv1.prelu.device.type == "cpu"


def test_video_path_runs_without_jax():
    """The video VAE's encode, ESRGAN's upscale and a FastBlend -> RIFE chain
    on tiny CPU inputs, in a fresh process, load neither JAX nor the JAX
    package."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        from PIL import Image
        torch.set_num_threads(2)
        from physicedit_torch.core.params import init_random_, materialize
        from physicedit_torch.extensions import esrgan, rife
        from physicedit_torch.extensions.processors import SequencialProcessor
        from physicedit_torch.models import vae3d
        gen = torch.Generator().manual_seed(0)
        vae = init_random_(materialize(vae3d.VideoVAE(vae3d.VAEConfig(base_dim=8)), "cpu"), gen)
        z = vae3d.encode(vae, torch.rand(1, 3, 16, 16, 3, generator=gen) * 2 - 1)
        assert z.shape == (1, 3, 2, 2, 16) and torch.isfinite(z).all()
        net = esrgan.init_esrgan(gen, num_feat=8, num_block=1, num_grow_ch=4, device="cpu")
        rng = np.random.default_rng(0)
        frames = [Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
                  for _ in range(4)]
        assert esrgan.upscale(net, frames[0]).size == (128, 128)
        chain = SequencialProcessor.from_configs(
            [{"processor_type": "FastBlend", "config": {"batch_size": 4, "window_size": 2,
                                                        "num_iter": 2}},
             {"processor_type": "RIFE", "config": {"batch_size": 2}}],
            models={"rife": rife.init_ifnet(gen, c=16, device="cpu")}, device="cpu")
        out = chain(frames, original_frames=frames)
        assert len(out) == 4 and out[0].size == (32, 32)
        assert "jax" not in sys.modules, "the port imported jax"
        assert "physicedit_tpu" not in sys.modules, "the port imported the JAX package"
        print("NO_JAX_OK")
    """)
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout

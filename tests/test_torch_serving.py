"""The port's serving surface against the JAX package's, on the CPU:
``eval/sweep.py`` (PICA / KRIS sweeps, ``BucketBatcher``), ``eval/metrics.py``,
``cli/serving.py`` and the ``inference_pica`` / ``inference_kris`` /
``generate`` CLIs, and the pipeline's single-row ``reason_physical`` /
``encode_prompt``.

Each sweep runs through both packages on a local ``datasets.Dataset`` (the
hub is never reached): on recording mock pipelines the calls, output names,
folders and skips must be identical; on the tiny pipeline of both packages
(the JAX weights carried across, fp32) the images within one uint8 level,
the pipeline tests' tolerance.  The metrics equal JAX's to 1e-12 relative.
"""

import argparse
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from PIL import Image

datasets = pytest.importorskip("datasets")

from physicedit_tpu.eval import metrics as jmetrics  # noqa: E402
from physicedit_tpu.eval import sweep as jsweep  # noqa: E402
from physicedit_torch.eval import metrics as tmetrics  # noqa: E402
from physicedit_torch.eval import sweep as tsweep  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class MockPipe:
    def __init__(self):
        self.calls = []

    def __call__(self, prompt, edit_image=None, seed=None, num_inference_steps=None,
                 height=None, width=None, edit_image_auto_resize=True, **kw):
        self.calls.append({"prompt": prompt, "h": height, "w": width, "seed": seed,
                           "steps": num_inference_steps, "kw": kw})
        return Image.new("RGB", (width, height), (seed % 255, 0, 0))


class MockBatchPipe(MockPipe):
    def __init__(self):
        super().__init__()
        self.batch_calls = []

    def edit_batch(self, prompts, edit_images, height=None, width=None, seeds=None,
                   num_inference_steps=None, **kw):
        self.batch_calls.append({"n": len(prompts), "h": height, "w": width,
                                 "prompts": list(prompts), "seeds": list(seeds), "kw": kw})
        return [Image.new("RGB", (width, height), (i, 0, 0)) for i in range(len(prompts))]


class MockMixedPipe(MockBatchPipe):
    def __init__(self):
        super().__init__()
        self.mixed_calls = []

    def edit_batch_mixed(self, prompts, edit_images, heights=None, widths=None, seeds=None,
                         num_inference_steps=None, **kw):
        self.mixed_calls.append({"n": len(prompts), "sizes": list(zip(widths, heights)),
                                 "prompts": list(prompts), "seeds": list(seeds), "kw": kw})
        return [Image.new("RGB", (w, h), (i, 0, 0))
                for i, (w, h) in enumerate(zip(widths, heights))]


def _records(pipe):
    return {k: getattr(pipe, k) for k in ("calls", "batch_calls", "mixed_calls")
            if hasattr(pipe, k)}


def _both(run, pipe_cls, tmp_path, name, **kw):
    """``run`` (a sweep's name) through both packages on fresh mock pipes;
    asserts the same calls and output files and returns the port's pipe and
    output folder."""
    seen = {}
    for pkg, mod in (("jax", jsweep), ("port", tsweep)):
        pipe = pipe_cls()
        out = str(tmp_path / f"{name}_{pkg}")
        getattr(mod, run)(pipe, out, **kw)
        files = sorted(os.path.relpath(os.path.join(d, f), out)
                       for d, _, fs in os.walk(out) for f in fs)
        seen[pkg] = (_records(pipe), files, pipe, out)
    assert seen["port"][0] == seen["jax"][0]
    assert seen["port"][1] == seen["jax"][1]
    return seen["port"][2], seen["port"][3]


def _fake_pica(tmp_path, n=3, sizes=None, name="pica_ds"):
    rng = np.random.default_rng(0)
    sizes = sizes or [(70, 100)] * n
    recs = {
        "image": [Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
                  for h, w in sizes],
        "intermediate_prompt": [f"int {i}" for i in range(len(sizes))],
        "superficial_prompt": [f"sup {i}" for i in range(len(sizes))],
        "explicit_prompt": [f"exp {i}" for i in range(len(sizes))],
    }
    path = str(tmp_path / name)
    datasets.Dataset.from_dict(recs).save_to_disk(path)
    return path


def _fake_kris(tmp_path, name="kris_ds"):
    rng = np.random.default_rng(3)
    recs = {
        "image": [Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
                  for h, w in [(60, 80), (80, 60), (64, 64), (60, 80)]],
        "category": ["physics", "chem", "physics", "bio"],
        "image_id": ["a1", "b2", "c3", "d4"],
        "instruction": ["melt it", "burn it", "drop it", "grow it"],
    }
    path = str(tmp_path / name)
    datasets.Dataset.from_dict(recs).save_to_disk(path)
    return path


# ---------------------------------------------------------------------------
# The sweeps on mock pipelines, both packages
# ---------------------------------------------------------------------------

def test_pica_sweep_outputs_and_skip(tmp_path):
    ds = _fake_pica(tmp_path)
    pipe, out = _both("run_pica_sweep", MockPipe, tmp_path, "out", prompt_type="intermediate",
                      local_dataset_path=ds, seed=42, num_inference_steps=2)
    assert sorted(os.listdir(out)) == ["00000.jpg", "00001.jpg", "00002.jpg"]
    assert len(pipe.calls) == 3
    assert all(c["h"] % 32 == 0 and c["w"] % 32 == 0 for c in pipe.calls)   # /32 sizes
    assert pipe.calls[0]["prompt"] == "int 0"
    # restartable: a second run skips everything
    pipe2 = MockPipe()
    tsweep.run_pica_sweep(pipe2, out, prompt_type="intermediate", local_dataset_path=ds)
    assert pipe2.calls == []


def test_pica_index_sharding(tmp_path):
    ds = _fake_pica(tmp_path)
    _, out = _both("run_pica_sweep", MockPipe, tmp_path, "out2", start_idx=1, end_idx=2,
                   local_dataset_path=ds)
    assert sorted(os.listdir(out)) == ["00001.jpg"]


def test_model_config_local_resolution(tmp_path):
    from physicedit_torch.io.model_config import ModelConfig

    base = tmp_path / "models" / "Org" / "Model"
    (base / "vae").mkdir(parents=True)
    f = base / "vae" / "diffusion_pytorch_model.safetensors"
    f.write_bytes(b"x")
    cfg = ModelConfig(model_id="Org/Model", origin_file_pattern="vae/*.safetensors",
                      local_model_path=str(tmp_path / "models"), skip_download=True)
    assert cfg.download_if_necessary() == str(f)
    missing = ModelConfig(model_id="Org/Model", origin_file_pattern="nope/*.safetensors",
                          local_model_path=str(tmp_path / "models"), skip_download=True)
    with pytest.raises(FileNotFoundError):
        missing.download_if_necessary()


def test_find_model_files(tmp_path):
    from physicedit_tpu.cli.validate import find_model_files as j_find
    from physicedit_torch.cli.validate import find_model_files

    base = tmp_path / "Qwen" / "Qwen-Image"
    (base / "vae").mkdir(parents=True)
    (base / "vae" / "diffusion_pytorch_model.safetensors").write_bytes(b"x")
    hits = find_model_files(str(tmp_path))
    assert hits and hits[0].endswith("diffusion_pytorch_model.safetensors")
    assert hits == j_find(str(tmp_path))


@pytest.mark.parametrize("mod", ["validate", "generate", "inference_pica", "inference_kris"])
def test_cli_help(mod, capsys):
    """Every port CLI parses --help, with the JAX CLI's flags plus --device."""
    import importlib

    outs = {}
    for pkg in ("physicedit_tpu", "physicedit_torch"):
        m = importlib.import_module(f"{pkg}.cli.{mod}")
        with pytest.raises(SystemExit) as e:
            m.main(["--help"])
        assert e.value.code == 0
        outs[pkg] = capsys.readouterr().out
    flags = {w.strip("[],") for w in outs["physicedit_tpu"].split() if w.startswith("--")}
    port = {w.strip("[],") for w in outs["physicedit_torch"].split() if w.startswith("--")}
    assert flags <= port and "--device" in port


def test_pica_prompt_rewriter(tmp_path):
    ds = _fake_pica(tmp_path)
    pipe, _ = _both("run_pica_sweep", MockPipe, tmp_path, "out3", local_dataset_path=ds,
                    end_idx=1, prompt_rewriter=lambda p: p.upper())
    assert pipe.calls[0]["prompt"] == "INT 0"


def test_make_prompt_rewriter_cmd():
    from physicedit_torch.cli.serving import make_prompt_rewriter

    assert make_prompt_rewriter(None) is None
    up = make_prompt_rewriter(
        f"{sys.executable} -c \"import sys; print(sys.stdin.read().upper())\"")
    assert up("hello world") == "HELLO WORLD"
    bad = make_prompt_rewriter(f"{sys.executable} -c \"raise SystemExit(3)\"")
    assert bad("keep me") == "keep me"            # a failing command keeps the prompt
    gone = make_prompt_rewriter("/nonexistent/rewriter")
    assert gone("still here") == "still here"


def _serving_parser(tmp_path):
    from physicedit_torch.cli import serving

    p = argparse.ArgumentParser()
    p.add_argument("--base_model_path", default=str(tmp_path))
    p.add_argument("--lora_path", default=None)
    p.add_argument("--tokenizer_path", default=None)
    serving.add_serving_args(p)
    return p


def test_serving_args_reach_the_sweep(tmp_path, monkeypatch):
    """--batch_size / --quantize / --prompt_rewriter_cmd / --device flow
    through inference_pica.main into the sweep and the pipeline; the device
    defaults to cuda; a mesh and --quantize exclude each other."""
    from physicedit_torch.cli import inference_pica, serving
    from physicedit_torch.pipeline.edit_pipeline import PhysicEditPipeline

    seen = {}

    def fake_from_pretrained(paths, **kw):
        seen.update(quantize=kw.get("quantize"), device=kw.get("device"))
        return MockPipe()

    def fake_sweep(pipe, out_dir, **kw):
        seen.update(batch_size=kw.get("batch_size"), rewriter=kw.get("prompt_rewriter"),
                    trunc=kw.get("cfg_truncate_step"))

    monkeypatch.setattr(PhysicEditPipeline, "from_pretrained", staticmethod(fake_from_pretrained))
    monkeypatch.setattr(tsweep, "run_pica_sweep", fake_sweep)
    inference_pica.main([
        "--base_model_path", str(tmp_path), "--output_dir", str(tmp_path),
        "--batch_size", "8", "--quantize", "int8", "--cfg_truncate_step", "30",
        "--prompt_rewriter_cmd",
        f"{sys.executable} -c \"import sys; print(sys.stdin.read().upper())\""])
    assert (seen["quantize"], seen["batch_size"], seen["trunc"]) == ("int8", 8, 30)
    assert seen["device"] == "cuda" and seen["rewriter"]("abc") == "ABC"
    inference_pica.main(["--base_model_path", str(tmp_path), "--output_dir", str(tmp_path),
                         "--device", "cpu"])
    assert seen["device"] == "cpu" and seen["rewriter"] is None
    args = _serving_parser(tmp_path).parse_args(["--quantize", "int4", "--model_parallel", "2"])
    with pytest.raises(SystemExit, match="pick one"):
        serving.build_pipeline(args)


@pytest.mark.parametrize("flags", [["--data_parallel", "2"], ["--model_parallel", "4"]])
def test_mesh_flags_raise(tmp_path, flags):
    """A mesh needs one process per device: in a single process (no
    torchrun) the flags exit before anything is loaded, naming the
    processes the mesh needs."""
    from physicedit_torch.cli import serving

    with pytest.raises(SystemExit, match="processes"):
        serving.build_pipeline(_serving_parser(tmp_path).parse_args(flags))


def test_kris_cli_serving_args(tmp_path, monkeypatch):
    from physicedit_torch.cli import inference_kris
    from physicedit_torch.pipeline.edit_pipeline import PhysicEditPipeline

    seen = {}
    monkeypatch.setattr(PhysicEditPipeline, "from_pretrained",
                        staticmethod(lambda paths, **kw: seen.update(kw) or MockPipe()))
    monkeypatch.setattr(tsweep, "run_kris_sweep", lambda pipe, out, **kw: seen.update(kw))
    inference_kris.main(["--base_model_path", str(tmp_path), "--output_dir", str(tmp_path),
                         "--batch_size", "4"])
    assert seen["batch_size"] == 4 and seen["device"] == "cuda"


def test_pica_sweep_batched_buckets(tmp_path):
    """batch_size > 1 groups same-/32-bucket images into edit_batch calls;
    stragglers and odd buckets flush at the end."""
    ds = _fake_pica(tmp_path, sizes=[(70, 100), (70, 100), (70, 100), (40, 64), (70, 100)],
                    name="pica_b")
    pipe, out = _both("run_pica_sweep", MockBatchPipe, tmp_path, "outb", local_dataset_path=ds,
                      batch_size=2, num_inference_steps=2, mixed_resolution_batching=False,
                      cfg_truncate_step=30)
    assert sorted(c["n"] for c in pipe.batch_calls) == [2, 2]
    assert len(pipe.calls) == 1 and len(os.listdir(out)) == 5
    assert all(c["kw"] == {"cfg_truncate_step": 30} for c in pipe.batch_calls)


def test_pica_sweep_mixed_resolution_batching(tmp_path):
    """The default native-size mode: full arrival-order batches across
    resolutions through edit_batch_mixed (2 + 2, then the last one)."""
    ds = _fake_pica(tmp_path, sizes=[(70, 100), (40, 64), (100, 70), (64, 40), (70, 100)],
                    name="pica_m")
    pipe, out = _both("run_pica_sweep", MockMixedPipe, tmp_path, "outm", local_dataset_path=ds,
                      batch_size=2, num_inference_steps=2)
    assert [c["n"] for c in pipe.mixed_calls] == [2, 2, 1]
    assert pipe.calls == [] and pipe.batch_calls == []
    assert pipe.mixed_calls[0]["sizes"] == [(96, 64), (64, 32)]
    assert len(os.listdir(out)) == 5


def test_kris_sweep_folders_names_and_skip(tmp_path):
    """Per-category folders, image_id names, about-1024^2 inputs, batched
    per bucket, and a rerun that skips what exists."""
    ds = _fake_kris(tmp_path)
    pipe, out = _both("run_kris_sweep", MockBatchPipe, tmp_path, "outk", local_dataset_path=ds,
                      batch_size=2, num_inference_steps=3, start_idx=0, end_idx=4)
    assert sorted(os.listdir(out)) == ["bio", "chem", "physics"]
    assert sorted(os.listdir(os.path.join(out, "physics"))) == ["a1.jpg", "c3.jpg"]
    sizes = [(c["w"], c["h"]) for c in pipe.calls] + [(c["w"], c["h"]) for c in
                                                       pipe.batch_calls]
    assert all(w % 32 == 0 and h % 32 == 0 and 0.8e6 < w * h < 1.3e6 for w, h in sizes)
    pipe2 = MockBatchPipe()
    tsweep.run_kris_sweep(pipe2, out, local_dataset_path=ds)
    assert pipe2.calls == [] and pipe2.batch_calls == []


# ---------------------------------------------------------------------------
# The metrics
# ---------------------------------------------------------------------------

def test_psnr_identity_and_noise():
    rng = np.random.default_rng(0)
    img = rng.random((64, 64, 3)).astype(np.float32)
    assert tmetrics.psnr(img, img) == float("inf")
    noisy = np.clip(img + rng.normal(0, 0.1, img.shape), 0, 1).astype(np.float32)
    p = tmetrics.psnr(img, noisy)
    assert 15 < p < 25 and p == pytest.approx(jmetrics.psnr(img, noisy), rel=1e-12)


def test_ssim_identity_and_degradation():
    rng = np.random.default_rng(1)
    img = rng.random((64, 64, 3)).astype(np.float32)
    assert tmetrics.ssim(img, img) > 0.999
    noisy = np.clip(img + rng.normal(0, 0.2, img.shape), 0, 1).astype(np.float32)
    s = tmetrics.ssim(img, noisy)
    assert 0.0 < s < 0.9 and s == pytest.approx(jmetrics.ssim(img, noisy), rel=1e-12)
    gray = img[..., 0]                              # 2-D input
    assert tmetrics.ssim(gray, gray * 0.9) == pytest.approx(jmetrics.ssim(gray, gray * 0.9),
                                                            rel=1e-12)


def test_parity_report_keys():
    rng = np.random.default_rng(2)
    a = (rng.random((32, 32, 3)) * 255).astype(np.uint8)
    b = (rng.random((32, 32, 3)) * 255).astype(np.uint8)
    rep = tmetrics.parity_report(a, a)
    assert rep["ssim"] > 0.999 and rep["psnr"] == float("inf")
    assert tmetrics.lpips(a, a) is None or "lpips" in rep      # no lpips package: None
    got, want = tmetrics.parity_report(a, b), jmetrics.parity_report(a, b)
    assert got.keys() == want.keys()
    assert all(got[k] == pytest.approx(want[k], rel=1e-12) for k in want)


# ---------------------------------------------------------------------------
# Both packages' sweeps on the same tiny pipeline
# ---------------------------------------------------------------------------

class Recorder:
    """A pipeline's serving calls with the reasoner off (a 1000-token decode
    of random weights would only add time and drift), each output kept."""

    def __init__(self, pipe):
        self.pipe, self.outs = pipe, []

    def _keep(self, outs):
        self.outs += [np.asarray(o, np.int16) for o in outs]
        return outs

    def __call__(self, *a, **kw):
        return self._keep([self.pipe(*a, have_text_reasoning=False, **kw)])[0]

    def edit_batch(self, *a, **kw):
        return self._keep(self.pipe.edit_batch(*a, have_text_reasoning=False, **kw))

    def edit_batch_mixed(self, *a, **kw):
        return self._keep(self.pipe.edit_batch_mixed(*a, have_text_reasoning=False, **kw))


@pytest.fixture(scope="module")
def pipes():
    from physicedit_tpu.pipeline.testing import build_tiny_pipeline
    from physicedit_torch.io.from_jax import pipeline_from_jax
    from tests.test_torch_pipeline import _random_vae

    jpipe = build_tiny_pipeline()
    jpipe.vae_params = _random_vae(jpipe.vae_params)
    return jpipe, pipeline_from_jax(jpipe, device="cpu")


@pytest.mark.parametrize("mode", ["mixed", "uniform", "kris"])
def test_sweep_on_the_tiny_pipeline_matches_jax(pipes, tmp_path, mode):
    """PICA in mixed and uniform batching (batch 2, CFG truncated after the
    first step) and KRIS (batch 1) through each package's sweep and
    pipeline: the same files, every image within one uint8 level."""
    jpipe, tpipe = pipes
    if mode == "kris":
        ds, run = _fake_kris(tmp_path), "run_kris_sweep"
        kw = dict(batch_size=1, end_idx=2)
    else:
        ds = _fake_pica(tmp_path, sizes=[(64, 64), (70, 100), (64, 64), (64, 64)])
        run = "run_pica_sweep"
        kw = dict(batch_size=2, mixed_resolution_batching=mode == "mixed", cfg_truncate_step=1)
    if mode == "kris":      # KRIS resizes to about 1024^2: keep the tiny model's 64^2
        import physicedit_tpu.eval.sweep as jsw
        import physicedit_torch.eval.sweep as tsw
        jsw_resize, tsw_resize = jsw.resize_image, tsw.resize_image
        jsw.resize_image = tsw.resize_image = lambda im: im.resize((64, 64))
    try:
        recs, files = {}, {}
        for name, mod, pipe in (("jax", jsweep, jpipe), ("port", tsweep, tpipe)):
            recs[name] = Recorder(pipe)
            out = str(tmp_path / name)
            getattr(mod, run)(recs[name], out, local_dataset_path=ds, num_inference_steps=2,
                              seed=7, **kw)
            files[name] = sorted(os.path.relpath(os.path.join(d, f), out)
                                 for d, _, fs in os.walk(out) for f in fs)
    finally:
        if mode == "kris":
            jsw.resize_image, tsw.resize_image = jsw_resize, tsw_resize
    assert files["port"] == files["jax"] and len(files["port"]) == (2 if mode == "kris" else 4)
    assert len(recs["port"].outs) == len(recs["jax"].outs) == len(files["port"])
    for g, w in zip(recs["port"].outs, recs["jax"].outs):
        assert g.shape == w.shape and w.std() > 0
        assert np.abs(g - w).max() <= 1


def test_single_row_methods_match_jax(pipes):
    """reason_physical is one row of reason_physical_batch, encode_prompt the
    T2I encode (no image, t2i_drop_idx): both as JAX's."""
    jpipe, tpipe = pipes
    rng = np.random.default_rng(8)
    edit = Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8))
    want = jpipe.reason_physical("tilt the cup", edit, max_new_tokens=6)
    got = tpipe.reason_physical("tilt the cup", edit, max_new_tokens=6)
    assert got == want == tpipe.reason_physical_batch(["tilt the cup"], [edit], 6)[0]
    (emb, special), (jemb, jspecial) = (tpipe.encode_prompt("a red cup on a table"),
                                        jpipe.encode_prompt("a red cup on a table"))
    assert special is None and jspecial is None and emb.shape == np.asarray(jemb).shape
    np.testing.assert_allclose(emb, np.asarray(jemb), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# The CLIs on the CPU over a tiny synthetic tree and a local dataset
# ---------------------------------------------------------------------------

def _loadable_tiny_pipeline():
    """The tiny pipeline with a head_dim-128 DiT: a loaded tree gets the
    published rope axes (16, 56, 56), which need it."""
    import dataclasses

    from physicedit_torch.models.dit import DiTConfig
    from physicedit_torch.pipeline.testing import SIZES, random_pipeline

    dims = dataclasses.replace(SIZES["tiny"], rope_axes=(16, 56, 56), dit=DiTConfig(
        num_layers=2, dim=128, num_heads=1, head_dim=128, txt_in_dim=64, patch_dim=64,
        time_dim=32))
    return random_pipeline(dims, "cpu", torch.float32, torch.Generator().manual_seed(1))


@pytest.fixture
def tiny_tree(tmp_path, monkeypatch):
    """A tiny tree written by the port's synthetic-checkpoint tool, with the
    fake tokenizer in place of load_tokenizer (the tree has none)."""
    from physicedit_torch.pipeline.edit_pipeline import PhysicEditPipeline
    from physicedit_torch.tools import make_synthetic_checkpoint as synth
    from tests.test_torch_io import fake_tokenizer

    pipe = _loadable_tiny_pipeline()
    base = str(tmp_path / "tree")
    synth.write_tree(pipe, base)
    monkeypatch.setattr(PhysicEditPipeline, "load_tokenizer", lambda self, path:
                        fake_tokenizer(self))
    return base


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_pica_cli_runs_on_cpu(tiny_tree, tmp_path, quantize):
    ds = _fake_pica(tmp_path, sizes=[(64, 64), (64, 96), (64, 64)])
    out = str(tmp_path / "pica_out")
    from physicedit_torch.cli import inference_pica

    args = ["--base_model_path", tiny_tree, "--output_dir", out, "--local_dataset_path", ds,
            "--num_inference_steps", "1", "--batch_size", "2", "--device", "cpu",
            "--prompt_rewriter_cmd", f"{sys.executable} -c \"print('tilt it')\""]
    pipe = inference_pica.main(args + (["--quantize", quantize] if quantize else []))
    assert sorted(os.listdir(out)) == ["00000.jpg", "00001.jpg", "00002.jpg"]
    assert Image.open(os.path.join(out, "00001.jpg")).size == (96, 64)
    assert pipe.device.type == "cpu"
    fc1 = pipe.dit.blocks[0].img_mlp["fc1"]       # 2 x 128 x 512: over the default threshold
    assert (type(fc1).__name__ == "Int8Linear") == (quantize == "int8")


def test_kris_and_generate_clis_run_on_cpu(tiny_tree, tmp_path, monkeypatch):
    from physicedit_torch.cli import generate, inference_kris

    monkeypatch.setattr(tsweep, "resize_image", lambda im: im.resize((64, 64)))
    out = str(tmp_path / "kris_out")
    inference_kris.main(["--base_model_path", tiny_tree, "--output_dir", out,
                         "--local_dataset_path", _fake_kris(tmp_path), "--end_idx", "2",
                         "--num_inference_steps", "1", "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["chem", "physics"]
    save = str(tmp_path / "t2i" / "out.png")
    pipe = generate.main(["--prompt", "a red cup", "--save_path", save, "--base_model_path",
                          tiny_tree, "--height", "64", "--width", "48",
                          "--num_inference_steps", "1", "--device", "cpu"])
    assert Image.open(save).size == (48, 64) and pipe.device.type == "cpu"


def test_serving_surface_runs_without_jax(tmp_path):
    """The PICA CLI on a tiny tree and local dataset, a W8A8 edit and the
    three refiners, in a fresh process, load neither JAX nor the JAX package."""
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        import torch
        import datasets
        from PIL import Image
        torch.set_num_threads(2)
        from physicedit_torch.cli import inference_pica
        from physicedit_torch.core.params import init_random_, materialize
        from physicedit_torch.models import bloom, marian
        from physicedit_torch.models.qwen_vl import TINY_TEXT, QwenVLText
        from physicedit_torch.pipeline import prompt_refiners as pr
        from physicedit_torch.pipeline.edit_pipeline import PhysicEditPipeline
        import dataclasses
        from physicedit_torch.models.dit import DiTConfig
        from physicedit_torch.pipeline.testing import SIZES, FakeTokenizer, random_pipeline
        from physicedit_torch.tools import make_synthetic_checkpoint as synth
        base = {str(tmp_path)!r}
        dims = dataclasses.replace(SIZES["tiny"], rope_axes=(16, 56, 56), dit=DiTConfig(
            num_layers=2, dim=128, num_heads=1, head_dim=128, txt_in_dim=64, patch_dim=64,
            time_dim=32))
        synth.write_tree(random_pipeline(dims, "cpu", torch.float32), base + "/tree")
        def fake_tokenizer(self, path):
            self.tokenizer = FakeTokenizer()
            self.boi_token_id, self.eoi_token_id = 96, 95
            self.edit_drop_idx = self.t2i_drop_idx = 2
        PhysicEditPipeline.load_tokenizer = fake_tokenizer
        rng = np.random.default_rng(0)
        datasets.Dataset.from_dict({{
            "image": [Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8))] * 2,
            "intermediate_prompt": ["tilt", "fall"]}}).save_to_disk(base + "/ds")
        loaded = inference_pica.main(["--base_model_path", base + "/tree", "--output_dir",
                                      base + "/out", "--local_dataset_path", base + "/ds",
                                      "--num_inference_steps", "1", "--batch_size", "2",
                                      "--device", "cpu", "--quantize", "int8"])
        assert type(loaded.dit.blocks[0].img_mlp["fc1"]).__name__ == "Int8Linear"
        g = torch.Generator().manual_seed(0)
        def rand(model):
            model = init_random_(materialize(model, "cpu"), g)
            model.embed.normal_(0.0, 0.5, generator=g)
            return model.eval()
        class Tok:
            def encode(self, text): return [5, 6, 7, 8]
            def apply_chat_template(self, m, tokenize=False, add_generation_prompt=True):
                return " ".join(x["content"] for x in m)
            def decode(self, toks, skip_special_tokens=True): return " ".join(map(str, toks))
        b = rand(bloom.Bloom(bloom.BloomConfig(vocab_size=50, hidden_size=32, num_layers=2,
                                               num_heads=4))).reset_alibi_()
        print(pr.BeautifulPrompt(b, Tok())("a cat"))
        m = rand(marian.Marian(marian.MarianConfig(vocab_size=40, d_model=32, encoder_layers=1,
                                                   decoder_layers=1, num_heads=4, ffn_dim=64,
                                                   max_positions=64)))
        m.pos.copy_(torch.from_numpy(marian.sinusoidal_table(64, 32)))
        m.final_logits_bias.zero_()
        print(pr.Translator(m, Tok())("x", max_new_tokens=4))
        print(pr.QwenPrompt(rand(QwenVLText(TINY_TEXT)), Tok())("x", max_new_tokens=4))
        assert "jax" not in sys.modules, "the port imported jax"
        assert "physicedit_tpu" not in sys.modules, "the port imported the JAX package"
        print("NO_JAX_OK")
    """)
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout

"""The port's training entry point against the JAX package on the CPU:
checkpoint resolution and resume, Adafactor and gradient accumulation
against optax, the distillation loss against ``jax.value_and_grad``, the
trainer's cached data-process mode, noise redraw, resume and eval, and
``python -m physicedit_torch.cli.train`` beside ``physicedit_tpu.cli.train``
on the same tiny tree and the same synthetic PhysicTran folder.

Both packages read the videos through the same stand-in
``imageio.get_reader`` (``train/synthetic.StandInReader``: imageio may
have no mp4 backend where the tests run), so each package's own ``_load_frames`` crops
and resizes the frames.  The CLIs load bf16; the tests make them load fp32,
and give the JAX pipeline the tree's DINOv2 config (it keeps DINOv2-B's).
Tolerances are stated beside each comparison.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax
from jax.experimental import pallas as pl
from safetensors.numpy import load_file

import physicedit_tpu.cli.train as j_cli
import physicedit_torch.cli.train as t_cli
from physicedit_tpu.ops import rope as j_rope
from physicedit_tpu.pipeline.edit_pipeline import PhysicEditPipeline as JPipe
from physicedit_tpu.sampling import flow_match as j_fm
from physicedit_tpu.train import checkpoint as j_ckpt
from physicedit_tpu.train import loss as j_loss
from physicedit_tpu.train import train_step as j_ts
from physicedit_tpu.train import trainer as j_trainer
from physicedit_torch.io.from_jax import dit_from_jax, to_jax_tree, trainable_from_jax
from physicedit_torch.pipeline.edit_pipeline import PhysicEditPipeline as TPipe
from physicedit_torch.train import checkpoint as t_ckpt
from physicedit_torch.train import loss as t_loss
from physicedit_torch.train import synthetic
from physicedit_torch.train import train_step as t_ts
from physicedit_torch.train import trainer as t_trainer
from tests.test_torch_io import DINO, build_tree, fake_tokenizer
from tests.test_torch_train import (TRAIN_DIT, SyntheticDataset, _assert_trees_close,
                                    _batch, _frozen, _jax_trainable, _np_tree, _rel_l2,
                                    _torch_batch, _train_cfg, tiny_pipes)  # noqa: F401

torch.set_num_threads(2)

CKPT_REL = 1e-4     # rel-L2 of each exported tensor after a few fp32 steps on both sides
OPT_TOL = dict(rtol=1e-6, atol=1e-7)   # an optimizer's fp32 arithmetic against optax's


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


# ---------------------------------------------------------------------------
# Checkpoint resolution and position
# ---------------------------------------------------------------------------

def _sidecars(tmp_path):
    """A directory with latest.json, a file with a sidecar, a file without,
    and a legacy sidecar written by four processes."""
    d = tmp_path / "run"
    d.mkdir()
    meta = {"global_step": 7, "epoch": 1, "num_processes": 1, "batches_per_epoch": 3,
            "gradient_accumulation_steps": 1, "sample_index": 2}
    (d / "step-7.json").write_text(json.dumps(meta))
    (d / "latest.json").write_text(json.dumps({"checkpoint": "step-7.safetensors", **meta}))
    (d / "step-7.safetensors").write_bytes(b"")
    (tmp_path / "bare.safetensors").write_bytes(b"")
    legacy = {"global_step": 10, "epoch": 0, "num_processes": 4}
    (tmp_path / "legacy.json").write_text(json.dumps(legacy))
    (tmp_path / "legacy.safetensors").write_bytes(b"")
    return {"dir": str(d), "file": str(d / "step-7.safetensors"),
            "bare": str(tmp_path / "bare.safetensors"),
            "legacy": str(tmp_path / "legacy.safetensors")}


@pytest.mark.parametrize("form", ["dir", "file", "bare", "legacy"])
def test_resolve_resume_matches_jax(tmp_path, form):
    path = _sidecars(tmp_path)[form]
    assert t_ckpt.resolve_resume(path) == j_ckpt.resolve_resume(path)


@pytest.mark.parametrize("meta,num_processes,batches", [
    ({"global_step": 7, "epoch": 1}, 1, 3),
    ({"global_step": 10, "epoch": 0, "num_processes": 4}, 1, 3),    # 4 -> 1: 40 steps
    ({"global_step": 10, "epoch": 0, "num_processes": 4}, 2, 7),    # 4 -> 2: 20 steps
    ({"global_step": 9, "num_processes": 0}, 3, 4),
    ({"global_step": 5, "epoch": 2}, 1, 0),                         # no batches per epoch
    ({}, 1, 5),
])
def test_resume_position_matches_jax(meta, num_processes, batches):
    assert (t_ckpt.resume_position(meta, num_processes, batches)
            == j_ckpt.resume_position(meta, num_processes, batches))


# ---------------------------------------------------------------------------
# Adafactor and gradient accumulation against optax
# ---------------------------------------------------------------------------

LEAVES = {"w": (128, 300), "b": (300,), "small": (7, 5), "stacked": (3, 130, 140)}


def _module(params):
    m = torch.nn.Module()
    for k, v in params.items():
        m.register_parameter(k, torch.nn.Parameter(torch.tensor(v)))
    return m


def _run_both(jopt, topt, steps, seed, check=None):
    """``steps`` updates of optax's ``jopt`` and the port's ``topt`` on the
    same leaves and gradients (some near 0, some large); ``check(i, jax,
    port, before)`` after each."""
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in LEAVES.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp)
    mod = _module(params)
    ts = topt.init(mod)
    for i in range(steps):
        grads = {k: (rng.normal(size=s) * 10.0 ** rng.integers(-6, 2, size=s))
                 .astype(np.float32) for k, s in LEAVES.items()}
        before = {k: p.detach().clone() for k, p in mod.named_parameters()}
        updates, js = jopt.update({k: jnp.asarray(g) for k, g in grads.items()}, js, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in mod.named_parameters():
            p.grad = torch.tensor(grads[k])
        topt.step(mod, ts)
        got = {k: p.detach().numpy() for k, p in mod.named_parameters()}
        if check is not None:
            check(i, {k: np.asarray(v) for k, v in jp.items()}, got, before)
    return js, ts, mod


def test_factored_dims_rule():
    """optax's factoring rule: the two largest dims when the second is at
    least 128 (a LoRA factor [r, n] with r = 128 is factored; a bias, a
    rank-4 factor and a small matrix are not)."""
    from optax._src.factorized import _factored_dims

    for shape in [(128, 3072), (3072, 128), (127, 300), (300,), (7, 5), (60, 3, 3072, 128),
                  (60, 128, 18432), (60, 3072, 4), (3, 130, 140), (140, 2, 129), (128, 128)]:
        assert t_ts.factored_dims(shape) == _factored_dims(shape, True, 128), shape


@pytest.mark.parametrize("chunk", [t_ts.CHUNK, 1000], ids=["whole", "chunked"])
def test_adafactor_matches_optax(monkeypatch, chunk):
    """make_optimizer(name="adafactor") against optax.adafactor as the JAX
    package configures it, 5 steps on a factored [128, 300], a bias [300],
    an unfactored [7, 5] and a stacked [3, 130, 140] (factored over its last
    two dims); also with CHUNK small enough to split every leaf: parameters
    within fp32 rounding, and the factored statistics too."""
    monkeypatch.setattr(t_ts, "CHUNK", chunk)
    lr, wd = 1e-2, 1e-2

    def check(i, jax_p, port_p, _):
        for k in LEAVES:
            np.testing.assert_allclose(port_p[k], jax_p[k], err_msg=f"step {i} {k}", **OPT_TOL)

    js, ts, _ = _run_both(j_ts.make_optimizer(lr, wd, name="adafactor"),
                          t_ts.make_optimizer(lr, wd, name="adafactor"), 5, 0, check)
    factored = js[0]
    assert ts.count == 5 and set(ts.v) == {"b", "small"} and set(ts.v_row) == {"w", "stacked"}
    for k in ("w", "stacked"):
        np.testing.assert_allclose(ts.v_row[k].numpy(), np.asarray(factored.v_row[k]),
                                   rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(ts.v_col[k].numpy(), np.asarray(factored.v_col[k]),
                                   rtol=1e-5, err_msg=k)
    assert t_ts.optimizer_state_bytes(ts) == 4 * (300 + 128 + 3 * 140 + 3 * 130 + 300 + 35)


@pytest.mark.parametrize("name,state_dtype", [("adamw", None), ("adamw", "bfloat16"),
                                              ("adafactor", None)])
def test_gradient_accumulation_matches_multisteps(name, state_dtype):
    """gradient_accumulation_steps=3 against optax.MultiSteps over 7 calls:
    the parameters hold still (bit for bit) on the calls that only
    accumulate, and after every third call match optax within fp32
    rounding; the inner optimizer steps only then."""
    lr, wd = 1e-2, 1e-2
    jdt = None if state_dtype is None else jnp.bfloat16
    tdt = None if state_dtype is None else torch.bfloat16

    def check(i, jax_p, port_p, before):
        for k in LEAVES:
            np.testing.assert_allclose(port_p[k], jax_p[k], err_msg=f"call {i} {k}", **OPT_TOL)
            moved = not np.array_equal(port_p[k], before[k].numpy())
            assert moved == (i % 3 == 2), (i, k)

    js, ts, _ = _run_both(j_ts.make_optimizer(lr, wd, 3, state_dtype=jdt, name=name),
                          t_ts.make_optimizer(lr, wd, 3, state_dtype=tdt, name=name), 7, 1,
                          check)
    assert (ts.mini_step, ts.gradient_step, ts.inner.count) == (1, 2, 2)
    assert int(js.mini_step) == 1 and int(js.gradient_step) == 2
    for k in LEAVES:       # the running mean of the one call since the last step
        np.testing.assert_allclose(ts.acc[k].numpy(), np.asarray(js.acc_grads[k]), rtol=1e-6)


def test_trainer_counts_calls_under_accumulation(tiny_pipes):
    """The trainer's global_step counts calls, as in JAX; the trainable
    moves on every second call with accumulation 2."""
    _, tpipe = tiny_pipes
    tt = t_trainer.Trainer(tpipe, SyntheticDataset(), t_trainer.TrainConfig(
        **_train_cfg(optimizer="adafactor", gradient_accumulation_steps=2)), device="cpu")
    batch = tt.preprocess(SyntheticDataset()[0])
    moved = []
    for _ in range(4):
        before = [p.detach().clone() for p in tt.trainable.parameters()]
        tt.step(batch)
        moved.append(any(not torch.equal(a, p) for a, p in zip(before, tt.trainable.parameters())))
    assert moved == [False, True, False, True] and tt.global_step == 4
    assert tt.opt_state.inner.count == 2


@pytest.mark.parametrize("optimizer,accum", [("adafactor", 1), ("adamw", 2)])
def test_train_launch_structure_adafactor_and_accumulation(monkeypatch, optimizer, accum):
    """The launches chip_smoke.py demands of a training step hold for the
    Adafactor step and for a step that only accumulates: the optimizer
    launches no attention kernel.  The q/k and ``ln_mod`` wrappers' calls
    count as those made with grad off: their kernels have no backward."""
    import chip_smoke
    from physicedit_torch.kernels import flash_attention as tfa
    from physicedit_torch.models import dit as t_dit

    calls = dict.fromkeys(["fixedmax_attention", "fixedmax_attention_bwd", "w4a8_matmul",
                           "w4_bwd_dx", "qk_norm_rope", "ln_mod", "residual_ln_mod"], 0)
    no_backward = ("qk_norm_rope", "ln_mod", "residual_ln_mod")

    def spy(module, attr):
        real = getattr(module, attr)

        def counted(*a, **k):
            # with grad on these wrappers run their plain versions and launch nothing
            if attr not in no_backward or not torch.is_grad_enabled():
                calls[attr] += 1
            return real(*a, **k)

        monkeypatch.setattr(module, attr, counted)

    spy(t_dit, "fixedmax_attention")
    spy(t_dit, "qk_norm_rope")
    spy(t_dit, "ln_mod")
    spy(t_dit, "residual_ln_mod")
    spy(tfa, "fixedmax_attention_bwd")
    trainable = trainable_from_jax(_jax_trainable(TRAIN_DIT, 32), TRAIN_DIT, device="cpu")
    opt = t_ts.make_optimizer(1e-3, name=optimizer, gradient_accumulation_steps=accum)
    t_ts.train_step(trainable, dit_from_jax(_frozen(False), TRAIN_DIT, device="cpu"), opt,
                    opt.init(trainable), _torch_batch(_batch(TRAIN_DIT, 32)),
                    *j_fm.adapter_t_range(), use_remat=True)
    assert calls == chip_smoke.train_launch_counts(TRAIN_DIT.num_layers, False)


# ---------------------------------------------------------------------------
# The distillation loss
# ---------------------------------------------------------------------------

def _distill_inputs(seed=0, s_t=24, h=8, w=8):
    rng = np.random.default_rng(seed)
    mask = np.ones((1, s_t), bool)
    mask[0, 20:] = False
    ropes = j_rope.build_rope_tables([(1, h // 2, w // 2), (1, h // 2, w // 2)], s_t,
                                     axes_dim=(16, 56, 56))
    return {"latents0": rng.normal(size=(1, h, w, 16)).astype(np.float32),
            "extra": rng.normal(size=(1, (h // 2) * (w // 2), 64)).astype(np.float32),
            "emb": rng.normal(size=(1, s_t, TRAIN_DIT.txt_in_dim)).astype(np.float32),
            "mask": mask, "ropes": [np.asarray(r) for r in ropes],
            "target": rng.normal(size=(1, h, w, 16)).astype(np.float32)}


def test_direct_distill_loss_matches_jax():
    """direct_distill_loss through a 4-step schedule on the tiny DiT with a
    LoRA, in fp32: the loss within 1e-4 relative and every LoRA gradient
    within rel-L2 1e-3 of jax.value_and_grad (K1 forward and K8 backward in
    interpret mode on the JAX side, their plain versions here)."""
    params = _frozen(False)
    tree = _jax_trainable(TRAIN_DIT, 32, seed=3)
    tree["lora"] = jax.tree_util.tree_map(   # B nonzero, so A has a gradient
        lambda x: x + 0.02 * np.random.default_rng(5).normal(size=x.shape).astype(np.float32),
        tree["lora"])
    x = _distill_inputs()
    sched = j_fm.build_schedule(4, j_fm.QWEN_IMAGE_CONFIG, dynamic_shift_len=16)

    def loss_fn(lora):
        return j_loss.direct_distill_loss(
            params, TRAIN_DIT, jnp.asarray(x["latents0"]), jnp.asarray(x["extra"]),
            jnp.asarray(x["emb"]), jnp.asarray(x["mask"]), [jnp.asarray(r) for r in x["ropes"]],
            sched, jnp.asarray(x["target"]), lora=lora, attn_impl="pallas")

    want, grads = jax.value_and_grad(loss_fn)(jax.tree_util.tree_map(jnp.asarray, tree["lora"]))
    lora = trainable_from_jax(tree, TRAIN_DIT, device="cpu").lora
    dit = dit_from_jax(params, TRAIN_DIT, device="cpu")
    got = t_loss.direct_distill_loss(
        dit, torch.tensor(x["latents0"]), torch.tensor(x["extra"]), torch.tensor(x["emb"]),
        torch.tensor(x["mask"]), [torch.tensor(r) for r in x["ropes"]], sched,
        torch.tensor(x["target"]), lora=lora)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    assert float(np.abs(np.asarray(jax.tree_util.tree_leaves(grads)[0])).max()) > 0
    _assert_trees_close(to_jax_tree(lora, grads=True), _np_tree(grads), 1e-3)


def test_denoise_keeps_no_graph_unless_asked():
    """Inference keeps no graph even with a trainable LoRA live; grad=True
    (the distillation loss) does."""
    from physicedit_torch.sampling.denoise import denoise

    params = _frozen(False)
    lora = trainable_from_jax(_jax_trainable(TRAIN_DIT, 32), TRAIN_DIT, device="cpu").lora
    dit = dit_from_jax(params, TRAIN_DIT, device="cpu")
    x = _distill_inputs()
    sched = j_fm.build_schedule(2, j_fm.QWEN_IMAGE_CONFIG, dynamic_shift_len=16)
    args = (dit, torch.tensor(x["latents0"]), torch.tensor(x["extra"]), torch.tensor(x["emb"]),
            torch.tensor(x["mask"]), *[torch.tensor(r) for r in x["ropes"]],
            *[torch.tensor(np.asarray(a), dtype=torch.float32)
              for a in (sched.sigmas, sched.sigmas_next, sched.timesteps)], 1.0, (8, 8))
    assert not denoise(*args, lora=lora).requires_grad
    assert denoise(*args, lora=lora, grad=True).requires_grad


# ---------------------------------------------------------------------------
# The trainer: cached bundles, noise redraw, resume, eval
# ---------------------------------------------------------------------------

def _both_trainers(tiny_pipes, tmp_path, **kw):
    jpipe, tpipe = tiny_pipes
    cfg = _train_cfg(output_path=str(tmp_path), **kw)
    jt = j_trainer.Trainer(jpipe, SyntheticDataset(), j_trainer.TrainConfig(**cfg))
    tt = t_trainer.Trainer(tpipe, SyntheticDataset(), t_trainer.TrainConfig(**cfg),
                           device="cpu")
    return jt, tt


def test_cache_preprocessed_matches_jax(tiny_pipes, tmp_path):
    """cache_preprocessed writes JAX's bundles: the same files, keys and
    dtypes; noise, timestep, masks, indices and RoPE tables bitwise, the
    encoder outputs within fp32 tolerance; CachedPreprocessedDataset reads
    them back."""
    from physicedit_torch.train.dataset import CachedPreprocessedDataset

    jt, tt = _both_trainers(tiny_pipes, tmp_path)
    assert tt.cache_preprocessed(str(tmp_path / "port")) == 3
    assert jt.cache_preprocessed(str(tmp_path / "jax")) == 3
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [
        "000000.npz", "000001.npz", "000002.npz"]
    got, want = CachedPreprocessedDataset(str(tmp_path / "port")), \
        CachedPreprocessedDataset(str(tmp_path / "jax"))
    for i in range(3):
        g, w = got[i], want[i]
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            if w[k].dtype.kind in "biu" or k in ("noise", "sigma", "timestep", "weight",
                                                  "img_cos", "img_sin", "txt_cos", "txt_sin"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-4, err_msg=k)


def test_refresh_noise_draws_match_jax(tiny_pipes, tmp_path):
    """_refresh_noise redraws timestep and noise from the trainer's generator
    in JAX's order: equal draws, visit after visit; the other fields are the
    bundle's, in the trainer's dtypes."""
    jt, tt = _both_trainers(tiny_pipes, tmp_path)
    tt.cache_preprocessed(str(tmp_path / "cache"))
    jt.cache_preprocessed(str(tmp_path / "jax_cache"))     # the same draws on both generators
    from physicedit_torch.train.dataset import CachedPreprocessedDataset

    bundle = CachedPreprocessedDataset(str(tmp_path / "cache"))[1]
    for _ in range(3):
        g, w = tt._refresh_noise(bundle), jt._refresh_noise(bundle)
        for k in ("noise", "sigma", "timestep", "weight"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=k)
        assert not np.array_equal(g["noise"].numpy(), bundle["noise"])
    assert g["prompt_emb"].dtype == tt.pipe.dtype and g["special_idx"].dtype == torch.long
    assert g["txt_mask"].dtype == torch.bool
    np.testing.assert_array_equal(g["dino_mid_feats"].numpy(), bundle["dino_mid_feats"])


def _mid_epoch_checkpoint(jt):
    """A JAX checkpoint in its output folder after two of three items (step
    2, sample_index 2), with a LoRA B that is not 0; returns the folder."""
    jt.trainable = jax.tree_util.tree_map(
        lambda x: x + 0.01 * np.random.default_rng(2).normal(size=x.shape).astype(x.dtype),
        jt.trainable)
    jt.global_step, jt._epoch_pos = 2, 2
    jt.save(0)
    return jt.cfg.output_path


def test_resume_from_jax_checkpoint_matches_jax(tiny_pipes, tmp_path):
    """Resuming a JAX-written checkpoint (its directory, then a legacy file
    without sample_index) gives the port the trainable (bit for bit) and the
    position JAX's resume gives; the optimizer state starts afresh."""
    jt, tt = _both_trainers(tiny_pipes, tmp_path)
    path = _mid_epoch_checkpoint(jt)
    jt2 = j_trainer.Trainer(jt.pipe, SyntheticDataset(), jt.cfg)
    tt.step(tt.preprocess(SyntheticDataset()[0]))      # a state to drop
    for where in (path, os.path.join(path, "step-2.safetensors")):
        if where.endswith(".safetensors"):
            os.remove(os.path.join(path, "step-2.json"))    # a legacy file: no sidecar
        jt2.resume(where)
        tt.resume(where)
        assert (tt.global_step, tt.start_epoch, tt.skip_batches) == (
            jt2.global_step, jt2.start_epoch, jt2.skip_batches)
        port = {"lora": to_jax_tree(tt.trainable.lora),
                "adapters": to_jax_tree(tt.trainable.adapters)}
        _assert_trees_close(port, _np_tree(jt2.trainable), 0.0)
        assert tt.opt_state.count == 0 and all(m.abs().max() == 0 for m in tt.opt_state.mu.values())
    assert (tt.global_step, tt.start_epoch, tt.skip_batches) == (0, 0, 0)


def test_port_checkpoint_resumes_in_jax(tiny_pipes, tmp_path):
    """A port-written mid-epoch checkpoint resumes in JAX: its trainable
    equal to the port's bit for bit, the position equal; the end of an
    epoch rolls to the next."""
    jt, tt = _both_trainers(tiny_pipes, tmp_path)
    tt.step(tt.preprocess(SyntheticDataset()[0]))
    tt._epoch_pos = 2
    tt.save(0)
    jt.resume(str(tmp_path))
    assert (jt.global_step, jt.start_epoch, jt.skip_batches) == (1, 0, 2)
    port = {"lora": to_jax_tree(tt.trainable.lora), "adapters": to_jax_tree(tt.trainable.adapters)}
    _assert_trees_close(_np_tree(jt.trainable), port, 0.0)
    tt._epoch_pos = 3
    tt.save(0)
    tt.resume(str(tmp_path))
    assert (tt.global_step, tt.start_epoch, tt.skip_batches) == (1, 1, 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resume_dtypes_j7(tiny_pipes, tmp_path, dtype):
    """J7: JAX's resume imports the LoRA and the adapters as fp32 whatever
    lora_dtype / adapters_dtype say; the port loads them into the trainable
    in its configured dtypes.  In fp32 both give the checkpoint's values
    bit for bit; in bf16 JAX's come back fp32 and the port's are their bf16
    rounding."""
    jt, tt = _both_trainers(tiny_pipes, tmp_path, lora_dtype=dtype, adapters_dtype=dtype)
    path = _mid_epoch_checkpoint(jt)
    saved = load_file(os.path.join(path, "step-2.safetensors"))
    jt.resume(path)
    tt.resume(path)
    jleaves = jax.tree_util.tree_leaves(jt.trainable)
    assert {np.asarray(x).dtype for x in jleaves} == {np.dtype(np.float32)}
    assert {p.dtype for p in tt.trainable.parameters()} == {getattr(torch, dtype)}
    got = t_ckpt.export_trainable_state_dict(tt.trainable)
    assert sorted(got) == sorted(saved)
    for k, v in saved.items():
        want = v if dtype == "float32" else torch.tensor(v).bfloat16().float().numpy()
        np.testing.assert_array_equal(got[k], want, err_msg=k)


def test_evaluate_matches_jax_and_restores_the_pipeline(tiny_pipes, tmp_path):
    """evaluate writes the [edit | GT | output] strip; its output third
    within two uint8 levels of JAX's on the same trainable (fp32); the
    pipeline's LoRA and adapters are restored, and the step's gradients are
    freed; skipped under cached_inputs."""
    from PIL import Image

    jt, tt = _both_trainers(tiny_pipes, tmp_path)
    tree = _jax_trainable(jt.pipe.dit_cfg, 32, seed=11, rank=2)
    tree["lora"] = jax.tree_util.tree_map(lambda x: x + 0.05, tree["lora"])
    jt.trainable = jax.tree_util.tree_map(jnp.asarray, tree)
    tt.trainable = trainable_from_jax(tree, jt.pipe.dit_cfg, device="cpu")
    tt.global_step = jt.global_step = 4
    pipe = tt.pipe
    before = (dict(pipe.adapters), pipe.adapter, pipe.dit_lora)
    for p in tt.trainable.parameters():
        p.grad = torch.ones_like(p)
    got = tt.evaluate(1, num_inference_steps=3)
    want = jt.evaluate(1, num_inference_steps=3)
    assert (dict(pipe.adapters), pipe.adapter, pipe.dit_lora) == before
    assert all(p.grad is None for p in tt.trainable.parameters())
    assert got.size == want.size == (3 * 64, 64)
    g, w = np.asarray(got, np.int16), np.asarray(want, np.int16)
    assert np.array_equal(g[:, :128], w[:, :128])
    assert np.abs(g[:, 128:] - w[:, 128:]).max() <= 2 and w[:, 128:].std() > 0
    assert Image.open(tmp_path / "eval-step-4.jpg").size == (192, 64)
    tt.cfg.cached_inputs = True
    assert tt.evaluate(0) is None


class _TensorParallelMesh:
    """The shape of a (1, 2) mesh, all the trainer reads before it refuses W4."""

    mesh_dim_names = ("data", "model")

    @staticmethod
    def size(dim):
        return (1, 2)[dim]


def test_mesh_and_its_flags_raise(tiny_pipes, tmp_path):
    """A packed W4 frozen DiT with a model axis above one raises, as in the
    JAX package (the mesh path itself: tests/test_torch_parallel_*.py); the
    CLI's mesh flags in a single process (no torchrun) exit before it loads
    anything, naming the processes the mesh needs."""
    _, tpipe = tiny_pipes
    with pytest.raises(ValueError, match="tensor-parallel"):
        t_trainer.Trainer(tpipe, SyntheticDataset(),
                          t_trainer.TrainConfig(**_train_cfg(quantize_frozen="w4")),
                          mesh=_TensorParallelMesh(), device="cpu")
    for flags in (["--data_parallel", "2"], ["--model_parallel", "2"]):
        with pytest.raises(SystemExit, match="processes"):
            t_cli.main(["--dataset_base_path", str(tmp_path), "--base_model_path",
                        str(tmp_path / "none"), "--dinov2_path", "none", *flags])


# ---------------------------------------------------------------------------
# Both CLIs on one tiny tree and one synthetic PhysicTran folder
# ---------------------------------------------------------------------------

CLI_STEPS_LR = 1e-3


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Each mode through both CLIs: data process; cached training; raw
    training (loader threads, a save every 2 steps and an eval every 2);
    resume of the raw run for a second epoch; Adafactor with accumulation
    2.  Every training run but the resume starts from the tree's finetuned
    export (--resume_from a file without a sidecar: weights only, position
    0), so the two packages start from the same trainable."""
    root = tmp_path_factory.mktemp("train_cli")
    tree = build_tree(str(root / "tree"))
    synthetic.write_physictran_tree(str(root / "data"), n=3, excluded=1, frames=17, width=96,
                                    height=80, seed=4)
    common = ["--dataset_base_path", str(root / "data"), "--base_model_path", tree["base"],
              "--dinov2_path", os.path.join(tree["base"], "dinov2", "model.safetensors"),
              "--height", "64", "--width", "64", "--num_frames", "17", "--lora_rank", "4",
              "--num_epochs", "1", "--learning_rate", str(CLI_STEPS_LR), "--seed", "5"]
    start = ["--resume_from", tree["finetuned"]]
    runs = {
        "process": ["--data_process_output", "{out}"],
        "cached": ["--cached_inputs_path", "{process}", *start],
        "raw": ["--loader_workers", "2", "--save_every_n_steps", "2",
                "--eval_every_n_steps", "2", *start],
        "resumed": ["--resume_from", "{raw}", "--num_epochs", "2", "--save_every_n_steps", "2"],
        "adafactor": ["--optimizer", "adafactor", "--gradient_accumulation_steps", "2",
                      "--loader_workers", "0", *start],
    }
    out = {"tree": tree}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        import imageio

        mp.setattr(imageio, "get_reader", synthetic.StandInReader)
        for cls, fp32 in ((JPipe, jnp.float32), (TPipe, torch.float32)):
            mp.setattr(cls, "load_tokenizer", lambda self, path: fake_tokenizer(self))
            load = cls.from_pretrained.__func__

            def from_pretrained(c, *a, _load=load, _dt=fp32, **kw):
                pipe = _load(c, *a, dtype=_dt, **kw)
                if isinstance(pipe, JPipe):
                    pipe.dinov2_cfg = DINO
                return pipe

            mp.setattr(cls, "from_pretrained", classmethod(from_pretrained))
        for pkg, cli, extra in (("port", t_cli, ["--device", "cpu"]), ("jax", j_cli, [])):
            dirs = {name: str(root / pkg / name) for name in runs}
            for name, flags in runs.items():
                flags = [f.format(out=dirs[name], **dirs) for f in flags]
                if name == "resumed":      # resume a copy of the raw run's output
                    import shutil

                    shutil.copytree(dirs["raw"], dirs[name])
                    flags = [dirs[name] if f == dirs["raw"] else f for f in flags]
                argv = common + extra + flags + (["--output_path", dirs[name]]
                                                 if name != "process" else [])
                result = cli.main(argv)
                out[(pkg, name)] = dirs[name]
                if pkg == "port":
                    out[("trainer", name)] = result
    return out


def _checkpoint_pair(runs, name, step):
    got = load_file(os.path.join(runs[("port", name)], f"step-{step}.safetensors"))
    want = load_file(os.path.join(runs[("jax", name)], f"step-{step}.safetensors"))
    return got, want


def _assert_checkpoints_match(runs, name, steps):
    """The exported tensors of each step: the same keys, each tensor within
    rel-L2 CKPT_REL and every element within 2 * lr * steps (an Adam or
    Adafactor step moves an element by about lr at most, so this bounds an
    element whose tiny gradient flips sign between the packages); the
    sidecars equal but for the timestamp."""
    for step in steps:
        got, want = _checkpoint_pair(runs, name, step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert _rel_l2(got[k], want[k]) <= CKPT_REL, (step, k, _rel_l2(got[k], want[k]))
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2 * CLI_STEPS_LR * step,
                                       err_msg=k)
        for side in (f"step-{step}.json", "latest.json"):
            g, w = (json.load(open(os.path.join(runs[(p, name)], side)))
                    for p in ("port", "jax"))
            g.pop("timestamp"), w.pop("timestamp")
            if side == "latest.json" and step != steps[-1]:
                continue
            assert g == w, side


def test_cli_data_process_matches_jax(cli_runs):
    """--data_process_output: one bundle per kept video (the filter file
    drops the fourth), equal to JAX's (noise and indices bitwise, encoder
    outputs within fp32 tolerance)."""
    port, jax_dir = cli_runs[("port", "process")], cli_runs[("jax", "process")]
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax_dir)) == [
        "000000.npz", "000001.npz", "000002.npz"]
    for name in os.listdir(jax_dir):
        g, w = np.load(os.path.join(port, name)), np.load(os.path.join(jax_dir, name))
        assert sorted(g.files) == sorted(w.files)
        for k in w.files:
            assert g[k].dtype == w[k].dtype, k
            if k in ("noise", "sigma", "timestep", "special_idx", "txt_mask"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-4, err_msg=k)


def test_cli_cached_training_matches_jax(cli_runs):
    """--cached_inputs_path: three steps from the bundles with the noise
    redrawn; the epoch-end checkpoints agree; no eval ran."""
    _assert_checkpoints_match(cli_runs, "cached", [3])
    trainer = cli_runs[("trainer", "cached")]
    assert trainer.cfg.cached_inputs and trainer.global_step == 3
    assert not any(f.startswith("eval") for f in os.listdir(cli_runs[("port", "cached")]))


def test_cli_raw_training_matches_jax(cli_runs):
    """Raw videos through two loader threads, a save every 2 steps, an eval
    every 2: steps 2 and 3 agree with JAX's, and both wrote the eval strip
    of step 2."""
    _assert_checkpoints_match(cli_runs, "raw", [2, 3])
    for pkg in ("port", "jax"):
        files = os.listdir(cli_runs[(pkg, "raw")])
        assert "eval-step-2.jpg" in files
    trainer = cli_runs[("trainer", "raw")]
    assert trainer.global_step == 3 and len(trainer.history) == 3
    assert all(np.isfinite(m["loss"]) for m in trainer.history)


def test_cli_resume_matches_jax(cli_runs):
    """--resume_from the raw run's directory with --num_epochs 2: its epoch-end
    sidecar rolls to epoch 1, three more steps run, and steps 5 and 6 agree
    with JAX's."""
    trainer = cli_runs[("trainer", "resumed")]
    assert (trainer.start_epoch, trainer.skip_batches) == (1, 0)
    assert trainer.global_step == 6 and len(trainer.history) == 3
    _assert_checkpoints_match(cli_runs, "resumed", [4, 6])


def test_cli_adafactor_accumulation_matches_jax(cli_runs):
    """--optimizer adafactor --gradient_accumulation_steps 2: three calls,
    the trainable moved by the second only; the checkpoint agrees with
    JAX's."""
    _assert_checkpoints_match(cli_runs, "adafactor", [3])
    trainer = cli_runs[("trainer", "adafactor")]
    assert trainer.opt_state.inner.count == 1 and trainer.opt_state.mini_step == 1


def test_train_cli_runs_without_jax(tmp_path):
    """The training CLI on a tree written by the port's synthetic-checkpoint
    tool (with its DINOv2) and a synthetic PhysicTran folder, in a fresh
    process: the data-process mode, then training from the bundles with
    Adafactor and accumulation, load neither JAX nor the JAX package."""
    import subprocess
    import sys
    import textwrap

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = textwrap.dedent(f"""
        import dataclasses, os, sys
        import torch
        torch.set_num_threads(2)
        from physicedit_torch.cli import train
        from physicedit_torch.models.dit import DiTConfig
        from physicedit_torch.pipeline.edit_pipeline import PhysicEditPipeline
        from physicedit_torch.pipeline.testing import SIZES, FakeTokenizer, random_pipeline
        from physicedit_torch.tools import make_synthetic_checkpoint as synth
        from physicedit_torch.train import synthetic
        base = {str(tmp_path)!r}
        dims = dataclasses.replace(SIZES["tiny"], rope_axes=(16, 56, 56), dit=DiTConfig(
            num_layers=2, dim=128, num_heads=1, head_dim=128, txt_in_dim=64, patch_dim=64,
            time_dim=32))
        synth.write_tree(random_pipeline(dims, "cpu", torch.float32), base + "/tree")
        synthetic.write_physictran_tree(base + "/data", n=2, frames=9, width=64, height=64)
        def fake_tokenizer(self, path):
            self.tokenizer = FakeTokenizer()
            self.boi_token_id, self.eoi_token_id = 96, 95
            self.edit_drop_idx = self.t2i_drop_idx = 2
        PhysicEditPipeline.load_tokenizer = fake_tokenizer
        common = ["--dataset_base_path", base + "/data", "--base_model_path", base + "/tree",
                  "--dinov2_path", base + "/tree/dinov2/model.safetensors", "--height", "64",
                  "--width", "64", "--num_frames", "9", "--lora_rank", "2", "--num_epochs", "1",
                  "--device", "cpu"]
        with synthetic.stand_in_reader():
            train.main(common + ["--data_process_output", base + "/cache"])
        trainer = train.main(common + ["--cached_inputs_path", base + "/cache", "--output_path",
                                       base + "/out", "--optimizer", "adafactor",
                                       "--gradient_accumulation_steps", "2"])
        assert trainer.global_step == 2 and os.path.exists(base + "/out/step-2.safetensors")
        assert "jax" not in sys.modules, "the port imported jax"
        assert "physicedit_tpu" not in sys.modules, "the port imported the JAX package"
        print("NO_JAX_OK")
    """)
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout

"""The port's models on a mesh against the JAX package on the CPU, with the
port on Gloo ranks (``tests/torch_dist_worker.py``) and the same weights
(``io/from_jax.py``):

- the tiny DiT with ``attn_impl="ring"`` over two ranks (plain, with the
  EliGen bias, and tensor-parallel on the ring's axis, where the heads are
  traded for the sequence), output and LoRA gradients, against JAX's ring
  DiT;
- ``shard()`` of the tiny pipeline at (1, 4) (heads that do not split over
  4 stay whole, D3) and at (2, 2): ``edit_batch`` and ``edit_batch_mixed``
  split over the data axis, the reasoner on the tensor-parallel VL model;
- one tensor-parallel and one data-parallel training step: the loss, the
  gradients the update applied and the updated trainable surface.

Tolerances are stated beside each comparison.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from PIL import Image

from physicedit_tpu.kernels.flash_attention import LOG2E
from physicedit_tpu.lora import init_dit_lora as j_init_lora
from physicedit_tpu.models import dit as j_dit
from physicedit_tpu.ops import rope as j_rope
from physicedit_tpu.parallel import sharding as j_sh
from physicedit_tpu.pipeline.testing import build_tiny_pipeline
from physicedit_tpu.sampling import flow_match as j_fm
from physicedit_tpu.train import loss as j_loss
from physicedit_torch.io.from_jax import config_from_jax, pipeline_from_jax, trainable_from_jax
from physicedit_torch.models.dit import DiTConfig
from physicedit_torch.pipeline.testing import FakeTokenizer
from physicedit_torch.train import train_step as t_ts
from tests.test_torch_pipeline import _random_vae
from tests.test_torch_train import (TRAIN_DIT, _assert_trees_close, _batch, _frozen,
                                    _jax_trainable, _np_tree, _torch_batch)
from tests.torch_dist_worker import run_world

torch.set_num_threads(2)

DIT_TOL = dict(atol=2e-4, rtol=2e-4)     # fp32, two blocks: the DiT tests' order of rounding
GRAD_TOL = 1e-4                          # rel-L2 of each gradient leaf (tests/test_torch_train)
LOSS_TOL = 1e-5

RING_DIT = j_dit.DiTConfig(num_layers=2, dim=64, num_heads=2, head_dim=32, txt_in_dim=48,
                           patch_dim=64, time_dim=32)


def _lora(cfg, rank=4, seed=1):
    lora = _np_tree(j_init_lora(jax.random.PRNGKey(seed), cfg, rank=rank))
    rng = np.random.default_rng(seed)
    for leaf in lora.values():
        leaf["B"] = (0.05 * rng.normal(size=leaf["B"].shape)).astype(np.float32)
    return lora


def _dit_inputs():
    rng = np.random.default_rng(0)
    s_i, s_t = 32, 9                     # joint 41: padded to 42 over two ranks
    img = rng.normal(size=(2, s_i, 64)).astype(np.float32)
    txt = rng.normal(size=(2, s_t, 48)).astype(np.float32)
    t = np.array([0.5, 0.3], np.float32)
    ropes = [np.asarray(r, np.float32) for r in
             j_rope.build_rope_tables([(1, 4, 8)], s_t, axes_dim=(8, 12, 12))]
    mask = np.ones((2, s_t), bool)
    mask[1, 6:] = False
    s = s_t + s_i
    bias = np.where(rng.random((2, s, s)) < 0.2, -1e30, 0.0).astype(np.float32)
    bias[:, :, s_t:s_t + 1] = 0.0        # every query keeps a live key
    cot = rng.normal(size=(2, s_i, 64)).astype(np.float32)
    return dict(img=img, txt=txt, t=t, ropes=ropes, mask=mask, bias=bias, cot=cot)


@pytest.fixture(scope="module")
def dit_world(tmp_path_factory):
    params = _np_tree(j_dit.init_dit_params(jax.random.PRNGKey(3), RING_DIT))
    lora, x = _lora(RING_DIT), _dit_inputs()
    tx = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in x.items()}
    inputs = {"params": params, "cfg": config_from_jax(RING_DIT, DiTConfig), "lora": lora,
              "x": {"args": (tx["img"], tx["txt"], tx["t"],
                             *(torch.from_numpy(r) for r in x["ropes"])),
                    "mask": tx["mask"], "bias_log2": tx["bias"] * LOG2E, "cot": tx["cot"]}}
    ranks = run_world("dit", inputs, 2, str(tmp_path_factory.mktemp("dit")))
    return params, lora, x, ranks


def _jax_ring_dit(params, lora, x, use_bias):
    mesh = j_sh.create_mesh(1, 2)
    j_dit.set_ring_context(mesh, j_sh.MODEL_AXIS)

    def loss(lo):
        y = j_dit.dit_forward(params, RING_DIT, x["img"], x["txt"], x["t"], *x["ropes"],
                              txt_key_mask=x["mask"], attn_impl="ring", lora=lo,
                              attn_bias=x["bias"] if use_bias else None)
        return jnp.sum(y * x["cot"]), y

    (_, y), grads = jax.value_and_grad(loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, lora))
    return np.asarray(y), _np_tree(grads)


@pytest.mark.parametrize("case", ["ring", "ring_bias", "ring_tp"])
def test_ring_dit_matches_jax(dit_world, case):
    """The ring DiT (two ranks) and its LoRA gradients against JAX's ring
    DiT on a (1, 2) mesh; ``ring_tp`` also splits the blocks' heads and MLPs
    over the ring's axis.  Every rank returns the whole output."""
    params, lora, x, ranks = dit_world
    want, grads = _jax_ring_dit(params, lora, x, case == "ring_bias")
    for r in ranks:
        np.testing.assert_allclose(r[case]["out"].numpy(), want, **DIT_TOL)
        got = {}
        for name, g in r[case]["grads"].items():
            leaf, ab = name.split(".")
            got.setdefault(leaf, {})[ab] = g.numpy()
        _assert_trees_close(got, grads, GRAD_TOL)


# ---------------------------------------------------------------------------
# The pipeline: shard() and data-parallel serving
# ---------------------------------------------------------------------------

def _image(seed, w=64, h=64):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


SINGLE_KW = dict(edit_image=_image(1), height=64, width=64, seed=5, num_inference_steps=2,
                 have_text_reasoning=False, edit_image_auto_resize=False)
BATCH = dict(prompts=["move the red box", "tilt the big cup now"],
             images=[_image(40), _image(41)],
             kw=dict(height=64, width=64, seeds=[5, 9], num_inference_steps=2,
                     have_text_reasoning=False))
MIXED = dict(prompts=["a", "b b", "c"], images=[_image(50, 64, 64), _image(51, 96, 64),
                                                _image(52, 64, 64)],
             kw=dict(seeds=[1, 2, 3], num_inference_steps=2, have_text_reasoning=False))


@pytest.fixture(scope="module")
def pipe_world(tmp_path_factory):
    jpipe = build_tiny_pipeline()
    jpipe.vae_params = _random_vae(jpipe.vae_params)
    tpipe = pipeline_from_jax(jpipe, device="cpu")
    tpipe.tokenizer = FakeTokenizer()        # the port's own (the workers load no JAX)
    inputs = {"pipe": tpipe, "prompt": "tilt the lamp", "single_kw": SINGLE_KW,
              "batch": BATCH, "mixed": MIXED}
    return jpipe, run_world("pipeline", inputs, 4, str(tmp_path_factory.mktemp("pipe")))


def _close_images(got, want):
    """Within one uint8 level everywhere and below 1.0 on average (JAX's own
    sharded-pipeline test allows a mean error below 1.0)."""
    got, want = np.asarray(got, np.int16), np.asarray(want, np.int16)
    assert want.std() > 0 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1 and np.abs(got - want).mean() < 1.0


def test_shard_pipeline_matches_jax(pipe_world):
    """shard() at (1, 4): the DiT's two heads and the VL's two KV heads do
    not split over 4, so both attentions stay whole on every rank (D3) and
    the modulations, MLPs and lm_head split; the edit equals JAX's on every
    rank."""
    jpipe, ranks = pipe_world
    want = jpipe("tilt the lamp", **SINGLE_KW)
    for r in ranks:
        _close_images(r["single"], want)


def test_data_parallel_edit_batch_matches_jax(pipe_world):
    """edit_batch at (2, 2): each data rank denoises one item with its DiT
    split over two ranks, and every rank returns both images in order."""
    jpipe, ranks = pipe_world
    want = jpipe.edit_batch(BATCH["prompts"], BATCH["images"], **BATCH["kw"])
    for r in ranks:
        assert len(r["batch"]) == 2
        for g, w in zip(r["batch"], want):
            _close_images(g, w)


def test_data_parallel_edit_batch_mixed_matches_jax(pipe_world):
    """edit_batch_mixed at (2, 2): the 64x64 group of two splits over the
    data axis, the group of one runs on every rank."""
    jpipe, ranks = pipe_world
    want = jpipe.edit_batch_mixed(MIXED["prompts"], MIXED["images"], **MIXED["kw"])
    for r in ranks:
        for g, w in zip(r["mixed"], want):
            _close_images(g, w)


def test_tensor_parallel_reasoner_matches_jax(pipe_world):
    """The reasoner's prefill and greedy decode on the VL model split over
    two ranks (its 4 query and 2 KV heads by whole heads, the KV cache of
    each rank's heads, the lm_head's logits gathered) write JAX's text."""
    jpipe, ranks = pipe_world
    want = jpipe.reason_physical_batch(BATCH["prompts"], BATCH["images"], max_new_tokens=6)
    assert all(r["reason"] == want for r in ranks) and all(want)


# ---------------------------------------------------------------------------
# Training: one tensor-parallel and one data-parallel step
# ---------------------------------------------------------------------------

LR = 1e-3


@pytest.fixture(scope="module")
def train_world(tmp_path_factory):
    """The port's two steps on two Gloo ranks, and ``jax.value_and_grad`` of
    the JAX loss over the same global batch of two (Pallas in interpret
    mode)."""
    params = _frozen(False)
    tree = _jax_trainable(TRAIN_DIT, 32, seed=4)
    b0, b1 = _batch(TRAIN_DIT, 32, seed=5), _batch(TRAIN_DIT, 32, seed=6, frames=2)
    shared = ("img_cos", "img_sin", "txt_cos", "txt_sin")     # the RoPE tables
    batch = {k: b0[k] if k in shared else np.concatenate([b0[k], b1[k]]) for k in b0}
    t_min, t_max = j_fm.adapter_t_range()
    inputs = {"params": params, "cfg": config_from_jax(TRAIN_DIT, DiTConfig),
              "trainable": tree, "batch": _torch_batch(batch), "lr": LR,
              "t_min": t_min, "t_max": t_max}
    ranks = run_world("train", inputs, 2, str(tmp_path_factory.mktemp("train")))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

    def loss_fn(tr):
        return j_loss.physic_training_loss(tr, {"dit": params}, TRAIN_DIT, jbatch, t_min,
                                           t_max, attn_impl="pallas", use_remat=True)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        (want, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, tree))
    return tree, float(want), _np_tree(grads), ranks


@pytest.mark.parametrize("mesh", ["tp", "dp"])
def test_parallel_train_step_matches_jax(train_world, mesh):
    """One step on a global batch of two: ``tp`` (1, 2) splits the frozen
    DiT's heads and MLPs, ``dp`` (2, 1) gives each rank one row and
    all-reduce-averages the gradients.  The loss and the gradients the
    update applied equal ``jax.value_and_grad`` of the JAX loss over the
    global batch (its mean over rows); the updated trainable surface is the
    port's AdamW step from the original weights on those gradients, on
    every rank alike."""
    tree, want, grads, ranks = train_world
    # the update from the original weights on the gradients rank 0 applied
    trainable = trainable_from_jax(tree, TRAIN_DIT, device="cpu")
    applied = trainable_from_jax(_np_tree(ranks[0][mesh]["grads"]), TRAIN_DIT, device="cpu")
    for p, g in zip(trainable.parameters(), applied.parameters()):
        p.grad = g.detach()
    opt = t_ts.make_optimizer(LR, 1e-2)
    opt.step(trainable, opt.init(trainable))
    updated = {"lora": _flat(_tree_np(trainable.lora)),
               "adapters": _flat(_tree_np(trainable.adapters))}
    for r in ranks:
        got = r[mesh]
        np.testing.assert_allclose(got["loss"], want, rtol=LOSS_TOL)
        _assert_trees_close(_np_tree(got["grads"]), grads, GRAD_TOL)
        for part in ("lora", "adapters"):
            for name, value in _flat(got["params"][part]).items():
                np.testing.assert_allclose(np.asarray(value), updated[part][name],
                                           atol=1e-7, rtol=1e-6, err_msg=name)


def _flat(tree, prefix=""):
    """A nest of dicts and lists as {path: leaf}."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _tree_np(module):
    from physicedit_torch.io.from_jax import to_jax_tree

    return _np_tree(to_jax_tree(module))

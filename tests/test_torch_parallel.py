"""The port's multi-GPU attention and specs against the JAX package on the
CPU: the partition specs of the DiT and the VL text model, the split and
reassembly of a weight, ``ring_attention`` in both lanes (JAX's ``pallas``
in interpret mode, and ``xla``) forward and gradients at a ragged S with
masked keys, the EliGen-biased ring, ``ulysses_attention`` and
``ops.attention(impl="ring")``.  The port runs on four Gloo ranks
(``tests/torch_dist_worker.py``, one world for the file), JAX on four of
its eight virtual CPU devices.  The kernels lane's n virtual ranks in one
process (``virtual_ring_fixedmax``, the card's check) are held against the
Gloo ring and JAX's monolithic K1 / K8.

Tolerances: the fp32 fixed-max partials add with no rescale, so the ring
equals one attention call to fp32 rounding; every ring comparison allows
2e-5 absolute (and relative) on the live rows.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from physicedit_tpu.kernels import flash_attention as jfa
from physicedit_tpu.models import dit as j_dit
from physicedit_tpu.models import qwen_vl as j_text
from physicedit_tpu.ops.attention import sdpa_bnsd as j_sdpa
from physicedit_tpu.parallel import ring_attention as j_ra
from physicedit_tpu.parallel import sharding as j_sh
from physicedit_tpu.pipeline.testing import _rand_text_params
from physicedit_torch.io.from_jax import dit_from_jax, text_from_jax
from physicedit_torch.kernels import flash_attention as tfa
from physicedit_torch.parallel import ring_attention as t_ra
from physicedit_torch.parallel import sharding as t_sh
from tests.torch_dist_worker import run_world

torch.set_num_threads(2)

WORLD = 4
RING_TOL = dict(atol=2e-5, rtol=2e-5)
B, N, S, D = 2, 2, WORLD * 37, 128      # 37 rows a rank: ragged against every tile


def _np(x):
    return np.asarray(x, np.float32)


def _inputs():
    rng = np.random.default_rng(0)

    def t(*shape, sc=1.0):
        return (rng.normal(size=shape) * sc).astype(np.float32)

    q, k, v = t(B, N, S, D, sc=0.3), t(B, N, S, D, sc=0.3), t(B, N, S, D)
    mask = np.ones((B, S), bool)
    mask[0, 120:] = False             # a tail across the last two ranks
    mask[1, 3:9] = False              # a hole inside the first
    g = t(B, N, S, D) * mask[:, None, :, None]   # no cotangent on masked rows
    bias = np.where(rng.random((B, S, S)) < 0.2, -1e30, 0.0).astype(np.float32)
    bias[:, :, 0] = 0.0               # every row keeps a live key
    uq, uk, uv = t(1, 8, WORLD * 16, 32), t(1, 8, WORLD * 16, 32), t(1, 8, WORLD * 16, 32)
    umask = np.ones((1, WORLD * 16), bool)
    umask[0, 50:] = False
    return dict(q=q, k=k, v=v, mask=mask, g=g, bias=bias, uq=uq, uk=uk, uv=uv, umask=umask)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One Gloo world of four ranks for the file's ring calls."""
    x = _inputs()
    tt = {k: torch.from_numpy(v) for k, v in x.items()}
    common = dict(q=tt["q"], k=tt["k"], v=tt["v"], mask=tt["mask"], g=tt["g"])
    calls = {"kernels": dict(common, impl="kernels"), "dense": dict(common, impl="dense"),
             "bias": dict(common, bias=tt["bias"])}
    inputs = {"ring": calls,
              "ulysses": dict(q=tt["uq"], k=tt["uk"], v=tt["uv"], mask=tt["umask"]),
              "attention": dict(q=tt["q"].transpose(1, 2), k=tt["k"].transpose(1, 2),
                                v=tt["v"].transpose(1, 2), mask=tt["mask"])}
    ranks = run_world("ring", inputs, WORLD, str(tmp_path_factory.mktemp("ring")))
    return x, ranks


def _gathered(ranks, call, key):
    return torch.cat([r[call][key] for r in ranks], dim=2).numpy()


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _jax_ring(x, impl, bias=None):
    """JAX's ring_attention on a (1, 4) mesh: the output and, through the
    cotangent, the gradients of q, k and v."""
    mesh = j_sh.create_mesh(1, WORLD)
    mask = jnp.asarray(x["mask"])
    b = None if bias is None else jnp.asarray(bias)

    def loss(q, k, v):
        out = j_ra.ring_attention(q, k, v, mask, mesh, axis=j_sh.MODEL_AXIS, impl=impl, bias=b)
        return jnp.sum(out * x["g"]), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x[n]) for n in "qkv"))
    return _np(out), [_np(g) for g in grads]


def _assert_ring(x, ranks, call, out, grads):
    live = x["mask"]
    for b in range(B):
        np.testing.assert_allclose(_gathered(ranks, call, "out")[b][:, live[b]],
                                   out[b][:, live[b]], **RING_TOL)
    for name, want in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(_gathered(ranks, call, name), want, **RING_TOL,
                                   err_msg=name)


def test_ring_kernels_lane_matches_jax_pallas(world, interpret):
    """The kernels lane (K1 per hop, K8 per backward hop; their plain
    versions on the CPU) against JAX's pallas ring: output and gradients."""
    x, ranks = world
    _assert_ring(x, ranks, "kernels", *_jax_ring(x, "pallas"))


def test_ring_dense_lane_matches_jax_xla(world):
    """The dense lane (online softmax, torch ops) against JAX's xla ring:
    output and gradients (JAX differentiates through its scan and
    ppermutes; the port runs the second ring)."""
    x, ranks = world
    _assert_ring(x, ranks, "dense", *_jax_ring(x, "xla"))


def test_ring_with_entity_bias_matches_jax(world):
    """A biased call takes the dense lane in both packages; each hop reads
    the bias columns of the chunk it holds."""
    x, ranks = world
    _assert_ring(x, ranks, "bias", *_jax_ring(x, None, bias=x["bias"]))


def test_ulysses_matches_jax(world):
    x, ranks = world
    mesh = j_sh.create_mesh(1, WORLD)
    want = _np(j_ra.ulysses_attention(*(jnp.asarray(x[n]) for n in ("uq", "uk", "uv")),
                                      jnp.asarray(x["umask"]), mesh, axis=j_sh.MODEL_AXIS))
    got = _gathered(ranks, "ulysses", "out")
    live = x["umask"][0]
    np.testing.assert_allclose(got[:, :, live], want[:, :, live], **RING_TOL)


def test_attention_ring_impl_matches_dense(world):
    """ops.attention(impl="ring") on full BSND inputs (padded to the axis,
    split, gathered back) on every rank equals JAX's dense attention."""
    x, ranks = world
    want = _np(j_sdpa(*(jnp.asarray(x[n]) for n in "qkv"), key_mask=jnp.asarray(x["mask"])))
    for r in ranks:
        got = r["attention"]["out"].transpose(1, 2).numpy()
        for b in range(B):
            live = x["mask"][b]
            np.testing.assert_allclose(got[b][:, live], want[b][:, live], **RING_TOL)


def test_virtual_ring_matches_gloo_ring_and_jax(world, interpret):
    """virtual_ring_fixedmax (four ranks in one process through the same
    hops, the card's single-GPU check) equals the Gloo ring and JAX's one
    K1 call (out and l); its backward equals the Gloo ring's and JAX's one
    K8 call (``_fm_bwd``, prescaled)."""
    x, ranks = world
    q, k, v, g = (torch.from_numpy(x[n]) for n in ("q", "k", "v", "g"))
    mask = torch.from_numpy(x["mask"])
    out, l = t_ra.virtual_ring_fixedmax(q, k, v, mask, WORLD)
    live = x["mask"]
    gloo = _gathered(ranks, "kernels", "out")
    for b in range(B):
        np.testing.assert_allclose(out.numpy()[b][:, live[b]], gloo[b][:, live[b]], **RING_TOL)

    qs = tfa._prescale(q)
    bias = jnp.where(jnp.asarray(x["mask"]), 0.0, jfa.NEG_INF)[:, None, :].astype(jnp.float32)
    bq, bk = jfa._pick_blocks(S, S)
    pad = (-S) % max(bq, bk)

    def padded(a):
        return jnp.pad(jnp.asarray(a), ((0, 0), (0, 0), (0, pad), (0, 0)))

    jbias = jnp.pad(bias, ((0, 0), (0, 0), (0, pad)), constant_values=jfa.NEG_INF)
    j_out, j_l = jfa._fixedmax_bnsd_lse(padded(qs.numpy()), padded(x["k"]), padded(x["v"]),
                                        jbias, bq, bk, clamp=True, prescaled=True)
    j_out, j_l = _np(j_out)[:, :, :S], _np(j_l)[:, :, :S, 0]
    for b in range(B):
        np.testing.assert_allclose(out.numpy()[b][:, live[b]], j_out[b][:, live[b]], **RING_TOL)
    np.testing.assert_allclose(l.numpy(), j_l, rtol=2e-5)

    dq, dk, dv = t_ra.virtual_ring_fixedmax_bwd(qs, k, v, mask, g, out, l, WORLD)
    np.testing.assert_allclose((dq * tfa._prescale(torch.ones(D))).numpy(),
                               _gathered(ranks, "kernels", "dq"), **RING_TOL)
    np.testing.assert_allclose(dk.numpy(), _gathered(ranks, "kernels", "dk"), **RING_TOL)
    np.testing.assert_allclose(dv.numpy(), _gathered(ranks, "kernels", "dv"), **RING_TOL)
    dd = jnp.sum(jnp.asarray(x["g"]) * jnp.asarray(out.numpy()), axis=-1)
    l8 = jnp.broadcast_to(jnp.asarray(l.numpy())[..., None], l.shape + (8,))
    jdq, jdk, jdv = jfa._fm_bwd(padded(qs.numpy()), padded(x["k"]), padded(x["v"]), jbias,
                                padded(x["g"]), jnp.pad(jnp.broadcast_to(dd[..., None],
                                                                         dd.shape + (8,)),
                                                        ((0, 0), (0, 0), (0, pad), (0, 0))),
                                jnp.pad(l8, ((0, 0), (0, 0), (0, pad), (0, 0)),
                                        constant_values=1.0),
                                bq, bk, clamp=True, prescaled=True)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.numpy(), _np(want)[:, :, :S], **RING_TOL)


# ---------------------------------------------------------------------------
# Specs and the split of a weight
# ---------------------------------------------------------------------------

SPEC_DIT = j_dit.DiTConfig(num_layers=2, dim=64, num_heads=2, head_dim=32, txt_in_dim=48,
                           patch_dim=64, time_dim=32)


def _jax_leaf(tree, name):
    """The JAX leaf (or spec) of a port parameter name: ``blocks.{i}`` /
    ``layers.{i}`` are the stacked trees, ``weight`` / ``bias`` are ``w`` /
    ``b``; the MLP ModuleDicts keep their keys."""
    node = tree
    for part in name.split("."):
        if part.isdigit():
            continue
        node = node[{"weight": "w", "bias": "b"}.get(part, part)]
    return node


def _expected_spec(split, jax_ndim, is_bias):
    spec = [None] * jax_ndim
    if split is not None:
        # the port's [out, in] dim 0 is JAX's last axis, dim 1 its second-last
        spec[jax_ndim - 1 if split.dim == 0 or is_bias else jax_ndim - 2] = j_sh.MODEL_AXIS
    return tuple(spec)


def _spec_tuple(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("model", ["dit", "vl_text"])
def test_specs_match_jax(model):
    """Every port parameter is split where JAX's spec splits its leaf and
    replicated where JAX replicates it: JAX's column split is the port's
    ``Split(0)``, its row split ``Split(1)``."""
    if model == "dit":
        params = j_dit.init_dit_params(jax.random.PRNGKey(0), SPEC_DIT)
        jspecs = j_sh.dit_param_specs(params)
        tspecs = t_sh.dit_param_specs(dit_from_jax(params, SPEC_DIT, device="cpu"))
    else:
        params = _rand_text_params(jax.random.PRNGKey(0), j_text.TINY_TEXT)
        jspecs = j_sh.qwen_vl_text_param_specs(params)
        tspecs = t_sh.qwen_vl_text_param_specs(text_from_jax(params, j_text.TINY_TEXT,
                                                             device="cpu"))
    n_split = 0
    for name, split in tspecs.items():
        leaf = np.asarray(_jax_leaf(params, name))
        want = _spec_tuple(_jax_leaf(jspecs, name), leaf.ndim)
        assert _expected_spec(split, leaf.ndim, name.endswith("bias")) == want, name
        n_split += split is not None
    # per block / layer: DiT 16 (mods, QKVs with their biases, outputs, MLPs),
    # VL 10 (q, k, v with biases, o, gate, up, down), plus the VL's lm_head
    assert n_split == (2 * 16 if model == "dit" else 2 * 10 + 1)


def test_shard_tensor_reassembles_by_whole_heads():
    """The ranks' slices of a fused QKV weight take whole heads of each part
    and reassemble it bit for bit; a row split cuts the input features."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(3 * 4 * 8, 16, generator=g)          # 3 parts x 4 heads x 8
    split = t_sh.Split(0, parts=3, unit=8)
    for tp in (2, 4):
        shards = [t_sh.shard_tensor(w, split, r, tp) for r in range(tp)]
        assert all(s.is_contiguous() and s.shape == (3 * 4 * 8 // tp, 16) for s in shards)
        back = torch.cat([s.view(3, -1, 16) for s in shards], dim=1).reshape(w.shape)
        assert torch.equal(back, w) and torch.equal(t_sh.unshard_tensor(shards, split), w)
        assert torch.equal(shards[1].view(3, -1, 16)[0], w[4 * 8 // tp:2 * 4 * 8 // tp])
    row = [t_sh.shard_tensor(w, t_sh.Split(1), r, 4) for r in range(4)]
    assert torch.equal(torch.cat(row, dim=1), w)
    assert torch.equal(t_sh.unshard_tensor(row, t_sh.Split(1)), w)
    bias = torch.randn(3 * 4 * 8, generator=g)
    assert torch.equal(t_sh.unshard_tensor([t_sh.shard_tensor(bias, split, r, 2)
                                            for r in range(2)], split), bias)
    assert not t_sh.splits_evenly((3 * 4 * 8, 16), split, 8)   # 4 heads over 8 ranks: whole

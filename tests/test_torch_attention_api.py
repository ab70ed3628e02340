"""The attention family behind ``physicedit_torch.ops.attention`` against
the JAX package, fp32 on the CPU with the same numpy inputs: the plain
versions of K10 / K10b (online softmax, without and with a head-shared bias)
and of K1' (fixed-max without row sums, ``prescaled`` and ``clamp`` both
ways) against the Pallas kernels in interpret mode; the public
``attention(impl, variant)``, the BSND ``flash_attention`` and its dense
rule, and the DiT's ``attn_impl``.

Tolerances: fp32 on both sides.  K1' shares the JAX kernel's exp2
arithmetic (1e-5).  K10 folds log2(e) into the fp32 scale and the bias and
uses exp2 where JAX uses exp; the exponents then differ by a few ulps of
their size, so rows with logits of ~300 carry ~1e-4 (stated per case).
"""

import functools
import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from physicedit_tpu.kernels import flash_attention as jfa
from physicedit_tpu.models import dit as j_dit
from physicedit_tpu.ops import rope as j_rope
from physicedit_torch.io.from_jax import dit_from_jax
from physicedit_torch.kernels import flash_attention as tfa
from physicedit_torch.ops import attention as t_attn

torch.set_num_threads(2)

# the module (physicedit_tpu.ops re-exports its function under the same name)
j_attn = importlib.import_module("physicedit_tpu.ops.attention")

NEG = -1e30
# the port's impl names for JAX's
IMPL_NAMES = {"dense": "xla", "kernels": "pallas"}


@pytest.fixture
def interpret(monkeypatch):
    """Run pallas_call in interpreter mode on the CPU (as the JAX tests do)."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _inputs(seed, b, n, sq, sk, d=128, scale=1.0):
    """q, k RMS-normed times ``scale`` (|q.k| / sqrt(d) reaches about
    scale^2 * 3), v standard normal."""
    rng = np.random.default_rng(seed)

    def rms(x):
        return x / np.sqrt((x ** 2).mean(-1, keepdims=True))

    q = (rms(rng.normal(size=(b, n, sq, d))) * scale).astype(np.float32)
    k = (rms(rng.normal(size=(b, n, sk, d))) * scale).astype(np.float32)
    v = rng.normal(size=(b, n, sk, d)).astype(np.float32)
    return rng, q, k, v


def _fp64_softmax_attention(q, k, v, mask, bias=None):
    """Dense attention in float64 over the live keys; rows with none are 0."""
    s = np.einsum("bnqd,bnkd->bnqk", q.astype(np.float64), k.astype(np.float64))
    s /= np.sqrt(q.shape[-1])
    if bias is not None:
        s = s + bias[:, None].astype(np.float64)
    live = mask[:, None, None, :] & (s > -1e29)
    s = np.where(live, s, -np.inf)
    m = s.max(-1, keepdims=True)
    p = np.where(live, np.exp(s - np.where(np.isfinite(m), m, 0.0)), 0.0)
    l = p.sum(-1, keepdims=True)
    return np.einsum("bnqk,bnkd->bnqd", p / np.maximum(l, 1e-300), v.astype(np.float64))


# ---------------------------------------------------------------------------
# K10 / K10b
# ---------------------------------------------------------------------------

K10_CASES = {
    # name: (seed, b, n, sq, sk, q/k scale, key-masked span per batch row,
    #        bias rows blocked (-1e30), {row: key spans blocked by BAND}, atol)
    "ragged_300_key_padding": (1, 2, 2, 300, 300, 1.0, [(250, 300), (0, 0)], [], {}, 1e-5),
    "sq_lt_sk": (2, 1, 2, 96, 384, 1.0, [(300, 384)], [], {}, 1e-5),
    "masked_batch_row": (0, 2, 2, 128, 200, 1.0, [(0, 0), (0, 200)], [5, 77], {}, 1e-5),
    # |q.k / sqrt(d)| up to about 300 (q and k x 10): no fixed max holds here
    "unbounded_logits": (3, 1, 2, 160, 256, 10.0, [(230, 256)], [], {}, 2e-4),
    # the card kernel's 128-key tiles: one live key in the last tile, a
    # ragged last tile, a mask hole across key 128, S_q > S_k
    "tile_edge_sk_129": (4, 1, 2, 129, 129, 1.0, [(0, 0)], [], {}, 1e-5),
    "tile_edge_sk_255": (5, 2, 2, 255, 255, 1.0, [(0, 0), (200, 255)], [], {}, 1e-5),
    "hole_across_key_128": (6, 2, 2, 300, 300, 1.0, [(100, 160), (0, 0)], [], {}, 1e-5),
    "sq_300_gt_sk_129": (7, 1, 2, 300, 129, 1.0, [(120, 125)], [], {}, 1e-5),
    # K10b: rows whose first key tile (and keys 200-239) the bias blocks,
    # beside rows it blocks wholly, at -1e30 and at BAND
    "first_tile_blocked": (8, 1, 2, 160, 300, 1.0, [(280, 300)], [4],
                           {3: [(0, 128), (200, 240)], 130: [(0, 128), (200, 240)],
                            5: [(0, 300)]}, 1e-5),
}
# A bias that blocks a key (in exp2 units -8.7e29, below the -5e29 threshold)
# but leaves its x above the running max's start of -1e30: only the
# threshold test keeps exp2(x - m) from weighing it by 1 in a row it blocks
# wholly (a -1e30 bias, -1.44e30 in exp2 units, gives exp2(x - m) = 0 alone).
BAND = -6e29


@pytest.mark.parametrize("with_bias", [False, True], ids=["k10", "k10b"])
@pytest.mark.parametrize("case", list(K10_CASES))
def test_k10_plain_matches_pallas(case, with_bias, interpret):
    seed, b, n, sq, sk, scale, spans, blocked, banded, atol = K10_CASES[case]
    rng, q, k, v = _inputs(seed, b, n, sq, sk, scale=scale)
    mask = np.ones((b, sk), bool)
    for i, (m0, m1) in enumerate(spans):
        mask[i, m0:m1] = False
    bias = None
    if with_bias:
        bias = np.where(rng.random((b, sq, sk)) < 0.2, NEG,
                        rng.normal(size=(b, sq, sk))).astype(np.float32)
        bias[:, :, 0] = 0.0
        bias[:, blocked] = NEG          # query rows with no live key
        for r, row_spans in banded.items():
            for k0, k1 in row_spans:
                bias[:, r, k0:k1] = BAND
    want = np.asarray(jfa.flash_attention_bnsd(
        *map(jnp.asarray, (q, k, v, mask)), bias=None if bias is None else jnp.asarray(bias),
        variant="online"))
    got = tfa.flash_attention_bnsd(*_t(q, k, v, mask), bias=None if bias is None
                                   else torch.from_numpy(bias), variant="online").numpy()
    assert got.shape == want.shape == (b, n, sq, 128)
    # rows with a live key are compared; rows without one are 0 in the port
    # (the JAX kernel gives a mean of V over its block padding there)
    live = mask.any(-1)[:, None, None].repeat(sq, 2)
    if bias is not None:
        live = live & ((bias > -1e29) & mask[:, None, :]).any(-1)[:, None]
    live = np.broadcast_to(live, (b, n, sq))
    assert live.any() and (case != "masked_batch_row" or not live.all())
    if bias is not None and banded:
        assert live[:, :, [3, 130]].all() and not live[:, :, [4, 5]].any()
    np.testing.assert_allclose(got[live], want[live], atol=atol, rtol=atol)
    assert np.all(got[~live] == 0.0)
    ref = _fp64_softmax_attention(q, k, v, mask, bias)
    np.testing.assert_allclose(got[live], ref[live], atol=atol, rtol=atol)


def test_k10_holds_unbounded_logits_where_fixedmax_cannot():
    """At |q.k / sqrt(d)| ~ 300 the running max keeps K10 on the float64
    softmax, while the fixed-max kernel's clamp flattens it: why K10 exists."""
    _, q, k, v = _inputs(3, 1, 2, 128, 256, scale=10.0)
    mask = np.ones((1, 256), bool)
    ref = _fp64_softmax_attention(q, k, v, mask)
    logits = np.einsum("bnqd,bnkd->bnqk", q, k) / np.sqrt(128)
    assert np.abs(logits).max() > 250
    online = tfa.flash_attention_bnsd(*_t(q, k, v, mask), variant="online").numpy()
    fixed = tfa.flash_attention_bnsd(*_t(q, k, v, mask), variant="fixedmax").numpy()
    assert np.abs(online - ref).max() < 2e-4
    assert np.abs(fixed - ref).max() > 0.1


def test_k10_bias_row_view_equals_contiguous_copy():
    """K10b reads the bias rows with a pitch and a batch stride: a strided
    view (the slim block's rows) gives what its contiguous copy gives."""
    rng, q, k, v = _inputs(5, 2, 2, 64, 200)
    full = rng.normal(size=(2, 300, 200)).astype(np.float32)
    view = torch.from_numpy(full)[:, 40:104]
    assert not view.is_contiguous()
    got = tfa.online_attention(*_t(q, k, v), bias=view)
    want = tfa.online_attention(*_t(q, k, v), bias=view.contiguous())
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# K1'
# ---------------------------------------------------------------------------

K1P_CASES = {
    # name: (b, n, sq, sk, q/k scale, key-masked span per batch row)
    "ragged_key_padding": (2, 2, 200, 200, 1.0, [(150, 200), (0, 0)]),
    "sq_lt_sk": (1, 2, 64, 256, 1.0, [(200, 256)]),
    "masked_batch_row": (2, 2, 128, 128, 1.0, [(0, 0), (0, 128)]),
    "clamp_binds": (1, 2, 128, 128, 12.0, [(100, 128)]),
    # a ragged last 128-key stage of the card kernels
    "tile_edge_sk_255": (1, 2, 255, 255, 1.0, [(200, 255)]),
}


@pytest.mark.parametrize("clamp", [True, False], ids=["clamp", "noclamp"])
@pytest.mark.parametrize("prescaled", [True, False], ids=["prescaled", "scaled"])
@pytest.mark.parametrize("case", list(K1P_CASES))
def test_k1prime_plain_matches_pallas(case, prescaled, clamp, interpret):
    b, n, sq, sk, scale, spans = K1P_CASES[case]
    if case == "clamp_binds" and not clamp:
        scale = 4.0             # no clamp: logits stay where exp2 does not overflow
    _, q, k, v = _inputs(10 + sorted(K1P_CASES).index(case), b, n, sq, sk, scale=scale)
    mask = np.ones((b, sk), bool)
    for i, (m0, m1) in enumerate(spans):
        mask[i, m0:m1] = False
    if prescaled:
        q = (q * np.float32(jfa.LOG2E / np.sqrt(128))).astype(np.float32)
    # the JAX kernel takes block multiples and a [B, 1, S_k] key bias
    blk = 64
    pq, pk = (-sq) % blk, (-sk) % blk
    qp = np.pad(q, ((0, 0), (0, 0), (0, pq), (0, 0)))
    kp = np.pad(k, ((0, 0), (0, 0), (0, pk), (0, 0)))
    vp = np.pad(v, ((0, 0), (0, 0), (0, pk), (0, 0)))
    key_bias = np.where(np.pad(mask, ((0, 0), (0, pk))), 0.0, NEG).astype(np.float32)[:, None]
    want = np.asarray(jfa._fixedmax_bnsd(*map(jnp.asarray, (qp, kp, vp, key_bias)), blk, blk,
                                         clamp=clamp, prescaled=prescaled))[:, :, :sq]
    got = tfa.fixedmax_bnsd(*_t(q, k, v, mask), clamp=clamp, prescaled=prescaled).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    if case == "masked_batch_row":
        assert np.all(got[1] == 0.0)


def test_k1prime_is_forward_only():
    _, q, k, v = _inputs(0, 1, 1, 8, 8)
    q = torch.from_numpy(q).requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        tfa.fixedmax_bnsd(q, *_t(k, v))
    with pytest.raises(RuntimeError, match="forward only"):
        tfa.online_attention(q, *_t(k, v))


# ---------------------------------------------------------------------------
# The public API: ops.attention.attention, flash_attention, default_impl
# ---------------------------------------------------------------------------

def _bsnd(seed, b, s, n, d, scale=1.0):
    _, q, k, v = _inputs(seed, b, n, s, s, d=d, scale=scale)
    return [x.transpose(0, 2, 1, 3).copy() for x in (q, k, v)]


@pytest.mark.parametrize("variant", ["fixedmax", "online"])
@pytest.mark.parametrize("impl", ["dense", "kernels"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
def test_attention_matches_jax(impl, variant, with_bias, interpret):
    q, k, v = _bsnd(20, 2, 150, 2, 128)
    mask = np.ones((2, 150), bool)
    mask[1, 120:] = False
    bias = None
    if with_bias:
        bias = np.random.default_rng(21).normal(size=(2, 1, 150, 150)).astype(np.float32)
    want = np.asarray(j_attn.attention(
        *map(jnp.asarray, (q, k, v, mask)), bias=None if bias is None else jnp.asarray(bias),
        impl=IMPL_NAMES[impl], variant=variant))
    got = t_attn.attention(*_t(q, k, v, mask), bias=None if bias is None
                           else torch.from_numpy(bias), impl=impl, variant=variant).numpy()
    assert got.shape == want.shape == (2, 150, 2, 128)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", ["bias", "head_dim_64"])
def test_flash_attention_dense_rule_matches_jax(case, interpret, monkeypatch):
    """A bias, or a head_dim that is not a multiple of 128, goes to the
    dense softmax in both packages (the JAX package's own rule)."""
    d = 64 if case == "head_dim_64" else 128
    q, k, v = _bsnd(30, 2, 96, 2, d)
    mask = np.ones((2, 96), bool)
    mask[0, 80:] = False
    bias = None
    if case == "bias":
        bias = np.random.default_rng(31).normal(size=(2, 1, 96, 96)).astype(np.float32)
    want = np.asarray(jfa.flash_attention(*map(jnp.asarray, (q, k, v, mask)),
                                          bias=None if bias is None else jnp.asarray(bias)))
    dense_calls = []
    real = t_attn.sdpa_xla
    monkeypatch.setattr(t_attn, "sdpa_xla", lambda *a, **kw: dense_calls.append(1) or
                        real(*a, **kw))
    got = tfa.flash_attention(*_t(q, k, v, mask),
                              bias=None if bias is None else torch.from_numpy(bias)).numpy()
    assert dense_calls == [1]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_attention_impl_names():
    q, k, v = _t(*_bsnd(40, 1, 8, 1, 128))
    assert t_attn.default_impl() == ("kernels" if torch.cuda.is_available() else "dense")
    with pytest.raises(NotImplementedError, match="ring"):
        t_attn.attention(q, k, v, impl="ring")
    with pytest.raises(ValueError, match="unknown attention impl"):
        t_attn.attention(q, k, v, impl="xla")
    with pytest.raises(ValueError, match="unknown attention variant"):
        tfa.flash_attention_bnsd(*[x.transpose(1, 2) for x in (q, k, v)], variant="x")


# ---------------------------------------------------------------------------
# The DiT's attn_impl
# ---------------------------------------------------------------------------

DIT_CFG = j_dit.DiTConfig(num_layers=2, dim=256, num_heads=2, head_dim=128, txt_in_dim=64,
                          patch_dim=64, time_dim=64)


@pytest.mark.parametrize("slim", [0, 16])
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("impl", ["dense", "kernels"])
def test_dit_attn_impl_matches_jax(impl, with_bias, slim, interpret):
    """``dit_forward(attn_impl=)`` in both packages: the dense softmax, or
    the kernels (K1 / K7 in the port, Pallas in JAX), with an EliGen-style
    bias and the slim last block."""
    params = jax.tree_util.tree_map(np.asarray,
                                    j_dit.init_dit_params(jax.random.PRNGKey(3), DIT_CFG))
    rng = np.random.default_rng(3)
    s_i, s_t = 32, 24
    img = rng.normal(size=(2, s_i, 64)).astype(np.float32)
    txt = rng.normal(size=(2, s_t, 64)).astype(np.float32)
    t = np.array([0.7, 0.3], np.float32)
    mask = np.ones((2, s_t), bool)
    mask[1, 16:] = False
    ropes = j_rope.build_rope_tables([(1, 4, 4), (1, 4, 4)], s_t)
    bias = None
    if with_bias:
        s = s_t + s_i
        bias = np.where(rng.random((2, s, s)) < 0.3, NEG, 0.0).astype(np.float32)
        bias[:, :, 0] = 0.0
    want = j_dit.dit_forward(params, DIT_CFG, *map(jnp.asarray, (img, txt, t)),
                             *map(jnp.asarray, ropes), txt_key_mask=jnp.asarray(mask),
                             attn_impl=IMPL_NAMES[impl], slim_last=slim,
                             attn_bias=None if bias is None else jnp.asarray(bias))
    model = dit_from_jax(params, DIT_CFG, device="cpu")
    bias_log2 = None if bias is None else tfa.bias_log2(torch.from_numpy(bias))
    with torch.no_grad():
        got = model(*_t(img, txt, t), *_t(*ropes), txt_key_mask=torch.from_numpy(mask),
                    slim_last=slim, attn_bias_log2=bias_log2, attn_impl=impl)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)

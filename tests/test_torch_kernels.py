"""Port kernels K1 / K2: plain versions against the JAX Pallas kernels
(interpret mode on the CPU), the CPU routing of the wrappers and the
builder.  The kernels themselves are tested on the card in
tests/test_torch_cuda.py."""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from physicedit_tpu.kernels import flash_attention as jfa
from physicedit_torch.kernels import _build
from physicedit_torch.kernels import flash_attention as tfa

torch.set_num_threads(2)

FP32_TOL = 2e-5  # fp32 on both sides; only the summation order differs


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    """Run pallas_call in interpreter mode on the CPU (as the JAX tests do)."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _bnsd(rng, b, n, s, d, scale=1.0, rms=False):
    x = rng.normal(size=(b, n, s, d)).astype(np.float32) * scale
    if rms:
        x /= np.sqrt((x ** 2).mean(-1, keepdims=True))
    return x


K1_CASES = {
    # name: (b, n, sq, sk, q scale, rms-normed q/k, clamp, masked spans per row)
    "masked_ragged_300": (2, 2, 300, 300, 1.0, False, True, [(250, 300), (100, 140)]),
    "sq_ne_sk": (1, 2, 128, 384, 0.3, False, True, [(300, 384)]),
    "noclamp_rms": (1, 2, 256, 256, 1.0, True, False, [(200, 256)]),
    "clamp_large_logits": (1, 2, 128, 128, 30.0, False, True, []),
}


@pytest.mark.parametrize("case", list(K1_CASES))
def test_fixedmax_plain_matches_pallas(case):
    b, n, sq, sk, scale, rms, clamp, spans = K1_CASES[case]
    rng = np.random.default_rng(sorted(K1_CASES).index(case))
    q = _bnsd(rng, b, n, sq, 128, scale, rms)
    k = _bnsd(rng, b, n, sk, 128, scale, rms)
    v = _bnsd(rng, b, n, sk, 128)
    mask = np.ones((b, sk), bool)
    for row, (lo, hi) in enumerate(spans):
        mask[row, lo:hi] = False
    want = jfa.flash_attention_bnsd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    key_mask=jnp.asarray(mask), block_q=128,
                                    block_k=128, variant="fixedmax", clamp=clamp)
    got = tfa.fixedmax_attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                           torch.from_numpy(v), torch.from_numpy(mask),
                                           clamp=clamp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FP32_TOL, atol=FP32_TOL)


def test_fixedmax_fully_masked_row_is_zero():
    rng = np.random.default_rng(9)
    q = torch.from_numpy(_bnsd(rng, 1, 1, 128, 128))
    mask = torch.zeros((1, 128), dtype=torch.bool)
    out, l = tfa.fixedmax_attention_reference(q, q, q, mask, return_l=True)
    want = jfa.flash_attention_bnsd(jnp.asarray(q.numpy()), jnp.asarray(q.numpy()),
                                    jnp.asarray(q.numpy()),
                                    key_mask=jnp.asarray(mask.numpy()),
                                    block_q=128, block_k=128, variant="fixedmax")
    assert torch.isfinite(out).all()
    np.testing.assert_array_equal(out.numpy(), 0.0)
    np.testing.assert_array_equal(np.asarray(want), 0.0)
    np.testing.assert_array_equal(l.numpy(), 0.0)


def test_fixedmax_row_sum_matches_pallas_lse():
    """The l output (return_l) against the Pallas forward's denominator."""
    rng = np.random.default_rng(3)
    q = _bnsd(rng, 1, 2, 256, 128, rms=True)
    k = _bnsd(rng, 1, 2, 256, 128, rms=True)
    v = _bnsd(rng, 1, 2, 256, 128)
    mask = np.ones((1, 256), bool)
    mask[0, 180:] = False
    key_bias = jnp.where(jnp.asarray(mask), 0.0, jfa.NEG_INF)[:, None, :].astype(jnp.float32)
    qs = jnp.asarray(q) * jnp.asarray(jfa.LOG2E / 128 ** 0.5, jnp.float32)
    _, l_want = jfa._fixedmax_bnsd_lse(qs, jnp.asarray(k), jnp.asarray(v), key_bias,
                                       128, 128, clamp=True, prescaled=True)
    _, l_got = tfa.fixedmax_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask), return_l=True)
    np.testing.assert_allclose(l_got.numpy(), np.asarray(l_want)[..., 0],
                               rtol=FP32_TOL, atol=FP32_TOL)


GQA_CASES = {
    # name: (b, s, n, kv, left pad per row)
    "full_mask_8q_2kv": (1, 384, 8, 2, [0]),
    "left_padded_batch": (2, 300, 4, 4, [77, 5]),
}


@pytest.mark.parametrize("case", list(GQA_CASES))
def test_gqa_causal_plain_matches_pallas(case):
    b, s, n, kv, pads = GQA_CASES[case]
    rng = np.random.default_rng(len(case))
    q = rng.normal(size=(b, s, n, 128)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, 128)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, 128)).astype(np.float32)
    mask = np.ones((b, s), bool)
    for row, p in enumerate(pads):
        mask[row, :p] = False
    want = np.asarray(jfa.gqa_causal_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           jnp.asarray(mask), block_q=128, block_k=128))
    got = tfa.gqa_causal_attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                             torch.from_numpy(v),
                                             torch.from_numpy(mask)).numpy()
    for i in range(b):   # rows with no live key are not defined: live rows only
        np.testing.assert_allclose(got[i][mask[i]], want[i][mask[i]],
                                   rtol=FP32_TOL, atol=FP32_TOL)


def test_sdpa_bnsd_matches_jax_and_fixedmax():
    """The plain softmax attention against the JAX package's, and K1's plain
    version against it on RMS-normed (bounded-logit) inputs."""
    from physicedit_tpu.ops.attention import sdpa_bnsd as j_sdpa
    from physicedit_torch.ops.attention import sdpa_bnsd as t_sdpa

    rng = np.random.default_rng(6)
    q = _bnsd(rng, 2, 2, 96, 64, rms=True)
    k = _bnsd(rng, 2, 2, 96, 64, rms=True)
    v = _bnsd(rng, 2, 2, 96, 64)
    mask = np.ones((2, 96), bool)
    mask[1, 40:] = False
    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
    got = t_sdpa(tq, tk, tv, tm)
    want = j_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FP32_TOL, atol=FP32_TOL)
    np.testing.assert_allclose(tfa.fixedmax_attention_reference(tq, tk, tv, tm).numpy(),
                               got.numpy(), rtol=FP32_TOL, atol=FP32_TOL)


def test_wrappers_take_plain_versions_on_cpu():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(_bnsd(rng, 1, 2, 64, 128))
    mask = torch.ones((1, 64), dtype=torch.bool)
    before = dict(tfa.LAUNCHES)
    assert torch.equal(tfa.fixedmax_attention(q, q, q, mask),
                       tfa.fixedmax_attention_reference(q, q, q, mask))
    qg = torch.from_numpy(rng.normal(size=(1, 64, 4, 128)).astype(np.float32))
    kg = qg[:, :, :2].contiguous()
    assert torch.equal(tfa.gqa_causal_attention(qg, kg, kg, mask),
                       tfa.gqa_causal_attention_reference(qg, kg, kg, mask))
    assert tfa.LAUNCHES == before   # no kernel launched on the CPU


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build("fixedmax_attention")


def test_build_hash_covers_every_source():
    names = {p.name for p in _build.CSRC.glob("*.cu*")}
    assert {"fixedmax_attention.cu", "gqa_causal_attention.cu", "mma_bf16.cuh"} <= names
    assert _build.library_path("fixedmax_attention").name.startswith("fixedmax_attention-")

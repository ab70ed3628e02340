"""The bf16 attention prototypes of ``tools/`` (T1 v1-v4, T2, T3, T5, T7,
T8) against their ports in ``physicedit_torch/tools/``, on the CPU with the
same numpy inputs: each JAX tool function runs its Pallas kernel in
interpret mode, the port's wrapper its plain version (the tensors lie on
the CPU, so no kernel launches).

Interpret mode: T3's kernel has a scalar-prefetch grid and
("arbitrary", "parallel", ...) dimension semantics, which the plain
``interpret=True`` cannot lower on the CPU (no rule for ``program_id``) and
``interpret=pltpu.InterpretParams()`` refuses (parallel dimensions must
lead the grid); it runs with ``InterpretParams()`` and the dimension
semantics dropped from its ``CompilerParams``.  Both are patches of this
file's fixtures; ``tools/`` is unchanged.  Each JAX function is compiled
with XLA's excess precision off: XLA's CPU compiler may otherwise keep a
bf16 intermediate in fp32 (T1 v1's p, whose rounding moves its output by
rel-L2 1.7e-3), where the jaxpr's types, the TPU kernel and the port round
it.  Three of the tool modules point
JAX's persistent compilation cache at the repo's ``.jax_cache`` when they
are imported: the config is restored right after the import, so the other
tests on the same worker are untouched.

Tolerances: fp32 inputs within 1e-5 of the largest output (the same
arithmetic; only the order of the fp32 sums differs).  T1 v1 rounds the
score to bf16 three times, where a difference of one fp32 ulp in the
product can flip a rounding, so rel-L2 1e-3.  bf16 inputs (the kernel's
type): max |err| 4e-3 and rel-L2 5e-3, the card's gates for the kernel
against this plain version.  The unnormalised v3 and v4 grow with S, so
their max |err| is taken relative to the largest output.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from physicedit_torch.kernels import flash_attention as tfa
from physicedit_torch.tools import _proto_attention as pa
from physicedit_torch.tools import proto_attn_bf16s as t_t1
from physicedit_torch.tools import proto_attn_fast as t_t23
from physicedit_torch.tools import proto_attn_interleave as t_t5
from physicedit_torch.tools import proto_fixedmax as t_t7
from physicedit_torch.tools import proto_fixedmax2 as t_t8

_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
_saved_config = {key: getattr(jax.config, key) for key in _CACHE_KEYS}
from tools import proto_attn_bf16s as j_t1  # noqa: E402
from tools import proto_attn_fast as j_t23  # noqa: E402
from tools import proto_attn_interleave as j_t5  # noqa: E402
from tools import proto_fixedmax as j_t7  # noqa: E402
from tools import proto_fixedmax2 as j_t8  # noqa: E402

for _key, _value in _saved_config.items():
    jax.config.update(_key, _value)

torch.set_num_threads(2)

NEG = -1e30
DTYPES = {"fp32": (np.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
CU_SOURCE = Path(pa.__file__).resolve().parents[1] / "csrc" / f"{pa.SOURCE}.cu"


def _interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _interpret_t3(monkeypatch):
    real = pltpu.CompilerParams

    def without_semantics(**kwargs):
        kwargs.pop("dimension_semantics", None)
        return real(**kwargs)

    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=pltpu.InterpretParams()))
    monkeypatch.setattr(pltpu, "CompilerParams", without_semantics)


@pytest.fixture
def interpret(monkeypatch):
    """pallas_call in interpret mode on the CPU, as the JAX tests run it."""
    _interpret(monkeypatch)


@pytest.fixture
def interpret_t3(monkeypatch):
    """T3's interpret mode: ``InterpretParams()`` and no dimension semantics."""
    _interpret_t3(monkeypatch)


@pytest.fixture
def no_launch():
    """The port's wrappers take their plain versions on CPU tensors."""
    before = dict(tfa.LAUNCHES)
    yield
    assert tfa.LAUNCHES == before


def _qkv(seed, b, n, s, d, std=0.5):
    rng = np.random.default_rng(seed)
    return rng, [(rng.normal(size=(b, n, s, d)) * std).astype(np.float32) for _ in range(3)]


def _both(dtype, *arrays):
    """The same values for JAX and for the port, in ``dtype`` (bf16 rounds
    to nearest even on both sides)."""
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)).to(tdt) for a in arrays])


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _check(got, want, dtype, rel_l2_only=False, unnormalised=False):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape and np.isfinite(want).all()
    err = np.abs(got - want).max()
    rel_l2 = np.linalg.norm(got - want) / np.linalg.norm(want)
    scale = np.abs(want).max() if unnormalised else 1.0
    if dtype == "fp32":
        if rel_l2_only:
            assert rel_l2 <= 1e-3, rel_l2
        else:
            assert err <= 1e-5 * np.abs(want).max(), (err, np.abs(want).max())
    else:
        assert err <= 4e-3 * scale and rel_l2 <= 5e-3, (err, scale, rel_l2)


def _jax(fn, *args):
    """``fn(*args)`` compiled with ``xla_allow_excess_precision`` off."""
    lowered = jax.jit(fn).lower(*args)
    return lowered.compile(compiler_options={"xla_allow_excess_precision": False})(*args)


def _prescaled(q, d):
    """q' = q * log2(e) / sqrt(d) in q's dtype, the scale rounded to it
    first, as the T1 tool's caller forms it for bf16 inputs (``q0 * scale``)
    and the port's ``_prescale``."""
    return q * jnp.asarray(j_t1.fa.LOG2E / d ** 0.5, q.dtype)


# ---------------------------------------------------------------------------
# T7, T8, T5: the key bias
# ---------------------------------------------------------------------------

def _key_bias(rng, b, s, masked, big=None):
    """[B, 1, S] fp32: normal x 0.5, -1e30 on each batch's ``masked`` span,
    and in the last batch the values of ``big`` ({key: value}) at their
    keys.  Two keys at +120 and +140 make the clamp at 100 bind: with it
    they weigh the same, without it the second outweighs the first 2^20
    times.  In fp32 only: in bf16 the output is then the mean of two bf16
    values, often a rounding tie, which JAX's exp2 (exp(x * ln 2), a few
    fp32 ulps from exp2 at x = 100) breaks one way and exp2 the other."""
    bias = (rng.normal(size=(b, 1, s)) * 0.5).astype(np.float32)
    for i, (m0, m1) in enumerate(masked):
        bias[i, :, m0:m1] = NEG
    for key, value in (big or {}).items():
        bias[-1, :, key] = value
    return bias


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_t7_fixedmax_matches_jax(dtype, interpret, no_launch):
    b, n, s, d = 2, 2, 256, 64
    rng, (q, k, v) = _qkv(0, b, n, s, d)
    bias = _key_bias(rng, b, s, [(200, 256), (10, 40)],
                     big={77: 120.0, 90: 140.0} if dtype == "fp32" else None)
    (jq, jk, jv), (tq, tk, tv) = _both(dtype, q, k, v)
    want = _jax(functools.partial(j_t7.fixedmax_bnsd, block_q=128, block_k=128),
                jq, jk, jv, jnp.asarray(bias))
    got = t_t7.fixedmax_bnsd(tq, tk, tv, torch.from_numpy(bias))
    _check(got, want, dtype)


def test_t7_scales_the_keys_past_bias_keys(no_launch):
    """T7's plain version with bias_keys < S_k, the kernel's path for the
    tiles past the bias (read_stage scales every tile, adds the bias on
    those below bias_keys), against numpy in fp32: s * c on every key, the
    bias on keys < 200 only, the clamp at 100 (binding on keys 5 and 9 of
    batch 1), exp2, acc * (1 / l).  Keys 150-259 of batch 0 carry -1e30:
    keys 200-259 stay live, so the bias on every key gives another output,
    and so does a score left unscaled past the prefix."""
    b, n, s, d, bias_keys = 2, 2, 300, 128, 200
    rng, (q, k, v) = _qkv(33, b, n, s, d)
    bias = _key_bias(rng, b, s, [(150, 260), (0, 0)], big={5: 120.0, 9: 140.0})
    c = np.float32(tfa.LOG2E / np.sqrt(d))

    def expect(scale_past_prefix=True):
        x = np.matmul(q, k.swapaxes(-1, -2))
        x[..., :bias_keys] = x[..., :bias_keys] * c + bias[:, :, None, :bias_keys]
        if scale_past_prefix:
            x[..., bias_keys:] = x[..., bias_keys:] * c
        p = np.exp2(np.minimum(x, np.float32(100.0)))
        return np.matmul(p, v) * (np.float32(1.0) / p.sum(-1, keepdims=True))

    tq, tk, tv, tbias = map(torch.from_numpy, (q, k, v, bias))
    got = pa.reference("proto_fixedmax", tq, tk, tv, tbias, bias_keys)
    _check(got, expect(), "fp32")
    assert pa.max_abs_diff(got, torch.from_numpy(expect(scale_past_prefix=False))) > 0.01
    everywhere = pa.reference("proto_fixedmax", tq, tk, tv, tbias, s)
    assert pa.max_abs_diff(got[:1], everywhere[:1]) > 0.01


def test_t7_row_with_no_live_key_is_nan(interpret, no_launch):
    """l == 0 and no floor: acc * (1 / l) = 0 * inf, in JAX and in the port."""
    b, n, s, d = 2, 2, 256, 64
    rng, (q, k, v) = _qkv(1, b, n, s, d)
    bias = _key_bias(rng, b, s, [(0, 0), (0, s)])
    want = _f32(_jax(functools.partial(j_t7.fixedmax_bnsd, block_q=128, block_k=128),
                     q, k, v, bias))
    got = _f32(t_t7.fixedmax_bnsd(*map(torch.from_numpy, (q, k, v, bias))))
    assert np.isnan(want[1]).all() and np.isnan(got[1]).all()
    _check(got[:1], want[:1], "fp32")


@pytest.mark.parametrize("sub", [1, 2])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_t8_fixedmax2_bias_on_the_prefix_only(dtype, sub, interpret, no_launch):
    """Batch 0's bias holds -1e30 on keys 100-199, past the prefix from key
    128: JAX adds the bias on its first k block only, the port on the keys
    before ``bias_keys``; keys 128-199 stay live, so biasing every key would
    give another output.  In fp32 the clamp binds in batch 1's prefix."""
    b, n, s, d, block_k = 2, 2, 384, 128, 128
    rng, (q, k, v) = _qkv(2, b, n, s, d)
    bias = _key_bias(rng, b, s, [(100, 200), (60, 128)],
                     big={5: 120.0, 9: 140.0} if dtype == "fp32" else None)
    (jq, jk, jv), (tq, tk, tv) = _both(dtype, q, k, v)
    want = _jax(functools.partial(j_t8.fixedmax2_bnsd, block_q=128, block_k=block_k, sub=sub),
                jq, jk, jv, jnp.asarray(bias))
    tbias = torch.from_numpy(bias)
    got = t_t8.fixedmax2_bnsd(tq, tk, tv, tbias, bias_keys=block_k, overlap=sub > 1)
    _check(got, want, dtype)
    everywhere = t_t8.fixedmax2_bnsd_reference(tq, tk, tv, tbias, bias_keys=s)
    assert pa.max_abs_diff(got[:1], everywhere[:1]) > 0.05


@pytest.mark.parametrize("sub,bias_subs", [(2, 1), (4, 1), (2, 0)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_t5_interleaved_bias_on_the_prefix_only(dtype, sub, bias_subs, interpret, no_launch):
    """JAX adds the bias on the first ``bias_subs`` sub-tiles of its first k
    block (none for 0); the port on the keys before bias_subs * block_k /
    sub.  The bias holds -1e30 past that prefix too."""
    b, n, s, d, block_k = 1, 2, 512, 64, 256
    rng, (q, k, v) = _qkv(3, b, n, s, d)
    bias = _key_bias(rng, b, s, [(40, 60)])
    bias[:, :, 280:480] = NEG
    bias_keys = bias_subs * block_k // sub
    (jq, jk, jv), (tq, tk, tv) = _both(dtype, q, k, v)
    want = _jax(functools.partial(j_t5.attn_interleaved, block_q=128, block_k=block_k,
                                  sub=sub, bias_subs=bias_subs), jq, jk, jv, jnp.asarray(bias))
    got = t_t5.attn_interleaved(tq, tk, tv, torch.from_numpy(bias), bias_keys=bias_keys,
                                overlap=sub > 1)
    _check(got, want, dtype)
    everywhere = t_t5.attn_interleaved_reference(tq, tk, tv, torch.from_numpy(bias),
                                                 bias_keys=s)
    assert pa.max_abs_diff(got, everywhere) > 0.05


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_t5_bias_keys_inside_a_tile_matches_jax(dtype, interpret, no_launch):
    """The prefix ends at key 200, inside the Hopper loop's second 128-key
    tile (the JAX tool: one 400-key block in two sub-tiles, the first
    biased).  The bias holds -1e30 on keys 150-249: keys 150-199 are
    blocked, 200-249 stay live on both sides."""
    b, n, s, d, block_k, sub = 2, 2, 800, 64, 400, 2
    rng, (q, k, v) = _qkv(30, b, n, s, d)
    bias = _key_bias(rng, b, s, [(150, 250), (20, 90)])
    (jq, jk, jv), (tq, tk, tv) = _both(dtype, q, k, v)
    want = _jax(functools.partial(j_t5.attn_interleaved, block_q=400, block_k=block_k,
                                  sub=sub, bias_subs=1), jq, jk, jv, jnp.asarray(bias))
    tbias = torch.from_numpy(bias)
    got = t_t5.attn_interleaved(tq, tk, tv, tbias, bias_keys=block_k // sub)
    _check(got, want, dtype)
    at_tile_edge = t_t5.attn_interleaved_reference(tq, tk, tv, tbias, bias_keys=256)
    assert pa.max_abs_diff(got[:1], at_tile_edge[:1]) > 0.01


def test_t5_row_blocked_on_every_key_is_nan(interpret, no_launch):
    """A batch whose bias blocks every key (the prefix covering all of S):
    l == 0 and 1 / l has no floor, so its rows are NaN in JAX
    (``pl.reciprocal``) and in the port."""
    b, n, s, d = 2, 2, 256, 64
    rng, (q, k, v) = _qkv(31, b, n, s, d)
    bias = _key_bias(rng, b, s, [(0, 0), (0, s)])
    want = _f32(_jax(functools.partial(j_t5.attn_interleaved, block_q=128, block_k=s, sub=1,
                                       bias_subs=1), q, k, v, bias))
    got = _f32(t_t5.attn_interleaved(*map(torch.from_numpy, (q, k, v, bias)), bias_keys=s))
    assert np.isnan(want[1]).all() and np.isnan(got[1]).all()
    _check(got[:1], want[:1], "fp32")


# ---------------------------------------------------------------------------
# T2, T3: no bias in the loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inscale", [True, False], ids=["inscale", "prescaled"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_t2_nobias_matches_jax(dtype, inscale, interpret, no_launch):
    b, n, s, d = 2, 2, 256, 128
    _, (q, k, v) = _qkv(4, b, n, s, d, std=0.3)
    (jq, jk, jv), (tq, tk, tv) = _both(dtype, q, k, v)
    want = _jax(functools.partial(j_t23.attn_nobias, block_q=128, block_k=128, inscale=inscale),
                jq, jk, jv)
    got = t_t23.attn_nobias(tq, tk, tv, inscale)
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_t3_nmask_matches_jax(dtype, interpret_t3, no_launch):
    """Two batches with different masked counts (64 and 150 of 384)."""
    b, n, s, d = 2, 2, 384, 64
    _, (q, k, v) = _qkv(5, b, n, s, d)
    mask = np.ones((b, s), bool)
    mask[0, -64:] = False
    mask[1, 20:170] = False
    (jq, jk, jv), (tq, tk, tv) = _both(dtype, q, k, v)
    want = _jax(functools.partial(j_t23.attn_nmask, block_q=128, block_k=128),
                jq, jk, jv, jnp.asarray(mask))
    got = t_t23.attn_nmask(tq, tk, tv, torch.from_numpy(mask))
    _check(got, want, dtype)


def test_t3_batch_with_no_live_key_is_zero(interpret_t3, no_launch):
    """Every key of batch 1 masked: l - n_masked = 0 is floored at 1e-30 and
    the zeroed V leaves acc at 0, so the batch comes out 0 on both sides."""
    b, n, s, d = 2, 2, 256, 64
    _, (q, k, v) = _qkv(6, b, n, s, d)
    mask = np.ones((b, s), bool)
    mask[1] = False
    want = _f32(_jax(functools.partial(j_t23.attn_nmask, block_q=128, block_k=128),
                     q, k, v, mask))
    got = _f32(t_t23.attn_nmask(*map(torch.from_numpy, (q, k, v, mask))))
    assert (want[1] == 0).all() and (got[1] == 0).all()
    _check(got[:1], want[:1], "fp32")


# ---------------------------------------------------------------------------
# T1 v1-v4: the score-tile ablations
# ---------------------------------------------------------------------------

T1_VARIANTS = {  # name: (JAX body, port function, takes the bias, normalised)
    "v1_bf16s": (j_t1._bf16s_kernel, t_t1.attn_bf16s, True, True),
    "v2_nobias": (j_t1._nobias_kernel,
                  functools.partial(t_t23.attn_nobias, inscale=False), False, True),
    "v3_expnosum": (j_t1._expnosum_kernel, t_t1.attn_expnosum, False, False),
    "v4_noexp": (j_t1._noexp_kernel, t_t1.attn_noexp, False, False),
}


@pytest.mark.parametrize("variant", list(T1_VARIANTS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_t1_ablations_match_jax(dtype, variant, interpret, no_launch):
    """q prescaled by the caller on both sides; v1's bias is taken in bf16."""
    body, port, with_bias, normalised = T1_VARIANTS[variant]
    b, n, s, d = 2, 2, 256, 128
    rng, (q, k, v) = _qkv(7, b, n, s, d)
    (jq, jk, jv), (tq, tk, tv) = _both(dtype, q, k, v)
    jqs, tqs = _prescaled(jq, d), tfa._prescale(tq)
    assert np.array_equal(_f32(jqs), _f32(tqs))
    if with_bias:
        bias = _key_bias(rng, b, s, [(200, 256), (0, 30)])
        want = _jax(lambda q_, k_, v_, b_: j_t1._call(body, q_, k_, v_, (b_,), 128, 128),
                    jqs, jk, jv, jnp.asarray(bias, jnp.bfloat16))
        got = port(tqs, tk, tv, torch.from_numpy(bias))
    else:
        want = _jax(lambda q_, k_, v_: j_t1._call(body, q_, k_, v_, (), 128, 128), jqs, jk, jv)
        got = port(tqs, tk, tv)
    _check(got, want, dtype, rel_l2_only=variant == "v1_bf16s", unnormalised=not normalised)


# ---------------------------------------------------------------------------
# T2, T3, T1 v1 / v3 / v4, T5, T7, T8 at the Hopper loop's 128-key tile edges
# ---------------------------------------------------------------------------

# name: (seed, b, n, sq, sk, per batch row the span of keys that T3 masks and
# the key bias of T1 v1, T5, T7 and T8 blocks).  One live key in the last tile, a ragged last tile, a
# ragged q tile with S_q < S_k, and a hole across key 128.  The JAX tools'
# grids need S to divide by their blocks, so they take the whole sequence
# as one block; the port's plain version walks its loop's 128-key tiles.
EDGE_CASES = {
    "sk_129": (20, 1, 2, 129, 129, [(100, 120)]),
    "sk_255": (21, 2, 2, 255, 255, [(0, 0), (200, 255)]),
    "sq_130_lt_sk_385": (22, 1, 2, 130, 385, [(350, 385)]),
    "hole_across_key_128": (23, 2, 2, 300, 300, [(100, 160), (0, 0)]),
}
EDGE_VARIANTS = ("t2_inscale", "t2_prescaled", "t3", "t1_v1", "t1_v3", "t1_v4", "t5", "t7",
                 "t8")


def _edge_jax(variant, jq, jk, jv, mask, bias, sq, sk):
    if variant.startswith("t2"):
        return _jax(functools.partial(j_t23.attn_nobias, block_q=sq, block_k=sk,
                                      inscale=variant == "t2_inscale"), jq, jk, jv)
    if variant == "t3":
        return _jax(functools.partial(j_t23.attn_nmask, block_q=sq, block_k=sk), jq, jk, jv,
                    jnp.asarray(mask))
    if variant == "t5":   # one k block, biased: the prefix is every key
        return _jax(functools.partial(j_t5.attn_interleaved, block_q=sq, block_k=sk, sub=1,
                                      bias_subs=1), jq, jk, jv, jnp.asarray(bias))
    if variant == "t7":
        return _jax(functools.partial(j_t7.fixedmax_bnsd, block_q=sq, block_k=sk), jq, jk, jv,
                    jnp.asarray(bias))
    if variant == "t8":   # one k block, biased: the prefix is every key
        return _jax(functools.partial(j_t8.fixedmax2_bnsd, block_q=sq, block_k=sk, sub=1),
                    jq, jk, jv, jnp.asarray(bias))
    body = {"t1_v1": j_t1._bf16s_kernel, "t1_v3": j_t1._expnosum_kernel,
            "t1_v4": j_t1._noexp_kernel}[variant]
    jqs = _prescaled(jq, jq.shape[-1])
    if variant == "t1_v1":
        return _jax(lambda q_, k_, v_, b_: j_t1._call(body, q_, k_, v_, (b_,), sq, sk),
                    jqs, jk, jv, jnp.asarray(bias, jnp.bfloat16))
    return _jax(lambda q_, k_, v_: j_t1._call(body, q_, k_, v_, (), sq, sk), jqs, jk, jv)


def _edge_port(variant, tq, tk, tv, mask, bias):
    if variant.startswith("t2"):
        return t_t23.attn_nobias(tq, tk, tv, variant == "t2_inscale")
    if variant == "t3":
        return t_t23.attn_nmask(tq, tk, tv, torch.from_numpy(mask))
    if variant == "t5":
        return t_t5.attn_interleaved(tq, tk, tv, torch.from_numpy(bias), bias_keys=tk.shape[2])
    if variant == "t7":
        return t_t7.fixedmax_bnsd(tq, tk, tv, torch.from_numpy(bias))
    if variant == "t8":
        return t_t8.fixedmax2_bnsd(tq, tk, tv, torch.from_numpy(bias), bias_keys=tk.shape[2])
    tqs = tfa._prescale(tq)
    if variant == "t1_v1":
        return t_t1.attn_bf16s(tqs, tk, tv, torch.from_numpy(bias))
    return (t_t1.attn_expnosum if variant == "t1_v3" else t_t1.attn_noexp)(tqs, tk, tv)


@pytest.mark.parametrize("variant", EDGE_VARIANTS)
@pytest.mark.parametrize("case", list(EDGE_CASES))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_hopper_tile_edges_match_jax(dtype, case, variant, monkeypatch, no_launch):
    """The instantiations of the Hopper loop (T2 both scales, T3, T1 v1 /
    v3 / v4, T5, T7, T8) at its tile edges: the port's plain version against
    the JAX tool's function, with Pallas in interpret mode (T3's as in
    ``test_t3_nmask_matches_jax``)."""
    (_interpret_t3 if variant == "t3" else _interpret)(monkeypatch)
    seed, b, n, sq, sk, spans = EDGE_CASES[case]
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, n, sq, 128)) * 0.5).astype(np.float32)
    k, v = ((rng.normal(size=(b, n, sk, 128)) * 0.5).astype(np.float32) for _ in range(2))
    mask = np.ones((b, sk), bool)
    for i, (m0, m1) in enumerate(spans):
        mask[i, m0:m1] = False
    bias = _key_bias(rng, b, sk, spans)
    (jq, jk, jv), (tq, tk, tv) = _both(dtype, q, k, v)
    want = _edge_jax(variant, jq, jk, jv, mask, bias, sq, sk)
    got = _edge_port(variant, tq, tk, tv, mask, bias)
    assert tuple(got.shape) == (b, n, sq, 128)
    _check(got, want, dtype, rel_l2_only=variant == "t1_v1",
           unnormalised=variant in ("t1_v3", "t1_v4"))


# ---------------------------------------------------------------------------
# the kernel source against the switches the plain version follows
# ---------------------------------------------------------------------------

def _cases():
    """The C entry point's ``case`` lines: {id: (launcher, its template
    arguments as written)}."""
    return {int(i): (fn, tuple(a.strip() for a in args.split(",")))
            for i, fn, args in re.findall(r"case (\d+): return (\w+)<([^>]*)>",
                                          CU_SOURCE.read_text())}


def test_kernel_instantiations_match_the_variants():
    """Each variant's id selects, in the C entry point, a ``launch_hopper``
    (the Hopper mainloop; the source defines no other kernel, no
    ``proto_kernel``) whose template arguments are the variant's switches;
    every variant has its launch counter.  (The source is compiled only on
    the card.)"""
    codes = {"true": 1, "false": 0, "kNoBias": 0, "kBiasF32": 1, "kBiasBf16": 2,
             "kRecip": 0, "kFloor": 1, "kUnnormalised": 2}
    cases = _cases()
    assert sorted(cases) == sorted({var.kernel_id for var in pa.VARIANTS.values()}) == list(
        range(10))
    assert {fn for fn, _ in cases.values()} == {"launch_hopper"}
    for name, var in pa.VARIANTS.items():
        assert tuple(codes[a] for a in cases[var.kernel_id][1]) == var.template_args(), name
        assert name in tfa.LAUNCHES
    source = CU_SOURCE.read_text()
    assert source.count("__global__") == 1
    assert re.findall(r"^(\w+_kernel)\(", source, re.M) == ["proto_hopper_kernel"]
    assert not re.search(r"\bproto_kernel\b|\blaunch\(", source)


def test_t5_ids_reach_one_hopper_instantiation():
    """T5's two names keep their ids (8 and 9), and both select, in the C
    entry point, the one Hopper instantiation with the fp32 key bias on a
    prefix, the in-kernel scale and the clamp off and the 1 / l epilogue
    (kRecip)."""
    launches = dict(re.findall(r"case (\d+): return (launch\w*<[^>]*>)", CU_SOURCE.read_text()))
    assert launches["8"] == launches["9"] == (
        "launch_hopper<false, kBiasF32, false, true, true, kRecip>")
    t5 = [pa.VARIANTS["proto_interleave"], pa.VARIANTS["proto_interleave_overlap"]]
    assert [v.kernel_id for v in t5] == [8, 9]
    assert t5[0].template_args() == t5[1].template_args() == (
        0, pa.BIAS_CODES["fp32"], 0, 1, 1, pa.NORM_CODES["recip"])


def test_t7_t8_ids_reach_their_hopper_instantiations():
    """T8's two names keep their ids (1 and 2) and select one instantiation:
    T5's with the clamp on.  T7 (id 0) is the one with the in-kernel scale,
    the fp32 key bias, the clamp and kRecip, which the policy no longer
    forbids; its read_stage scales S before it adds the bias, with no FMA
    contraction (__fmul_rn, then __fadd_rn)."""
    cases = _cases()
    assert cases[1] == cases[2] == (
        "launch_hopper", ("false", "kBiasF32", "true", "true", "true", "kRecip"))
    assert cases[0] == ("launch_hopper", ("true", "kBiasF32", "true", "true", "true", "kRecip"))
    t8 = [pa.VARIANTS["proto_fixedmax2"], pa.VARIANTS["proto_fixedmax2_overlap"]]
    assert [v.kernel_id for v in t8] == [1, 2]
    assert t8[0].template_args() == t8[1].template_args() == (
        0, pa.BIAS_CODES["fp32"], 1, 1, 1, pa.NORM_CODES["recip"])
    source = CU_SOURCE.read_text()
    assert "static_assert(!(kInScale && kBias == kBiasF32)" not in source
    read_stage = source[source.index("void read_stage("):source.index("void p_tile(")]
    assert read_stage.index("__fmul_rn(s[i], scale)") < read_stage.index("__fadd_rn(s[4 * n]")


@pytest.mark.parametrize("bias_keys", [0, 1, 200, 256, 333, 400])
@pytest.mark.parametrize("name", ["proto_interleave", "proto_bf16s", "proto_fixedmax"])
def test_padded_key_bias_is_zero_from_bias_keys_and_sk(name, bias_keys):
    """What the Hopper loop reads as T5's, T1 v1's and T7's key bias: whole
    128-key tiles, the bias (T1 v1's rounded to bf16) on the keys below
    bias_keys and S_k, 0 from there on, also inside the last tile; an fp32
    bias with bias_keys 0 is passed as none at all (the kernel then copies
    none), T1 v1's as zeros."""
    b, sk = 2, 333
    rng = np.random.default_rng(32)
    bias = torch.from_numpy((rng.normal(size=(b, 1, sk)) * 5).astype(np.float32))
    got = pa.kernel_key_bias(name, bias, b, sk, bias_keys, "cpu")
    if pa.VARIANTS[name].bias == "fp32" and bias_keys == 0:
        assert got is None
        return
    assert got.shape == (b, 384) and got.dtype == torch.float32 and got.is_contiguous()
    n = min(bias_keys, sk)
    want = bias[:, 0, :n]
    if name == "proto_bf16s":
        want = want.bfloat16().float()
    assert torch.equal(got[:, :n], want)
    assert not got[:, n:].any()


def test_chip_smoke_reads_registers_per_instantiation(tmp_path):
    """``chip_smoke.ptxas_report`` keys nvcc's ``-Xptxas -v`` lines by the
    template arguments of each instantiation of ``proto_hopper_kernel`` (its
    default kernel), as ``Variant.template_args`` gives them, and keeps
    another kernel of the same log (K1's ``fixedmax_kernel<bool>``) apart."""
    import chip_smoke

    # each kernel's instantiations and the positions of its int (not bool) arguments
    args = {"proto_hopper_kernel": sorted({var.template_args() for var in pa.VARIANTS.values()}),
            "fixedmax_kernel": [(0,), (1,)]}
    int_args = {"proto_hopper_kernel": (1, 5), "fixedmax_kernel": ()}
    lines, i = ["ptxas info    : 0 bytes gmem"], 0
    for kernel, instantiations in args.items():
        for a in instantiations:
            mangled = ("_ZN60_GLOBAL__N__97cb8cc7_27_proto_fixedmax_attention_cu_8eff71d0"
                       f"{len(kernel)}{kernel}I"
                       + "".join(f"L{'i' if j in int_args[kernel] else 'b'}{x}E"
                                 for j, x in enumerate(a))
                       + "EEvPKtS2_S2_PKfS4_Ptiiiif")
            lines += [f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'",
                      f"ptxas info    : Function properties for {mangled}",
                      f"    0 bytes stack frame, {4 * i} bytes spill stores, "
                      f"{8 * i} bytes spill loads",
                      f"ptxas info    : Used {160 + i} registers, used 1 barriers",
                      "ptxas info    : Compile time = 374.846 ms"]
            i += 1
    log = tmp_path / "proto.so.log"
    log.write_text("\n".join(lines) + "\n")
    first = 0
    for kernel, instantiations in args.items():
        assert chip_smoke.ptxas_report(log, kernel) == {
            a: {"registers": 160 + first + j, "spill_store_bytes": 4 * (first + j),
                "spill_load_bytes": 8 * (first + j)}
            for j, a in enumerate(instantiations)}
        first += len(instantiations)
    assert len(args["proto_hopper_kernel"]) == 8   # ids 8 / 9, 1 / 2 and T2 / T3 share
    assert chip_smoke.ptxas_report(log) == chip_smoke.ptxas_report(log, "proto_hopper_kernel")


def test_chip_smoke_names_each_kernels_loop():
    """The ``kernels`` line names the loop of every kernel it lists; every
    prototype's is the Hopper attention mainloop."""
    import chip_smoke

    assert {name for name, *_ in chip_smoke.KERNEL_ROWS} == set(chip_smoke.KERNEL_LOOPS)
    for name in pa.VARIANTS:
        assert chip_smoke.KERNEL_LOOPS[name] == "hopper_attention", name


# ---------------------------------------------------------------------------
# the before / after tools
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tool", ["proto_before_after", "w4_before_after"])
def test_before_after_tools_need_a_card(tool, tmp_path, capsys):
    """Without a card each tool exits 2 and prints no timing."""
    import importlib

    module = importlib.import_module(f"physicedit_torch.tools.{tool}")
    assert module.main(["--before", str(tmp_path)]) == 2
    assert capsys.readouterr().out == ""


def test_before_after_turns_summarise_each_case(monkeypatch, tmp_path, capsys):
    """Four turns, before, after, after, before: each case's line gives
    both checkouts' means over their two turns and after / before."""
    import json

    from physicedit_torch.tools import _turns

    turns = []

    def fake_turn(tool, checkout, worker, arg):
        turns.append(checkout.name)
        ms = {"old": [4.0, 6.0], "new": [1.0, 3.0]}[checkout.name][
            turns.count(checkout.name) - 1]
        return [{"kernel": "proto_nobias", "case": "c", "shape": [1], "ms": ms,
                 "graph_ms": ms / 2}]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_turns, "card", lambda: "a card, 700.00 W")
    monkeypatch.setattr(_turns, "run_turn", fake_turn)
    (tmp_path / "old").mkdir()
    (tmp_path / "new").mkdir()
    assert _turns.compare("t", tmp_path / "old", tmp_path / "new", "", "") == 0
    assert turns == ["old", "new", "new", "old"]
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"card": "a card, 700.00 W"}
    assert [(r["turn"], r["side"]) for r in lines[1:5]] == [
        (0, "before"), (1, "after"), (2, "after"), (3, "before")]
    assert lines[5] == {"kernel": "proto_nobias", "case": "c", "shape": [1],
                        "before_ms": 5.0, "after_ms": 2.0, "after_over_before_ms": 0.4,
                        "before_graph_ms": 2.5, "after_graph_ms": 1.0,
                        "after_over_before_graph_ms": 0.4}

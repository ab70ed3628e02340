"""The int8, W4 and elementwise-rate probes of ``tools/`` (T9, T10, T12,
T11, T4, T6) against their ports in ``physicedit_torch/tools/``, on the CPU
with the same numpy inputs: each JAX tool function runs its Pallas kernel in
interpret mode, the port's wrapper its plain version (the tensors lie on
the CPU, so no kernel launches).  The JAX tools hold their weights as ``[K,
N]`` (T9) and ``[K/2, N]`` (the W4 forms); the port as ``[N, K]`` and ``[N,
K/2]``, so the tests transpose them.

Tolerances: integer results (T9 i32, T11, every W4 accumulator) exactly;
with unit scales and no bias the W4 epilogue is exact too, so those outputs
compare exactly.  XLA's CPU compiler contracts the epilogue's last
``* wsb[0] + wsb[1]`` and T6's ``x * c + d`` into one fma, where the jaxpr,
the kernels and the port round the product first: with other scales, and
for T6 in fp32, the outputs are within one ulp of JAX's (fp32 or bf16, as
written) of the larger of the output and that product.  T6 in
bf16 (c = 1.0, so one rounding) compares exactly.  T9 f32 sums in another
order than XLA: exactly on integer-valued inputs (sums exact in any order),
within one bf16 ulp on normal ones.  T4: its int8 codes and scales exactly;
fp32 inputs within 1e-5 of the largest output (exp2 and the order of the
fp32 sums differ), bf16 inputs within max |err| 4e-3 and rel-L2 5e-3, the
card's gates for the kernel against this plain version.  Two tool modules
point JAX's persistent compilation cache at the repo's ``.jax_cache`` when
they are imported: the config is restored right after the import, so the
other tests on the same worker are untouched.
"""

import functools
import re
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from physicedit_torch.kernels import quant_matmul as tqm
from physicedit_torch.tools import _proto_int8 as pi
from physicedit_torch.tools import proto_attn_int8qk as t_t4
from physicedit_torch.tools import proto_ew_rate as t_t6
from physicedit_torch.tools import proto_int8_rate as t_t9
from physicedit_torch.tools import proto_prefill_blocks as t_t10
from physicedit_torch.tools import proto_w4_gemv as t_t11
from physicedit_torch.tools import proto_w4_unpack as t_t12

_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
_saved_config = {key: getattr(jax.config, key) for key in _CACHE_KEYS}
from tools import proto_attn_int8qk as j_t4  # noqa: E402
from tools import proto_ew_rate as j_t6  # noqa: E402
from tools import proto_int8_rate as j_t9  # noqa: E402
from tools import proto_prefill_blocks as j_t10  # noqa: E402
from tools import proto_w4_gemv as j_t11  # noqa: E402
from tools import proto_w4_unpack as j_t12  # noqa: E402

for _key, _value in _saved_config.items():
    jax.config.update(_key, _value)

torch.set_num_threads(2)

CSRC = Path(pi.__file__).resolve().parents[1] / "csrc"
REPO = Path(__file__).resolve().parents[1]
TOOLS = (t_t9, t_t10, t_t12, t_t11, t_t4, t_t6)


@pytest.fixture
def interpret(monkeypatch):
    """pallas_call in interpret mode on the CPU, as the JAX tests run it."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.fixture
def no_launch():
    """The port's wrappers take their plain versions on CPU tensors."""
    before = dict(pi.LAUNCHES)
    yield
    assert pi.LAUNCHES == before


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        jnp.asarray(x, jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _within_ulps(got, want, dtype, term=None):
    """|got - want| <= one ulp in ``dtype`` (fp32 or bf16) of want, or of
    ``term`` where it is larger: the product that an fma adds without
    rounding it, whose rounding can be many ulps of a sum that cancels."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    mag = np.abs(want) if term is None else np.maximum(np.abs(want), np.abs(term))
    mant = 24 if dtype == "fp32" else 8
    _, e = np.frexp(np.where(mag == 0, 1e-30, mag))
    assert np.all(np.abs(got - want) <= np.ldexp(1.0, e - mant)), \
        np.abs(got - want).max()


def _w4_operands(seed, m, k, n, scales):
    """int8 x in [-128, 127], weights in [-7, 7] as [K, N] (JAX) and the
    packed [K/2, N]; x_scale [M, 1] and wsb [2, N]: ones and zeros for
    ``scales="unit"``, else uniform scales and a normal bias row."""
    rng = np.random.default_rng(seed)
    xq = rng.integers(-128, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-7, 8, (k, n)).astype(np.int8)
    if scales == "unit":
        xs = np.ones((m, 1), np.float32)
        wsb = np.stack([np.ones(n), np.zeros(n)]).astype(np.float32)
    else:
        xs = rng.uniform(1e-3, 1e-2, (m, 1)).astype(np.float32)
        wsb = np.stack([rng.uniform(1e-3, 1e-2, n), rng.normal(size=n)]).astype(np.float32)
    return xq, wq, j_t12.pack_offset(wq), xs, wsb


# ---------------------------------------------------------------------------
# T9: the plain int8 (and bf16) GEMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(64, 256, 128), (96, 384, 256)])
def test_t9_i32_matches_jax_exactly(m, k, n, interpret, no_launch):
    rng = np.random.default_rng(0)
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    want = np.asarray(j_t9.pallas_mm(jnp.asarray(x), jnp.asarray(w), 32, 64, 128, "i32"))
    got = t_t9.pallas_mm(_t(x), _t(w.T), "i32")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, x.astype(np.int64) @ w.astype(np.int64))


@pytest.mark.parametrize("values", ["integers", "normal"])
def test_t9_f32_matches_jax(values, interpret, no_launch):
    """Integer-valued bf16 inputs give sums exact in any order: equal bits;
    normal ones within one bf16 ulp (the fp32 sums' order differs)."""
    rng = np.random.default_rng(1)
    m, k, n = 64, 256, 128
    if values == "integers":
        x, w = rng.integers(-15, 16, (m, k)), rng.integers(-15, 16, (k, n))
    else:
        x, w = rng.normal(size=(m, k)) * 0.1, rng.normal(size=(k, n)) * 0.1
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = j_t9.pallas_mm(jx, jw, 32, 64, 128, "f32")
    tx = _t(_np(jx)).bfloat16()
    tw = _t(_np(jw).T).bfloat16()
    got = t_t9.pallas_mm(tx, tw, "f32")
    assert got.dtype == torch.bfloat16
    if values == "integers":
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        _within_ulps(got, want, "bf16")


@pytest.mark.parametrize("m", [1, 37, 129])
@pytest.mark.parametrize("acc", ["i32", "f32"])
def test_t9_ragged_m_matches_jax(acc, m, interpret, no_launch):
    """M that is no multiple of the card GEMM's 128-row tile (one block of M
    rows on the JAX side), N 384 (a half-full last 256-column tile): i32
    exactly; f32 on integer-valued inputs bit for bit."""
    rng = np.random.default_rng(2)
    k, n = 256, 384
    if acc == "i32":
        x = rng.integers(-128, 128, (m, k)).astype(np.int8)
        w = rng.integers(-128, 128, (k, n)).astype(np.int8)
        jx, jw, tx, tw = jnp.asarray(x), jnp.asarray(w), _t(x), _t(w.T)
    else:
        x, w = rng.integers(-15, 16, (m, k)), rng.integers(-15, 16, (k, n))
        jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
        tx, tw = _t(_np(jx)).bfloat16(), _t(_np(jw).T).bfloat16()
    want = j_t9.pallas_mm(jx, jw, m, 128, 64, acc)
    got = t_t9.pallas_mm(tx, tw, acc)
    assert tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(_np(got), _np(want))


# x shape, w shape, the form, what the message names
T9_REFUSED = [
    ((256, 256), (100, 256), "i32", "N % 128"),       # N not whole 128-column tiles
    ((256, 192), (128, 192), "i32", "K % 128"),       # K % 128 for int8
    ((256, 96), (128, 96), "f32", "K % 64"),          # K % 64 for bf16
    ((256, 256), (128, 128), "i32", "do not fit"),    # x and w disagree on K
    ((0, 256), (128, 256), "f32", "do not fit"),      # no rows
    ((256,), (128, 256), "i32", "2-D"),
]


@pytest.mark.parametrize("x_shape,w_shape,acc,match", T9_REFUSED,
                         ids=["n_100", "k_192_i32", "k_96_f32", "k_mismatch", "m_0", "x_1d"])
def test_t9_wrapper_raises_before_any_launch(x_shape, w_shape, acc, match, monkeypatch):
    """T9's wrapper refuses the shapes its GEMM cannot take while checking
    them, before it reaches the operands' device or the library: nothing is
    launched or counted (the checks run first, so CPU tensors show it)."""
    dtype = torch.int8 if acc == "i32" else torch.bfloat16

    def no_launch(*args):
        raise AssertionError("launched")

    monkeypatch.setattr(pi._build, "launch", no_launch)
    before = dict(pi.LAUNCHES)
    with pytest.raises(ValueError, match=re.escape(match)):
        pi.launch_matmul(t_t9.ACC[acc], torch.zeros(x_shape, dtype=dtype),
                         torch.zeros(w_shape, dtype=dtype))
    assert pi.LAUNCHES == before


# ---------------------------------------------------------------------------
# T10 and T12: the W4A8 tiled forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scales", ["unit", "random"])
def test_t10_i32_unpack_matches_jax(scales, interpret, no_launch):
    """The JAX kernel writes bf16; with unit scales it is the exact product
    rounded to bf16, and the port's fp32 output is the exact product."""
    m, k, n = 64, 512, 256
    xq, wq, packed, xs, wsb = _w4_operands(2, m, k, n, scales)
    want = j_t10.i32_matmul(jnp.asarray(xq), jnp.asarray(packed), jnp.asarray(xs),
                            jnp.asarray(wsb), 32, 128, 128)
    got, acc = t_t10.i32_matmul(_t(xq), _t(packed.T), _t(xs), _t(wsb), return_acc=True)
    exact = xq.astype(np.int64) @ wq.astype(np.int64)
    np.testing.assert_array_equal(acc.numpy(), exact)
    assert got.dtype == torch.bfloat16
    if scales == "unit":
        np.testing.assert_array_equal(_np(got), _np(want))
        got32 = t_t10.i32_matmul(_t(xq), _t(packed.T), _t(xs), _t(wsb), torch.float32)
        np.testing.assert_array_equal(got32.numpy(), exact.astype(np.float32))
    else:
        _within_ulps(got, want, "bf16", exact * xs * wsb[0])


@pytest.mark.parametrize("scales", ["unit", "random"])
def test_t10_i32_unpack_k384_matches_jax(scales, interpret, no_launch):
    """K = 384: K/2 = 192 ends half-way through the card kernel's last
    128-byte stage, where a zero packed byte unpacks to lo = -8 and must meet
    zeros of x (the kernel's map of x's low half is K/2 wide); the JAX kernel
    takes the whole K/2 as one block.  The accumulators exactly, the bf16
    output exactly with unit scales, else within one bf16 ulp."""
    m, k, n = 64, 384, 256
    xq, wq, packed, xs, wsb = _w4_operands(11, m, k, n, scales)
    want = j_t10.i32_matmul(jnp.asarray(xq), jnp.asarray(packed), jnp.asarray(xs),
                            jnp.asarray(wsb), 32, 128, 192)
    got, acc = t_t10.i32_matmul(_t(xq), _t(packed.T), _t(xs), _t(wsb), return_acc=True)
    exact = xq.astype(np.int64) @ wq.astype(np.int64)
    np.testing.assert_array_equal(acc.numpy(), exact)
    assert got.dtype == torch.bfloat16
    if scales == "unit":
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        _within_ulps(got, want, "bf16", exact * xs * wsb[0])


@pytest.mark.parametrize("out_dtype,scales", [("float32", "unit"), ("float32", "random"),
                                              ("bfloat16", "random"), ("int8", "unit")])
def test_t12_and_only_matches_jax(out_dtype, scales, interpret, no_launch):
    m, k, n = 64, 512, 256
    xq, wq, packed, xs, wsb = _w4_operands(3, m, k, n, scales)
    if out_dtype == "int8":
        wsb[0] = 1.0 / 64        # a power of two: exact, and most outputs in range
    want = j_t12.w4a8_i8_matmul(jnp.asarray(xq), jnp.asarray(packed), jnp.asarray(xs),
                                jnp.asarray(wsb), getattr(jnp, out_dtype),
                                block_m=32, block_n=128, block_k2=128)
    got, acc = t_t12.w4a8_i8_matmul(_t(xq), _t(packed.T), _t(xs), _t(wsb),
                                    getattr(torch, out_dtype), return_acc=True)
    np.testing.assert_array_equal(acc.numpy(), xq.astype(np.int64) @ wq.astype(np.int64))
    assert got.dtype == getattr(torch, out_dtype)
    if scales == "unit":
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        _within_ulps(got, want, "fp32" if out_dtype == "float32" else "bf16",
                     acc.double().numpy() * xs * wsb[0])


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16", "int8"])
def test_t12_and_only_k384_matches_jax(out_dtype, interpret, no_launch):
    """K = 384: K/2 = 192 is no multiple of the card kernel's 128-byte stage
    (its last stage reads TMA's zeros past K/2), and the JAX kernel walks it
    in three 64-row blocks.  Integers exactly; unit scales, so every output
    dtype compares exactly (int8 with wsb[0] = 1/64, a power of two)."""
    m, k, n = 64, 384, 256
    xq, wq, packed, xs, wsb = _w4_operands(10, m, k, n, "unit")
    if out_dtype == "int8":
        wsb[0] = 1.0 / 64
    want = j_t12.w4a8_i8_matmul(jnp.asarray(xq), jnp.asarray(packed), jnp.asarray(xs),
                                jnp.asarray(wsb), getattr(jnp, out_dtype),
                                block_m=32, block_n=128, block_k2=64)
    got, acc = t_t12.w4a8_i8_matmul(_t(xq), _t(packed.T), _t(xs), _t(wsb),
                                    getattr(torch, out_dtype), return_acc=True)
    np.testing.assert_array_equal(acc.numpy(), xq.astype(np.int64) @ wq.astype(np.int64))
    assert got.dtype == getattr(torch, out_dtype)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_t12_int8_out_saturates_as_jax(interpret, no_launch):
    """A zero scale row leaves the bias row as the output: 300 -> 127, -300
    -> -128, 127.6 -> 127, -128.7 -> -128 in JAX and in the port
    (``Tensor.to(torch.int8)`` alone would give 44 for 300)."""
    m, k, n = 32, 256, 128
    xq, _, packed, xs, wsb = _w4_operands(4, m, k, n, "random")
    edge = np.array([300.0, -300.0, 127.6, -128.7, 126.9, -127.9, 0.5, -0.5], np.float32)
    wsb[0] = 0.0
    wsb[1] = np.resize(edge, n)
    want = np.asarray(j_t12.w4a8_i8_matmul(jnp.asarray(xq), jnp.asarray(packed),
                                           jnp.asarray(xs), jnp.asarray(wsb), jnp.int8,
                                           block_m=32, block_n=128, block_k2=128))
    got = t_t12.w4a8_i8_matmul(_t(xq), _t(packed.T), _t(xs), _t(wsb), torch.int8)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[0, :8].numpy(), [127, -128, 127, -128, 126, -127, 0, 0])


def test_and_only_planes_give_the_exact_product():
    """Every byte value as a packed weight (hi = -8 included, whose plane
    byte 16 hi = -128 is still an int8) against x at -128 and 127."""
    packed = torch.arange(-128, 128, dtype=torch.int8).reshape(2, 128)
    x = torch.tensor([[-128] * 256, [127] * 256, list(range(-128, 128))], dtype=torch.int8)
    assert torch.equal(pi.and_only_acc(x, packed), tqm._exact_acc(x, packed))


# ---------------------------------------------------------------------------
# T11: the decode GEMV
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [8, 1])
def test_t11_gemv_matches_jax_exactly(m, interpret, no_launch):
    rng = np.random.default_rng(5)
    k, n = 512, 256
    xq = rng.integers(-128, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-7, 8, (k, n)).astype(np.int8)
    packed = j_t11.pack_offset(wq)
    want = np.asarray(j_t11.gemv_and_only(jnp.asarray(xq), jnp.asarray(packed), block_n=128))
    got = t_t11.gemv_and_only(_t(xq), _t(packed.T))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, xq.astype(np.int64) @ wq.astype(np.int64))


@pytest.mark.parametrize("m,k", [(3, 512), (8, 544), (3, 544)])
def test_t11_gemv_edges_match_jax_exactly(m, k, interpret, no_launch):
    """m = 3 (x rows past m arrive as zeros on the card) and K = 544, whose
    K/2 = 272 is no multiple of the card kernel's 128-byte stage (its last
    stage reads zeros past K/2 in the packed box and in both halves of x,
    and its row sums take only x's low half)."""
    rng = np.random.default_rng(12 + k + m)
    n = 256
    xq = rng.integers(-128, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-7, 8, (k, n)).astype(np.int8)
    packed = j_t11.pack_offset(wq)
    want = np.asarray(j_t11.gemv_and_only(jnp.asarray(xq), jnp.asarray(packed), block_n=128))
    got = t_t11.gemv_and_only(_t(xq), _t(packed.T))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, xq.astype(np.int64) @ wq.astype(np.int64))


def test_pack_offset_is_the_jax_tools_and_k3s_packing():
    rng = np.random.default_rng(6)
    w = rng.normal(size=(64, 96)).astype(np.float32)    # [N, K]
    w4, w_scale = tqm.quantize_weight_int4(_t(w))
    wq = torch.clamp(torch.round(_t(w) / w_scale[:, None]), -7, 7).to(torch.int8)
    packed = pi.pack_offset(wq)
    assert torch.equal(packed, w4)
    np.testing.assert_array_equal(packed.numpy().T, j_t12.pack_offset(wq.numpy().T))
    np.testing.assert_array_equal(packed.numpy().T, j_t11.pack_offset(wq.numpy().T))


# ---------------------------------------------------------------------------
# T4: fixed-max attention with int8 QK^T
# ---------------------------------------------------------------------------

def _t4_inputs(seed, b=2, n=2, s=256, d=128):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, n, s, d)).astype(np.float32) for _ in range(3))
    bias = (rng.normal(size=(b, 1, s)) * 0.5).astype(np.float32)
    bias[1, :, -40:] = -1e30
    return q, k, v, bias


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_t4_int8qk_matches_jax(dtype, interpret, no_launch):
    q, k, v, bias = _t4_inputs(7)
    jdt, tdt = (np.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    want = _np(j_t4.fixedmax_int8qk(jq, jk, jv, jnp.asarray(bias), 128, 128))
    got = t_t4.fixedmax_int8qk(*(_t(_np(a)).to(tdt) for a in (jq, jk, jv)), _t(bias))
    assert got.dtype == tdt
    _t4_compare(_np(got), want, dtype)


def _t4_compare(got, want, dtype):
    """fp32 inputs within 1e-5 of the largest output, bf16 ones under the
    card's gates (max |err| 4e-3, rel-L2 5e-3)."""
    err = np.abs(got - want).max()
    if dtype == "fp32":
        assert err <= 1e-5 * np.abs(want).max(), err
    else:
        assert err <= 4e-3 and np.linalg.norm(got - want) / np.linalg.norm(want) <= 5e-3, err


# S_q, S_k and JAX's blocks: a partial last 128-key tile of the port's walk
# (1088 = 8.5 x 128), S_q != S_k, and batch 0 blocked on every key
T4_TILE_CASES = {"s1088": (1088, 1088, 1088, 544), "sq1152_sk1088": (1152, 1088, 576, 544),
                 "blocked_batch": (1088, 1088, 1088, 544)}


@pytest.mark.parametrize("case", list(T4_TILE_CASES))
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_t4_int8qk_key_tiles_match_jax(dtype, case, interpret, no_launch):
    """The plain version walks the card kernel's 128-key tiles, the last one
    partial at S_k 1088, against JAX's kernel in blocks that divide S; a
    batch blocked on every key gives 0 in both."""
    sq, sk, block_q, block_k = T4_TILE_CASES[case]
    rng = np.random.default_rng(11)
    q = rng.normal(size=(2, 1, sq, 128)).astype(np.float32)
    k, v = (rng.normal(size=(2, 1, sk, 128)).astype(np.float32) for _ in range(2))
    bias = (rng.normal(size=(2, 1, sk)) * 0.5).astype(np.float32)
    bias[1, :, -64:] = -1e30
    if case == "blocked_batch":
        bias[0] = -1e30
    jdt, tdt = (np.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    want = _np(j_t4.fixedmax_int8qk(jq, jk, jv, jnp.asarray(bias), block_q, block_k))
    got = _np(t_t4.fixedmax_int8qk(*(_t(_np(a)).to(tdt) for a in (jq, jk, jv)), _t(bias)))
    _t4_compare(got, want, dtype)
    if case == "blocked_batch":
        assert not got[0].any() and not want[0].any()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_t4_row_quantizer_codes_equal_jax(dtype, interpret, monkeypatch):
    """The int8 codes and scales that reach JAX's kernel (caught at its
    ``pallas_call``, run eagerly) against the port's wrapper work (on the
    CPU, the plain version of the card's quantize kernel), with ties at
    +-0.5, +-1.5, +-2.5 and 3.5 (half to even), zero rows and rows whose
    amax makes s exactly 1, in q and in k, and a row of small values whose
    scale is the 1e-8 floor."""
    q, k, _, _ = _t4_inputs(8, s=128)
    q[0, 0, 3] = 0.0                     # a zero row: the 1e-8 floor
    q[0, 1, 5] = 0.0                     # amax 127, so s = 1: ties half to even
    q[0, 1, 5, :6] = [127.0, 2.5, -2.5, 1.5, 0.5, -0.5]
    k[1, 0, 9] = 0.0
    k[1, 1, 2] = 0.0
    k[1, 1, 2, :7] = [-127.0, -1.5, 3.5, -0.5, 0.5, 2.5, -2.5]
    q[1, 0, 4] = 2.0 ** -24              # amax / 127 under 1e-8: codes x / 1e-8
    q[1, 0, 4, :2] = [2.0 ** -23, -(2.0 ** -22)]
    seen = []
    run = pl.pallas_call

    def catch(*args, **kwargs):
        call = run(*args, **kwargs)
        return lambda *operands: (seen.append(operands), call(*operands))[1]

    monkeypatch.setattr(pl, "pallas_call", catch)
    jdt, tdt = (np.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    jq, jk = jnp.asarray(q, jdt), jnp.asarray(k, jdt)
    with jax.disable_jit():
        j_t4.fixedmax_int8qk(jq, jk, jk, jnp.zeros((2, 1, 128), jnp.float32), 128, 128)
    qq, kq, _, qs, ks, _ = seen[0]
    got = t_t4._quantized(_t(_np(jq)).to(tdt), _t(_np(jk)).to(tdt))
    for mine, theirs in zip(got, (qq, kq, np.asarray(qs)[..., 0], np.asarray(ks)[..., 0])):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


def test_t4_raises_on_an_untiled_sequence():
    q = torch.zeros(1, 1, 100, 128)
    with pytest.raises(ValueError, match="multiples of the 64-row tile"):
        t_t4.fixedmax_int8qk(q, q, q, torch.zeros(1, 1, 100))


# ---------------------------------------------------------------------------
# T6: the elementwise pass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_t6_scale_matches_jax(dtype, interpret, no_launch):
    """bf16: c rounds to 1.0, one rounding, equal bits.  fp32: XLA-CPU's
    fma against the port's two roundings, within one ulp; the port's bits
    are numpy's float32 product then sum."""
    rng = np.random.default_rng(9)
    x = (rng.normal(size=(256, 512)) * 3).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (np.float32, torch.float32)
    jx = jnp.asarray(x, jdt)
    want = j_t6.pallas_scale(jx, 64, 128)
    c, d = t_t6.scale_constants(tdt)
    assert (c.item(), d.item()) == (float(jnp.asarray(0.999, jdt)), float(jnp.asarray(1e-4, jdt)))
    got = t_t6.pallas_scale(_t(_np(jx)).to(tdt))
    assert got.dtype == tdt
    if dtype == "bf16":
        assert c.item() == 1.0
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        np.testing.assert_array_equal(got.numpy(),
                                      x * np.float32(c.item()) + np.float32(d.item()))
        _within_ulps(got, want, "fp32", x * np.float32(c.item()))


# ---------------------------------------------------------------------------
# The kernel sources, the smoke's tables and the shared helpers
# ---------------------------------------------------------------------------

def _cases(source: str, pattern: str) -> dict:
    return {int(i): rest for i, *rest in re.findall(pattern, (CSRC / f"{source}.cu").read_text())}


def test_kernel_switches_match_the_variants():
    """Each variant's id selects, in its source's C entry point, the
    instantiation whose kernel and template arguments the variant names;
    every variant has its launch counter.  (The sources are compiled only
    on the card.)"""
    text = (CSRC / f"{pi.MATMUL}.cu").read_text()
    consts = {name: int(v) for name, v in re.findall(r"\b(k\w+) = (\d+)", text)}
    launchers = {"gemm": "gemm_wgmma_kernel", "w4": "w4_wgmma_kernel",
                 "gemv": "gemv_mma_kernel"}
    mm = {i: (launchers[fn], (consts[arg],) if arg else ()) for i, (fn, arg) in _cases(
        pi.MATMUL, r"case (\d+): return launch_(\w+)(?:<(\w+)>)?\(MM_ARGS\);").items()}
    ew = {i: ("ew_scale_kernel", (int(arg),)) for i, (arg,) in _cases(
        pi.EW, r"case (\d+): return launch<(\d)>").items()}
    # T4's source: two kernels, neither a template, each behind its own entry
    attention = (CSRC / f"{pi.ATTENTION}.cu").read_text()
    entries = {"int8qk_hopper_kernel": "proto_int8qk_attention_bf16",
               "int8qk_rowquant_kernel": "proto_int8qk_rowquant"}
    for kernel, entry in entries.items():
        assert re.search(rf"\)\n{kernel}\(", attention), kernel
        assert re.search(rf"extern \"C\" int {entry}\((?:.|\n)*?{kernel}<<<", attention), entry
    assert not re.search(r"template <[^\n]*>\n__global__", attention)
    tables = {pi.MATMUL: mm, pi.EW: ew,
              pi.ATTENTION: {0: ("int8qk_hopper_kernel", ()), 1: ("int8qk_rowquant_kernel", ())}}
    for source, table in tables.items():
        mine = {v.kernel_id: (v.kernel, v.template_args) for v in pi.VARIANTS.values()
                if v.source == source}
        assert mine == table, source
    assert set(pi.LAUNCHES) == set(pi.VARIANTS)
    # T9's two forms, T10 and T12 on TMA + wgmma GEMMs, T11 a TMA-fed
    # mma.sync GEMV; no variant runs the mma.sync tiling, and no source has
    # it: T11's kernel is the one user of mma.sync
    wgmma = {name for name, v in pi.VARIANTS.items() if "wgmma" in v.kernel}
    assert wgmma == {"proto_mm_i32", "proto_mm_f32", "proto_w4_i32", "proto_w4_and"}
    assert pi.VARIANTS["proto_w4_gemv_and"].kernel == "gemv_mma_kernel"
    assert not {name for name, v in pi.VARIANTS.items() if v.kernel == "tiled_kernel"}
    users = {src.name for src in CSRC.glob("*.cu") if "mma_s8_16832(" in src.read_text()}
    assert users == {f"{pi.MATMUL}.cu"}
    for source in CSRC.glob("*.cu*"):
        assert "tiled_kernel" not in source.read_text(), source.name
    gemv = text[text.index("gemv_mma_kernel("):]
    assert text.count("mma_s8_16832(") == gemv.count("mma_s8_16832(") == 2
    # T4 is an instantiation of the Hopper attention mainloop with an int8 Q K^T
    assert "hp::attention_mainloop(pol)" in attention and "using Score = int;" in attention


def test_chip_smoke_rows_and_sources_cover_every_probe():
    import chip_smoke

    rows = {name: (src, replaces) for name, src, replaces, _ in chip_smoke.KERNEL_ROWS}
    for name, var in pi.VARIANTS.items():
        assert rows[name][0] == f"physicedit_torch/csrc/{var.source}.cu", name
        path, line = rows[name][1].split(":")
        lines = (REPO / path).read_text().splitlines()[int(line) - 1:]
        assert lines[0].startswith("def ") and any("pl.pallas_call(" in ln for ln in lines[:40])
    assert set(pi.SOURCES) <= set(chip_smoke.KERNEL_SOURCES)
    assert pi in chip_smoke._counter_modules()
    loops = {name: chip_smoke.KERNEL_LOOPS[name] for name in pi.VARIANTS}
    assert loops["proto_w4_and"] == loops["proto_w4_i32"] == loops["proto_mm_i32"] == "tma_wgmma"
    assert loops["proto_int8qk"] == "hopper_attention"
    assert loops["proto_w4_gemv_and"] == "tma_mma_gemv"


def test_chip_smoke_reads_registers_of_the_probe_kernels(tmp_path):
    """``chip_smoke.ptxas_report(log, kernel)`` keys each kernel function's
    instantiations by their template arguments, () for a function that is
    no template."""
    import chip_smoke

    mangled = {("gemm_wgmma_kernel", (a,)): "_ZN12_GLOBAL__N_117gemm_wgmma_kernelILi"
               f"{a}EEEv14CUtensorMap_stS1_Pviiiii" for a in range(2)}
    mangled.update({("w4_wgmma_kernel", (a,)): "_ZN12_GLOBAL__N_115w4_wgmma_kernelILi"
                    f"{a}EEEv14CUtensorMap_stS1_S1_PKfS3_PKiPvPiiiiiiiii" for a in (2, 3)})
    mangled[("gemv_mma_kernel", ())] = ("_ZN12_GLOBAL__N_115gemv_mma_kernelE14CUtensorMap_st"
                                       "S0_S0_Piiiii")
    mangled[("int8qk_hopper_kernel", ())] = ("_ZN12_GLOBAL__N_120int8qk_hopper_kernelE14CUtensor"
                                            "Map_stS0_S0_PKfS2_S2_Ptiii")
    mangled[("int8qk_rowquant_kernel", ())] = ("_ZN12_GLOBAL__N_122int8qk_rowquant_kernelEPKtS1_"
                                              "PaS2_PfS3_llf")
    lines = []
    for i, name in enumerate(mangled.values()):
        lines += [f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
                  f"    0 bytes stack frame, {i} bytes spill stores, {2 * i} bytes spill loads",
                  f"ptxas info    : Used {100 + i} registers, used 1 barriers"]
    log = tmp_path / "probe.so.log"
    log.write_text("\n".join(lines) + "\n")
    for i, (kernel, args) in enumerate(mangled):
        assert chip_smoke.ptxas_report(log, kernel)[args] == {
            "registers": 100 + i, "spill_store_bytes": i, "spill_load_bytes": 2 * i}
    assert set(chip_smoke.ptxas_report(log, "w4_wgmma_kernel")) == {(2,), (3,)}
    assert set(chip_smoke.ptxas_report(log, "gemv_mma_kernel")) == {()}
    assert set(chip_smoke.ptxas_report(log, "gemm_wgmma_kernel")) == {(0,), (1,)}
    assert set(chip_smoke.ptxas_report(log, "int8qk_hopper_kernel")) == {()}


def test_l2_copies_and_their_rotation():
    """Copies fill twice the L2 (here a smaller bound); ``rotated`` takes
    the next copy at each call and keeps the last len(copies) results
    alive, so that no output's memory is written again at once."""
    t = torch.zeros(3 << 20, dtype=torch.uint8)
    copies = pi.l2_copies(t, min_bytes=10 << 20)
    assert len(copies) == 4 and copies[0] is t
    assert len({c.data_ptr() for c in copies}) == 4
    assert len(pi.l2_copies(torch.zeros(60 << 20, dtype=torch.uint8))) == 2
    assert len(pi.l2_copies(torch.zeros(101 << 20, dtype=torch.uint8))) == 1
    seen = []
    run = pi.rotated(lambda c: seen.append(c) or c[:8].clone(), copies)
    alive = [weakref.ref(run()) for _ in range(8)]
    assert [a is b for a, b in zip(seen, copies + copies)] == [True] * 8
    assert [r() is not None for r in alive] == [False] * 4 + [True] * 4


def test_w4_epilogue_converts_to_int8_as_jax():
    v = np.array([300.0, -300.0, 127.6, 127.0, -128.7, -128.0, 2.9, -2.9, 0.0, 1e9],
                 np.float32)
    got = pi.w4_epilogue(torch.ones(1, v.size, dtype=torch.int32), torch.ones(1, 1),
                         torch.stack([torch.zeros(v.size), _t(v)]), torch.int8)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jnp.asarray(v).astype(jnp.int8)))


@pytest.mark.parametrize("tool", TOOLS, ids=lambda m: m.NAME)
def test_tools_measure_the_card_only(tool):
    """Without a card each tool's ``main()`` stops before it measures."""
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main()

"""Port kernels K1-K10b, the q / k RMSNorm + RoPE kernel, the attention
prototypes and the int8, W4 and elementwise-rate probes on an NVIDIA GPU
against their plain versions.

Every test here needs a card and nvcc and skips without one.  The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import math

import pytest
import torch

from physicedit_torch.kernels import flash_attention as tfa
from physicedit_torch.kernels import fused_quant as tfq
from physicedit_torch.kernels import qk_norm_rope as tqk
from physicedit_torch.kernels import quant_matmul as tqm
from physicedit_torch.tools import _bench as tbench
from physicedit_torch.tools import _proto_attention as tpa
from physicedit_torch.tools import _proto_int8 as tpi
from physicedit_torch.tools import proto_attn_fast as t_t23
from physicedit_torch.tools import proto_attn_interleave as t_t5
from physicedit_torch.tools import proto_attn_int8qk as t_t4
from physicedit_torch.tools import proto_ew_rate as t_t6
from physicedit_torch.tools import proto_fixedmax as t_t7
from physicedit_torch.tools import proto_int8_rate as t_t9
from physicedit_torch.tools import proto_prefill_blocks as t_t10
from physicedit_torch.tools import proto_w4_gemv as t_t11
from physicedit_torch.tools import proto_w4_unpack as t_t12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


BF16_TOL = 2e-2  # bf16 kernel output against the plain version (fp32 softmax)
K7_REL_L2 = 5e-3  # and K7's rel-L2 over the whole output
# the attention prototypes, all on the Hopper loop (T2, T3, T1 v1-v4, T5, T7, T8)
HOPPER_PROTOS = list(tpa.VARIANTS)


@pytest.mark.cuda
def test_fixedmax_kernel_matches_plain_on_cuda(cuda):
    g = torch.Generator(cuda).manual_seed(0)
    q, k = (torch.randn(2, 3, 300, 128, device=cuda, generator=g) for _ in range(2))
    q = (q / q.pow(2).mean(-1, keepdim=True).sqrt()).bfloat16()
    k = (k / k.pow(2).mean(-1, keepdim=True).sqrt()).bfloat16()
    v = torch.randn(2, 3, 300, 128, device=cuda, generator=g).bfloat16()
    mask = torch.ones(2, 300, dtype=torch.bool, device=cuda)
    mask[1, 100:200] = False
    before = tfa.LAUNCHES["fixedmax_attention"]
    out, l = tfa.fixedmax_attention(q, k, v, mask, return_l=True)
    ref, l_ref = tfa.fixedmax_attention_reference(q, k, v, mask, return_l=True)
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)
    torch.testing.assert_close(l, l_ref, rtol=1e-4, atol=0)
    assert tfa.LAUNCHES["fixedmax_attention"] == before + 1


@pytest.mark.cuda
def test_fixedmax_kernel_clamp_binds_on_cuda(cuda):
    """q and k scaled so that many logits pass CLAMP: without the clamp
    exp2 overflows, so only a kernel that clamps as the plain version does
    agrees with it."""
    g = torch.Generator(cuda).manual_seed(3)
    q, k = (torch.randn(1, 2, 200, 128, device=cuda, generator=g) for _ in range(2))
    q = (8.0 * q / q.pow(2).mean(-1, keepdim=True).sqrt()).bfloat16()
    k = (8.0 * k / k.pow(2).mean(-1, keepdim=True).sqrt()).bfloat16()
    v = torch.randn(1, 2, 200, 128, device=cuda, generator=g).bfloat16()
    mask = torch.ones(1, 200, dtype=torch.bool, device=cuda)
    mask[0, 150:] = False
    logits = tfa._prescale(q).float() @ k.float().transpose(-1, -2)
    assert (logits > tfa.CLAMP).any()
    out, l = tfa.fixedmax_attention(q, k, v, mask, clamp=True, return_l=True)
    ref, l_ref = tfa.fixedmax_attention_reference(q, k, v, mask, clamp=True, return_l=True)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)
    torch.testing.assert_close(l, l_ref, rtol=1e-4, atol=0)


@pytest.mark.cuda
def test_gqa_kernel_matches_plain_on_cuda(cuda):
    g = torch.Generator(cuda).manual_seed(1)
    q = torch.randn(2, 300, 28, 128, device=cuda, generator=g).bfloat16()
    k = torch.randn(2, 300, 4, 128, device=cuda, generator=g).bfloat16()
    v = torch.randn(2, 300, 4, 128, device=cuda, generator=g).bfloat16()
    mask = torch.ones(2, 300, dtype=torch.bool, device=cuda)
    mask[0, :77] = False
    out = tfa.gqa_causal_attention(q, k, v, mask)
    ref = tfa.gqa_causal_attention_reference(q, k, v, mask)
    live = mask[:, :, None].expand_as(out)
    torch.testing.assert_close(out.float()[live], ref.float()[live],
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.cuda
def test_kernel_wrappers_raise_on_unsupported_inputs(cuda):
    x = torch.zeros(1, 1, 64, 128, device=cuda)          # fp32: not taken
    with pytest.raises(ValueError, match="bf16"):
        tfa.fixedmax_attention(x, x, x)
    y = torch.zeros(1, 1, 64, 64, device=cuda, dtype=torch.bfloat16)   # head_dim 64
    with pytest.raises(ValueError, match="head_dim"):
        tfa.fixedmax_attention(y, y, y)


@pytest.mark.cuda
def test_fully_masked_rows_are_zero_on_cuda(cuda):
    """K1 rows with every key masked, and K2 left-pad query rows (no live
    key), come out as exactly 0."""
    g = torch.Generator(cuda).manual_seed(2)
    q = torch.randn(1, 2, 100, 128, device=cuda, generator=g).bfloat16()
    out = tfa.fixedmax_attention(q, q, q, torch.zeros(1, 100, dtype=torch.bool, device=cuda))
    assert torch.equal(out, torch.zeros_like(out))
    qg = torch.randn(1, 130, 14, 128, device=cuda, generator=g).bfloat16()
    kg = torch.randn(1, 130, 2, 128, device=cuda, generator=g).bfloat16()
    mask = torch.ones(1, 130, dtype=torch.bool, device=cuda)
    mask[0, :70] = False
    out = tfa.gqa_causal_attention(qg, kg, kg, mask)
    assert torch.equal(out[0, :70], torch.zeros_like(out[0, :70]))
    assert torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 13, 100, 300])
def test_w4a8_kernel_matches_plain_on_cuda(cuda, m):
    """K3 in both regimes (M <= 16 GEMV, tiled above) and at ragged M: the
    int32 accumulators exactly, the bf16 outputs bit for bit (the epilogue
    runs in the same order in fp32)."""
    g = torch.Generator(cuda).manual_seed(m)
    k, n = 768, 384
    xq = torch.randint(-127, 128, (m, k), device=cuda, dtype=torch.int8, generator=g)
    w4 = torch.randint(-128, 128, (n, k // 2), device=cuda, dtype=torch.int8, generator=g)
    xs = torch.rand(m, 1, device=cuda, generator=g) * 0.01 + 1e-3
    ws = torch.rand(n, device=cuda, generator=g) * 0.01 + 1e-3
    b = torch.randn(n, device=cuda, generator=g).bfloat16()
    before = tqm.LAUNCHES["w4a8_matmul"]
    out, acc = tqm.w4a8_matmul(xq, w4, xs, ws, b, return_acc=True)
    ref, acc_ref = tqm.w4a8_matmul_reference(xq, w4, xs, ws, b, return_acc=True)
    assert torch.equal(acc, acc_ref)
    assert torch.equal(out, ref)
    assert tqm.LAUNCHES["w4a8_matmul"] == before + 1


@pytest.mark.cuda
def test_w4a8_kernel_rejects_untileable_layers(cuda):
    xq = torch.zeros(4, 200, device=cuda, dtype=torch.int8)
    w4 = torch.zeros(128, 100, device=cuda, dtype=torch.int8)
    with pytest.raises(ValueError, match="multiples of 128"):
        tqm.w4a8_matmul(xq, w4, torch.ones(4, 1, device=cuda), torch.ones(128, device=cuda))


def _k3_operands(g, m, k, n, bias=True):
    dev = g.device
    xq = torch.randint(-127, 128, (m, k), device=dev, dtype=torch.int8, generator=g)
    w4 = torch.randint(-128, 128, (n, k // 2), device=dev, dtype=torch.int8, generator=g)
    xs = torch.rand(m, 1, device=dev, generator=g) * 0.01 + 1e-3
    ws = torch.rand(n, device=dev, generator=g) * 0.01 + 1e-3
    b = torch.randn(n, device=dev, generator=g).bfloat16() if bias else None
    return xq, w4, xs, ws, b


@pytest.mark.cuda
@pytest.mark.parametrize("k2", [128, 640, 9472])
@pytest.mark.parametrize("n", [128, 384])
@pytest.mark.parametrize("m", [17, 129, 255, 1000, 16384])
def test_w4a8_tiled_kernel_tile_edges_on_cuda(cuda, m, n, k2):
    """K3's tiled regime at the edges of its tiles (128 weight rows by 128 x
    rows; 128 packed bytes of k a stage, one stage at K/2 = 128, five at
    640, which a 256-byte stage would not divide; more tiles than SMs at
    M = 16384, so a block walks several): the int32 accumulators exactly and
    the bf16 outputs bit for bit."""
    g = torch.Generator(cuda).manual_seed(m + n + k2)
    xq, w4, xs, ws, b = _k3_operands(g, m, 2 * k2, n)
    before = dict(tqm.REGIME_LAUNCHES)
    out, acc = tqm.w4a8_matmul(xq, w4, xs, ws, b, return_acc=True)
    ref, acc_ref = tqm.w4a8_matmul_reference(xq, w4, xs, ws, b, return_acc=True)
    assert torch.equal(acc, acc_ref)
    assert torch.equal(out, ref)
    assert tqm.REGIME_LAUNCHES == {**before, "tiled": before["tiled"] + 1}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k3_gemv", "k3_tiled", "k3_tiled_no_bias", "k9", "k4",
                                    "k5"])
def test_w4_kernels_repeat_bit_for_bit_on_cuda(cuda, kernel):
    """Three calls give the same bits (no atomics, no order that changes)."""
    g = torch.Generator(cuda).manual_seed(81)
    if kernel in ("k4", "k5"):
        fn, _ = _row_pipeline_call(kernel, (5, 377, 3072), g)
        first = fn()
        assert all(torch.equal(a, b) for _ in range(2) for a, b in zip(first, fn()))
        return
    if kernel == "k9":
        go = torch.randn(700, 384, device=cuda, generator=g).bfloat16()
        w4 = torch.randint(-128, 128, (384, 640), device=cuda, dtype=torch.int8, generator=g)
        ws = torch.rand(384, device=cuda, generator=g) * 0.01 + 1e-3

        def fn():
            return tqm.w4_bwd_dx(go, w4, ws)
    else:
        m = 9 if kernel == "k3_gemv" else 700
        xq, w4, xs, ws, b = _k3_operands(g, m, 1280, 384, bias=kernel != "k3_tiled_no_bias")

        def fn():
            return tqm.w4a8_matmul(xq, w4, xs, ws, b)
    first = fn()
    assert all(torch.equal(first, fn()) for _ in range(2))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [64, 37])
def test_fused_quant_kernels_match_plain_on_cuda(cuda, s):
    """K4, K5 and K6 give the plain versions' int8 codes and scales exactly,
    at a tiling S and a ragged one."""
    g = torch.Generator(cuda).manual_seed(s)
    x = (torch.randn(2, s, 768, device=cuda, generator=g) * 3).bfloat16()
    sh, sc = ((torch.randn(2, 768, device=cuda, generator=g) * 0.5).bfloat16() for _ in range(2))
    heads = (torch.randn(2, 6, s, 128, device=cuda, generator=g) * 3).bfloat16()
    cases = [(tfq._ln_mod_quant(x, sh, sc, 1e-6), tfq.ln_mod_quant_reference(x, sh, sc, 1e-6)),
             (tfq._gelu_quant(x), tfq.gelu_quant_reference(x)),
             (tfq._transpose_quant(heads), tfq.transpose_quant_reference(heads))]
    for (q, qs), (q_ref, qs_ref) in cases:
        assert torch.equal(q, q_ref)
        assert torch.equal(qs, qs_ref)


@pytest.mark.cuda
def test_fused_quant_rounds_half_to_even_on_cuda(cuda):
    """Values at exact half steps of the quantization grid (scale 1: the row
    max is 127) round to the even code, as jnp.round does."""
    row = torch.zeros(768, device=cuda)
    row[:8] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 126.5])
    heads = row.reshape(6, 1, 128).expand(6, 8, 128).reshape(1, 6, 8, 128)
    q, qs = tfq._transpose_quant(heads.bfloat16().contiguous())
    assert q[0, 0, :8].tolist() == [127, 0, 2, 2, 0, -2, 4, 126]
    assert qs[0, 0, 0].item() == 1.0
    q_ref, _ = tfq.transpose_quant_reference(heads.bfloat16())
    assert torch.equal(q, q_ref)


# K4 / K5 shapes: the DiT widths (3072, 12288) at ragged and tiling S, batch
# boundaries (B = 3, S = 37; B = 5, where row groups walk several rows and
# some walks cross a boundary), the image and text streams, and widths that
# take other row groups (128: one warp; 5120: two or four; 32768: the block,
# eight chunks a thread)
ROW_PIPELINE_SHAPES = [(2, 64, 3072), (2, 1001, 3072), (3, 37, 3072), (5, 1001, 3072),
                       (2, 8192, 3072), (2, 64, 12288), (2, 1001, 12288), (3, 37, 12288),
                       (5, 377, 12288), (2, 1280, 12288), (1, 3, 128), (2, 300, 5120),
                       (1, 5, 32768)]


def _row_pipeline_call(kernel, shape, g):
    """K4 or K5 and its plain twin on random inputs of ``shape``."""
    dev = g.device
    x = (torch.randn(*shape, device=dev, generator=g) * 3).bfloat16()
    if kernel == "k4":
        sh, sc = ((torch.randn(shape[0], shape[2], device=dev, generator=g) * 0.5).bfloat16()
                  for _ in range(2))
        return (lambda: tfq._ln_mod_quant(x, sh, sc, 1e-6),
                lambda: tfq.ln_mod_quant_reference(x, sh, sc, 1e-6))
    return lambda: tfq._gelu_quant(x), lambda: tfq.gelu_quant_reference(x)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ROW_PIPELINE_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kernel", ["k4", "k5"])
def test_row_pipelines_match_plain_on_cuda(cuda, kernel, shape):
    """K4 and K5 (persistent blocks over a ring of rows) give their plain
    twins' int8 codes and scales exactly, at the DiT widths and wherever a
    block's walk ends off the ring's period or crosses a batch index."""
    g = torch.Generator(cuda).manual_seed(sum(shape))
    run, plain = _row_pipeline_call(kernel, shape, g)
    (q, qs), (q_ref, qs_ref) = run(), plain()
    assert torch.equal(q, q_ref)
    assert torch.equal(qs, qs_ref)
    # each row group walks a contiguous range of the rows
    rows = shape[0] * shape[1]
    launch = tfq.row_pipeline_launch("ln_mod_quant" if kernel == "k4" else "gelu_quant", rows,
                                     shape[2])
    walks = launch["grid"] * (8 // launch["warps_per_row"])
    ranges = [(rows * v // walks, rows * (v + 1) // walks) for v in range(walks)]
    if shape[0] == 5:
        assert any(r0 // shape[1] != (r1 - 1) // shape[1] for r0, r1 in ranges if r1 > r0)
    if shape in ((2, 8192, 3072), (2, 1001, 12288)):  # walks that wrap the ring off its period
        assert any(r1 - r0 > launch["stages"] and (r1 - r0) % launch["stages"]
                   for r0, r1 in ranges)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k4", "k5"])
def test_row_pipelines_round_half_steps_on_cuda(cuda, kernel):
    """Quotients y / scale exactly at 63.5 and one ulp either side, under
    scales that are not powers of two: with row max a (bf16) and y = a / 2,
    y / RN(a / 127) rounds to 63.5 or one of its neighbours, as a decides.
    K4 with scale = -1 passes shift through as y; K5 passes x >= 16 through
    (its sigmoid rounds to 1).  Codes and scales equal the twins'."""
    # bf16 row maxima over eight binades, every mantissa: 1024 scales
    a = torch.tensor([(128 + m) * 2.0 ** e for e in range(-2, 6) for m in range(128)],
                     device=cuda)
    pattern = torch.stack([a, a / 2, -a / 2, a / 2, a / 4, a / 8], 1)  # y per row
    if kernel == "k4":
        k = 3072
        shift = torch.zeros(len(a), k, device=cuda)
        shift[:, :pattern.shape[1]] = pattern
        shift, scale = shift.bfloat16(), torch.full_like(shift, -1.0).bfloat16()
        x = torch.randn(len(a), 3, k, device=cuda).bfloat16()
        (q, qs), (q_ref, qs_ref) = (tfq._ln_mod_quant(x, shift, scale, 1e-6),
                                    tfq.ln_mod_quant_reference(x, shift, scale, 1e-6))
        y = shift.float()
        codes = q[:, 0, :pattern.shape[1]]
    else:
        k = 12288
        pattern = pattern[:, [0, 1, 3]]  # the positive y: x >= 16 is passed through
        x = torch.zeros(1, len(a), k, device=cuda)
        x[0, :, :pattern.shape[1]] = pattern
        x = x.bfloat16()
        (q, qs), (q_ref, qs_ref) = tfq._gelu_quant(x), tfq.gelu_quant_reference(x)
        y = x[0].float()
        codes = q[0, :, :pattern.shape[1]]
    assert torch.equal(q, q_ref)
    assert torch.equal(qs, qs_ref)
    s = qs.reshape(len(a), -1)[:, :1]
    assert not torch.equal(s, torch.exp2(torch.log2(s).round()))  # not all powers of two
    quot = (y[:, 1] / s[:, 0])  # a / 2 over the scale
    half = torch.tensor(63.5, device=cuda)
    below = torch.nextafter(half, torch.tensor(0.0, device=cuda))
    above = torch.nextafter(half, torch.tensor(128.0, device=cuda))
    for edge, code in ((half, 64), (below, 63), (above, 64)):
        hit = quot == edge
        assert hit.any(), f"no quotient at {edge.item()!r}"
        assert (codes[hit, 1] == code).all()


@pytest.mark.cuda
def test_row_pipelines_raise_on_misaligned_or_strided_inputs(cuda):
    """K4 and K5 read their rows by bulk copies of 16-byte aligned,
    contiguous rows: a view one element into a buffer, or a transposed one,
    raises (no copy)."""
    buf = torch.zeros(2 * 64 * 768 + 1, dtype=torch.bfloat16, device=cuda)
    off = buf[1:].view(2, 64, 768)
    strided = torch.zeros(64, 2, 768, dtype=torch.bfloat16, device=cuda).transpose(0, 1)
    mod = torch.zeros(2, 768, dtype=torch.bfloat16, device=cuda)
    for x, match in ((off, "16-byte aligned"), (strided, "contiguous")):
        with pytest.raises(ValueError, match=match):
            tfq._ln_mod_quant(x, mod, mod, 1e-6)
        with pytest.raises(ValueError, match=match):
            tfq._gelu_quant(x)


def _rms(x, scale=1.0):
    return (scale * x / x.pow(2).mean(-1, keepdim=True).sqrt()).bfloat16()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["masked_ragged", "clamp_binds", "sq_ne_sk", "fully_masked"])
def test_fixedmax_bwd_kernel_matches_plain_on_cuda(cuda, case):
    """K8 against its plain version on the same q', l, out and g: bf16
    outputs within BF16_TOL of their scale (fp32 sums in another order, dS
    rounded to bf16 on both sides)."""
    b, n, sq, sk, scale, clamp, spans = {
        "masked_ragged": (2, 3, 300, 300, 1.0, True, [(250, 300), (10, 90)]),
        "clamp_binds": (1, 2, 200, 200, 8.0, True, [(150, 200)]),
        "sq_ne_sk": (1, 2, 130, 333, 1.0, False, [(300, 333)]),
        "fully_masked": (2, 1, 100, 100, 1.0, True, [(0, 0), (0, 100)]),
    }[case]
    g = torch.Generator(cuda).manual_seed(len(case))
    q = tfa._prescale(_rms(torch.randn(b, n, sq, 128, device=cuda, generator=g), scale))
    k = _rms(torch.randn(b, n, sk, 128, device=cuda, generator=g), scale)
    v = torch.randn(b, n, sk, 128, device=cuda, generator=g).bfloat16()
    go = torch.randn(b, n, sq, 128, device=cuda, generator=g).bfloat16()
    mask = torch.ones(b, sk, dtype=torch.bool, device=cuda)
    for row, (lo, hi) in enumerate(spans):
        mask[row, lo:hi] = False
    out, l = tfa._fixedmax_prescaled(q, k, v, mask, clamp, return_l=True)
    before = tfa.LAUNCHES["fixedmax_attention_bwd"]
    got = tfa.fixedmax_attention_bwd(q, k, v, mask, go, out, l, clamp)
    want = tfa.fixedmax_attention_bwd_reference(q, k, v, mask, go, out, l, clamp)
    assert tfa.LAUNCHES["fixedmax_attention_bwd"] == before + 1
    for x, y in zip(got, want):
        assert torch.isfinite(x).all()
        tol = BF16_TOL * max(1.0, y.float().abs().max().item())
        torch.testing.assert_close(x.float(), y.float(), rtol=BF16_TOL, atol=tol)
    if case == "fully_masked":
        assert all(torch.equal(x[1], torch.zeros_like(x[1])) for x in got)


@pytest.mark.cuda
def test_fixedmax_autograd_runs_k1_and_k8_on_cuda(cuda):
    g = torch.Generator(cuda).manual_seed(7)
    q, k = (_rms(torch.randn(1, 2, 200, 128, device=cuda, generator=g)).requires_grad_(True)
            for _ in range(2))
    v = torch.randn(1, 2, 200, 128, device=cuda, generator=g).bfloat16().requires_grad_(True)
    mask = torch.ones(1, 200, dtype=torch.bool, device=cuda)
    before = dict(tfa.LAUNCHES)
    tfa.fixedmax_attention(q, k, v, mask).float().square().sum().backward()
    assert tfa.LAUNCHES["fixedmax_attention"] == before["fixedmax_attention"] + 1
    assert tfa.LAUNCHES["fixedmax_attention_bwd"] == before["fixedmax_attention_bwd"] + 1
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


# K1 and K2 at the edges of the Hopper mainloop (csrc/hopper_attention.cuh):
# 128-row q tiles and 128-key stages, so a ragged last key tile, a key-mask
# hole across key 128, S_q < S_k, and left pads across query row 128; and a
# key mask that changes every stage (chip_smoke.stage_varying_mask), so that
# a tile masked with the liveness word of the tile that next takes its ring
# slot shows.
K1_EDGE_CASES = {
    # name: (b, n, sq, sk, masked [lo, hi) per batch row or "per_stage",
    #        clamp, q/k scale)
    "sk_129": (1, 2, 129, 129, [], True, 1.0),
    "sk_255": (2, 2, 255, 255, [(0, 0), (200, 255)], True, 1.0),
    "hole_across_key_128": (2, 3, 300, 300, [(100, 160), (0, 0)], False, 1.0),
    "sq_lt_sk_ragged_8513_clamp": (1, 2, 130, 8448 + 65, [(8400, 8513)], True, 8.0),
    "stage_varying_mask_8448": (2, 4, 8448, 8448, "per_stage", False, 1.0),
}


def _edge_mask(b, s, masked, device):
    """The key mask of an edge case: ``masked`` is a [lo, hi) span per batch
    row, a left pad per batch row, or "per_stage"."""
    from chip_smoke import stage_varying_mask

    if masked == "per_stage":
        return stage_varying_mask(b, s, device)
    mask = torch.ones(b, s, dtype=torch.bool, device=device)
    for row, span in enumerate(masked):
        lo, hi = span if isinstance(span, tuple) else (0, span)
        mask[row, lo:hi] = False
    return mask


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K1_EDGE_CASES))
def test_fixedmax_kernel_tile_edges_on_cuda(cuda, case):
    """K1 (out and l) against its plain version at the tile edges, two more
    calls and K1' prescaled, the same kernel with l null, bit for bit
    against the first."""
    b, n, sq, sk, spans, clamp, scale = K1_EDGE_CASES[case]
    g = torch.Generator(cuda).manual_seed(50 + sorted(K1_EDGE_CASES).index(case))
    q = _rms(torch.randn(b, n, sq, 128, device=cuda, generator=g), scale)
    k = _rms(torch.randn(b, n, sk, 128, device=cuda, generator=g), scale)
    v = torch.randn(b, n, sk, 128, device=cuda, generator=g).bfloat16()
    mask = _edge_mask(b, sk, spans, cuda)
    out, l = tfa.fixedmax_attention(q, k, v, mask, clamp, return_l=True)
    ref, l_ref = tfa.fixedmax_attention_reference(q, k, v, mask, clamp, return_l=True)
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)
    assert _rel_l2(out, ref) <= K7_REL_L2
    torch.testing.assert_close(l, l_ref, rtol=1e-4, atol=0)
    for _ in range(2):
        assert torch.equal(tfa.fixedmax_attention(q, k, v, mask, clamp), out)
    before = tfa.LAUNCHES["fixedmax_bnsd"]
    qs = tfa._prescale(q).contiguous()
    assert torch.equal(tfa.fixedmax_bnsd(qs, k, v, mask, clamp, prescaled=True), out)
    assert tfa.LAUNCHES["fixedmax_bnsd"] == before + 1


GQA_EDGE_CASES = {
    # name: (b, s, n, kv, left pad per batch row or "per_stage")
    "s_130": (1, 130, 14, 2, [0]),
    "s_129_pad_128": (2, 129, 8, 4, [5, 128]),
    "s_1500_pads_300_130": (2, 1500, 28, 4, [300, 130]),
    "stage_varying_mask_4096": (2, 4096, 28, 4, "per_stage"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GQA_EDGE_CASES))
def test_gqa_kernel_tile_edges_on_cuda(cuda, case):
    """K2 against its plain version on live rows (a live key at or before
    them) at lengths that are no multiple of 128, with left pads across
    query row 128; rows with no live key come out exactly 0; two more calls
    give the same bits."""
    b, s, n, kv, pads = GQA_EDGE_CASES[case]
    g = torch.Generator(cuda).manual_seed(60 + sorted(GQA_EDGE_CASES).index(case))
    q = torch.randn(b, s, n, 128, device=cuda, generator=g).bfloat16()
    k = torch.randn(b, s, kv, 128, device=cuda, generator=g).bfloat16()
    v = torch.randn(b, s, kv, 128, device=cuda, generator=g).bfloat16()
    mask = _edge_mask(b, s, pads, cuda)
    out = tfa.gqa_causal_attention(q, k, v, mask)
    ref = tfa.gqa_causal_attention_reference(q, k, v, mask)
    live = (mask.cumsum(1) > 0)[:, :, None].expand_as(out)
    torch.testing.assert_close(out.float()[live], ref.float()[live],
                               rtol=BF16_TOL, atol=BF16_TOL)
    assert _rel_l2(out[live], ref[live]) <= K7_REL_L2
    assert torch.equal(out[~live], torch.zeros_like(out[~live]))
    for _ in range(2):
        assert torch.equal(tfa.gqa_causal_attention(q, k, v, mask), out)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [300, 3504])
def test_fixedmax_autograd_matches_plain_k1_k8_on_cuda(cuda, s):
    """The gradients of the differentiable K1 (the kernel forward, K8
    backward) against K8's plain version on K1's plain outputs, also at the
    training slice's ragged joint length 3,504."""
    g = torch.Generator(cuda).manual_seed(8)
    q, k = (_rms(torch.randn(1, 2, s, 128, device=cuda, generator=g)) for _ in range(2))
    v = torch.randn(1, 2, s, 128, device=cuda, generator=g).bfloat16()
    go = torch.randn(1, 2, s, 128, device=cuda, generator=g).bfloat16()
    mask = torch.ones(1, s, dtype=torch.bool, device=cuda)
    mask[0, 120:140] = False
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    tfa.fixedmax_attention(qg, kg, vg, mask).backward(go)
    qs = tfa._prescale(q).contiguous()
    out, l = tfa._fixedmax_prescaled_reference(qs, k, v, mask, True)
    dqs, dk, dv = tfa.fixedmax_attention_bwd_reference(qs, k, v, mask, go, out, l, True)
    scale = torch.tensor(tfa.LOG2E / 128 ** 0.5, dtype=torch.bfloat16).item()
    for got, want in zip((qg.grad, kg.grad, vg.grad), (dqs.float() * scale, dk, dv)):
        tol = BF16_TOL * max(1.0, want.float().abs().max().item())
        torch.testing.assert_close(got.float(), want.float(), rtol=BF16_TOL, atol=tol)


def _misaligned(shape, device):
    """A contiguous bf16 view one element into a flat buffer: not 16-byte
    aligned, as TMA needs."""
    buf = torch.zeros(math.prod(shape) + 1, dtype=torch.bfloat16, device=device)
    x = buf[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2
    return x


@pytest.mark.cuda
def test_hopper_kernels_raise_on_misaligned_or_strided_inputs(cuda):
    """TMA takes 16-byte aligned, contiguous tensors: a contiguous view one
    bf16 element into a flat buffer, or a transposed view, raises (no copy)."""
    def misaligned(shape):
        return _misaligned(shape, cuda)

    shape = (1, 2, 130, 128)
    ok = torch.zeros(shape, dtype=torch.bfloat16, device=cuda)
    strided = torch.zeros(1, 130, 2, 128, dtype=torch.bfloat16, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.fixedmax_attention(ok, misaligned(shape), ok)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.fixedmax_bnsd(misaligned(shape), ok, ok, prescaled=True)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.fixedmax_attention(ok, ok, strided)
    # K7 and K1' scaled (one kernel), K8
    bias = torch.zeros(1, 130, 130, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.fixedmax_attention_bias(misaligned(shape), ok, ok, bias)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.fixedmax_attention_bias(ok, strided, ok, bias)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.fixedmax_bnsd(ok, ok, misaligned(shape), prescaled=False)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.fixedmax_bnsd(strided, ok, ok, prescaled=False)
    l = torch.ones(1, 2, 130, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.fixedmax_attention_bwd(ok, ok, ok, None, misaligned(shape), ok, l)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.fixedmax_attention_bwd(ok, strided, ok, None, ok, ok, l)
    gshape = (1, 130, 4, 128)
    gq = torch.zeros(gshape, dtype=torch.bfloat16, device=cuda)
    kv = torch.zeros(1, 130, 2, 128, dtype=torch.bfloat16, device=cuda)
    mask = torch.ones(1, 130, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.gqa_causal_attention(misaligned(gshape), kv, kv, mask)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.gqa_causal_attention(gq.transpose(1, 2).contiguous().transpose(1, 2), kv, kv, mask)
    # K10 and K10b
    nat = torch.zeros(1, 130, 130, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.online_attention(misaligned(shape), ok, ok)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.online_attention(strided, ok, ok)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.online_attention(misaligned(shape), ok, ok, bias=nat)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.online_attention(ok, ok, strided, bias=nat)
    # K3's tiled regime and K9: TMA maps over x / g and w4
    xq, w4, xs, ws, b = _k3_operands(torch.Generator(cuda).manual_seed(3), 40, 256, 128)
    buf = torch.zeros(xq.numel() + 1, dtype=torch.int8, device=cuda)
    x_off = buf[1:].view(xq.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tqm.w4a8_matmul(x_off, w4, xs, ws, b)
    with pytest.raises(ValueError, match="contiguous"):
        tqm.w4a8_matmul(torch.zeros(256, 40, dtype=torch.int8, device=cuda).T, w4, xs, ws, b)
    with pytest.raises(ValueError, match="contiguous"):
        tqm.w4a8_matmul(xq, torch.zeros(128, 128, dtype=torch.int8, device=cuda).T, xs, ws, b)
    go = torch.zeros(40, 128, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tqm.w4_bwd_dx(misaligned((40, 128)), w4, ws)
    with pytest.raises(ValueError, match="contiguous"):
        tqm.w4_bwd_dx(torch.zeros(128, 40, dtype=torch.bfloat16, device=cuda).T, w4, ws)
    with pytest.raises(ValueError, match="contiguous"):
        tqm.w4_bwd_dx(go, torch.zeros(128, 128, dtype=torch.int8, device=cuda).T, ws)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k1_with_l", "k1prime_prescaled", "k2", "k7",
                                    "k1prime_scaled", "k8", "k10", "k10b", "k3_tiled", "k9",
                                    "k4", "k5", "t9_i32", "t9_f32", "t12", "t4", "t10", "t11"]
                         + HOPPER_PROTOS)
def test_hopper_kernels_in_a_cuda_graph_give_the_eager_bits(cuda, kernel):
    """The tensor maps reach the kernel by value: a CUDA-graph replay gives
    the eager call's bits (K4 and K5: their persistent grids, sized once per
    card; the prototypes on the Hopper loop: T1 v1's and T5's padded key
    bias made inside the graph too; T9's persistent GEMM at a ragged M; T10
    and T12 at a ragged M and K = 384; T11's cluster launch at m 3, K 544 and
    N 1000; T4 with its quantize launch, at S 1088)."""
    g = torch.Generator(cuda).manual_seed(70)
    if kernel.startswith("t9"):
        x, w = _t9_operands(g, kernel[3:], 300, 384, 640)

        def fn():
            return (t_t9.pallas_mm(x, w, kernel[3:]),)
    elif kernel == "t12":
        xq, w4, xs, wsb = _w4_probe_operands(g, 300, 384, 384)

        def fn():
            return t_t12.w4a8_i8_matmul(xq, w4, xs, wsb, torch.bfloat16, return_acc=True)
    elif kernel == "t10":
        xq, w4, xs, wsb = _w4_probe_operands(g, 300, 384, 384)

        def fn():
            return t_t10.i32_matmul(xq, w4, xs, wsb, torch.bfloat16, return_acc=True)
    elif kernel == "t11":
        xq, w4, _, _ = _w4_probe_operands(g, 3, 544, 1000)

        def fn():
            return (t_t11.gemv_and_only(xq, w4),)
    elif kernel == "t4":
        q, k, v, bias = _t4_inputs(g, 2, 3, 1088, 1088)

        def fn():
            return (t_t4.fixedmax_int8qk(q, k, v, bias),)
    elif kernel in HOPPER_PROTOS:
        call, _ = _hopper_proto_call(kernel, g, 250, 333, [(100, 160), (0, 0)])

        def fn():
            return (call(),)
    elif kernel in ("k4", "k5"):
        fn, _ = _row_pipeline_call(kernel, (2, 1001, 12288), g)
    elif kernel == "k3_tiled":
        xq, w4, xs, ws, b = _k3_operands(g, 300, 1280, 384)

        def fn():
            return tqm.w4a8_matmul(xq, w4, xs, ws, b, return_acc=True)
    elif kernel == "k9":
        go = torch.randn(300, 384, device=cuda, generator=g).bfloat16()
        w4 = torch.randint(-128, 128, (384, 640), device=cuda, dtype=torch.int8, generator=g)
        ws = torch.rand(384, device=cuda, generator=g) * 0.01 + 1e-3

        def fn():
            return (tqm.w4_bwd_dx(go, w4, ws),)
    elif kernel == "k2":
        q = torch.randn(2, 300, 14, 128, device=cuda, generator=g).bfloat16()
        k, v = (torch.randn(2, 300, 2, 128, device=cuda, generator=g).bfloat16()
                for _ in range(2))
        mask = torch.ones(2, 300, dtype=torch.bool, device=cuda)
        mask[1, :140] = False

        def fn():
            return (tfa.gqa_causal_attention(q, k, v, mask),)
    elif kernel == "k8":
        q, k, v, _, mask = _k7_inputs(g, 2, 3, 250, 333)
        qs = tfa._prescale(q).contiguous()
        go = torch.randn(2, 3, 250, 128, device=cuda, generator=g).bfloat16()
        out, l = tfa._fixedmax_prescaled(qs, k, v, mask, True, return_l=True)

        def fn():
            return tfa.fixedmax_attention_bwd(qs, k, v, mask, go, out, l)
    else:
        q, k, v, bias, mask = _k7_inputs(g, 2, 3, 250, 333)
        qs = tfa._prescale(q).contiguous()
        bias_nat = bias / tfa.LOG2E

        def fn():
            if kernel == "k1prime_prescaled":
                return (tfa.fixedmax_bnsd(qs, k, v, mask, prescaled=True),)
            if kernel == "k1prime_scaled":
                return (tfa.fixedmax_bnsd(q, k, v, mask, prescaled=False),)
            if kernel == "k7":
                return (tfa.fixedmax_attention_bias(q, k, v, bias, mask),)
            if kernel == "k10":
                return (tfa.online_attention(q, k, v, mask),)
            if kernel == "k10b":
                return (tfa.online_attention(q, k, v, mask, bias_nat),)
            return tfa.fixedmax_attention(q, k, v, mask, return_l=True)
    eager = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(eager, captured))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 3072, 18432), (37, 512, 384), (300, 768, 256)]
                         # the edges of the kernel's tiles: 128 dx rows, 128
                         # packed columns, 64 n a stage
                         + [(m, k, n) for m in (1, 37, 129, 3120) for n in (128, 3072)
                            for k in (256, 1280)])
def test_w4_bwd_kernel_matches_plain_on_cuda(cuda, m, k, n):
    """K9 against its plain version: g2 = bf16(g * w_scale) identically, fp32
    sums in another order, bf16 dx."""
    g = torch.Generator(cuda).manual_seed(m)
    go = torch.randn(m, n, device=cuda, generator=g).bfloat16()
    w4 = torch.randint(-128, 128, (n, k // 2), device=cuda, dtype=torch.int8, generator=g)
    ws = torch.rand(n, device=cuda, generator=g) * 0.01 + 1e-3
    before = tqm.LAUNCHES["w4_bwd_dx"]
    got = tqm.w4_bwd_dx(go, w4, ws)
    want = tqm.w4_bwd_dx_reference(go, w4, ws)
    assert tqm.LAUNCHES["w4_bwd_dx"] == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2 * want.float().abs().max().item())


@pytest.mark.cuda
def test_w4_bwd_kernel_rejects_untileable_layers(cuda):
    with pytest.raises(ValueError, match="multiples of 128"):
        tqm.w4_bwd_dx(torch.zeros(4, 128, device=cuda, dtype=torch.bfloat16),
                      torch.zeros(128, 100, device=cuda, dtype=torch.int8),
                      torch.ones(128, device=cuda))


def _rel_l2(got, want):
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm()).item()


def _k7_inputs(g, b, n, sq, sk, scale=1.0, blocked_rows=()):
    """bf16 q/k/v (RMS-normed q and k, times ``scale``), an fp32 entity-style
    bias in exp2 units and a key mask."""
    q = _rms(torch.randn(b, n, sq, 128, device=g.device, generator=g), scale)
    k = _rms(torch.randn(b, n, sk, 128, device=g.device, generator=g), scale)
    v = torch.randn(b, n, sk, 128, device=g.device, generator=g).bfloat16()
    blocked = torch.rand(b, sq, sk, device=g.device, generator=g) < 0.3
    bias = torch.where(blocked, -1e30, 0.5 * torch.randn(b, sq, sk, device=g.device, generator=g))
    bias[:, :, 0] = 0.0
    bias[:, list(blocked_rows)] = -1e30
    mask = torch.ones(b, sk, dtype=torch.bool, device=g.device)
    mask[-1, sk - sk // 5:] = False
    return q, k, v, tfa.bias_log2(bias), mask


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["joint", "ragged_blocked_row", "clamp_binds"])
def test_fixedmax_bias_kernel_matches_plain_on_cuda(cuda, case):
    """K7 against its plain version: an entity bias over a joint sequence, a
    ragged S with a query row whose keys are all blocked (exactly 0), logits
    past the clamp.  Beside the elementwise check, rel-L2 within
    K7_REL_L2 (as chip_smoke.py gates it)."""
    b, n, sq, sk, scale, rows = {
        "joint": (2, 3, 320, 320, 1.0, ()),
        "ragged_blocked_row": (1, 2, 237, 237, 1.0, (5, 236)),
        "clamp_binds": (1, 2, 200, 200, 8.0, ()),
    }[case]
    g = torch.Generator(cuda).manual_seed(len(case))
    q, k, v, bias, mask = _k7_inputs(g, b, n, sq, sk, scale, rows)
    if case == "clamp_binds":
        logits = q.float() @ k.float().transpose(-1, -2) * (tfa.LOG2E / 128 ** 0.5)
        assert (logits > tfa.CLAMP).any()
    before = tfa.LAUNCHES["fixedmax_attention_bias"]
    out = tfa.fixedmax_attention_bias(q, k, v, bias, mask)
    ref = tfa.fixedmax_attention_bias_reference(q, k, v, bias, mask)
    assert tfa.LAUNCHES["fixedmax_attention_bias"] == before + 1
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)
    assert _rel_l2(out, ref) <= K7_REL_L2
    for r in rows:
        assert torch.equal(out[:, :, r], torch.zeros_like(out[:, :, r]))


@pytest.mark.cuda
def test_fixedmax_bias_kernel_reads_a_strided_slim_view_on_cuda(cuda):
    """The slim last block's queries (the base-image rows s_t .. s_t + base)
    read their bias rows as a view of the joint bias with its row pitch and
    batch stride: the same result as a contiguous copy."""
    g = torch.Generator(cuda).manual_seed(11)
    s_t, base, s = 40, 96, 232
    q, k, v, bias, mask = _k7_inputs(g, 2, 2, s, s)
    qs = q[:, :, s_t:s_t + base].contiguous()
    view = bias[:, s_t:s_t + base]
    assert not view.is_contiguous()
    out = tfa.fixedmax_attention_bias(qs, k, v, view, mask)
    torch.testing.assert_close(out, tfa.fixedmax_attention_bias(qs, k, v, view.contiguous(), mask),
                               rtol=0, atol=0)
    ref = tfa.fixedmax_attention_bias_reference(qs, k, v, view, mask)
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)
    assert _rel_l2(out, ref) <= K7_REL_L2


# K7 (and K1' scaled, its kernel without the bias) and K8 at the edges of
# their Hopper loops: 128-row q tiles and 128-key stages (K7), 64-row stream
# tiles (K8), so a ragged last tile, a key-mask hole across key 128, S_q < S_k
# with a blocked row past row 128, and a key mask (and for K7 a bias) that
# changes every stage.
K7_EDGE_CASES = {
    # name: (b, n, sq, sk, masked [lo, hi) per batch row or "per_stage", rows blocked)
    "sk_129": (1, 2, 129, 129, [(100, 129)], ()),
    "sk_255": (2, 2, 255, 255, [(0, 0), (200, 255)], ()),
    "hole_across_key_128": (2, 3, 300, 300, [(100, 160), (0, 0)], ()),
    "sq_130_lt_sk_385_blocked_row_129": (1, 2, 130, 385, [(350, 385)], (129,)),
    "stage_varying_mask_and_bias_1100": (2, 2, 1100, 1100, "per_stage", ()),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K7_EDGE_CASES))
def test_fixedmax_bias_kernel_tile_edges_on_cuda(cuda, case):
    """K7 against its plain version at the tile edges (blocked rows exactly
    0), two more calls bit for bit against the first; then K1' scaled, the
    same kernel without the bias, with the clamp on and off, likewise."""
    from chip_smoke import stage_varying_bias

    b, n, sq, sk, spans, rows = K7_EDGE_CASES[case]
    g = torch.Generator(cuda).manual_seed(80 + sorted(K7_EDGE_CASES).index(case))
    q, k, v, bias, _ = _k7_inputs(g, b, n, sq, sk, blocked_rows=rows)
    mask = _edge_mask(b, sk, spans, cuda)
    if spans == "per_stage":
        bias = stage_varying_bias(b, sq, sk, cuda, g)
    out = tfa.fixedmax_attention_bias(q, k, v, bias, mask)
    ref = tfa.fixedmax_attention_bias_reference(q, k, v, bias, mask)
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)
    assert _rel_l2(out, ref) <= K7_REL_L2
    for r in rows:
        assert torch.equal(out[:, :, r], torch.zeros_like(out[:, :, r]))
    for _ in range(2):
        assert torch.equal(tfa.fixedmax_attention_bias(q, k, v, bias, mask), out)
    for clamp in (True, False):
        out = tfa.fixedmax_bnsd(q, k, v, mask, clamp=clamp, prescaled=False)
        ref = tfa.fixedmax_bnsd_reference(q, k, v, mask, clamp=clamp, prescaled=False)
        torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)
        assert _rel_l2(out, ref) <= K7_REL_L2
        for _ in range(2):
            assert torch.equal(tfa.fixedmax_bnsd(q, k, v, mask, clamp=clamp), out)


K8_EDGE_CASES = {
    # name: (b, n, sq, sk, masked [lo, hi) per batch row or "per_stage", clamp)
    "s_129": (1, 2, 129, 129, [(100, 129)], True),
    "s_300_hole_across_key_128": (2, 2, 300, 300, [(100, 160), (0, 0)], True),
    "sq_130_lt_sk_385": (1, 2, 130, 385, [(350, 385)], False),
    "stage_varying_mask_1100": (2, 2, 1100, 1100, "per_stage", True),
    "training_joint_3504": (1, 2, 3504, 3504, [(100, 256)], True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K8_EDGE_CASES))
def test_fixedmax_bwd_kernel_tile_edges_on_cuda(cuda, case):
    """K8 against its plain version at the edges of its 128-row own tiles
    and 64-row stream tiles, and two more calls bit for bit against the
    first (no atomics)."""
    b, n, sq, sk, spans, clamp = K8_EDGE_CASES[case]
    g = torch.Generator(cuda).manual_seed(90 + sorted(K8_EDGE_CASES).index(case))
    q = tfa._prescale(_rms(torch.randn(b, n, sq, 128, device=cuda, generator=g)))
    k = _rms(torch.randn(b, n, sk, 128, device=cuda, generator=g))
    v = torch.randn(b, n, sk, 128, device=cuda, generator=g).bfloat16()
    go = torch.randn(b, n, sq, 128, device=cuda, generator=g).bfloat16()
    mask = _edge_mask(b, sk, spans, cuda)
    out, l = tfa._fixedmax_prescaled(q, k, v, mask, clamp, return_l=True)
    got = tfa.fixedmax_attention_bwd(q, k, v, mask, go, out, l, clamp)
    want = tfa.fixedmax_attention_bwd_reference(q, k, v, mask, go, out, l, clamp)
    for x, y in zip(got, want):
        assert torch.isfinite(x).all()
        tol = BF16_TOL * max(1.0, y.float().abs().max().item())
        torch.testing.assert_close(x.float(), y.float(), rtol=BF16_TOL, atol=tol)
        assert _rel_l2(x, y) <= 1e-2
    for _ in range(2):
        again = tfa.fixedmax_attention_bwd(q, k, v, mask, go, out, l, clamp)
        assert all(torch.equal(x, y) for x, y in zip(again, got))


@pytest.mark.cuda
def test_fixedmax_bias_kernel_raises_on_unsupported_inputs(cuda):
    x = torch.zeros(1, 1, 64, 128, device=cuda)                        # fp32
    bias = torch.zeros(1, 64, 64, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        tfa.fixedmax_attention_bias(x, x, x, bias)
    y = torch.zeros(1, 1, 64, 64, device=cuda, dtype=torch.bfloat16)  # head_dim 64
    with pytest.raises(ValueError, match="head_dim"):
        tfa.fixedmax_attention_bias(y, y, y, bias)
    z = torch.zeros(1, 1, 64, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="fp32"):
        tfa.fixedmax_attention_bias(z, z, z, bias.bfloat16())
    with pytest.raises(RuntimeError, match="forward only"):
        tfa.fixedmax_attention_bias(z.clone().requires_grad_(True), z, z, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged_masked", "sq_lt_sk", "bias_blocked_row",
                                  "unbounded_logits"])
def test_online_kernel_matches_plain_on_cuda(cuda, case):
    """K10 (and K10b with a natural-log bias) against its plain version: a
    ragged S with masked keys, S_q < S_k, a query row whose keys are all
    blocked (exactly 0), and logits far past any fixed max (q and k x 10)."""
    b, n, sq, sk, scale, rows = {
        "ragged_masked": (2, 3, 301, 301, 1.0, None),
        "sq_lt_sk": (1, 2, 96, 333, 1.0, None),
        "bias_blocked_row": (1, 2, 237, 237, 1.0, (5, 236)),
        "unbounded_logits": (1, 2, 200, 200, 10.0, None),
    }[case]
    g = torch.Generator(cuda).manual_seed(20 + len(case))
    q, k, v, bias_log2, mask = _k7_inputs(g, b, n, sq, sk, scale, rows or ())
    bias = None if rows is None else bias_log2 / tfa.LOG2E
    name = "online_attention" if bias is None else "online_attention_bias"
    before = tfa.LAUNCHES[name]
    out = tfa.flash_attention_bnsd(q, k, v, mask, bias=bias, variant="online")
    ref = tfa.online_attention_reference(q, k, v, mask, bias)
    assert tfa.LAUNCHES[name] == before + 1
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)
    assert _rel_l2(out, ref) <= K7_REL_L2
    for r in rows or ():
        assert torch.equal(out[:, :, r], torch.zeros_like(out[:, :, r]))


@pytest.mark.cuda
def test_online_bias_kernel_reads_a_strided_view_on_cuda(cuda):
    g = torch.Generator(cuda).manual_seed(12)
    s_t, base, s = 40, 96, 232
    q, k, v, bias, mask = _k7_inputs(g, 2, 2, s, s)
    bias = bias / tfa.LOG2E
    qs = q[:, :, s_t:s_t + base].contiguous()
    view = bias[:, s_t:s_t + base]
    out = tfa.online_attention(qs, k, v, mask, view)
    torch.testing.assert_close(out, tfa.online_attention(qs, k, v, mask, view.contiguous()),
                               rtol=0, atol=0)
    ref = tfa.online_attention_reference(qs, k, v, mask, view)
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)


# K10 / K10b at the edges of the Hopper loop's 128-row q tiles and 128-key
# stages.  Rows "first" have the bias block keys [0, 128) and [200, 240)
# (the running max is still at its start when the first tile ends), rows
# "blocked" every key at -1e30 and rows "band" every key at ONLINE_BAND.
ONLINE_EDGE_CASES = {
    # name: (b, n, sq, sk, masked [lo, hi) per batch row or "per_stage",
    #        q/k scale, rows first, blocked, band)
    "sk_129": (1, 2, 129, 129, [(0, 0)], 1.0, (), (), ()),
    "sk_255": (2, 2, 255, 255, [(0, 0), (200, 255)], 1.0, (), (), ()),
    "hole_across_key_128": (2, 3, 300, 300, [(100, 160), (0, 0)], 1.0, (), (), ()),
    "sq_300_gt_sk_129": (1, 2, 300, 129, [(120, 125)], 1.0, (), (), ()),
    "first_tile_blocked_row": (1, 2, 300, 385, [(350, 385)], 1.0, (3, 130), (4, 131), (5,)),
    "unbounded_logits_1100": (2, 2, 1100, 1100, "per_stage", 10.0, (), (), ()),
}
# In exp2 units -8.7e29: below the kernel's -5e29 threshold, above the
# running max's start (-1e30), so only that test keeps such a key's weight 0.
ONLINE_BAND = -6e29


def _online_edge_inputs(case, g, dev):
    b, n, sq, sk, spans, scale, first, blocked, band = ONLINE_EDGE_CASES[case]
    q, k, v, bias, _ = _k7_inputs(g, b, n, sq, sk, scale, blocked)
    bias = bias / tfa.LOG2E
    for r in first:
        bias[:, r, :128] = -1e30
        bias[:, r, 200:240] = -1e30
    if band:
        bias[:, list(band)] = ONLINE_BAND
    if scale != 1.0:   # the outputs near one-hot rows of v: v / scale keeps bf16 steps small
        v = (v.float() / scale).bfloat16()
    return q, k, v, bias, _edge_mask(b, sk, spans, dev), first, blocked + band


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [False, True], ids=["k10", "k10b"])
@pytest.mark.parametrize("case", list(ONLINE_EDGE_CASES))
def test_online_kernel_tile_edges_on_cuda(cuda, case, with_bias):
    """K10 and K10b against their plain versions at the tile edges, S_q >
    S_k, logits far past any fixed max and a key mask that changes every
    stage; K10b also with rows whose first key tile the bias blocks (within
    the gates) beside rows it blocks wholly (exactly 0); two more calls bit
    for bit against the first."""
    g = torch.Generator(cuda).manual_seed(100 + sorted(ONLINE_EDGE_CASES).index(case))
    q, k, v, bias, mask, first, dead = _online_edge_inputs(case, g, cuda)
    if not with_bias:
        bias, first, dead = None, (), ()
    name = "online_attention_bias" if with_bias else "online_attention"
    before = tfa.LAUNCHES[name]
    out = tfa.online_attention(q, k, v, mask, bias)
    assert tfa.LAUNCHES[name] == before + 1
    ref = tfa.online_attention_reference(q, k, v, mask, bias)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)
    assert (out.float() - ref.float()).abs().max().item() <= 4e-3
    assert _rel_l2(out, ref) <= K7_REL_L2
    for r in first:
        assert out[:, :, r].abs().max() > 0
    for r in dead:
        assert torch.equal(out[:, :, r], torch.zeros_like(out[:, :, r]))
    for _ in range(2):
        assert torch.equal(tfa.online_attention(q, k, v, mask, bias), out)


@pytest.mark.cuda
def test_online_kernel_with_no_keys_gives_zeros_on_cuda(cuda):
    """S_k = 0: every query row has no live key, so K10 and K10b give 0, as
    their plain version does."""
    q = torch.ones(1, 2, 130, 128, device=cuda, dtype=torch.bfloat16)
    kv = torch.zeros(1, 2, 0, 128, device=cuda, dtype=torch.bfloat16)
    for bias in (None, torch.zeros(1, 130, 0, device=cuda)):
        out = tfa.online_attention(q, kv, kv, bias=bias)
        assert torch.equal(out, torch.zeros_like(q))
        assert torch.equal(out, tfa.online_attention_reference(q, kv, kv, bias=bias))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [2304, 2303], ids=["pitch_16_bytes", "ragged_pitch"])
def test_online_bias_kernel_reads_views_of_any_pitch_on_cuda(cuda, s):
    """K10b's bias rows as a view (the rows of a slim block's queries, with
    the joint bias's row pitch and batch stride): a pitch of whole 16-byte
    groups (16-byte copies) and a ragged one (4-byte copies) each give the
    bits of a contiguous copy."""
    g = torch.Generator(cuda).manual_seed(s)
    s_t, base = 40, 300
    q, k, v, bias, mask = _k7_inputs(g, 2, 2, s, s)
    bias = bias / tfa.LOG2E
    qs = q[:, :, s_t:s_t + base].contiguous()
    view = bias[:, s_t:s_t + base]
    assert not view.is_contiguous() and view.stride(1) == s
    out = tfa.online_attention(qs, k, v, mask, view)
    assert torch.equal(out, tfa.online_attention(qs, k, v, mask, view.contiguous()))
    ref = tfa.online_attention_reference(qs, k, v, mask, view)
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)
    assert _rel_l2(out, ref) <= K7_REL_L2


@pytest.mark.cuda
@pytest.mark.parametrize("clamp", [True, False])
@pytest.mark.parametrize("prescaled", [True, False])
def test_fixedmax_bnsd_kernel_matches_plain_on_cuda(cuda, prescaled, clamp):
    """K1': K1's kernel without l (prescaled) or K7's without the bias,
    with the clamp on or off, against its plain version."""
    g = torch.Generator(cuda).manual_seed(30 + 2 * prescaled + clamp)
    q, k, v, _, mask = _k7_inputs(g, 2, 3, 250, 250)
    if prescaled:
        q = tfa._prescale(q).contiguous()
    before = tfa.LAUNCHES["fixedmax_bnsd"]
    out = tfa.fixedmax_bnsd(q, k, v, mask, clamp=clamp, prescaled=prescaled)
    ref = tfa.fixedmax_bnsd_reference(q, k, v, mask, clamp=clamp, prescaled=prescaled)
    assert tfa.LAUNCHES["fixedmax_bnsd"] == before + 1
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=BF16_TOL)
    assert _rel_l2(out, ref) <= K7_REL_L2


@pytest.mark.cuda
def test_attention_api_dispatch_on_cuda(cuda):
    """ops.attention.attention(impl="kernels") reaches K10 for
    variant="online" and K1 for "fixedmax"; a bias goes to the dense
    softmax (no kernel), as the JAX package routes it."""
    from physicedit_torch.ops.attention import attention

    g = torch.Generator(cuda).manual_seed(40)
    q, k, v, _, mask = _k7_inputs(g, 1, 2, 130, 130)
    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    tfa.reset_launch_counts()
    attention(q, k, v, mask, impl="kernels", variant="online")
    attention(q, k, v, mask, impl="kernels", variant="fixedmax")
    attention(q, k, v, mask, bias=torch.zeros(1, 1, 130, 130, device=cuda), impl="kernels")
    assert tfa.LAUNCHES["online_attention"] == 1 and tfa.LAUNCHES["fixedmax_attention"] == 1
    assert sum(tfa.LAUNCHES.values()) == 2
    with pytest.raises(ValueError, match="bf16"):
        attention(q.float(), k.float(), v.float(), mask, impl="kernels", variant="online")


def _proto_inputs(name, g, sq=300, sk=333):
    """The operands of prototype ``name`` at a ragged S: q prescaled unless
    the variant scales in the kernel; a key bias with masked spans, of which
    [150, 200) lies past the 128-key prefix that T8 and T5 bias (those keys
    stay live there); for T3 K and V zeroed where masked and the counts."""
    var = tpa.VARIANTS[name]
    q, k, v, _, mask = _k7_inputs(g, 2, 3, sq, sk)
    mask[0, 40:60] = False
    mask[0, 150:200] = False
    if name == "proto_nmask":
        q, k, v, nm = t_t23._nmask_operands(q, k, v, mask)
        return q, k, v, {"n_masked": nm}
    if not var.inscale:
        q = tfa._prescale(q).contiguous()
    kwargs = {}
    if var.bias != "none":
        prefix = "fixedmax2" in name or "interleave" in name
        kwargs = {"key_bias": tpa.mask_bias(mask), "bias_keys": 128 if prefix else sk}
    return q, k, v, kwargs


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(tpa.VARIANTS))
def test_proto_attention_kernel_matches_plain_on_cuda(cuda, name):
    """Each instantiation of ``csrc/proto_fixedmax_attention.cu`` against its
    plain version at S_q 300, S_k 333 (ragged edges): the normalised ones
    within the K1 gates, T1 v3 / v4 (unnormalised) relative to their largest
    output, as chip_smoke.py gates them."""
    g = torch.Generator(cuda).manual_seed(50 + tpa.VARIANTS[name].kernel_id)
    q, k, v, kwargs = _proto_inputs(name, g)
    before = tfa.LAUNCHES[name]
    out = tpa.run(name, q, k, v, **kwargs)
    ref = tpa.reference(name, q, k, v, **kwargs)
    assert tfa.LAUNCHES[name] == before + 1
    assert torch.isfinite(out).all()
    if tpa.VARIANTS[name].norm == "none":
        err = (out.float() - ref.float()).abs().max() / ref.float().abs().max()
        assert err <= 8e-3
    else:
        torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL, atol=4e-3)
    assert _rel_l2(out, ref) <= K7_REL_L2


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["proto_fixedmax2", "proto_interleave"])
def test_proto_attention_overlap_gives_the_same_bits_on_cuda(cuda, name):
    """Both names launch one instantiation: the same bits."""
    g = torch.Generator(cuda).manual_seed(60)
    q, k, v, kwargs = _proto_inputs(name, g, 257, 1000)
    assert torch.equal(tpa.run(name, q, k, v, **kwargs),
                       tpa.run(name + "_overlap", q, k, v, **kwargs))


@pytest.mark.cuda
def test_proto_attention_rows_with_no_live_key_on_cuda(cuda):
    """T7 and T5 (no floor on l) give NaN where a batch has no live key, T3
    0."""
    g = torch.Generator(cuda).manual_seed(61)
    q, k, v, _, _ = _k7_inputs(g, 2, 2, 130, 130)
    live = torch.ones(2, 130, dtype=torch.bool, device=cuda)
    live[1] = False
    assert torch.isnan(t_t7.fixedmax_bnsd(q, k, v, tpa.mask_bias(live))[1]).all()
    for overlap in (False, True):
        out = t_t5.attn_interleaved(q, k, v, tpa.mask_bias(live), 130, overlap)
        assert torch.isnan(out[1]).all()
        torch.testing.assert_close(
            out[0].float(), t_t5.attn_interleaved_reference(q, k, v, tpa.mask_bias(live),
                                                            130)[0].float(),
            rtol=BF16_TOL, atol=4e-3)
    out = t_t23.attn_nmask(q, k, v, live)
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    torch.testing.assert_close(out[0].float(), t_t23.attn_nmask_reference(q, k, v, live)[0].float(),
                               rtol=BF16_TOL, atol=4e-3)


@pytest.mark.cuda
def test_proto_attention_raises_on_unsupported_inputs(cuda):
    z = torch.zeros(1, 2, 64, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16"):
        tpa.run("proto_nobias", z.float(), z.float(), z.float())
    with pytest.raises(ValueError, match="key bias"):
        tpa.run("proto_fixedmax", z, z, z, None, 64)
    with pytest.raises(RuntimeError, match="forward only"):
        tpa.run("proto_noexp", z.clone().requires_grad_(True), z, z)


# the Hopper loop's 128-key tiles, as tests/test_torch_proto_attention.py's
# EDGE_CASES: (S_q, S_k, per batch row the keys that T3 masks and T1 v1's
# bias blocks)
PROTO_EDGE_CASES = {
    "sk_129": (129, 129, [(100, 120), (0, 0)]),
    "sk_255": (255, 255, [(0, 0), (200, 255)]),
    "sq_130_lt_sk_385": (130, 385, [(350, 385), (0, 0)]),
    "hole_across_key_128": (300, 300, [(100, 160), (0, 0)]),
}


def _hopper_proto_call(name, g, sq, sk, spans):
    """Calls of Hopper instantiation ``name`` and of its plain version on
    RMS-normed inputs (B 2, N 3) whose key mask (T3) or key bias (T1 v1, T5,
    T7, T8: -1e30 on the spans, normal x 0.5 elsewhere; the fp32 bias on a
    prefix of 200 keys, or 100 where S_k <= 200) holds ``spans``."""
    var = tpa.VARIANTS[name]
    q, k, v, _, _ = _k7_inputs(g, 2, 3, sq, sk)
    mask = torch.ones(2, sk, dtype=torch.bool, device=g.device)
    for i, (m0, m1) in enumerate(spans):
        mask[i, m0:m1] = False
    kwargs = {}
    if name == "proto_nmask":
        *args, nm = t_t23._nmask_operands(q, k, v, mask)
        kwargs = {"n_masked": nm}
    else:
        args = [q if var.inscale else tfa._prescale(q).contiguous(), k, v]
        if var.bias != "none":
            bias = torch.where(mask, 0.5 * torch.randn(2, sk, device=g.device, generator=g),
                               -1e30)
            # the fp32 bias's prefix ends inside a tile (keys it blocks past
            # it stay live; T7 scales the tiles past it all the same)
            bias_keys = (200 if sk > 200 else 100) if var.bias == "fp32" else sk
            kwargs = {"key_bias": bias[:, None, :], "bias_keys": bias_keys}
    return (lambda: tpa.run(name, *args, **kwargs)), (lambda: tpa.reference(name, *args,
                                                                            **kwargs))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(PROTO_EDGE_CASES))
@pytest.mark.parametrize("name", HOPPER_PROTOS)
def test_proto_hopper_tile_edges_on_cuda(cuda, name, case):
    """T2 (both scales), T3, T1 v1-v4, T7, and T5 and T8 (both names each)
    on the Hopper loop at its 128-key tile edges, under the card's gates for them (max
    |err| 4e-3 and rel-L2 5e-3; T1 v3 / v4 8e-3 of their largest output),
    three calls bit for bit."""
    g = torch.Generator(cuda).manual_seed(80 + tpa.VARIANTS[name].kernel_id)
    fn, plain = _hopper_proto_call(name, g, *PROTO_EDGE_CASES[case])
    out = fn()
    assert all(torch.equal(fn(), out) for _ in range(2))
    ref = plain()
    assert torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs().max().item()
    if tpa.VARIANTS[name].norm == "none":
        assert err <= 8e-3 * ref.float().abs().max().item()
    else:
        assert err <= 4e-3
    assert _rel_l2(out, ref) <= K7_REL_L2


@pytest.mark.cuda
@pytest.mark.parametrize("name", HOPPER_PROTOS)
def test_proto_hopper_raises_on_misaligned_or_strided_operands(cuda, name):
    """The Hopper loop reads q, k and v through TMA: a misaligned or a
    strided operand raises (no copy, no fallback to the plain version)."""
    shape = (1, 2, 130, 128)
    ok = torch.zeros(shape, dtype=torch.bfloat16, device=cuda)
    strided = torch.zeros(1, 130, 2, 128, dtype=torch.bfloat16, device=cuda).transpose(1, 2)
    kwargs = {"key_bias": torch.zeros(1, 1, 130, device=cuda), "bias_keys": 130} \
        if tpa.VARIANTS[name].bias != "none" else {}
    before = tfa.LAUNCHES[name]
    for args, match in (((_misaligned(shape, cuda), ok, ok), "16-byte aligned"),
                        ((ok, _misaligned(shape, cuda), ok), "16-byte aligned"),
                        ((ok, ok, strided), "contiguous"), ((strided, ok, ok), "contiguous")):
        with pytest.raises(ValueError, match=match):
            tpa.run(name, *args, **kwargs)
    assert tfa.LAUNCHES[name] == before


def _w4_probe_operands(g, m, k, n):
    """int8 x over [-127, 127], every byte a packed weight, row scales, and
    wsb with a bias row of normal x 100 (int8 outputs saturate)."""
    dev = g.device
    xq = torch.randint(-127, 128, (m, k), device=dev, generator=g, dtype=torch.int8)
    w4 = torch.randint(-128, 128, (n, k // 2), device=dev, generator=g, dtype=torch.int8)
    xs = torch.rand(m, 1, device=dev, generator=g) * 1e-2 + 1e-3
    wsb = torch.stack([torch.rand(n, device=dev, generator=g) * 1e-2 + 1e-3,
                       torch.randn(n, device=dev, generator=g) * 100])
    return xq, w4, xs, wsb


def _t9_operands(g, acc, m, n, k, values="integers"):
    """T9's x [m, k] and w [n, k]: int8 over the whole range (i32), bf16
    integer-valued in [-15, 15] or normal x 0.1 (f32)."""
    dev = g.device
    if acc == "i32":
        return tuple(torch.randint(-128, 128, (r, k), device=dev, generator=g, dtype=torch.int8)
                     for r in (m, n))
    if values == "integers":
        return tuple(torch.randint(-15, 16, (r, k), device=dev, generator=g).bfloat16()
                     for r in (m, n))
    return tuple((torch.randn(r, k, device=dev, generator=g) * 0.1).bfloat16() for r in (m, n))


# T9's tile edges: M around and under the GEMM's 128-row tile, N one, one
# and a half and two 256-column tiles, K an odd number of 128-byte stages
T9_EDGE_MS = [1, 100, 128, 129, 300, 1000]
T9_EDGE_NS = [128, 384, 512]
T9_EDGE_K = {"i32": 384, "f32": 448}


@pytest.mark.cuda
@pytest.mark.parametrize("n", T9_EDGE_NS)
@pytest.mark.parametrize("m", T9_EDGE_MS)
@pytest.mark.parametrize("acc", ["i32", "f32"])
def test_probe_int8_mm_matches_plain_on_cuda(cuda, acc, m, n):
    """T9 at its GEMM's tile edges: int8 exactly (the whole int8 range);
    bf16 bit for bit on integer-valued inputs (fp32 sums exact in any
    order) and within one bf16 step of the largest output on normal ones;
    three calls bit for bit, one launch each."""
    g = torch.Generator(cuda).manual_seed(70 + m + n)
    x, w = _t9_operands(g, acc, m, n, T9_EDGE_K[acc])
    name = t_t9.ACC[acc]
    before = tpi.LAUNCHES[name]
    out = t_t9.pallas_mm(x, w, acc)
    assert tpi.LAUNCHES[name] == before + 1
    assert torch.equal(out, t_t9.pallas_mm_reference(x, w, acc))
    assert all(torch.equal(t_t9.pallas_mm(x, w, acc), out) for _ in range(2))
    if acc == "f32":
        x, w = _t9_operands(g, acc, m, n, T9_EDGE_K[acc], "normal")
        got, want = t_t9.pallas_mm(x, w, acc).float(), t_t9.pallas_mm_reference(x, w, acc).float()
        step = 2.0 ** (math.frexp(want.abs().max().item())[1] - 8)
        assert (got - want).abs().max().item() <= step


@pytest.mark.cuda
@pytest.mark.parametrize("acc", ["i32", "f32"])
def test_probe_int8_mm_raises_on_misaligned_or_strided_operands(cuda, acc):
    """T9's GEMM reads x and w through TMA: a misaligned or a strided
    operand raises (no copy, no fallback), and nothing is launched."""
    g = torch.Generator(cuda).manual_seed(75)
    x, w = _t9_operands(g, acc, 130, 256, 256)
    buf = torch.zeros(x.numel() + 1, dtype=x.dtype, device=cuda)
    x_off = buf[1:].view(x.shape)
    name = t_t9.ACC[acc]
    before = tpi.LAUNCHES[name]
    for args, match in (((x_off, w), "16-byte aligned"), ((x, w.T.contiguous().T), "contiguous"),
                        ((x.T.contiguous().T, w), "contiguous")):
        with pytest.raises(ValueError, match=match):
            t_t9.pallas_mm(*args, acc)
    assert tpi.LAUNCHES[name] == before


@pytest.mark.cuda
@pytest.mark.parametrize("form,out_dtype", [("t10", torch.float32), ("t10", torch.bfloat16),
                                            ("t12", torch.float32), ("t12", torch.bfloat16),
                                            ("t12", torch.int8)])
def test_probe_w4_tiled_matches_plain_on_cuda(cuda, form, out_dtype):
    """T10 and T12 at a ragged M: the int32 accumulators exactly, the
    epilogue bit for bit in each output dtype (T10 writes fp32 and bf16)."""
    fn, plain = ((t_t10.i32_matmul, t_t10.i32_matmul_reference) if form == "t10"
                 else (t_t12.w4a8_i8_matmul, t_t12.w4a8_i8_matmul_reference))
    g = torch.Generator(cuda).manual_seed(71)
    xq, w4, xs, wsb = _w4_probe_operands(g, 300, 1024, 384)
    out, acc = fn(xq, w4, xs, wsb, out_dtype, return_acc=True)
    ref, acc_ref = plain(xq, w4, xs, wsb, out_dtype, return_acc=True)
    assert torch.equal(acc, acc_ref)
    assert torch.equal(out, ref)


# T12's shapes (M, K, N): ragged M (17, 129, 1000: under one, just past one
# and past several 128-row tiles), K = 384 (K/2 = 192, a half-empty last
# stage read from TMA's zeros) and the tool's M16384 K3072 N12288
T12_SHAPES = [(17, 3072, 384), (129, 3072, 384), (1000, 3072, 384), (300, 384, 384),
              (16384, 3072, 12288)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", T12_SHAPES, ids=lambda v: str(v))
def test_probe_w4_and_wgmma_matches_plain_on_cuda(cuda, m, k, n):
    """T12 on K3's TMA + wgmma loop: the int32 accumulators exactly and every
    output dtype bit for bit (int8 saturating), one launch each; bf16 three
    calls bit for bit."""
    g = torch.Generator(cuda).manual_seed(76 + m + k)
    xq, w4, xs, wsb = _w4_probe_operands(g, m, k, n)
    acc_ref = None
    for dt in (torch.float32, torch.bfloat16, torch.int8):
        before = tpi.LAUNCHES["proto_w4_and"]
        out, acc = t_t12.w4a8_i8_matmul(xq, w4, xs, wsb, dt, return_acc=True)
        assert tpi.LAUNCHES["proto_w4_and"] == before + 1
        ref, acc_ref = t_t12.w4a8_i8_matmul_reference(xq, w4, xs, wsb, dt, return_acc=True)
        assert torch.equal(acc, acc_ref), dt
        assert out.dtype == dt and torch.equal(out, ref), dt
        del out, acc, ref
    assert torch.equal(acc_ref, tqm._exact_acc(xq, w4))
    first = t_t12.w4a8_i8_matmul(xq, w4, xs, wsb, torch.bfloat16)
    assert all(torch.equal(t_t12.w4a8_i8_matmul(xq, w4, xs, wsb, torch.bfloat16), first)
               for _ in range(2))


@pytest.mark.cuda
def test_probe_w4_and_raises_on_misaligned_or_strided_operands(cuda):
    """T12 reads x and w4 through TMA: a misaligned or strided operand, or a
    shape off its tiles, raises before anything launches."""
    g = torch.Generator(cuda).manual_seed(77)
    xq, w4, xs, wsb = _w4_probe_operands(g, 130, 512, 256)
    buf = torch.zeros(xq.numel() + 1, dtype=torch.int8, device=cuda)
    x_off = buf[1:].view(xq.shape)
    before = tpi.LAUNCHES["proto_w4_and"]
    for args, match in (((x_off, w4), "16-byte aligned"),
                        ((xq, w4.T.contiguous().T), "contiguous"),
                        ((xq[:, :448], w4[:, :224]), "K % 128"),
                        ((xq, w4[:200]), "N % 128")):
        with pytest.raises(ValueError, match=match):
            t_t12.w4a8_i8_matmul(*args, xs, wsb[:, :args[1].shape[0]].contiguous(),
                                 torch.bfloat16)
    assert tpi.LAUNCHES["proto_w4_and"] == before


# T10's shapes (M, K, N): ragged M (17, 129, 1000), K = 384 (K/2 = 192: the
# last stage's packed bytes and both halves of x are TMA's zeros past K/2,
# and a zero byte unpacks to lo = -8) at a ragged M and at the tool's M and
# N, and the smoke's M1536 K3584 N37888
T10_SHAPES = [(17, 3072, 384), (129, 3072, 384), (1000, 1024, 384), (300, 384, 384),
              (1536, 384, 37888), (1536, 3584, 37888)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", T10_SHAPES, ids=lambda v: str(v))
def test_probe_w4_i32_wgmma_matches_plain_on_cuda(cuda, m, k, n):
    """T10 on T12's TMA + wgmma loop: the int32 accumulators exactly (also
    against the exact product), fp32 and bf16 out bit for bit, one launch
    each; bf16 three calls bit for bit."""
    g = torch.Generator(cuda).manual_seed(78 + m + k)
    xq, w4, xs, wsb = _w4_probe_operands(g, m, k, n)
    for dt in (torch.float32, torch.bfloat16):
        before = tpi.LAUNCHES["proto_w4_i32"]
        out, acc = t_t10.i32_matmul(xq, w4, xs, wsb, dt, return_acc=True)
        assert tpi.LAUNCHES["proto_w4_i32"] == before + 1
        ref, acc_ref = t_t10.i32_matmul_reference(xq, w4, xs, wsb, dt, return_acc=True)
        assert torch.equal(acc, acc_ref), dt
        assert out.dtype == dt and torch.equal(out, ref), dt
        del out, ref
    assert torch.equal(acc_ref, tqm._exact_acc(xq, w4))
    first = t_t10.i32_matmul(xq, w4, xs, wsb, torch.bfloat16)
    assert all(torch.equal(t_t10.i32_matmul(xq, w4, xs, wsb, torch.bfloat16), first)
               for _ in range(2))


def _t11_exact_once(xq, w4, monkeypatch):
    """T11's output, checked exactly against the plain version: one launch,
    no torch op for the row sums (the wrapper never calls
    ``low_half_rowsum8``), three calls bit for bit."""
    monkeypatch.setattr(tpi, "low_half_rowsum8", lambda x: pytest.fail("rs by a torch op"))
    before = tpi.LAUNCHES["proto_w4_gemv_and"]
    got = t_t11.gemv_and_only(xq, w4)
    assert tpi.LAUNCHES["proto_w4_gemv_and"] == before + 1
    monkeypatch.undo()
    assert got.dtype == torch.int32 and got.shape == (xq.shape[0], w4.shape[0])
    assert torch.equal(got, t_t11.gemv_and_only_reference(xq, w4))
    assert all(torch.equal(t_t11.gemv_and_only(xq, w4), got) for _ in range(2))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 3, 1])
def test_probe_w4_gemv_matches_plain_on_cuda(cuda, m, monkeypatch):
    """T11 at N = 1000 (the last 128-row tile ragged) and K = 3584."""
    g = torch.Generator(cuda).manual_seed(72)
    xq, w4, _, _ = _w4_probe_operands(g, m, 3584, 1000)
    _t11_exact_once(xq, w4, monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 3, 1])
@pytest.mark.parametrize("k,n", [(k, n) for _, k, n in t_t11.SHAPES] + [(544, 1000), (32, 128)],
                         ids=lambda v: str(v))
def test_probe_w4_gemv_tool_shapes_match_plain_on_cuda(cuda, k, n, m, monkeypatch):
    """T11 at its tool's three shapes (gate+up, down: K split over a cluster
    of 8, qkv), at K = 544 (K/2 = 272 ends inside a stage) with N = 1000, and
    at the smallest K (one 16-byte stage)."""
    g = torch.Generator(cuda).manual_seed(79 + k + m)
    xq, w4, _, _ = _w4_probe_operands(g, m, k, n)
    _t11_exact_once(xq, w4, monkeypatch)


@pytest.mark.cuda
def test_probe_w4_gemv_raises_on_misaligned_or_strided_operands(cuda):
    """T11 reads x and w4 through TMA: a misaligned or strided operand, or
    more than 8 rows, raises before anything launches."""
    g = torch.Generator(cuda).manual_seed(80)
    xq, w4, _, _ = _w4_probe_operands(g, 8, 512, 256)
    buf = torch.zeros(xq.numel() + 1, dtype=torch.int8, device=cuda)
    x_off = buf[1:].view(xq.shape)
    before = tpi.LAUNCHES["proto_w4_gemv_and"]
    for args, match in (((x_off, w4), "16-byte aligned"),
                        ((xq, w4.T.contiguous().T), "contiguous"),
                        ((torch.cat([xq, xq]), w4), "M <= 8")):
        with pytest.raises(ValueError, match=match):
            t_t11.gemv_and_only(*args)
    assert tpi.LAUNCHES["proto_w4_gemv_and"] == before


def _t4_inputs(g, b, n, sq, sk):
    """RMS-normed bf16 q and k, normal v, a normal key bias with batch 1's
    last 64 keys blocked."""
    dev = g.device
    q = _rms(torch.randn(b, n, sq, 128, device=dev, generator=g))
    k = _rms(torch.randn(b, n, sk, 128, device=dev, generator=g))
    v = torch.randn(b, n, sk, 128, device=dev, generator=g).bfloat16()
    bias = torch.randn(b, 1, sk, device=dev, generator=g) * 0.5
    bias[1, :, -64:] = -1e30
    return q, k, v, bias


# S_q, S_k: whole 128-key tiles plus a half tile (320), a partial last tile
# (1088 = 8.5 x 128), S_q != S_k, and batch 0 blocked on every key
T4_CASES = {"s320": (320, 320), "s1088": (1088, 1088), "sq1152_sk1088": (1152, 1088),
            "blocked_batch": (1088, 1088)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(T4_CASES))
def test_probe_int8qk_attention_matches_plain_on_cuda(cuda, case):
    """T4 on the Hopper loop under K1's gates (max |err| 4e-3, rel-L2 5e-3),
    with a normal key bias and one batch's last 64 keys blocked; a batch
    blocked on every key gives 0; one quantize and one attention launch."""
    g = torch.Generator(cuda).manual_seed(73)
    q, k, v, bias = _t4_inputs(g, 2, 3, *T4_CASES[case])
    if case == "blocked_batch":
        bias[0] = -1e30
    before = {name: tpi.LAUNCHES[name] for name in ("proto_int8qk", "proto_int8qk_quant")}
    out = t_t4.fixedmax_int8qk(q, k, v, bias)
    assert all(tpi.LAUNCHES[name] == n + 1 for name, n in before.items())
    ref = t_t4.fixedmax_int8qk_reference(q, k, v, bias)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=4e-3)
    assert _rel_l2(out, ref) <= K7_REL_L2
    if case == "blocked_batch":
        assert not out[0].any()
    assert torch.equal(t_t4.fixedmax_int8qk(q, k, v, bias), out)
    with pytest.raises(ValueError, match="64-row tile"):
        t_t4.fixedmax_int8qk(q[:, :, :100], k, v, bias)


@pytest.mark.cuda
def test_probe_int8qk_quantize_matches_rowquant_on_cuda(cuda):
    """T4's quantize kernel gives ``rowquant_scaled``'s codes and scales bit
    for bit: normal rows, a zero row (the 1e-8 floor), rows whose amax 127
    makes s exactly 1 with ties at +-0.5 and +-2.5 (half to even: 0, 2), and
    values at the scale's extremes."""
    g = torch.Generator(cuda).manual_seed(78)
    q = torch.randn(2, 3, 1088, 128, device=cuda, generator=g).bfloat16()
    k = (torch.randn(2, 3, 320, 128, device=cuda, generator=g) * 1e3).bfloat16()
    q[0, 0, 3] = 0.0
    q[0, 1, 5] = 0.0
    q[0, 1, 5, :8] = torch.tensor([127.0, 2.5, -2.5, 1.5, 0.5, -0.5, -127.0, 126.5])
    k[1, 2, 7] = 0.0
    k[1, 2, 7, :3] = torch.tensor([-127.0, 3.5, -0.5])
    before = tpi.LAUNCHES["proto_int8qk_quant"]
    got = tpi.launch_rowquant(q, k)
    assert tpi.LAUNCHES["proto_int8qk_quant"] == before + 1
    want = tpi.rowquant_scaled(q, k)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got[0][0, 1, 5, :8].tolist() == [127, 2, -2, 2, 0, 0, -127, 126]
    assert not got[0][0, 0, 3].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [4096 * 1024, 1000003])
def test_probe_ew_scale_bit_for_bit_on_cuda(cuda, dtype, n):
    """T6 over a whole number of 16-byte vectors and over a ragged tail."""
    g = torch.Generator(cuda).manual_seed(74)
    x = (torch.randn(n, device=cuda, generator=g) * 3).to(dtype)
    assert torch.equal(t_t6.pallas_scale(x), t_t6.pallas_scale_reference(x))


@pytest.mark.cuda
def test_probe_wrappers_raise_on_unsupported_inputs(cuda):
    x = torch.zeros(16, 256, device=cuda, dtype=torch.int8)
    with pytest.raises(ValueError, match="N % 128"):
        t_t9.pallas_mm(x, torch.zeros(100, 256, device=cuda, dtype=torch.int8), "i32")
    with pytest.raises(ValueError, match="int8"):
        t_t9.pallas_mm(x.float(), torch.zeros(128, 256, device=cuda), "i32")
    with pytest.raises(ValueError, match="M <= 8"):
        t_t11.gemv_and_only(torch.zeros(9, 256, device=cuda, dtype=torch.int8),
                            torch.zeros(128, 128, device=cuda, dtype=torch.int8))
    with pytest.raises(ValueError, match="bf16 or fp32"):
        t_t6.pallas_scale(torch.zeros(64, device=cuda, dtype=torch.float16))


@pytest.mark.cuda
def test_probe_l2_rotation_on_cuda(cuda):
    """The copies lie on the card, each in its own storage, and fill twice
    the 50 MB L2; the tools' timing rows take the next copy at each call,
    also inside the CUDA graph that ``graph_ms`` captures."""
    w = torch.zeros(10 << 20, dtype=torch.int8, device=cuda)
    copies = tpi.l2_copies(w)
    assert len(copies) == 10 and all(c.is_cuda for c in copies)
    assert len({c.data_ptr() for c in copies}) == 10
    seen = []

    def gemv(w):
        seen.append(w)
        return t_t11.gemv_and_only(x, w[: 128 * 512].view(128, 512))

    x = torch.zeros(8, 1024, device=cuda, dtype=torch.int8)
    run = tpi.rotated(gemv, copies)
    outs = [run() for _ in range(10)]
    assert len({t.data_ptr() for t in seen}) == 10
    assert len({o.data_ptr() for o in outs}) == 10
    row = tbench.timing_row("test", "gemv rotating", run, nbytes=128 * 512)
    assert row["ms"] > 0 and row["graph_ms"] > 0 and row["gb_per_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 5, 16, 17, 300])
def test_w8a8_int_mm_rows_on_cuda(cuda, rows):
    """W8A8's torch._int_mm on the card: fewer than 17 rows are padded with
    zero rows, and the accumulators equal the CPU's exactly; the layer's
    output equals the same layer's on the CPU bit for bit in fp32."""
    from physicedit_torch.ops import quant as tq8

    g = torch.Generator().manual_seed(rows)
    lin = tq8.Int8Linear.from_linear(torch.nn.Linear(3584, 512))
    x = torch.randn(rows, 3584, generator=g)
    xq, _ = tq8.quantize_rows(x)
    want = tq8.int_mm(xq, lin.w_q)
    got = tq8.int_mm(xq.to(cuda), lin.w_q.to(cuda))
    assert got.shape == (rows, 512) and torch.equal(got.cpu(), want)
    assert torch.equal(lin.to(cuda)(x.to(cuda)).cpu(), lin.cpu()(x))


@pytest.mark.cuda
def test_w8a8_refuses_widths_int_mm_cannot_take(cuda):
    """A layer whose widths are not multiples of 8 raises on the card; no
    float product stands in."""
    from physicedit_torch.ops import quant as tq8

    lin = tq8.Int8Linear.from_linear(torch.nn.Linear(36, 64)).to(cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        lin(torch.randn(20, 36, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cells_block", "cells_slim_block", "small_odd",
                                  "small_odd_slim"])
def test_qk_norm_rope_kernel_matches_the_eager_path_on_cuda(cuda, case):
    """The q / k RMSNorm + RoPE kernel against the eager ops it replaces
    (its plain version, ``qk_norm_rope_reference``) at the edit cells' block
    (B2 N24, text 640, image 8192, the text keys' gain 4), its slim last
    block and a small odd shape with per-row text tables: v bit for bit; q
    and k head rows bit for bit, but at most QK_ROWS_APART_MAX of them that
    equal the eager row with its bf16 rsqrt one ulp up or down: the order of
    the 128 squares' sum may move it (chip_smoke.py's gates).  With grad on
    the wrapper launches nothing and gives the plain version's bits and
    gradients."""
    from chip_smoke import head_rows_agreement, qk_norm_rope_inputs

    args, slim_base = qk_norm_rope_inputs(case, cuda, torch.Generator(cuda).manual_seed(7))
    before = tqk.LAUNCHES["qk_norm_rope"]
    with torch.no_grad():
        q, k, v = tqk.qk_norm_rope(*args, 1e-6, slim_base)
    assert tqk.LAUNCHES["qk_norm_rope"] == before + 1
    q_ref, k_ref, v_ref = tqk.qk_norm_rope_reference(*args, 1e-6, slim_base)
    assert q.shape == q_ref.shape and k.shape == k_ref.shape and q.is_contiguous()
    assert torch.equal(v, v_ref)
    for which, got, want in ((0, q, q_ref), (1, k, k_ref)):
        agree = head_rows_agreement(got, want, args, which, slim_base)
        assert agree["rows_explained"], agree
    with torch.no_grad():
        assert all(map(torch.equal, (q, k, v), tqk.qk_norm_rope(*args, 1e-6, slim_base)))

    img, txt, gains, *tables = args
    mine, plain = ([t.detach().clone().requires_grad_() for t in (img, txt, *gains)]
                   for _ in range(2))
    with torch.enable_grad():
        got = tqk.qk_norm_rope(mine[0], mine[1], tuple(mine[2:]), *tables, 1e-6, slim_base)
        want = tqk.qk_norm_rope_reference(plain[0], plain[1], tuple(plain[2:]), *tables, 1e-6,
                                          slim_base)
        cot = [torch.randn(t.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(8))
               .bfloat16() for t in want]
        # the slim block's q holds no text row: the text q gain gets no gradient
        grads = [torch.autograd.grad(out, leaves, cot, allow_unused=True)
                 for out, leaves in ((got, mine), (want, plain))]
    assert tqk.LAUNCHES["qk_norm_rope"] == before + 2
    assert all(map(torch.equal, got, want))
    assert all(a is b is None or torch.equal(a, b) for a, b in zip(*grads))


def _tiny_dit_on(device):
    from physicedit_torch.core.params import init_random_, materialize
    from physicedit_torch.models import dit as t_dit

    cfg = t_dit.DiTConfig(num_layers=2, dim=256, num_heads=2, head_dim=128, txt_in_dim=96,
                          patch_dim=64, time_dim=64)
    dit = init_random_(materialize(t_dit.DiT(cfg, torch.bfloat16), device),
                       torch.Generator(device).manual_seed(0)).eval()
    with torch.no_grad():
        dit.blocks[0].attn["norm_added_k"].scale.fill_(4.0)
    return dit


@pytest.mark.cuda
@pytest.mark.parametrize("slim", [0, 16])
def test_qk_norm_rope_launches_once_a_block_without_grad_on_cuda(cuda, slim):
    """A 2-block bf16 DiT on the card launches the kernel once a block with
    grad off and never with grad on (the eager ops, which autograd
    differentiates); the two forwards agree within bf16 rounding."""
    from physicedit_torch.ops.rope import build_rope_tables

    dit = _tiny_dit_on(cuda)
    g = torch.Generator(cuda).manual_seed(1)
    img = torch.randn(2, 32, 64, device=cuda, generator=g).bfloat16()
    txt = torch.randn(2, 24, 96, device=cuda, generator=g).bfloat16()
    t = torch.tensor([0.7, 0.7], device=cuda).bfloat16()
    mask = torch.ones(2, 24, dtype=torch.bool, device=cuda)
    mask[1, 16:] = False
    ropes = [torch.from_numpy(r).to(cuda)
             for r in build_rope_tables([(1, 4, 4), (1, 4, 4)], 24)]

    def forward():
        return dit(img, txt, t, *ropes, txt_key_mask=mask, slim_last=slim, attn_clamp=True)

    tqk.reset_launch_counts()
    with torch.no_grad():
        fused = forward()
    assert tqk.LAUNCHES["qk_norm_rope"] == 2
    with torch.enable_grad():
        eager = forward()
    assert tqk.LAUNCHES["qk_norm_rope"] == 2
    rel = ((fused.float() - eager.float()).norm() / eager.float().norm()).item()
    assert fused.shape == eager.shape and rel < 1e-2


@pytest.mark.cuda
def test_qk_norm_rope_raises_on_unsupported_inputs(cuda):
    """fp32, head_dim 64 and a CPU table beside CUDA inputs are refused; no
    eager path stands in, neither when the wrapper is called nor when a DiT
    forward without grad reaches it (fp32 in the dense lane, which K1 does
    not refuse first)."""
    from chip_smoke import qk_norm_rope_inputs
    from physicedit_torch.ops.rope import build_rope_tables

    (img, txt, gains, *tables), _ = qk_norm_rope_inputs(
        "small_odd", cuda, torch.Generator(cuda).manual_seed(0))
    with torch.no_grad():
        with pytest.raises(ValueError, match="bfloat16"):
            tqk.qk_norm_rope(img.float(), txt.float(), tuple(x.float() for x in gains), *tables)
        with pytest.raises(ValueError, match="head_dim 64"):
            tqk.qk_norm_rope(img[..., :15 * 64], txt[..., :15 * 64],
                             tuple(x[:64] for x in gains), *tables)
        with pytest.raises(ValueError, match="text cos"):
            tqk.qk_norm_rope(img, txt, gains, *tables[:2], tables[2].cpu(), tables[3])

    dit = _tiny_dit_on(cuda).float()
    ropes = [torch.from_numpy(r).to(cuda) for r in build_rope_tables([(1, 4, 4)], 8)]
    inputs = (torch.randn(1, 16, 64, device=cuda), torch.randn(1, 8, 96, device=cuda),
              torch.tensor([0.7], device=cuda))
    before = tqk.LAUNCHES["qk_norm_rope"]
    with torch.no_grad(), pytest.raises(ValueError, match="bfloat16"):
        dit(*inputs, *ropes, attn_impl="dense")
    assert tqk.LAUNCHES["qk_norm_rope"] == before

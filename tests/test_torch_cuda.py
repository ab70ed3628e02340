"""Port kernels K1-K6 on an NVIDIA GPU against their plain versions.

Every test here needs a card and nvcc and skips without one.  The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from physicedit_torch.kernels import flash_attention as tfa
from physicedit_torch.kernels import fused_quant as tfq
from physicedit_torch.kernels import quant_matmul as tqm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


BF16_TOL = 2e-2  # bf16 kernel output against the plain version (fp32 softmax)


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

"""Port kernels K1 / K2 on an NVIDIA GPU against their plain versions.

Every test here needs a card and nvcc and skips without one.  The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from physicedit_torch.kernels import flash_attention as tfa


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

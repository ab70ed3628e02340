"""T4, fixed-max attention with an int8 QK^T (the port of
``tools/proto_attn_int8qk.py``), and the tool that measures it on the card:

    python -m physicedit_torch.tools.proto_attn_int8qk

q and k are quantized per row to int8 (``s = max(amax / 127, 1e-8)``, codes
``round(x / s)`` half to even, clipped to ±127), and each scale is
multiplied by fp32(sqrt(log2(e) / sqrt(d))): XLA ops outside the JAX
kernel, one kernel launch here (``int8qk_rowquant_kernel``, whose plain
version is ``_proto_int8.rowquant_scaled``).  Then per key, in fp32 with
each step rounded:

    sf = fp32(q8 k8^T) * qs[row] * ks[key] + key_bias[b, key]
    p = exp2(min(sf, 100)),  l = sum(p)
    out = (p in v's dtype . v) / max(l, 1e-30)

no running max.  The kernels are ``csrc/proto_int8qk_attention.cu``: the
quantize, and the attention on the Hopper mainloop with an int8 ``wgmma``
QK^T over 128-key tiles (``int8qk_hopper_kernel``): bf16 q, k and v ``[B,
N, S, 128]``, an fp32 key bias ``[B, 1, S_k]``, S_q and S_k multiples of 64
(a multiple of 64 but not of 128 runs a partial last tile).  Another S
raises ``ValueError`` on either device, where the JAX tool leaves the rows
past its last whole block unwritten.  The JAX tool swept TPU block shapes;
the kernel has one tiling, so the tool prints one row, beside K1
(``flash_attention_bnsd``, bf16 QK^T) and, as context only, SDPA (no
PyTorch call computes int8 logits).
"""

from __future__ import annotations

import torch

from physicedit_torch.kernels import flash_attention as fa
from physicedit_torch.tools import _bench, _proto_int8 as pi

NAME = "proto_attn_int8qk"
BLOCK = pi.ATTN_BLOCK
KEY_TILE = 128   # the kernel's key tile, which the plain version walks


def _quantized(q, k):
    """The wrapper's work: int8 codes and scales of q and k, the scales
    times fp32(sqrt(log2(e) / sqrt(d))): the quantize kernel for CUDA
    tensors, its plain version ``rowquant_scaled`` for CPU ones."""
    if q.device.type == "cpu":
        return pi.rowquant_scaled(q, k)
    return pi.launch_rowquant(q, k)


def _check_tiles(q, k) -> None:
    if q.shape[2] % BLOCK or k.shape[2] % BLOCK:
        raise ValueError(f"{NAME}: S_q {q.shape[2]} and S_k {k.shape[2]} must be multiples of "
                         f"the {BLOCK}-row tile")


def fixedmax_int8qk(q, k, v, key_bias):
    """T4 on ``[B, N, S_q, D] x [B, N, S_k, D]`` with key_bias ``[B, 1,
    S_k]``: the kernel for CUDA tensors, :func:`fixedmax_int8qk_reference`
    for CPU ones."""
    _check_tiles(q, k)
    if q.device.type == "cpu":
        return fixedmax_int8qk_reference(q, k, v, key_bias)
    return pi.launch_int8qk(*_kernel_operands(q, k, v, key_bias))


def _kernel_operands(q, k, v, key_bias):
    """What the kernel reads: the codes and scales, v, the [B, S_k] bias."""
    qq, kq, qs, ks = _quantized(q, k)
    return qq, kq, v, qs, ks, key_bias.reshape(k.shape[0], k.shape[2]).float().contiguous()


def fixedmax_int8qk_reference(q, k, v, key_bias):
    """The plain version of T4, with the kernel's numerics: the codes and
    scales of ``rowquant_scaled``, the integer logits exact (|q8 k8| < 2^24
    for d = 128, so fp32 sums are exact in any order), the keys walked in the
    kernel's 128-key tiles (the last one partial where S_k % 128 == 64)."""
    _check_tiles(q, k)
    qq, kq, qs, ks = pi.rowquant_scaled(q, k)
    b, n, sq, d = q.shape
    sk = k.shape[2]
    bias = key_bias.reshape(b, 1, 1, sk).float()
    l = torch.zeros((b, n, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, n, sq, d), dtype=torch.float32, device=q.device)
    qf = qq.float()
    for k0 in range(0, sk, KEY_TILE):
        k1 = min(k0 + KEY_TILE, sk)
        s = torch.matmul(qf, kq[:, :, k0:k1].float().transpose(-1, -2))
        sf = s * qs[..., None] * ks[:, :, None, k0:k1] + bias[..., k0:k1]
        p = torch.exp2(sf.clamp(max=fa.CLAMP))
        l += p.sum(-1)
        acc += torch.matmul(p.to(v.dtype).float(), v[:, :, k0:k1].float())
    return (acc / l.clamp(min=1e-30)[..., None]).to(v.dtype)


def main() -> list:
    """On the card: T4 against K1 (``flash_attention_bnsd``, all keys live)
    at B1 N4 S1024 with q = k = v normal, max abs and rel (of the largest
    output) as the JAX tool prints them, then T4 (with its row quantize, its
    attention kernel alone on operands quantized beforehand, and the
    quantize alone), K1 and SDPA timed at the DiT's joint attention, B2 N24
    S8448 D128, q = k = v normal."""
    import torch.nn.functional as F

    dev = _bench.require_cuda(NAME)
    gen = torch.Generator(dev).manual_seed(0)
    x = torch.randn(1, 4, 1024, 128, device=dev, generator=gen).bfloat16()
    ref = fa.flash_attention_bnsd(x, x, x, key_mask=torch.ones(1, 1024, dtype=torch.bool,
                                                                 device=dev))
    got = fixedmax_int8qk(x, x, x, torch.zeros(1, 1, 1024, device=dev))
    err = (ref.float() - got.float()).abs().max().item()
    rows = [pi.check_row(NAME, "vs_k1_b1_n4_s1024", max_abs=err,
                         rel=err / ref.float().abs().max().item())]
    b, n, s, d = 2, 24, 8448, 128
    x = torch.randn(b, n, s, d, device=dev, generator=gen).bfloat16()
    bias = torch.zeros(b, 1, s, device=dev)
    mask = torch.ones(b, s, dtype=torch.bool, device=dev)
    flops = _bench.attention_flops(b, n, s, s, d)
    operands = _kernel_operands(x, x, x, bias)
    rows += [_bench.timing_row(NAME, "T4 int8 QK^T", lambda: fixedmax_int8qk(x, x, x, bias), flops),
             _bench.timing_row(NAME, "T4 kernel alone", lambda: pi.launch_int8qk(*operands), flops),
             _bench.timing_row(NAME, "T4 quantize alone", lambda: pi.launch_rowquant(x, x),
                               nbytes=2 * (2 * x.numel() + x.numel() + 4 * x.numel() // d)),
             _bench.timing_row(NAME, "K1 bf16 fixedmax",
                           lambda: fa.flash_attention_bnsd(x, x, x, key_mask=mask), flops),
             _bench.timing_row(NAME, "SDPA (context only)",
                           lambda: F.scaled_dot_product_attention(x, x, x), flops)]
    return rows


if __name__ == "__main__":
    main()

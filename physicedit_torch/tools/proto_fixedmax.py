"""T7, the first fixed-max attention prototype (the port of
``tools/proto_fixedmax.py``), and the tool that measures it on the card:

    python -m physicedit_torch.tools.proto_fixedmax

RMS-normed q and k bound the logits, so the softmax needs no running max:
with c = log2(e) / sqrt(d) in fp32,

    p = exp2(min(fp32(q k^T) * c + key_bias[b, key], 100))
    out = (bf16(p) . v) * (1 / l),  l = sum(p) in fp32

with an fp32 key bias [B, 1, S_k] on every key, added after the scale.  l
has no floor: a row whose keys all carry -1e30 comes out NaN, as in the JAX
tool.  The kernel is instantiation ``proto_fixedmax`` of
``csrc/proto_fixedmax_attention.cu`` on the Hopper mainloop.
The JAX tool swept TPU block shapes; the kernel has one tiling, so the tool
prints one row, beside K1′ (the same function with a bool key mask).
"""

from __future__ import annotations

from physicedit_torch.tools import _bench, _proto_attention as pa

NAME = "proto_fixedmax"


def fixedmax_bnsd(q, k, v, key_bias):
    """T7 on [B, N, S_q, D] x [B, N, S_k, D] with key_bias [B, 1, S_k]: the
    kernel for CUDA tensors, :func:`fixedmax_bnsd_reference` for CPU ones."""
    return pa.run(NAME, q, k, v, key_bias, k.shape[2])


def fixedmax_bnsd_reference(q, k, v, key_bias):
    """The plain version of T7, with the kernel's numerics."""
    return pa.reference(NAME, q, k, v, key_bias, k.shape[2])


def main() -> list:
    """On the card: T7 against K1′ (``fixedmax_bnsd`` scaled in the kernel,
    clamp on) and against SDPA at q 512 x k 2816, then its time at the DiT's
    joint attention (B2 N24 S8448 D128) beside K1′'s, and again with
    ``bias_keys`` 0 (the same kernel reading no bias: what the bias on every
    tile costs)."""
    import torch
    import torch.nn.functional as F

    from physicedit_torch.kernels import flash_attention as fa

    dev = _bench.require_cuda(NAME)
    gen = torch.Generator(dev).manual_seed(0)
    b, n, d, s = 2, 24, 128, 8448
    q = pa.dit_inputs(gen, 1.0, s=512)[0]
    k, v = pa.dit_inputs(gen, 1.0, s=2816)[:2]
    bias = torch.zeros(b, 1, 2816, device=dev)
    out = fixedmax_bnsd(q, k, v, bias)
    check = {"tool": NAME, "check": "q512_k2816",
             "max_abs_err_vs_k1prime": pa.max_abs_diff(
                 out, fa.fixedmax_bnsd(q, k, v, clamp=True, prescaled=False)),
             "max_abs_err_vs_sdpa": pa.max_abs_diff(out, F.scaled_dot_product_attention(q, k, v))}
    _bench.log(f"T7 max abs err vs K1': {check['max_abs_err_vs_k1prime']:.3e}, "
               f"vs sdpa: {check['max_abs_err_vs_sdpa']:.3e}")
    q, k, v = pa.dit_inputs(gen, 0.3, s=s)
    bias = torch.zeros(b, 1, s, device=dev)
    flops = _bench.attention_flops(b, n, s, s, d)
    return [check,
            _bench.timing_row(NAME, "K1' scaled, clamp", lambda: fa.fixedmax_bnsd(q, k, v),
                              flops),
            _bench.timing_row(NAME, "T7 fixedmax", lambda: fixedmax_bnsd(q, k, v, bias), flops),
            _bench.timing_row(NAME, "T7 fixedmax, bias_keys 0",
                              lambda: pa.run(NAME, q, k, v, bias, 0), flops)]


if __name__ == "__main__":
    main()

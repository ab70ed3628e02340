"""T8, the second fixed-max prototype (the port of
``tools/proto_fixedmax2.py``), and the tool that measures it on the card:

    python -m physicedit_torch.tools.proto_fixedmax2

q is prescaled, q' = bf16(q * bf16(log2(e) / sqrt(d))), and the key bias
is added only on the text prefix (the keys before ``bias_keys``; the JAX
tool adds it on its first k block, ``bias_keys`` = its ``block_k``):

    p = exp2(min(fp32(q' k^T) + [key < bias_keys] * key_bias[b, key], 100))
    out = (bf16(p) . v) * (1 / l),  l = sum(p) in fp32

A key past the prefix takes no bias whatever the bias holds there.  l has
no floor (a row with l == 0 is NaN).  ``overlap`` is the JAX tool's
``sub > 1``, its next sub-tile's QK^T issued before this one's softmax.
Both settings launch the same instantiation of
``csrc/proto_fixedmax_attention.cu`` (on the Hopper mainloop, whose
ping-pong already runs one warpgroup's exp2 under the other's products),
counted under ``proto_fixedmax2_overlap`` or ``proto_fixedmax2``.  The JAX
tool swept TPU block shapes and ``sub``; this one prints a row per overlap
setting.
"""

from __future__ import annotations

from physicedit_torch.kernels import flash_attention as fa
from physicedit_torch.tools import _bench, _proto_attention as pa

NAME = "proto_fixedmax2"


def fixedmax2_bnsd(q, k, v, key_bias, bias_keys: int = 1408, overlap: bool = True):
    """T8 on [B, N, S_q, D] x [B, N, S_k, D] (q not prescaled; scaled here)
    with key_bias [B, 1, S_k] on the keys before ``bias_keys``: the kernel
    for CUDA tensors, :func:`fixedmax2_bnsd_reference` for CPU ones."""
    return pa.run(NAME + ("_overlap" if overlap else ""), fa._prescale(q), k, v, key_bias,
                  bias_keys)


def fixedmax2_bnsd_reference(q, k, v, key_bias, bias_keys: int = 1408):
    """The plain version of T8, with the kernel's numerics."""
    return pa.reference(NAME, fa._prescale(q), k, v, key_bias, bias_keys)


def main() -> list:
    """On the card: T8 (overlap on) against K1 (prescaled, clamp on, the
    same function with a bool key mask) and against SDPA with that mask at
    q 768 x k 2816 with keys [100, 256) masked, then its time at the DiT's
    joint attention (B2 N24 S8448 D128), overlap off and on."""
    import torch
    import torch.nn.functional as F

    dev = _bench.require_cuda(NAME)
    gen = torch.Generator(dev).manual_seed(0)
    b, n, d, s = 2, 24, 128, 8448
    q = pa.dit_inputs(gen, 1.0, s=768)[0]
    k, v = pa.dit_inputs(gen, 1.0, s=2816)[:2]
    mask = torch.ones(b, 2816, dtype=torch.bool, device=dev)
    mask[:, 100:256] = False
    out = fixedmax2_bnsd(q, k, v, pa.mask_bias(mask))
    check = {"tool": NAME, "check": "q768_k2816_masked_100_256",
             "max_abs_err_vs_k1": pa.max_abs_diff(out, fa.fixedmax_attention(q, k, v, mask)),
             "max_abs_err_vs_sdpa": pa.max_abs_diff(out, F.scaled_dot_product_attention(
                 q, k, v, attn_mask=mask[:, None, None, :]))}
    _bench.log(f"T8 max abs err vs K1: {check['max_abs_err_vs_k1']:.3e}, "
               f"vs masked sdpa: {check['max_abs_err_vs_sdpa']:.3e}")
    q, k, v = pa.dit_inputs(gen, 0.3, s=s)
    bias = torch.zeros(b, 1, s, device=dev)
    flops = _bench.attention_flops(b, n, s, s, d)
    return [check] + [
        _bench.timing_row(NAME, f"T8 fixedmax2 overlap={overlap}",
                          lambda overlap=overlap: fixedmax2_bnsd(q, k, v, bias, overlap=overlap),
                          flops)
        for overlap in (False, True)]


if __name__ == "__main__":
    main()

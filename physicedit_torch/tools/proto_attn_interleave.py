"""T5, the fixed-max attention with the next key tile's QK^T issued before
this tile's softmax (the port of ``tools/proto_attn_interleave.py``), and
the tool that measures it on the card:

    python -m physicedit_torch.tools.proto_attn_interleave

q is prescaled, q' = bf16(q * bf16(log2(e) / sqrt(d))), no clamp, and the
key bias is added only on the text prefix, the keys before ``bias_keys``
(the JAX tool's ``bias_subs * block_k / sub``; 0 reads no bias):

    p = exp2(fp32(q' k^T) + [key < bias_keys] * key_bias[b, key])
    out = (bf16(p) . v) * (1 / l),  l = sum(p) in fp32

A key past the prefix takes no bias whatever the bias holds there; l has
no floor (a row with l == 0 is NaN).  Both names, ``proto_interleave``
(the JAX tool's ``sub = 1``) and ``proto_interleave_overlap`` (``sub >
1``, the ``overlap`` argument), launch one kernel: the instantiation of
``csrc/proto_fixedmax_attention.cu``'s ``proto_hopper_kernel`` with an fp32
key bias on a prefix and the ``1 / l`` epilogue, on K1's Hopper mainloop,
whose two consumer warpgroups take turns so that one's exp2 runs under the
other's products: the overlap the JAX tool wanted, with no switch.  The
kernel copies and adds the bias only on the 128-key tiles below
``bias_keys``.  The JAX tool swept TPU block shapes, ``sub`` and VMEM
limits; this one prints a row per name and bias setting, beside K1.
"""

from __future__ import annotations

from physicedit_torch.kernels import flash_attention as fa
from physicedit_torch.tools import _bench, _proto_attention as pa

NAME = "proto_interleave"


def attn_interleaved(q, k, v, key_bias, bias_keys: int = 1408, overlap: bool = True):
    """T5 on [B, N, S_q, D] x [B, N, S_k, D] (q not prescaled; scaled here)
    with key_bias [B, 1, S_k] on the keys before ``bias_keys``: the kernel
    for CUDA tensors, :func:`attn_interleaved_reference` for CPU ones."""
    return pa.run(NAME + ("_overlap" if overlap else ""), fa._prescale(q), k, v, key_bias,
                  bias_keys)


def attn_interleaved_reference(q, k, v, key_bias, bias_keys: int = 1408):
    """The plain version of T5, with the kernel's numerics."""
    return pa.reference(NAME, fa._prescale(q), k, v, key_bias, bias_keys)


def main() -> list:
    """On the card at the DiT's joint attention (B2 N24 S8448 D128, inputs
    normal x 0.1, keys [200, 256) of the text prefix masked): T5 with the
    overlap off and on against K1 without the clamp (the same function) and
    against SDPA with the bool mask, then K1 and T5 timed, overlap off and
    on, with the bias on the prefix and with none."""
    import torch
    import torch.nn.functional as F

    dev = _bench.require_cuda("proto_attn_interleave")
    gen = torch.Generator(dev).manual_seed(0)
    b, n, d, s = 2, 24, 128, 8448
    q, k, v = pa.dit_inputs(gen, 0.1, s=s)
    mask = torch.ones(b, s, dtype=torch.bool, device=dev)
    mask[:, 200:256] = False
    bias = pa.mask_bias(mask)
    ref = fa.fixedmax_attention(q, k, v, mask, clamp=False)
    sdpa = F.scaled_dot_product_attention(q, k, v, attn_mask=mask[:, None, None, :])
    rows = []
    for overlap in (False, True):
        got = attn_interleaved(q, k, v, bias, overlap=overlap)
        rows.append({"tool": "proto_attn_interleave", "check": f"overlap={overlap}",
                     "max_abs_err_vs_k1": pa.max_abs_diff(got, ref),
                     "max_abs_err_vs_sdpa": pa.max_abs_diff(got, sdpa)})
        _bench.log(f"interleaved overlap={overlap} vs K1: max abs diff "
                   f"{rows[-1]['max_abs_err_vs_k1']:.2e}, vs SDPA "
                   f"{rows[-1]['max_abs_err_vs_sdpa']:.2e}")
    del ref, sdpa
    flops = _bench.attention_flops(b, n, s, s, d)
    rows.append(_bench.timing_row("proto_attn_interleave", "K1 bool mask, no clamp",
                                  lambda: fa.fixedmax_attention(q, k, v, mask, clamp=False),
                                  flops))
    for bias_keys in (1408, 0):
        for overlap in (False, True):
            rows.append(_bench.timing_row(
                "proto_attn_interleave", f"T5 overlap={overlap} bias_keys={bias_keys}",
                lambda bk=bias_keys, ov=overlap: attn_interleaved(q, k, v, bias, bk, ov), flops))
    return rows


if __name__ == "__main__":
    main()

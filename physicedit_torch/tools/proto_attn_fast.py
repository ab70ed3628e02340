"""T2 and T3, the fixed-max prototypes with no bias in the loop (the port of
``tools/proto_attn_fast.py``), and the tool that measures them on the card:

    python -m physicedit_torch.tools.proto_attn_fast

T2 (:func:`attn_nobias`) takes no bias input, the ceiling for any scheme
that elides the bias: with c = log2(e) / sqrt(d) in fp32,

    p = exp2(fp32(q k^T) * (c if inscale else 1))
    out = (bf16(p) . v) / max(l, 1e-30),  l = sum(p) in fp32

no clamp.  ``inscale=False`` on a prescaled q is T1 v2.  T3
(:func:`attn_nmask`) gives K1's output with no bias in the loop: q is
prescaled, q' = bf16(q * bf16(c)), the masked keys' K and V rows are
zeroed, so each masked key adds exp2(0) = 1 to l and nothing to the
accumulator, and the denominator takes the batch's masked count back out:

    out = (bf16(exp2(q' k_z^T)) . v_z) / max(l - n_masked[b], 1e-30)

A batch whose keys are all masked comes out 0.  The zeroing and the count
are wrapper work (torch ops), as they were XLA ops in the JAX tool.  The
kernels are instantiations ``proto_nobias_inscale``, ``proto_nobias`` and
``proto_nmask`` (T2's with the count) of
``csrc/proto_fixedmax_attention.cu``, all three on K1's Hopper mainloop
(``csrc/hopper_attention.cuh``: TMA, ``wgmma``), as every instantiation
of that file.  The JAX tool swept TPU block shapes and VMEM limits; this
one prints a row per variant.
"""

from __future__ import annotations

import torch

from physicedit_torch.kernels import flash_attention as fa
from physicedit_torch.tools import _bench, _proto_attention as pa


def attn_nobias(q, k, v, inscale: bool):
    """T2 on [B, N, S_q, D] x [B, N, S_k, D]: the kernel for CUDA tensors,
    :func:`attn_nobias_reference` for CPU ones."""
    return pa.run("proto_nobias_inscale" if inscale else "proto_nobias", q, k, v)


def attn_nobias_reference(q, k, v, inscale: bool):
    """The plain version of T2, with the kernel's numerics."""
    return pa.reference("proto_nobias_inscale" if inscale else "proto_nobias", q, k, v)


def _nmask_operands(q, k, v, key_mask):
    """T3's wrapper work: q', K and V with the masked keys' rows zeroed, and
    the masked count of each batch in fp32."""
    live = key_mask[:, None, :, None]
    return (fa._prescale(q), torch.where(live, k, 0), torch.where(live, v, 0),
            (~key_mask).sum(1).float())


def attn_nmask(q, k, v, key_mask):
    """T3 on [B, N, S_q, D] x [B, N, S_k, D] (q not prescaled) with
    key_mask [B, S_k] bool (True = live): the kernel for CUDA tensors,
    :func:`attn_nmask_reference` for CPU ones."""
    qs, kz, vz, nm = _nmask_operands(q, k, v, key_mask)
    return pa.run("proto_nmask", qs, kz, vz, n_masked=nm)


def attn_nmask_reference(q, k, v, key_mask):
    """The plain version of T3, with the kernel's numerics."""
    qs, kz, vz, nm = _nmask_operands(q, k, v, key_mask)
    return pa.reference("proto_nmask", qs, kz, vz, n_masked=nm)


def main() -> list:
    """On the card at the DiT's joint attention (B2 N24 S8448 D128, inputs
    normal x 0.1, the last 64 keys masked): T3 against K1 without the clamp
    (the same function) and against SDPA with the bool mask, then T2 with
    the scale outside and inside the kernel and T3, timed."""
    import torch.nn.functional as F

    dev = _bench.require_cuda("proto_attn_fast")
    gen = torch.Generator(dev).manual_seed(0)
    b, n, d, s = 2, 24, 128, 8448
    q, k, v = pa.dit_inputs(gen, 0.1, s=s)
    mask = torch.ones(b, s, dtype=torch.bool, device=dev)
    mask[:, -64:] = False
    got = attn_nmask(q, k, v, mask)
    ref = fa.fixedmax_attention(q, k, v, mask, clamp=False)
    check = {"tool": "proto_attn_fast", "check": "t3_vs_k1_and_sdpa",
             "max_abs_err_vs_k1": pa.max_abs_diff(got, ref),
             "max_abs_out": ref.float().abs().max().item(),
             "max_abs_err_vs_sdpa": pa.max_abs_diff(got, F.scaled_dot_product_attention(
                 q, k, v, attn_mask=mask[:, None, None, :]))}
    _bench.log(f"T3 vs K1: max abs diff {check['max_abs_err_vs_k1']:.2e} (out max "
               f"{check['max_abs_out']:.2f}); vs SDPA: {check['max_abs_err_vs_sdpa']:.2e}")
    flops = _bench.attention_flops(b, n, s, s, d)
    return [check,
            _bench.timing_row("proto_attn_fast", "T2 nobias, scale outside",
                              lambda: attn_nobias(q, k, v, False), flops),
            _bench.timing_row("proto_attn_fast", "T2 nobias, scale inside",
                              lambda: attn_nobias(q, k, v, True), flops),
            _bench.timing_row("proto_attn_fast", "T3 nmask", lambda: attn_nmask(q, k, v, mask),
                              flops)]


if __name__ == "__main__":
    main()

"""T1, the score-tile ablations of the fixed-max attention (the port of
``tools/proto_attn_bf16s.py``), and the tool that times them against the
full kernel on the card:

    python -m physicedit_torch.tools.proto_attn_bf16s

Every variant takes q prescaled by the caller, q' = bf16(q * bf16(log2(e) /
sqrt(d))), and runs the two products of attention; they differ in what lies
between them:

  v0  K1′ ``fixedmax_bnsd(prescaled=True, clamp=False)`` with the key mask:
      the full kernel (fp32 scores, exp2, row sums, normalised)
  v1  :func:`attn_bf16s`: the score, its sum with the bf16 key bias and
      exp2 each rounded to bf16, l = sum(p) in fp32,
      out = (p . v) / max(l, 1e-30)
  v2  ``proto_attn_fast.attn_nobias(inscale=False)``: no bias,
      p = exp2(fp32(q' k^T)), out = (bf16(p) . v) / max(l, 1e-30)
  v3  :func:`attn_expnosum`: exp2 without the row sum,
      out = bf16(bf16(exp2(q' k^T)) . v), unnormalised
  v4  :func:`attn_noexp`: the products alone, out = bf16(bf16(q' k^T) . v)

v3 and v4 compute no attention: they say how much of the full kernel's
time the softmax takes.  All five run on K1's Hopper mainloop
(``csrc/hopper_attention.cuh``: TMA, ``wgmma``, ping-ponged consumer
warpgroups): v0 through K1's own policy, v1-v4 as the instantiations
``proto_bf16s``, ``proto_nobias``, ``proto_expnosum`` and ``proto_noexp``
of ``csrc/proto_fixedmax_attention.cu``'s policy.  So on one loop v4 is the
loop's own ceiling, v3 against v2 the cost of the row sum, v2 against v0
the cost of the key-mask test, and v1 against v2 what the bf16 score
chain costs or buys.
"""

from __future__ import annotations

from physicedit_torch.tools import _bench, _proto_attention as pa


def attn_bf16s(qs, k, v, key_bias):
    """T1 v1 on a prescaled q' [B, N, S_q, D] x [B, N, S_k, D] with
    key_bias [B, 1, S_k] (taken in bf16): the kernel for CUDA tensors, the
    plain version (:func:`attn_bf16s_reference`) for CPU ones."""
    return pa.run("proto_bf16s", qs, k, v, key_bias, k.shape[2])


def attn_bf16s_reference(qs, k, v, key_bias):
    return pa.reference("proto_bf16s", qs, k, v, key_bias, k.shape[2])


def attn_expnosum(qs, k, v):
    """T1 v3 (exp2, no row sum, unnormalised) on a prescaled q'."""
    return pa.run("proto_expnosum", qs, k, v)


def attn_expnosum_reference(qs, k, v):
    return pa.reference("proto_expnosum", qs, k, v)


def attn_noexp(qs, k, v):
    """T1 v4 (the two products alone) on a prescaled q'."""
    return pa.run("proto_noexp", qs, k, v)


def attn_noexp_reference(qs, k, v):
    return pa.reference("proto_noexp", qs, k, v)


def main() -> list:
    """On the card at the DiT's joint attention (B2 N24 S8448 D128, inputs
    normal x 0.1, the last 64 keys masked): v1 and v0 against an fp32
    softmax on one head and v1 against SDPA, then v0-v4 timed, twice in
    turn."""
    import torch
    import torch.nn.functional as F

    from physicedit_torch.kernels import flash_attention as fa
    from physicedit_torch.tools.proto_attn_fast import attn_nobias

    dev = _bench.require_cuda("proto_attn_bf16s")
    gen = torch.Generator(dev).manual_seed(0)
    b, n, d, s = 2, 24, 128, 8448
    q, k, v = pa.dit_inputs(gen, 0.1, s=s)
    mask = torch.ones(b, s, dtype=torch.bool, device=dev)
    mask[:, -64:] = False
    key_bias = pa.mask_bias(mask)
    qs = fa._prescale(q)

    # numerics: one head against an fp32 softmax, and v1 against SDPA
    logits = (q[0, 0].float() @ k[0, 0].float().T) / d ** 0.5
    o_ref = torch.softmax(logits.masked_fill(~mask[0], float("-inf")), -1) @ v[0, 0].float()
    o_v1 = attn_bf16s(qs[:1, :1].contiguous(), k[:1, :1].contiguous(), v[:1, :1].contiguous(),
                      key_bias[:1])[0, 0]
    o_v0 = fa.fixedmax_bnsd(qs[:1, :1].contiguous(), k[:1, :1].contiguous(),
                            v[:1, :1].contiguous(), mask[:1], clamp=False, prescaled=True)[0, 0]
    check = {"tool": "proto_attn_bf16s", "check": "one_head_vs_fp32_softmax",
             "max_abs_err_v1": pa.max_abs_diff(o_v1, o_ref),
             "max_abs_err_v0": pa.max_abs_diff(o_v0, o_ref),
             "ref_std": o_ref.std().item(),
             "v1_max_abs_err_vs_sdpa": pa.max_abs_diff(
                 attn_bf16s(qs, k, v, key_bias),
                 F.scaled_dot_product_attention(q, k, v, attn_mask=mask[:, None, None, :]))}
    _bench.log(f"max|v1-ref| = {check['max_abs_err_v1']:.5f} (std {check['ref_std']:.4f}); "
               f"max|v0-ref| = {check['max_abs_err_v0']:.5f}; "
               f"max|v1-sdpa| = {check['v1_max_abs_err_vs_sdpa']:.5f}")
    flops = _bench.attention_flops(b, n, s, s, d)
    variants = (
        ("v0 K1' prescaled, Hopper mainloop",
         lambda: fa.fixedmax_bnsd(qs, k, v, mask, clamp=False, prescaled=True)),
        ("v1 bf16 score", lambda: attn_bf16s(qs, k, v, key_bias)),
        ("v2 fp32 nobias", lambda: attn_nobias(qs, k, v, inscale=False)),
        ("v3 exp, no sum", lambda: attn_expnosum(qs, k, v)),
        ("v4 matmul only", lambda: attn_noexp(qs, k, v)))
    return [check] + [_bench.timing_row("proto_attn_bf16s", label, fn, flops)
                      for _ in range(2) for label, fn in variants]


if __name__ == "__main__":
    main()

"""T10, the W4A8 matmul with the sign-extending nibble unpack (the port of
``tools/proto_prefill_blocks.py``), and the tool that times it at the VL
prefill shapes:

    python -m physicedit_torch.tools.proto_prefill_blocks

:func:`i32_matmul` is ``(x_q . unpack(packed)^T) * x_scale * wsb[0] +
wsb[1]``: int8 x_q ``[M, K]``, packed ``[N, K/2]`` (K3's layout; the JAX
tool's is ``[K/2, N]``), each byte unpacked as ``lo = (b & 15) - 8`` against
``x[:, :K/2]`` and ``hi = b >> 4`` against ``x[:, K/2:]`` into one exact
int32 accumulator, then the epilogue in fp32, each step rounded, with an
fp32 bias row (K3's is bf16).  The JAX tool's kernel writes bf16; the port
also writes fp32.  The kernel is instantiation ``proto_w4_i32`` of
``csrc/proto_int8_matmul.cu``, on T12's TMA + ``wgmma`` loop (K3's); it
gives the same integers as T12 (``proto_w4_unpack``), which unpacks with
ANDs only.  The JAX tool swept TPU
block sizes; the kernel has one tiling, so the tool prints a row per form:
K3 (``kernels/quant_matmul.w4a8_matmul``), T10 and T12, at M1536 K3584
N37888 (gate+up) and M1536 K18944 N3584 (down).
"""

from __future__ import annotations

import torch

from physicedit_torch.kernels import quant_matmul as qm
from physicedit_torch.tools import _bench, _proto_int8 as pi

NAME = "proto_prefill_blocks"
SHAPES = [("gate+up m1536 k3584 n37888", 1536, 3584, 37888),
          ("down m1536 k18944 n3584", 1536, 18944, 3584)]


def i32_matmul(x_q, packed, x_scale, wsb, out_dtype=torch.bfloat16, return_acc: bool = False):
    """T10: x_q int8 ``[M, K]``, packed int8 ``[N, K/2]``, x_scale fp32 ``[M,
    1]``, wsb fp32 ``[2, N]`` (scale row, bias row) -> ``[M, N]`` in
    ``out_dtype`` (bf16 or fp32); the kernel for CUDA tensors,
    :func:`i32_matmul_reference` for CPU ones.  ``return_acc`` also returns
    the int32 accumulators."""
    if x_q.device.type == "cpu":
        return i32_matmul_reference(x_q, packed, x_scale, wsb, out_dtype, return_acc)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"i32_matmul writes bf16 or fp32, not {out_dtype}")
    return pi.launch_matmul("proto_w4_i32", x_q, packed, x_scale, wsb, None, out_dtype,
                            return_acc)


def i32_matmul_reference(x_q, packed, x_scale, wsb, out_dtype=torch.bfloat16,
                         return_acc: bool = False):
    """The plain version of T10: the exact accumulator, then the epilogue."""
    acc = qm._exact_acc(x_q, packed)
    out = pi.w4_epilogue(acc, x_scale, wsb, out_dtype)
    return (out, acc) if return_acc else out


def main() -> list:
    """On the card: T10 against its plain version at M256 K1024 N512 (exact
    accumulators, the output bit for bit), then K3, T10 and T12 (bf16 out)
    at the VL prefill shapes, weights normal x 0.02 quantized as the DiT's,
    x_q in [-4, 4], unit row scales."""
    from physicedit_torch.tools import proto_w4_unpack as t12

    dev = _bench.require_cuda(NAME)
    gen = torch.Generator(dev).manual_seed(0)

    def operands(m, k, n):
        w4, w_scale = qm.quantize_weight_int4(torch.randn(n, k, device=dev, generator=gen) * 0.02)
        xs = torch.ones(m, 1, device=dev)
        wsb = torch.stack([w_scale, torch.zeros_like(w_scale)])
        x0 = torch.randint(-4, 5, (m, k), device=dev, generator=gen, dtype=torch.int8)
        return x0, w4, xs, w_scale, wsb

    x0, w4, xs, _, wsb = operands(256, 1024, 512)
    out, acc = i32_matmul(x0, w4, xs, wsb, return_acc=True)
    ref, acc_ref = i32_matmul_reference(x0, w4, xs, wsb, return_acc=True)
    rows = [pi.check_row(NAME, "m256_k1024_n512", acc_equal=bool(torch.equal(acc, acc_ref)),
                         out_equal=bool(torch.equal(out, ref)))]
    for label, m, k, n in SHAPES:
        x0, w4, xs, w_scale, wsb = operands(m, k, n)
        ops = 2 * m * k * n
        rows += [
            _bench.timing_row(NAME, f"{label} K3",
                              lambda: qm.w4a8_matmul(x0, w4, xs, w_scale), ops),
            _bench.timing_row(NAME, f"{label} T10 i32 unpack",
                          lambda: i32_matmul(x0, w4, xs, wsb), ops),
            _bench.timing_row(NAME, f"{label} T12 AND-only",
                          lambda: t12.w4a8_i8_matmul(x0, w4, xs, wsb, torch.bfloat16), ops)]
    return rows


if __name__ == "__main__":
    main()

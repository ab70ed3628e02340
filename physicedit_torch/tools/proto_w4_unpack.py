"""T12, the W4A8 matmul with the AND-only nibble unpack (the port of
``tools/proto_w4_unpack.py``), and the tool that times it at the DiT's
image-stream shapes:

    python -m physicedit_torch.tools.proto_w4_unpack

The encoding is K3's, ``packed = (hi << 4) | (lo + 8)`` with lo, hi in [-7,
7], in the port's layout ``[N, K/2]`` (the JAX tool's is ``[K/2, N]``).
:func:`w4a8_i8_matmul` unpacks each byte with two ANDs only,

    t = b & 0x0F  (= lo + 8)          against x[:, :K/2] into acc
    h = b & 0xF0  (= 16 hi, an int8)  against x[:, K/2:] into acc16
    acc' = acc - 8 rowsum(x[:, :K/2]) + (acc16 >> 4)

(acc16 is a multiple of 16, so the shift is exact, and acc' is the exact
product), then ``acc' * x_scale * wsb[0] + wsb[1]`` in fp32, each step
rounded, written as fp32, bf16 or int8.  int8 is JAX's conversion, truncate
toward 0 and saturate (300 -> 127, 127.6 -> 127, -128.7 -> -128), which the
kernel and the plain version both do (``Tensor.to(torch.int8)`` would wrap).
The row sum is a torch op in the wrapper, as it is an XLA op outside the
JAX kernel.  The kernel is ``w4_and_wgmma_kernel`` of
``csrc/proto_int8_matmul.cu`` (``proto_w4_and``): K3's TMA + ``wgmma``
loop with the AND-only unpack and the two accumulators; T10
(``proto_prefill_blocks``) is the same function with the sign-extending
unpack.  The JAX tool swept TPU block sizes against the package's W4
kernel; the kernel has one tiling, so the tool prints a row per form: K3
(bf16 out, its only), T10 in bf16, and T12 in bf16, in int8 as the JAX
tool's loop wrote it, and in fp32 (the three outputs' bytes, 2, 1 and 4 a
value, show what the epilogue's stores cost).
"""

from __future__ import annotations

import torch

from physicedit_torch.kernels import quant_matmul as qm
from physicedit_torch.tools import _bench, _proto_int8 as pi

NAME = "proto_w4_unpack"
SHAPES = [("qkv m16384 k3072 n9216", 16384, 3072, 9216),
          ("to_out m16384 k3072 n3072", 16384, 3072, 3072),
          ("fc1 m16384 k3072 n12288", 16384, 3072, 12288),
          ("fc2 m16384 k12288 n3072", 16384, 12288, 3072)]
pack_offset = pi.pack_offset


def w4a8_i8_matmul(x_q, packed, x_scale, wsb, out_dtype, return_acc: bool = False):
    """T12: x_q int8 ``[M, K]``, packed int8 ``[N, K/2]``, x_scale fp32 ``[M,
    1]``, wsb fp32 ``[2, N]`` -> ``[M, N]`` in ``out_dtype`` (fp32, bf16 or
    int8); the kernel for CUDA tensors, :func:`w4a8_i8_matmul_reference` for
    CPU ones.  ``return_acc`` also returns the int32 accumulators acc'."""
    if x_q.device.type == "cpu":
        return w4a8_i8_matmul_reference(x_q, packed, x_scale, wsb, out_dtype, return_acc)
    return pi.launch_matmul("proto_w4_and", x_q, packed, x_scale, wsb,
                            pi.low_half_rowsum8(x_q), out_dtype, return_acc)


def w4a8_i8_matmul_reference(x_q, packed, x_scale, wsb, out_dtype, return_acc: bool = False):
    """The plain version of T12: acc' from the two AND planes, exactly
    (``_proto_int8.and_only_acc``), then the epilogue."""
    acc = pi.and_only_acc(x_q, packed)
    out = pi.w4_epilogue(acc, x_scale, wsb, out_dtype)
    return (out, acc) if return_acc else out


def main() -> list:
    """On the card: T12 against the exact product at M256 K512 N512 with
    unit scales (fp32 out), as the JAX tool checks, then K3, T10 and T12 at
    the four DiT image-stream shapes (weights normal x 0.02 quantized per
    column to [-7, 7], x_q in [-4, 4], unit scales)."""
    from physicedit_torch.tools import proto_prefill_blocks as t10

    dev = _bench.require_cuda(NAME)
    gen = torch.Generator(dev).manual_seed(0)
    k, n, m = 512, 512, 256
    wq = torch.randint(-7, 8, (n, k), device=dev, generator=gen, dtype=torch.int8)
    xq = torch.randint(-127, 128, (m, k), device=dev, generator=gen, dtype=torch.int8)
    xs = torch.ones(m, 1, device=dev)
    wsb = torch.stack([torch.ones(n, device=dev), torch.zeros(n, device=dev)])
    got = w4a8_i8_matmul(xq, pack_offset(wq), xs, wsb, torch.float32)
    want = qm._exact_mm(xq, wq).float()
    rows = [pi.check_row(NAME, "m256_k512_n512", max_abs_err=(got - want).abs().max().item())]
    for label, m, k, n in SHAPES:
        w4, _ = qm.quantize_weight_int4(torch.randn(n, k, device=dev, generator=gen) * 0.02)
        xs = torch.ones(m, 1, device=dev)
        ws1 = torch.ones(n, device=dev)
        wsb = torch.stack([ws1, torch.zeros(n, device=dev)])
        x0 = torch.randint(-4, 5, (m, k), device=dev, generator=gen, dtype=torch.int8)
        ops = 2 * m * k * n
        rows += [
            _bench.timing_row(NAME, f"{label} K3 bf16",
                              lambda: qm.w4a8_matmul(x0, w4, xs, ws1), ops),
            _bench.timing_row(NAME, f"{label} T10 bf16",
                          lambda: t10.i32_matmul(x0, w4, xs, wsb), ops),
            _bench.timing_row(NAME, f"{label} T12 bf16",
                          lambda: w4a8_i8_matmul(x0, w4, xs, wsb, torch.bfloat16), ops),
            _bench.timing_row(NAME, f"{label} T12 int8",
                          lambda: w4a8_i8_matmul(x0, w4, xs, wsb, torch.int8), ops),
            _bench.timing_row(NAME, f"{label} T12 fp32",
                              lambda: w4a8_i8_matmul(x0, w4, xs, wsb, torch.float32), ops)]
    return rows


if __name__ == "__main__":
    main()

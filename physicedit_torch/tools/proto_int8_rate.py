"""T9, the plain int8 GEMM probe (the port of ``tools/proto_int8_rate.py``),
and the tool that pins the card's int8 and bf16 tensor-core rates with it:

    python -m physicedit_torch.tools.proto_int8_rate

:func:`pallas_mm` is ``x [M, K] . w [N, K]^T``: ``acc="i32"`` on int8 x and
w gives int32, exactly; ``acc="f32"`` on bf16 x and w sums in fp32 and
returns bf16.  w is ``[N, K]``, the port's layout (both operands K-major,
as int8 ``wgmma`` takes them); the JAX tool's w is ``[K, N]``.  The kernels
are instantiations ``proto_mm_i32`` and ``proto_mm_f32`` of
``csrc/proto_int8_matmul.cu``'s ``gemm_wgmma_kernel``: a persistent grid of
128 x 256 output tiles, both operands copied by TMA into a 4-stage ring and
read by ``wgmma`` from shared memory.  The JAX tool swept TPU block shapes;
the kernel has one tiling, so the tool prints one row per form, beside the
two PyTorch calls it stands against: ``torch.matmul`` in bf16 (cuBLAS) and
``torch._int_mm`` (int8 in, int32 out), at the DiT fc1 shape M16384 K3072
N12288.
"""

from __future__ import annotations

import torch

from physicedit_torch.kernels import quant_matmul as qm
from physicedit_torch.tools import _bench, _proto_int8 as pi

NAME = "proto_int8_rate"
ACC = {"i32": "proto_mm_i32", "f32": "proto_mm_f32"}
M, K, N = 16384, 3072, 12288


def pallas_mm(x, w, acc: str):
    """T9 on x ``[M, K]`` and w ``[N, K]``: the kernel for CUDA tensors,
    :func:`pallas_mm_reference` for CPU ones.  On the card ``acc="i32"``
    takes int8 and ``"f32"`` bf16, contiguous and 16-byte aligned, with
    M >= 1, N % 128 == 0 and K % 128 (i32) or 64 (f32) == 0; any other
    shape raises before a launch."""
    if x.device.type == "cpu":
        return pallas_mm_reference(x, w, acc)
    return pi.launch_matmul(ACC[acc], x, w)


def pallas_mm_reference(x, w, acc: str):
    """The plain version of T9: the exact int32 product, or fp32 sums of the
    inputs' products rounded to bf16 (the sum's order is not the kernel's)."""
    if acc == "i32":
        return qm._exact_mm(x, w)
    if acc == "f32":
        return (x.float() @ w.float().T).to(torch.bfloat16)
    raise ValueError(f"acc must be 'i32' or 'f32', got {acc!r}")


def main() -> list:
    """On the card: both forms against their plain versions at M256 K1024
    N512, then the bf16 ``torch.matmul``, ``torch._int_mm``, T9 i32 and T9
    f32 timed at M16384 K3072 N12288 (x normal x 0.1 or int8 in [-127, 127],
    w normal x 0.1 or in [-7, 7], as the JAX tool draws them)."""
    dev = _bench.require_cuda(NAME)
    gen = torch.Generator(dev).manual_seed(0)

    def operands(m, k, n):
        return ((torch.randn(m, k, device=dev, generator=gen) * 0.1).bfloat16(),
                (torch.randn(n, k, device=dev, generator=gen) * 0.1).bfloat16(),
                torch.randint(-127, 128, (m, k), device=dev, generator=gen, dtype=torch.int8),
                torch.randint(-7, 8, (n, k), device=dev, generator=gen, dtype=torch.int8))

    xb, wb, xi, wi = operands(256, 1024, 512)
    got = pallas_mm(xb, wb, "f32")
    rows = [pi.check_row(
        NAME, "m256_k1024_n512",
        i32_equal=bool(torch.equal(pallas_mm(xi, wi, "i32"), pallas_mm_reference(xi, wi, "i32"))),
        f32_max_abs_err=(got.float() - pallas_mm_reference(xb, wb, "f32").float()).abs().max()
        .item())]
    xb, wb, xi, wi = operands(M, K, N)
    wit = wi.T
    ops = 2 * M * K * N
    rows += [_bench.timing_row(NAME, "torch.matmul bf16", lambda: xb @ wb.T, ops),
             _bench.timing_row(NAME, "torch._int_mm int8", lambda: torch._int_mm(xi, wit), ops),
             _bench.timing_row(NAME, "T9 i32", lambda: pallas_mm(xi, wi, "i32"), ops),
             _bench.timing_row(NAME, "T9 f32", lambda: pallas_mm(xb, wb, "f32"), ops)]
    return rows


if __name__ == "__main__":
    main()

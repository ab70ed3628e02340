"""T11, the decode GEMV with the AND-only nibble unpack (the port of
``tools/proto_w4_gemv.py``), and the tool that times it at the Qwen2.5-VL
decode shapes:

    python -m physicedit_torch.tools.proto_w4_gemv

:func:`gemv_and_only` is the exact int32 ``x_q . unpack(packed)^T`` for a
few padded decode rows (int8 x_q ``[m, K]``, m <= 8 on the card; packed
``[N, K/2]``, K3's layout, where the JAX tool's is ``[K/2, N]``), computed as
T12 computes it, with no scales: ``acc - 8 rowsum(x[:, :K/2]) + (acc16 >>
4)`` over the planes ``b & 0x0F`` and ``b & 0xF0``.  The kernel is
instantiation ``proto_w4_gemv_and`` of ``csrc/proto_int8_matmul.cu``: the
weights as the A operand of int8 ``mma.sync`` m16n8k32 against x's rows as
its 8-wide B, fed by TMA, K split over a cluster of blocks, the row sums
taken from the x it stages; the wrapper launches nothing else.  Beside it, per
shape: K3 at M = 8 (its GEMV regime, bf16 out), the "XLA unpack + dot"
analogue (``_unpack_w4_int8``
then ``torch._int_mm``, x padded to 32 rows because ``_int_mm`` takes M >
16) and the W8 baseline (``torch._int_mm`` on int8 weights).  A decode
reads 28 layers of weights per token, each once, and the qkv (10 MB) and
down (34 MB) weights fit in the 50 MB L2, so every row takes the next of
enough weight copies to fill twice the L2 (``_proto_int8.l2_copies``,
``rotated``).
"""

from __future__ import annotations

import torch

from physicedit_torch.kernels import quant_matmul as qm
from physicedit_torch.tools import _bench, _proto_int8 as pi

NAME = "proto_w4_gemv"
M_DECODE = pi.GEMV_ROWS
SHAPES = [("gate+up k3584 n37888", 3584, 37888),
          ("down k18944 n3584", 18944, 3584),
          ("qkv k3584 n5632", 3584, 5632)]


def gemv_and_only(x_q, packed):
    """T11: int32 ``[m, N]``; the kernel for CUDA tensors,
    :func:`gemv_and_only_reference` for CPU ones."""
    if x_q.device.type == "cpu":
        return gemv_and_only_reference(x_q, packed)
    return pi.launch_matmul("proto_w4_gemv_and", x_q, packed)


def gemv_and_only_reference(x_q, packed):
    """The plain version of T11: the AND-only planes' integer result,
    exactly (``_proto_int8.and_only_acc``)."""
    return pi.and_only_acc(x_q, packed)


def main() -> list:
    """On the card: T11 against the exact product at m8 K512 N512, as the
    JAX tool checks, then T11, K3, the unpack + ``_int_mm`` analogue and the
    W8 ``_int_mm`` at the three decode shapes (weights in [-7, 7], x_q in
    [-4, 4]), in ms and in GB/s of packed weights (W8: of int8 weights)."""
    dev = _bench.require_cuda(NAME)
    gen = torch.Generator(dev).manual_seed(0)
    k, n = 512, 512
    wq = torch.randint(-7, 8, (n, k), device=dev, generator=gen, dtype=torch.int8)
    xq = torch.randint(-127, 128, (M_DECODE, k), device=dev, generator=gen, dtype=torch.int8)
    rows = [pi.check_row(NAME, "m8_k512_n512", exact=bool(torch.equal(
        gemv_and_only(xq, pi.pack_offset(wq)), qm._exact_mm(xq, wq))))]
    for label, k, n in SHAPES:
        wq = torch.randint(-7, 8, (n, k), device=dev, generator=gen, dtype=torch.int8)
        w4s, w8s = pi.l2_copies(pi.pack_offset(wq)), pi.l2_copies(wq)
        x0 = torch.randint(-4, 5, (M_DECODE, k), device=dev, generator=gen, dtype=torch.int8)
        x32 = torch.cat([x0, x0.new_zeros(32 - M_DECODE, k)])
        xs = torch.ones(M_DECODE, 1, device=dev)
        ws = torch.ones(n, device=dev)
        w4_bytes = n * k // 2
        rotation = f" ({len(w4s)} weight copies)"
        rows += [
            _bench.timing_row(NAME, f"{label} T11 AND-only{rotation}",
                              pi.rotated(lambda w: gemv_and_only(x0, w), w4s), nbytes=w4_bytes),
            _bench.timing_row(NAME, f"{label} K3 gemv{rotation}",
                              pi.rotated(lambda w: qm.w4a8_matmul(x0, w, xs, ws), w4s),
                              nbytes=w4_bytes),
            _bench.timing_row(NAME, f"{label} unpack + _int_mm{rotation}",
                              pi.rotated(lambda w: torch._int_mm(x32, qm._unpack_w4_int8(w).T),
                                         w4s), nbytes=w4_bytes),
            _bench.timing_row(NAME, f"{label} W8 _int_mm ({len(w8s)} weight copies)",
                              pi.rotated(lambda w: torch._int_mm(x32, w.T), w8s),
                              nbytes=2 * w4_bytes)]
        del w4s, w8s
    return rows


if __name__ == "__main__":
    main()

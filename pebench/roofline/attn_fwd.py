"""The DiT's joint attention forward (kernel K1, ``fixedmax_attention``):
``4 * N * Sq * Sk * D`` operations a row (QK^T and PV), bf16 q, k, v read
and the output written once.  Per CFG step each row runs every block over
its own text tokens (padding excluded) and the image tokens; the last block
is queried by the output image's tokens only."""

from pebench import peaks
from pebench.roofline import least_time

KERNELS = ("fixedmax_kernel",)


def call_bound_s(b: int, n: int, sq: int, sk: int, d: int) -> float:
    flops = 4.0 * b * n * sq * sk * d
    bytes_ = 2.0 * b * n * d * (2 * sq + 2 * sk)
    return least_time(flops, bytes_, peaks.BF16_FLOPS, peaks.HBM_BYTES_PER_S)


def step_bound_s(shapes: dict) -> float:
    n, d, layers = shapes["heads"], shapes["head_dim"], shapes["layers"]
    total = 0.0
    for txt in shapes["txt_valid"]:
        sk = txt + shapes["img_tokens"]
        total += (layers - 1) * call_bound_s(1, n, sk, sk, d)
        total += call_bound_s(1, n, shapes["base"], sk, d)
    return total

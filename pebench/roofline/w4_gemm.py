"""The W4A8 linears of the DiT blocks (kernel K3, ``w4a8_matmul``, both
regimes): ``2 * M * N * K`` int8 operations; packed int4 weights, their
fp32 scales, the int8 activations and their scales read, the bf16 output
written once.  Per CFG step: every block's two modulations (M = the CFG
rows), and each stream's QKV, output projection and MLP over its tokens
(text padding excluded); the last block projects and runs the MLP for the
output image's tokens only, and skips the text stream's after the QKV."""

from pebench import peaks
from pebench.roofline import least_time

KERNELS = ("w4a8_",)


def call_bound_s(m: int, n: int, k: int) -> float:
    flops = 2.0 * m * n * k
    bytes_ = n * k / 2 + 4.0 * n + m * k + 4.0 * m + 2.0 * m * n + 2.0 * n
    return least_time(flops, bytes_, peaks.INT8_OPS, peaks.HBM_BYTES_PER_S)


def step_linears(shapes: dict) -> list:
    """(M, N, K) of every block linear of one CFG step."""
    d, f, layers, b = shapes["dim"], shapes["mlp_dim"], shapes["layers"], shapes["rows"]
    img = b * shapes["img_tokens"]
    txt = sum(shapes["txt_valid"])
    base = b * shapes["base"]
    out = []
    for i in range(layers):
        last = i == layers - 1
        out += [(b, 6 * d, d), (b, 6 * d, d), (img, 3 * d, d), (txt, 3 * d, d)]
        rows_img = base if last else img
        out += [(rows_img, d, d), (rows_img, f, d), (rows_img, d, f)]
        if not last:
            out += [(txt, d, d), (txt, f, d), (txt, d, f)]
    return out


def step_bound_s(shapes: dict) -> float:
    return sum(call_bound_s(m, n, k) for m, n, k in step_linears(shapes))

"""The joint attention backward (kernel K8, ``fixedmax_attention_bwd``):
``10 * B * N * S^2 * D`` operations (the recomputed QK^T, dV, dP, dQ and
dK), q, k, v, o and do read and dq, dk, dv written once in bf16.  For the
training cell that ``PERF.md`` keeps for later."""

from pebench import peaks
from pebench.roofline import least_time

KERNELS = ("fm_bwd_",)


def call_bound_s(b: int, n: int, s: int, d: int) -> float:
    flops = 10.0 * b * n * s * s * d
    bytes_ = 2.0 * b * n * s * d * 8
    return least_time(flops, bytes_, peaks.BF16_FLOPS, peaks.HBM_BYTES_PER_S)

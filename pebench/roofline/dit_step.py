"""The model FLOPs of one CFG denoise step (the whole DiT over both rows,
and the adapter's rewrite of the special tokens), counted from the
configuration and the joint length, and the least time they take at the
peaks of the precisions the configuration declares: the W4A8 lane's block
linears at the int8 peak, everything else at the bf16 peak."""

from pebench import peaks
from pebench.roofline import w4_gemm

KERNELS = ()


def step_flops(shapes: dict) -> dict:
    """{"block_linears", "other"} operations of one CFG step."""
    b, n, hd = shapes["rows"], shapes["heads"], shapes["head_dim"]
    d, layers = shapes["dim"], shapes["layers"]
    block = sum(2.0 * m * nn * k for m, nn, k in w4_gemm.step_linears(shapes))
    attn = 0.0
    for txt in shapes["txt_valid"]:
        sk = txt + shapes["img_tokens"]
        attn += 4.0 * n * hd * sk * (sk * (layers - 1) + shapes["base"])
    txt_rows = sum(shapes["txt_valid"])
    outer = 2.0 * (b * shapes["img_tokens"] * shapes["patch_dim"] * d
                   + txt_rows * shapes["txt_in_dim"] * d
                   + b * shapes["base"] * d * shapes["patch_dim"])
    a = shapes["adapter_dim"]
    adapter = 2 * 2.0 * b * shapes["specials"] * (a * 3 * a + 3 * a * a)
    return {"block_linears": block, "other": attn + outer + adapter}


def step_least_s(shapes: dict) -> float:
    f = step_flops(shapes)
    lin_peak = peaks.INT8_OPS if shapes.get("quantize") == "int4" else peaks.BF16_FLOPS
    return f["block_linears"] / lin_peak + f["other"] / peaks.BF16_FLOPS

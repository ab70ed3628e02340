"""The model FLOPs of one Kontext denoise step (the FLUX DiT over its one
row: 19 double-stream blocks, 38 single-stream blocks, the embedders and
the final layer), counted from the configuration and the joint length, and
the least time they take at the bf16 peak; and the bound of the step's
joint attention calls (kernel K1, ``roofline/attn_fwd.py``).  The last
single-stream block is queried by the target's rows only: its attention,
``proj_mlp`` and ``proj_out`` cover those rows, its QKV every row."""

from pebench import peaks
from pebench.roofline import load

KERNELS = ()


def step_linears(shapes: dict) -> list:
    """(M, N, K) of every block linear of one step."""
    d, f, b = shapes["dim"], shapes["mlp_dim"], shapes["rows"]
    img, txt = b * shapes["img_tokens"], b * shapes["txt"]
    joint, base = img + txt, b * shapes["base"]
    out = []
    for _ in range(shapes["layers"]):
        out += [(b, 6 * d, d), (b, 6 * d, d)]
        for m in (img, txt):
            out += [(m, 3 * d, d), (m, d, d), (m, f, d), (m, d, f)]
    singles = shapes["single_layers"]
    for i in range(singles):
        rows = base if i == singles - 1 else joint
        out += [(b, 3 * d, d), (joint, 3 * d, d), (rows, f, d), (rows, d, d + f)]
    return out


def attn_calls(shapes: dict) -> list:
    """(B, N, S_q, S_k, D) of every joint attention call of one step."""
    n, hd = shapes["heads"], shapes["head_dim"]
    s = shapes["txt"] + shapes["img_tokens"]
    blocks = shapes["layers"] + shapes["single_layers"]
    return ([(shapes["rows"], n, s, s, hd)] * (blocks - 1)
            + [(shapes["rows"], n, shapes["base"], s, hd)])


def step_flops(shapes: dict) -> dict:
    """{"block_linears", "attention", "other"} operations of one step."""
    d, b = shapes["dim"], shapes["rows"]
    block = sum(2.0 * m * nn * k for m, nn, k in step_linears(shapes))
    attn = sum(4.0 * bb * n * sq * sk * hd for bb, n, sq, sk, hd in attn_calls(shapes))
    t = shapes["time_dim"]
    embed = 2.0 * b * (2 * (t * d + d * d) + shapes["pooled_dim"] * d + d * d + d * 2 * d)
    outer = 2.0 * b * (shapes["img_tokens"] * shapes["patch_dim"] * d
                       + shapes["txt"] * shapes["txt_in_dim"] * d
                       + shapes["base"] * d * shapes["patch_dim"])
    return {"block_linears": block, "attention": attn, "other": embed + outer}


def step_least_s(shapes: dict) -> float:
    return sum(step_flops(shapes).values()) / peaks.BF16_FLOPS


def attn_step_bound_s(shapes: dict) -> float:
    op = load("attn_fwd")
    return sum(op.call_bound_s(*call) for call in attn_calls(shapes))

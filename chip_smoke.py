#!/usr/bin/env python3
"""Drive the PyTorch port (``physicedit_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py [--steps 4]

Phases, each printed as one JSON line, any failure exits non-zero:
  1. the card (nvidia-smi name and power limit) and the TF32 settings;
  2. build the kernel sources of ``physicedit_torch/csrc``, one nvcc each,
     all at once;
  3. K1 (DiT fixed-max attention) against its plain version at the main
     path's shapes, before any weights are allocated;
  4. K2 (VL causal GQA attention) against its plain version;
  5. K3 (W4A8 matmul) against its exact plain version at the W4 lane's
     shapes, and at the DiT image-stream shapes beside an unpack to int8
     and torch._int_mm (the JAX package's route at M >= 8192);
  6. K4-K6 (fused activation quantize) against their plain versions;
  7. a small head_dim-128 pipeline on the card (kernels) against the same
     weights on the CPU (plain versions), in bf16 and then quantized int4;
  8. the full-width pipeline (Qwen-Image-Edit-2509 widths, random bf16
     weights): three edits through ``PhysicEditPipeline.__call__`` with the
     reasoner on and CFG 4, with stage times, kernel launch counts and
     peak memory;
  9. the W4 serving lane at full width: an edit with the reasoner off in
     bf16, ``quantize_("int4")`` in place, the same edit on the W4 pipeline
     (image rel-L2 against bf16), then an edit with the reasoner on and the
     int8 KV cache, with exact K1-K6 launch counts and the decode profile.
The line before the last lists each kernel with its launches on its main
path, its error against the plain version and both times; the last line is
the run's result.  There is no CPU path: without a CUDA device it exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ATOL = RTOL = 2e-2   # bf16 kernel against its plain version (fp32 softmax)
PIPE_REL_L2 = 0.05   # small pipeline, bf16 on the card vs bf16 on the CPU
W4_REL_L2 = 0.05     # full-width W4 edit against the same edit in bf16
KERNEL_SOURCES = ("fixedmax_attention", "gqa_causal_attention", "w4a8_matmul", "fused_quant")
SEED = 0             # of the random weights and inputs
# K1 clamp cases scale the RMS-normed q and k by this, so that a logit
# (exp2 units) has a spread of ~90 and many pass fa.CLAMP: the clamp binds
CLAMP_QK_SCALE = 8.0


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# name, source, the TPU kernel it replaces, the report entry of its times
KERNEL_ROWS = [
    ("fixedmax_attention", "physicedit_torch/csrc/fixedmax_attention.cu",
     "physicedit_tpu/kernels/flash_attention.py:176", None),
    ("gqa_causal_attention", "physicedit_torch/csrc/gqa_causal_attention.cu",
     "physicedit_tpu/kernels/flash_attention.py:632", None),
    ("w4a8_matmul", "physicedit_torch/csrc/w4a8_matmul.cu",
     "physicedit_tpu/kernels/quant_matmul.py:143", "k3_decode_gate_up"),
    ("ln_mod_quant", "physicedit_torch/csrc/fused_quant.cu",
     "physicedit_tpu/kernels/fused_quant.py:54", None),
    ("gelu_quant", "physicedit_torch/csrc/fused_quant.cu",
     "physicedit_tpu/kernels/fused_quant.py:67", None),
    ("transpose_quant", "physicedit_torch/csrc/fused_quant.cu",
     "physicedit_tpu/kernels/fused_quant.py:119", None),
]


def _counter_modules():
    from physicedit_torch.kernels import flash_attention, fused_quant, quant_matmul

    return flash_attention, quant_matmul, fused_quant


def reset_counts() -> None:
    for module in _counter_modules():
        module.reset_launch_counts()


def counts() -> dict:
    return {name: n for module in _counter_modules() for name, n in module.LAUNCHES.items()}


def device_ms(fn, iters: int, name_part: str) -> float | None:
    """Mean device time per call of the kernels whose name holds
    ``name_part``, from torch.profiler; None if the trace has no device
    time.  Unlike a CUDA-event time it leaves out the host's launch cost,
    which bounds a call of a few microseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages() if name_part in e.key)
    return total / 1e3 / iters if total else None


def bf16_ulps(got, want):
    """|got - want| in units of want's bf16 ulp."""
    import torch

    _, e = torch.frexp(want.float())
    return ((got.float() - want.float()).abs() / torch.ldexp(torch.ones_like(want.float()),
                                                            e - 8)).max().item()


def k3_phase(report: dict, gen, time_ms) -> None:
    """K3 against its exact plain version at the W4 lane's shapes: decode
    (M = 1), DiT modulation (M = 2), DiT text stream (M = 512), VL prefill
    (M = 1536), the ViT (784 patches, 196 merged) and a ragged M.  The int32
    accumulators must be equal and the bf16 outputs within one ulp.  Weights
    rotate over enough copies to exceed the 50 MB L2, as a decode finds them
    cold.  Then the DiT image-stream shapes (M = 16384) beside the route
    the JAX package takes there, timed only: unpack to int8, torch._int_mm
    and the fp32 epilogue."""
    import torch

    from physicedit_torch.kernels import quant_matmul as qm

    dev = torch.device("cuda")
    cases = [  # name, M, K, N, bias
        ("decode_qkv", 1, 3584, 4608, True), ("decode_o", 1, 3584, 3584, False),
        ("decode_gate_up", 1, 3584, 37888, False), ("decode_down", 1, 18944, 3584, False),
        ("decode_lm_head", 1, 3584, 152064, False), ("dit_mod", 2, 3072, 18432, True),
        ("dit_text_qkv", 512, 3072, 9216, True), ("dit_text_out", 512, 3072, 3072, True),
        ("dit_text_fc1", 512, 3072, 12288, True), ("dit_text_fc2", 512, 12288, 3072, True),
        ("prefill_qkv", 1536, 3584, 4608, True), ("prefill_o", 1536, 3584, 3584, False),
        ("prefill_gate_up", 1536, 3584, 37888, False),
        ("prefill_down", 1536, 18944, 3584, False),
        ("vit_qkv", 784, 1280, 3840, True), ("vit_proj", 784, 1280, 1280, True),
        ("vit_merger_fc1", 196, 5120, 5120, True), ("vit_merger_fc2", 196, 5120, 3584, True),
        ("ragged_m1000", 1000, 3584, 4608, True)]

    def operands(m, k, n, bias):
        xq = torch.randint(-127, 128, (m, k), device=dev, dtype=torch.int8, generator=gen)
        w4 = torch.randint(-128, 128, (n, k // 2), device=dev, dtype=torch.int8, generator=gen)
        xs = torch.rand(m, 1, device=dev, generator=gen) * 1e-2 + 1e-3
        ws = torch.rand(n, device=dev, generator=gen) * 1e-2 + 1e-3
        b = torch.randn(n, device=dev, generator=gen).bfloat16() if bias else None
        return xq, w4, xs, ws, b

    for name, m, k, n, bias in cases:
        xq, w4, xs, ws, b = operands(m, k, n, bias)
        out, acc = qm.w4a8_matmul(xq, w4, xs, ws, b, return_acc=True)
        ref, acc_ref = qm.w4a8_matmul_reference(xq, w4, xs, ws, b, return_acc=True)
        torch.cuda.synchronize()
        acc_equal = bool(torch.equal(acc, acc_ref))
        ulps = bf16_ulps(out, ref)
        copies = [w4] + [torch.randint_like(w4, -128, 128)
                         for _ in range(max(0, -(-(100 << 20) // w4.numel()) - 1))]
        it = iter(range(1 << 30))

        def run():
            return qm.w4a8_matmul(xq, copies[next(it) % len(copies)], xs, ws, b)

        ms = time_ms(run, 20)
        dev_ms = device_ms(run, 20, "w4a8_")
        plain_ms = time_ms(lambda: qm.w4a8_matmul_reference(xq, w4, xs, ws, b), 3)
        row = {"phase": "k3", "case": name, "shape": [m, k, n], "bias": bias,
               "regime": "gemv" if m <= 16 else "tiled", "acc_equal": acc_equal,
               "max_bf16_ulps": ulps, "max_abs_err": (out.float() - ref.float()).abs().max().item(),
               "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
               "weight_copies": len(copies)}
        t = dev_ms or ms
        if m <= 16:
            row["gb_per_s_device"] = (n * k // 2 + m * k + 2 * m * n + 4 * n) / t / 1e6
        else:
            row["tops_device"] = 2 * m * n * k / t / 1e9
        report[f"k3_{name}"] = row
        report.setdefault("w4a8_matmul_err", []).append(row["max_abs_err"])
        emit(row)
        if not acc_equal or ulps > 1.0:
            fail(f"K3 {name} disagrees with its plain version")
        del xq, w4, xs, ws, b, out, acc, ref, acc_ref, copies
    torch.cuda.empty_cache()

    # the DiT image stream at 1024^2: M = 2 x 8192
    def int_mm_route(xq, w4, xs, ws, b):
        acc = torch._int_mm(xq, qm._unpack_w4_int8(w4).T)
        return qm._epilogue(acc, xs, ws, b, torch.bfloat16), acc

    m = 16384
    for name, k, n in (("qkv", 3072, 9216), ("out", 3072, 3072), ("fc1", 3072, 12288),
                       ("fc2", 12288, 3072)):
        xq, w4, xs, ws, b = operands(m, k, n, True)
        out, acc = qm.w4a8_matmul(xq, w4, xs, ws, b, return_acc=True)
        route, acc_route = int_mm_route(xq, w4, xs, ws, b)
        torch.cuda.synchronize()
        w8t = qm._unpack_w4_int8(w4).T
        row = {"phase": "k3_vs_int_mm", "case": f"dit_image_{name}", "shape": [m, k, n],
               "acc_equal": bool(torch.equal(acc, acc_route)),
               "max_bf16_ulps_vs_route": bf16_ulps(out, route),
               "k3_ms": time_ms(lambda: qm.w4a8_matmul(xq, w4, xs, ws, b), 10),
               "k3_device_ms": device_ms(lambda: qm.w4a8_matmul(xq, w4, xs, ws, b), 10,
                                         "w4a8_"),
               "int_mm_route_ms": time_ms(lambda: int_mm_route(xq, w4, xs, ws, b), 10),
               "int_mm_only_ms": time_ms(lambda: torch._int_mm(xq, w8t), 10)}
        for key in ("k3_ms", "int_mm_route_ms", "int_mm_only_ms"):
            row[key.replace("_ms", "_tops")] = 2 * m * n * k / row[key] / 1e9
        emit(row)
        if not row["acc_equal"] or row["max_bf16_ulps_vs_route"] > 1.0:
            fail(f"K3 and the _int_mm route disagree at the DiT image-stream {name}")
        del xq, w4, xs, ws, b, out, acc, route, acc_route, w8t
    torch.cuda.empty_cache()


def fused_quant_phase(report: dict, gen, time_ms) -> None:
    """K4, K5 and K6 against their plain versions at the 1024^2 DiT shapes
    and at a ragged S (1001, which the kernels take though the JAX tiling
    predicate would send it to the unfused path): int8 codes identical and
    scales equal."""
    import torch

    from physicedit_torch.kernels import fused_quant as fq

    dev = torch.device("cuda")

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).bfloat16()

    cases = [  # kernel, case, shape, timed
        ("ln_mod_quant", "image_2x8192x3072", (2, 8192, 3072), True),
        ("ln_mod_quant", "ragged_2x1001x3072", (2, 1001, 3072), False),
        ("gelu_quant", "image_2x8192x12288", (2, 8192, 12288), True),
        ("gelu_quant", "ragged_2x1001x12288", (2, 1001, 12288), False),
        ("transpose_quant", "joint_2x24x8448x128", (2, 24, 8448, 128), True),
        ("transpose_quant", "ragged_2x24x1001x128", (2, 24, 1001, 128), False)]
    for name, case, shape, timed in cases:
        x = randn(*shape, scale=3.0)
        if name == "ln_mod_quant":
            sh, sc = randn(shape[0], shape[2], scale=0.5), randn(shape[0], shape[2], scale=0.5)
            run = lambda: fq._ln_mod_quant(x, sh, sc, 1e-6)  # noqa: E731
            plain = lambda: fq.ln_mod_quant_reference(x, sh, sc, 1e-6)  # noqa: E731
        elif name == "gelu_quant":
            run, plain = (lambda: fq._gelu_quant(x)), (lambda: fq.gelu_quant_reference(x))
        else:
            run = lambda: fq._transpose_quant(x)  # noqa: E731
            plain = lambda: fq.transpose_quant_reference(x)  # noqa: E731
        (q, s), (q_ref, s_ref) = run(), plain()
        torch.cuda.synchronize()
        mismatched = int((q != q_ref).sum().item())
        max_code_diff = (q.int() - q_ref.int()).abs().max().item()
        scales_equal = bool(torch.equal(s, s_ref))
        row = {"phase": "fused_quant", "kernel": name, "case": case, "shape": list(shape),
               "codes_mismatched": mismatched, "max_code_diff": max_code_diff,
               "scales_equal": scales_equal,
               "max_scale_rel_diff": ((s - s_ref).abs() / s_ref).max().item()}
        if timed:
            row["ms"] = time_ms(run, 20)
            row["device_ms"] = device_ms(run, 20, f"{name}_kernel")
            row["plain_ms"] = time_ms(plain, 3)
            nbytes = x.numel() * 2 + q.numel() + s.numel() * 4
            row["gb_per_s_device"] = nbytes / (row["device_ms"] or row["ms"]) / 1e6
            report[name] = row
        report.setdefault(f"{name}_err", []).append(max_code_diff)
        emit(row)
        if mismatched or not scales_equal:
            fail(f"{name} {case} disagrees with its plain version")
        del x, q, s, q_ref, s_ref
    torch.cuda.empty_cache()


def w4_launch_counts(tm: dict, steps: int, n_blocks: int, n_layers: int,
                     vit_depth: int) -> dict:
    """The launches of K1-K6 that one W4 edit's structure implies (CFG 4,
    reasoner on, kv_int8).  Per CFG step and full block: four K4 (the QKV
    and fc1 inputs of both streams), two K5 (fc2), one K6; the slim last
    block three K4, one K5, one K6.  K3 runs every kernel-sized W4 linear:
    in the DiT per full block the two modulations (M = 2) and qkv, out, fc1
    and fc2 of both streams, in the slim block the two modulations, both
    QKV and the image stream's out, fc1 and fc2; in the VL text model qkv,
    o, gate_up and down per layer for the prefill, the prompt encode and
    every decode token, plus the lm_head on the prefill and every token; in
    the ViT qkv and proj per block and the merger's two layers (its MLP and
    patch embed are not kernel-sized and take the dense fallback)."""
    full, slim, per_layer = 10, 7, 4
    text = (2 * per_layer * n_layers + 1
            + tm["decode_tokens"] * (per_layer * n_layers + 1))
    vit = 2 * vit_depth + 2
    return {"fixedmax_attention": steps * n_blocks,
            "gqa_causal_attention": 2 * n_layers,
            "w4a8_matmul": steps * ((n_blocks - 1) * full + slim) + text + vit,
            "ln_mod_quant": steps * (4 * (n_blocks - 1) + 3),
            "gelu_quant": steps * (2 * (n_blocks - 1) + 1),
            "transpose_quant": steps * n_blocks}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4, help="denoise steps per edit")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    from PIL import Image

    from physicedit_torch.kernels import _build
    from physicedit_torch.kernels import flash_attention as fa

    # 1. the card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    # 2. build
    t0 = time.perf_counter()
    paths = _build.build_all(KERNEL_SOURCES)
    seconds = time.perf_counter() - t0
    for name, path in paths.items():
        _build.load(name)
        ptxas = [ln.strip() for ln in open(f"{path}.log") if "Used" in ln or "spill" in ln]
        emit({"phase": "build", "source": name, "seconds_all_sources": seconds,
              "ptxas": ptxas})

    gen = torch.Generator(dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def rms(x):  # the DiT RMS-norms q and k before attention
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True))

    def compare(got, want, live=None):
        got, want = got.float(), want.float()
        err = (got - want).abs()
        bad = err > ATOL + RTOL * want.abs()
        if live is not None:
            err, bad = err[live], bad[live]
        return err.max().item(), err.mean().item(), int(bad.sum().item())

    def time_ms(fn, iters):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    report = {}

    # 3. K1 at the main path's shapes
    k1_cases = [  # name, B, N, S_q, S_k, clamp, text rows masked in row 1
        ("joint_8448_noclamp", 2, 24, 8448, 8448, False, (60, 256)),
        ("joint_8448_clamp", 2, 24, 8448, 8448, True, (60, 256)),
        ("slim_4096x8448", 2, 24, 4096, 8448, False, (60, 256)),
        ("ragged_2303", 2, 24, 2303, 2303, True, (2000, 2303)),
    ]
    for name, b, n, sq, sk, clamp, (m0, m1) in k1_cases:
        scale = CLAMP_QK_SCALE if clamp else 1.0
        q = (rms(randn(b, n, sq, 128)) * scale).bfloat16()
        k = (rms(randn(b, n, sk, 128)) * scale).bfloat16()
        v = randn(b, n, sk, 128).bfloat16()
        mask = torch.ones(b, sk, dtype=torch.bool, device=dev)
        mask[1, m0:m1] = False
        # share of logits (batch 0, head 0) the clamp cuts: > 0 when it binds
        logits = fa._prescale(q[0, 0]).float() @ k[0, 0].float().T
        clamped = (logits > fa.CLAMP).float().mean().item()
        del logits
        if clamp and clamped == 0.0:
            fail(f"K1 {name}: no logit reaches the clamp")
        out, l = fa.fixedmax_attention(q, k, v, mask, clamp, return_l=True)
        ref, l_ref = fa.fixedmax_attention_reference(q, k, v, mask, clamp, return_l=True)
        torch.cuda.synchronize()
        max_err, mean_err, n_bad = compare(out, ref)
        l_rel = ((l - l_ref).abs() / l_ref).max().item()
        row = {"phase": "k1", "case": name, "shape": [b, n, sq, sk], "clamp": clamp,
               "qk_scale": scale, "clamped_logit_share": clamped,
               "max_abs_err": max_err, "mean_abs_err": mean_err, "n_out_of_tol": n_bad,
               "l_max_rel_err": l_rel, "atol": ATOL, "rtol": RTOL}
        if name == "joint_8448_noclamp":
            row["ms"] = time_ms(lambda: fa.fixedmax_attention(q, k, v, mask, clamp), 10)
            row["plain_ms"] = time_ms(
                lambda: fa.fixedmax_attention_reference(q, k, v, mask, clamp), 3)
            row["tflops"] = 4 * b * n * sq * sk * 128 / row["ms"] / 1e9
            report["fixedmax_attention"] = dict(row)
        report.setdefault("fixedmax_attention_err", []).append(max_err)
        emit(row)
        if n_bad or l_rel > 1e-3:
            fail(f"K1 {name} disagrees with its plain version")
        del q, k, v, out, ref, l, l_ref
    q = randn(1, 2, 200, 128).bfloat16()
    out = fa.fixedmax_attention(q, q, q, torch.zeros(1, 200, dtype=torch.bool, device=dev))
    torch.cuda.synchronize()
    emit({"phase": "k1", "case": "fully_masked_rows", "max_abs": out.abs().max().item()})
    if out.abs().max().item() != 0.0:
        fail("K1 fully masked rows are not exactly 0")
    torch.cuda.empty_cache()

    # 4. K2 at the reasoner prefill / prompt-encode shapes
    for name, b, s, pads in [("prefill_1536", 1, 1536, (0,)),
                             ("left_padded_2x1536", 2, 1536, (300, 17))]:
        q = randn(b, s, 28, 128).bfloat16()
        k = randn(b, s, 4, 128).bfloat16()
        v = randn(b, s, 4, 128).bfloat16()
        mask = torch.ones(b, s, dtype=torch.bool, device=dev)
        for i, p in enumerate(pads):
            mask[i, :p] = False
        out = fa.gqa_causal_attention(q, k, v, mask)
        ref = fa.gqa_causal_attention_reference(q, k, v, mask)
        torch.cuda.synchronize()
        live = mask[:, :, None].expand_as(out)
        max_err, mean_err, n_bad = compare(out, ref, live)
        row = {"phase": "k2", "case": name, "shape": [b, s, 28, 4], "left_pad": list(pads),
               "max_abs_err_live_rows": max_err, "mean_abs_err_live_rows": mean_err,
               "n_out_of_tol": n_bad, "atol": ATOL, "rtol": RTOL}
        if name == "prefill_1536":
            row["ms"] = time_ms(lambda: fa.gqa_causal_attention(q, k, v, mask), 20)
            row["plain_ms"] = time_ms(lambda: fa.gqa_causal_attention_reference(q, k, v, mask), 5)
            row["tflops"] = 2 * b * 28 * s * s * 128 / row["ms"] / 1e9
            report["gqa_causal_attention"] = dict(row)
        report.setdefault("gqa_causal_attention_err", []).append(max_err)
        emit(row)
        if n_bad:
            fail(f"K2 {name} disagrees with its plain version on live rows")
    del q, k, v, out, ref
    torch.cuda.empty_cache()

    # 5. K3 at the W4 lane's shapes; 6. K4-K6
    k3_phase(report, gen, time_ms)
    fused_quant_phase(report, gen, time_ms)

    from physicedit_torch.models.dit import DiTConfig
    from physicedit_torch.models.qwen_vl import QwenVLTextConfig
    from physicedit_torch.models.qwen_vl_vision import QwenVLVisionConfig
    from physicedit_torch.models.vae import VAEConfig
    from physicedit_torch.pipeline.testing import (PipelineDims, build_random_pipeline,
                                                   random_pipeline)

    rng = np.random.default_rng(SEED)

    def image(w, h):
        # a smooth random picture: low-resolution noise, upsampled
        small = rng.integers(0, 256, (h // 32, w // 32, 3), dtype=np.uint8)
        return Image.fromarray(small).resize((w, h), Image.BILINEAR)

    # 7. small pipeline: kernels on the card against plain versions on the CPU,
    # in bf16 and then quantized int4 (the fused W4 DiT path, K3-K6)
    small = PipelineDims(
        dit=DiTConfig(num_layers=2, dim=256, num_heads=2, head_dim=128,
                      txt_in_dim=256, patch_dim=64, time_dim=64),
        text=QwenVLTextConfig(hidden_size=256, num_layers=2, num_heads=2, num_kv_heads=1,
                              head_dim=128, intermediate_size=512, vocab_size=512),
        vision=QwenVLVisionConfig(depth=2, hidden_size=64, num_heads=2,
                                  intermediate_size=128, fullatt_block_indexes=(1,),
                                  out_hidden_size=256),
        vae=VAEConfig(base_dim=16), adapter_dim=256, rope_axes=(16, 56, 56),
        edit_drop_idx=2)
    for quantize in (None, "int4"):
        pipe = random_pipeline(small, dev, torch.bfloat16, gen)
        if quantize:
            pipe.quantize_(quantize)
        kw = dict(edit_image=image(128, 128), height=128, width=128, seed=11,
                  num_inference_steps=2, have_text_reasoning=False)
        reset_counts()
        got = np.asarray(pipe("tilt the cup", **kw), np.float32)
        launches = counts()
        want = np.asarray(pipe.to("cpu")("tilt the cup", **kw), np.float32)
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want - want.mean()))
        used = launches if quantize else {k: launches[k] for k in fa.LAUNCHES}
        emit({"phase": "small_pipeline_vs_cpu", "quantize": quantize, "rel_l2": rel,
              "limit": PIPE_REL_L2, "max_abs_levels": float(np.abs(got - want).max()),
              "launches": launches})
        if not rel <= PIPE_REL_L2 or min(used.values()) == 0:
            fail(f"the small pipeline (quantize={quantize}) on the card disagrees with the "
                 "CPU run or skipped a kernel")
        del pipe

    # 8. the full-width slice
    t0 = time.perf_counter()
    pipe = build_random_pipeline("full", device=dev, generator=gen)
    torch.cuda.synchronize()
    emit({"phase": "full_init", "seconds": time.perf_counter() - t0,
          "resident_gb": torch.cuda.memory_allocated() / 1e9,
          "attn_clamp": pipe.attn_clamp})
    n_layers = pipe.text.cfg.num_layers
    n_blocks = pipe.dit.cfg.num_layers
    prompt = "make the glass fall off the table and shatter"
    requests = [(1024, 1024, SEED + 1), (768, 512, SEED + 2),
                (1024, 1024, SEED + 3)]
    edit_images = {(w, h): image(w, h) for w, h, _ in requests}

    def edit(w, h, seed, reasoning):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = pipe(prompt, negative_prompt="", edit_image=edit_images[(w, h)],
                   cfg_scale=4.0, height=h, width=w, seed=seed,
                   num_inference_steps=args.steps, have_text_reasoning=reasoning)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
        arr = np.asarray(out, np.float32)
        tm = pipe.timings
        row = {"size": [w, h], "seed": seed, "steps": args.steps, "reasoning": reasoning,
               "joint_tokens": tm["joint_tokens"], "total_ms": total,
               "vision_ms": tm["vision"], "prompt_encode_ms": tm["prompt_encode"],
               "denoise_ms": tm["denoise"], "denoise_ms_per_step": tm["denoise"] / args.steps,
               "vae_encode_ms": tm["vae_encode"], "vae_decode_ms": tm["vae_decode"],
               "image_std": float(arr.std()),
               "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
        if reasoning:
            row.update({"reasoner_prefill_ms": tm["reasoner_prefill"],
                        "decode_tokens": tm["decode_tokens"],
                        "decode_ms": tm["reasoner_decode"],
                        "decode_ms_per_token":
                            tm["reasoner_decode"] / max(1, tm["decode_tokens"])})
        if out.size != (w, h) or arr.shape != (h, w, 3):
            fail(f"edit image is {out.size}, wanted {(w, h)}")
        if not np.isfinite(arr).all() or arr.std() == 0.0:
            fail("edit image is not finite or is constant")
        return arr, row

    reset_counts()
    for w, h, seed in requests:
        before = counts()
        _, row = edit(w, h, seed, True)
        k1 = fa.LAUNCHES["fixedmax_attention"] - before["fixedmax_attention"]
        k2 = fa.LAUNCHES["gqa_causal_attention"] - before["gqa_causal_attention"]
        # one reasoner prefill row and one prompt-encode chunk (both CFG rows)
        k2_want = n_layers * (1 + 1)
        row.update({"k1_launches": k1, "k1_expected": args.steps * n_blocks,
                    "k2_launches": k2, "k2_expected": k2_want})
        emit({"phase": "edit", **row})
        if k1 != args.steps * n_blocks or k2 != k2_want:
            fail(f"launch counts K1 {k1} / K2 {k2} differ from the expected "
                 f"{args.steps * n_blocks} / {k2_want}")
    main_launches = {name: fa.LAUNCHES[name] for name in fa.LAUNCHES}

    # 9. the W4 serving lane at full width
    w, h, seed = 1024, 1024, SEED + 4
    bf16_img, row = edit(w, h, seed, False)
    emit({"phase": "w4_reference_edit_bf16", **row})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.quantize_("int4")
    torch.cuda.synchronize()
    emit({"phase": "w4_quantize", "seconds": time.perf_counter() - t0,
          "resident_gb": torch.cuda.memory_allocated() / 1e9, "kv_int8": pipe.kv_int8})
    reset_counts()
    w4_img, row = edit(w, h, seed, False)
    rel = float(np.linalg.norm(w4_img - bf16_img) / np.linalg.norm(bf16_img - 127.5))
    emit({"phase": "w4_edit_vs_bf16", **row, "rel_l2": rel, "limit": W4_REL_L2,
          "launches": counts()})
    if not rel <= W4_REL_L2:
        fail(f"the W4 edit is {rel:.4f} rel-L2 from the bf16 edit (limit {W4_REL_L2})")

    reset_counts()
    _, row = edit(w, h, seed, True)
    launches = counts()
    want = w4_launch_counts(pipe.timings, args.steps, n_blocks, n_layers,
                            pipe.vision.cfg.depth)
    emit({"phase": "w4_edit", **row, "kv_int8": pipe.kv_int8, "launches": launches,
          "launches_expected": want})
    if launches != want:
        fail(f"W4 launch counts {launches} differ from the expected {want}")
    w4_launches = launches

    from physicedit_torch.profile_edit import profile_decode

    decode, table = profile_decode(pipe, prompt_len=1536, tokens=20, profiled=5,
                                   generator=gen)
    emit({"phase": "w4_decode_profile", "kv_int8": pipe.kv_int8, **decode})
    print(table, file=sys.stderr, flush=True)

    kernels = []
    for name, src, replaces, ms_case in KERNEL_ROWS:
        launches = main_launches[name] if name in main_launches else w4_launches[name]
        timing = report[ms_case] if ms_case else report[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches, "max_abs_err": max(report[f"{name}_err"]),
                        "ms": timing["ms"], "plain_ms": timing["plain_ms"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

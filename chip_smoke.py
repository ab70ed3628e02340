#!/usr/bin/env python3
"""Drive the PyTorch port (``physicedit_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py [--steps 4]

Phases, each printed as one JSON line, any failure exits non-zero:
  1. the card (nvidia-smi name and power limit) and the TF32 settings;
  2. build the two CUDA kernels from ``physicedit_torch/csrc``;
  3. K1 (DiT fixed-max attention) against its plain version at the main
     path's shapes, before any weights are allocated;
  4. K2 (VL causal GQA attention) against its plain version;
  5. a small head_dim-128 pipeline on the card (kernels) against the same
     weights on the CPU (plain versions);
  6. the full-width pipeline (Qwen-Image-Edit-2509 widths, random bf16
     weights): three edits through ``PhysicEditPipeline.__call__`` with the
     reasoner on and CFG 4, with stage times, kernel launch counts and
     peak memory.
The line before the last lists each kernel with its launches on the main
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
SEED = 0             # of the random weights and inputs
# K1 clamp cases scale the RMS-normed q and k by this, so that a logit
# (exp2 units) has a spread of ~90 and many pass fa.CLAMP: the clamp binds
CLAMP_QK_SCALE = 8.0


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


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
    for name in ("fixedmax_attention", "gqa_causal_attention"):
        t0 = time.perf_counter()
        path = _build.build(name)
        _build.load(name)
        ptxas = [ln.strip() for ln in open(f"{path}.log") if "Used" in ln or "spill" in ln]
        emit({"phase": "build", "kernel": name, "seconds": time.perf_counter() - t0,
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

    # 5. small pipeline: kernels on the card against plain versions on the CPU
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
    pipe = random_pipeline(small, dev, torch.bfloat16, gen)
    kw = dict(edit_image=image(128, 128), height=128, width=128, seed=11,
              num_inference_steps=2, have_text_reasoning=False)
    fa.reset_launch_counts()
    got = np.asarray(pipe("tilt the cup", **kw), np.float32)
    launches = dict(fa.LAUNCHES)
    want = np.asarray(pipe.to("cpu")("tilt the cup", **kw), np.float32)
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want - want.mean()))
    emit({"phase": "small_pipeline_vs_cpu", "rel_l2": rel, "limit": PIPE_REL_L2,
          "max_abs_levels": float(np.abs(got - want).max()), "launches": launches})
    if not rel <= PIPE_REL_L2 or min(launches.values()) == 0:
        fail("the small pipeline on the card disagrees with the CPU run")
    del pipe

    # 6. the full-width slice
    t0 = time.perf_counter()
    pipe = build_random_pipeline("full", device=dev, generator=gen)
    torch.cuda.synchronize()
    emit({"phase": "full_init", "seconds": time.perf_counter() - t0,
          "resident_gb": torch.cuda.memory_allocated() / 1e9,
          "attn_clamp": pipe.attn_clamp})
    n_layers = pipe.text.cfg.num_layers
    n_blocks = pipe.dit.cfg.num_layers
    requests = [(1024, 1024, SEED + 1), (768, 512, SEED + 2),
                (1024, 1024, SEED + 3)]
    edit_images = {(w, h): image(w, h) for w, h, _ in requests}
    fa.reset_launch_counts()
    for w, h, seed in requests:
        before = dict(fa.LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = pipe("make the glass fall off the table and shatter",
                   negative_prompt="", edit_image=edit_images[(w, h)], cfg_scale=4.0,
                   height=h, width=w, seed=seed, num_inference_steps=args.steps,
                   have_text_reasoning=True)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
        arr = np.asarray(out, np.float32)
        tm = pipe.timings
        k1 = fa.LAUNCHES["fixedmax_attention"] - before["fixedmax_attention"]
        k2 = fa.LAUNCHES["gqa_causal_attention"] - before["gqa_causal_attention"]
        # one reasoner prefill row and one prompt-encode chunk (both CFG rows)
        k2_want = n_layers * (1 + 1)
        emit({"phase": "edit", "size": [w, h], "seed": seed, "steps": args.steps,
              "joint_tokens": tm["joint_tokens"], "total_ms": total,
              "vision_ms": tm["vision"], "reasoner_prefill_ms": tm["reasoner_prefill"],
              "decode_tokens": tm["decode_tokens"], "decode_ms": tm["reasoner_decode"],
              "decode_ms_per_token": tm["reasoner_decode"] / max(1, tm["decode_tokens"]),
              "prompt_encode_ms": tm["prompt_encode"], "denoise_ms": tm["denoise"],
              "denoise_ms_per_step": tm["denoise"] / args.steps,
              "vae_encode_ms": tm["vae_encode"], "vae_decode_ms": tm["vae_decode"],
              "k1_launches": k1, "k1_expected": args.steps * n_blocks,
              "k2_launches": k2, "k2_expected": k2_want,
              "image_std": float(arr.std()),
              "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9})
        if out.size != (w, h) or arr.shape != (h, w, 3):
            fail(f"edit image is {out.size}, wanted {(w, h)}")
        if not np.isfinite(arr).all() or arr.std() == 0.0:
            fail("edit image is not finite or is constant")
        if k1 != args.steps * n_blocks or k2 != k2_want:
            fail(f"launch counts K1 {k1} / K2 {k2} differ from the expected "
                 f"{args.steps * n_blocks} / {k2_want}")

    kernels = []
    for name, src, replaces in [
            ("fixedmax_attention", "physicedit_torch/csrc/fixedmax_attention.cu",
             "physicedit_tpu/kernels/flash_attention.py:176"),
            ("gqa_causal_attention", "physicedit_torch/csrc/gqa_causal_attention.cu",
             "physicedit_tpu/kernels/flash_attention.py:632")]:
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": fa.LAUNCHES[name],
                        "max_abs_err": max(report[f"{name}_err"]),
                        "ms": report[name]["ms"], "plain_ms": report[name]["plain_ms"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

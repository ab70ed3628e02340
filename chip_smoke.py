#!/usr/bin/env python3
"""Drive the PyTorch port (``physicedit_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py [--steps 4]

Phases, each printed as one JSON line, any failure exits non-zero:
  1. the card (nvidia-smi name and power limit) and the TF32 settings;
  2. build the kernel sources of ``physicedit_torch/csrc``, one nvcc each,
     all at once;
  3. K1 (DiT fixed-max attention) and K7 (the same with a 2-D entity bias)
     against their plain versions at the main path's shapes, before any
     weights are allocated; K1 also with a key-mask hole across its 128-key
     stages and at a ragged 8513, timed (CUDA events and a CUDA graph)
     beside its kernel alone, its clamp on and SDPA, with its ptxas report
     (no spills); K7 also with a key-mask hole across key 128 at a ragged
     8513 and with a bias and key mask that change every stage, timed (CUDA
     events and a CUDA graph) beside K1' scaled (its kernel without the
     bias) and SDPA, with ptxas's report of its kernel (no spills); then K10
     and K10b (online softmax, through the public attention API) and K1'
     against their plain versions at B = 2, N = 24, S = 8448, K10 also with
     unbounded logits against an fp32 SDPA, K10b with the EliGen bias, its
     slim view and a ragged S with a first-tile-blocked row beside fully
     blocked rows, each
     timed (K10 and K10b also from a CUDA graph, with their ptxas report:
     no spills) beside SDPA, and two more calls bit for bit;
  4. K2 (VL causal GQA attention) against its plain version, also at
     S = 1500 with left pads across query row 128, timed from a CUDA graph
     beside SDPA's graph;
  5. K3 (W4A8 matmul: a GEMV at M <= 16, a TMA + wgmma GEMM above)
     against its exact plain version at the W4 lane's shapes, with times
     (CUDA events and a CUDA graph), bounds and the GEMM's ptxas report (no
     spills), and at the DiT image-stream shapes beside an unpack to int8
     and torch._int_mm (the JAX package's route at M >= 8192),
     torch._int_mm alone on weights unpacked beforehand and T10's
     proto_w4_i32 (the same product on T12's loop);
  6. K4-K6 (fused activation quantize) against their plain versions;
  7. a small head_dim-128 pipeline on the card (kernels) against the same
     weights on the CPU (plain versions), in bf16 and then quantized int4,
     each with a plain edit and an EliGen edit (K7, with K3-K6 in int4);
  8. the full-width pipeline (Qwen-Image-Edit-2509 widths, random bf16
     weights): three edits through ``PhysicEditPipeline.__call__`` with the
     reasoner on and CFG 4 (the first decoding the full 1000 tokens, the
     others EDIT_DECODE_CUT), with stage times, kernel launch counts and
     peak memory; then two EliGen edits at 1024^2 (two entities, CFG 4,
     reasoner off; full CFG and ``cfg_truncate_step``) with exact K7 / K1 /
     K2 launch counts; then batched serving: ``edit_batch`` of two edits
     against the single edits, ``edit_batch_mixed`` over two sizes, and the
     reasoner's decode at N = 1 and N = 2 rows;
  9. the W4 serving lane at full width: ``quantize_("int4")`` in place, the
     serving phase's first single edit on the W4 pipeline (image rel-L2
     against bf16), then an edit with the reasoner on (EDIT_DECODE_CUT
     tokens) and the int8 KV cache, with exact K1-K6 launch counts and the
     decode profile;
 10. a small head_dim-128 training step on the card against the same
     weights and batch on the CPU (loss and gradients), in bf16 and with the
     frozen DiT packed int4, and a few steps at lr 1e-3 whose loss must drop;
 11. training at full width on a freshly built pipeline (DINOv2-B/14 too),
     one 480x832 synthetic video sample per step: the bf16 lane (LoRA r128
     over the bf16 DiT, bf16 Adam moments) and then the W4 lane (the DiT
     packed int4 in place, fp32 moments), three steps each, with exact K1,
     K8, K3 and K9 launch counts per step, finite gradients, every leaf
     moving by step two, memory, times and a profiled step;
 12. K8 (the attention backward) and K9 (the W4 input gradient) against
     their plain versions at the training shapes (K8 also at a ragged 8513
     with a key-mask hole across key 128; both three calls bit for bit,
     with ptxas's report of their kernels), with times (CUDA events and a
     CUDA graph), bounds, PyTorch's own attention backward beside K8 and a
     bf16 matmul on dequantized weights beside K9; K1's out and l there
     against its plain version; K3 against its exact plain version at the
     W4 training lane's forward shapes;
 13. the bf16 attention prototypes of tools/ (T1 v1-v4, T2, T3, T5, T7, T8;
     csrc/proto_fixedmax_attention.cu) at B = 2, N = 24, S = 8448, each
     instantiation (all on the Hopper mainloop) against its plain version
     with its loop, time (CUDA events and a CUDA graph), bound share,
     registers, spills and shared memory (a spill fails the run), three
     calls bit for bit, and the one SDPA call that computes the same
     function; T1 v1 and T7 also at a ragged 8513 with a key bias that
     changes every stage, T7 also with logits past its clamp, T5 and T8
     (both names each) at the edges of their key-bias prefix (a ragged 8513
     with a bias that changes every stage, bias_keys 200 and 0, a batch
     blocked on every key: NaN); rows with no live key (NaN from T7, 0 from
     T3) at a ragged S; then
     each ported tool's main() (physicedit_torch/tools/proto_*.py), their
     path;
 14. the int8, W4 and elementwise-rate probes of tools/ (T9, T10, T12,
     T11, T4 with its row quantize, T6; csrc/proto_int8_matmul.cu,
     proto_int8qk_attention.cu, proto_ew_scale.cu) at their tools' shapes,
     each against its plain version (integers exact, epilogues, the
     quantize's codes and scales and T6 bit for bit, T4 under K1's gates,
     also at S 1088) with its time, bound, registers and the one PyTorch
     call where there is one; T9's, T10's and T12's GEMMs (TMA + wgmma) also
     three calls bit for bit, from a CUDA graph, at ragged M (T10 and T12
     also at K = 384) and T9 under one tile, T10 and T12 beside K3 on the
     same operands; T11's GEMV (TMA + mma.sync, K split over a cluster) at its
     tool's three shapes, three calls bit for bit, beside K3's GEMV at m8 on
     the same rotated weights; T9-T12, T4 (the Hopper mainloop with an int8
     wgmma QK^T, timed with and without its quantize beside K1 on the same
     inputs) and the quantize with ptxas's report and shared memory (a
     spill fails the run); then each ported tool's main(), their path.
 15. the serving surface: (a) on the load phase's tree (7b), the sweep CLIs'
     serving path (``add_serving_args`` with --batch_size 2
     --cfg_truncate_step 30 and a --prompt_rewriter_cmd, ``build_pipeline``,
     ``make_prompt_preprocessor``), ``eval.sweep.BucketBatcher`` in uniform
     mode over two 1024^2 items and in mixed mode over 1024^2 and 768x512,
     reasoner on (decode cut to 100 tokens), 32 steps: every image bit for
     bit the direct ``edit_batch`` / ``edit_batch_mixed`` call's, the
     rewriter's prompts,
     exact K1 and K2 launches; (b) the W8A8 lane at full width
     (``quantize_("int8")`` of phase 8's weights built again, whose bf16
     edit must equal phase 8's bit for bit): the first single edit of
     phase 8's serving part within rel-L2 0.05 of its bf16 image, one
     ``torch._int_mm`` per quantized DiT linear a step, the linears of the
     DiT's first block, its outer layers and the text model's first layer
     bit for bit against the CPU on 256 rows each, then the edit with the
     reasoner on (decode capped at 50 tokens, one ``torch._int_mm`` per
     text linear a token), memory and times; then the edit with the DiT's
     outer layers in bf16 and with two activation-side faults (read), and
     a control that must exceed the limit (an int4 weight grid); (c) the
     prompt refiners at their published widths with random weights
     (BeautifulPrompt's BLOOM, QwenPrompt's Qwen2-1.5B in bf16 with K2 once
     per layer in its prefill, the Translator's Marian in fp32) against the
     same weights in fp32 on the CPU: logits (QwenPrompt's through its KV
     cache), 16 greedy tokens teacher-forced, each public call timed,
     BLOOM's sampling repeatable.
 16. training through its CLI: (a)-(f) ``physicedit_torch.cli.train.main``
     on the load phase's tree (7b) with a DINOv2-B/14 written beside it,
     over a PhysicTran-layout folder of 4 videos (49 frames, 480x832; a
     fifth dropped by the filter file; mp4 through imageio where the machine
     has it, else the stand-in reader of ``train/synthetic.py``, as the line
     says): the data-process mode (the first bundle bit for bit a direct
     ``Trainer.preprocess``), raw-video training with two loader threads,
     saves and evals every 2 steps (exact K1 / K8 launches a step, exact K1
     / K2 an eval; s/step, peak GB), resume from a mid-epoch checkpoint (the
     trainable equal to the file bit for bit, exactly the remaining items
     trained), training from the bundles (noise drawn anew), Adafactor with
     accumulation 2 (the trainable moving on even calls only; the optimizer
     state's bytes) and the W4 lane (exact K1 / K8 / K3 / K9 a step); and,
     after phase 10 on its small model, ``direct_distill_loss`` through a
     4-step unroll against the CPU (exact K1 / K8) and deviation D1's drift
     over 50 steps, bf16 against fp32 activations (read, not gated).
 17. the multi-GPU slice (``physicedit_torch/parallel``) on one card, after
     phase 8's serving part: (a) the ring's kernels lane over RING_RANKS
     virtual ranks through its own hop functions at the DiT's joint
     attention at 1024^2 with the reasoner on, the forward against one K1
     call (K1's gates), dq / dk / dv against one K8 call (K8_REL), K1 and K8
     n^2 launches each, timed beside them; (b) every split weight of phase
     8's DiT and VL text model cut for tp 2 and 4 and put back bit for bit,
     and one block's fc1 / fc2 from its tp-4 shards (fp32 partial sums)
     within SHARD_PAIR_REL of the unsharded pair; (c) a world-1 NCCL group:
     phase 8's pipeline through ``shard(create_mesh(1, 1))`` with
     ``attn_impl="ring"`` edits 1024^2 (4 steps, reasoner off) within
     PIPE_REL_L2 of the kernels route, K1 once per block and step, beside a
     slim-off control; (d) with two GPUs or more, an NCCL world of two
     (this script with ``--dist-worker``) runs the small model's ring, TP
     and DP edits and a DP training step against one card; with one GPU
     its line says it did not run.
The line before the last lists each kernel with its launches on its main
path, its error against the plain version, its time, the plain version's,
its bound and the one PyTorch call that computes the same function (K1 and
K8 also with their launches in phase 17(a)'s ring, ``ring_launches``); the
last line is the run's result.  There is no CPU path: without a CUDA device
it exits 2.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time

ATOL = RTOL = 2e-2   # bf16 kernel against its plain version (fp32 softmax)
# K1 and K7 also against these: the elementwise rule alone lets through an
# error of a third of a typical output (~1.5e-2 at the DiT's shapes).  About
# 4-8x the H100 readings (max |err| 4.9e-4-9.8e-4)
ATTN_MAX_ABS = 4e-3
ATTN_REL_L2 = 5e-3
PIPE_REL_L2 = 0.05   # small pipeline, bf16 on the card vs bf16 on the CPU
W4_REL_L2 = 0.05     # full-width W4 edit against the same edit in bf16
KERNEL_SOURCES = ("fixedmax_attention", "gqa_causal_attention", "w4a8_matmul", "fused_quant",
                  "fixedmax_attention_bwd", "w4_bwd_dx", "fixedmax_attention_bias",
                  "online_attention", "proto_fixedmax_attention", "proto_int8_matmul",
                  "proto_int8qk_attention", "proto_ew_scale")
# small training step, bf16 card vs bf16 CPU through 2 blocks, about 10x the
# readings on an H100 (loss 4.6e-5, all gradients 5.1e-5, worst leaf 2.8e-3)
TRAIN_LOSS_REL = 5e-4  # the loss
TRAIN_GRAD_REL = 5e-4  # all gradients together (rel-L2)
TRAIN_LEAF_REL = 2e-2  # and each gradient leaf on its own (rel-L2)
K8_REL = 2e-2          # K8 / K9 against their plain versions: max |err| / max |ref|
# T1 v3 / v4 (unnormalised, their outputs grow with S) against their plain
# versions: max |err| / max |ref|, one bf16 step of the largest output (2^-7)
PROTO_UNNORM_REL = 8e-3
K8_REL_L2 = 1e-2       # and rel-L2; where the clamp binds only rel-L2 applies: a logit
                       # within rounding of the clamp is clamped on one side only,
                       # which zeroes or keeps its whole dS entry
# The card's datasheet peaks (H100 SXM, dense): the bound of a kernel is the
# larger of its operations over the peak rate and its bytes over the memory rate
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_FP32 = 67e12       # outside the tensor cores
PEAK_BYTES = 3.35e12
SEED = 0             # of the random weights and inputs
# the reasoner's decode in phase 8's second and third edits and in phase 9's
# reasoner edit, cut for time (random weights never emit EOS); phase 8's
# first edit keeps the reference's 1000-token budget
EDIT_DECODE_CUT = 100
# K1 clamp cases scale the RMS-normed q and k by this, so that a logit
# (exp2 units) has a spread of ~90 and many pass fa.CLAMP: the clamp binds
CLAMP_QK_SCALE = 8.0


START = time.perf_counter()


def emit(obj: dict) -> None:
    """One JSON line, with the seconds since the script started."""
    print(json.dumps({**obj, "t": round(time.perf_counter() - START, 1)}), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


@functools.cache
def card_name() -> str:
    """The card's name and power limit as nvidia-smi gives them (asked once)."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


# name, source, the TPU kernel it replaces, the report entry of its times
KERNEL_ROWS = [
    ("fixedmax_attention", "physicedit_torch/csrc/fixedmax_attention.cu",
     "physicedit_tpu/kernels/flash_attention.py:176", None),
    ("gqa_causal_attention", "physicedit_torch/csrc/gqa_causal_attention.cu",
     "physicedit_tpu/kernels/flash_attention.py:632", None),
    # K3's two regimes: the GEMV (M <= 16; its row's times at the decode's
    # gate_up) and the tiled TMA + wgmma GEMM (at the DiT image stream's fc1)
    ("w4a8_matmul_gemv", "physicedit_torch/csrc/w4a8_matmul.cu",
     "physicedit_tpu/kernels/quant_matmul.py:143", "k3_decode_gate_up"),
    ("w4a8_matmul_tiled", "physicedit_torch/csrc/w4a8_matmul.cu",
     "physicedit_tpu/kernels/quant_matmul.py:143", "k3_dit_image_fc1"),
    ("ln_mod_quant", "physicedit_torch/csrc/fused_quant.cu",
     "physicedit_tpu/kernels/fused_quant.py:54", None),
    ("gelu_quant", "physicedit_torch/csrc/fused_quant.cu",
     "physicedit_tpu/kernels/fused_quant.py:67", None),
    ("transpose_quant", "physicedit_torch/csrc/fused_quant.cu",
     "physicedit_tpu/kernels/fused_quant.py:119", None),
    ("fixedmax_attention_bwd", "physicedit_torch/csrc/fixedmax_attention_bwd.cu",
     "physicedit_tpu/kernels/flash_attention.py:330", None),
    ("w4_bwd_dx", "physicedit_torch/csrc/w4_bwd_dx.cu",
     "physicedit_tpu/kernels/quant_matmul.py:227", None),
    ("fixedmax_attention_bias", "physicedit_torch/csrc/fixedmax_attention_bias.cu",
     "physicedit_tpu/kernels/flash_attention.py:111", None),
    ("online_attention", "physicedit_torch/csrc/online_attention.cu",
     "physicedit_tpu/kernels/flash_attention.py:464", None),
    ("online_attention_bias", "physicedit_torch/csrc/online_attention.cu",
     "physicedit_tpu/kernels/flash_attention.py:536", None),
    # K1': its row's times are the JAX package's default form (q scaled in the
    # kernel, the clamp on), K7's kernel; the prescaled form runs K1's
    ("fixedmax_bnsd", "physicedit_torch/csrc/fixedmax_attention_bias.cu",
     "physicedit_tpu/kernels/flash_attention.py:78", None),
    # the bf16 attention prototypes of tools/, one instantiation each
    *((name, "physicedit_torch/csrc/proto_fixedmax_attention.cu", replaces, None)
      for name, replaces in (
          ("proto_fixedmax", "tools/proto_fixedmax.py:49"),            # T7
          ("proto_fixedmax2", "tools/proto_fixedmax2.py:68"),          # T8, sub = 1
          ("proto_fixedmax2_overlap", "tools/proto_fixedmax2.py:68"),  # T8, sub > 1
          ("proto_nobias_inscale", "tools/proto_attn_fast.py:72"),     # T2, inscale
          ("proto_nobias", "tools/proto_attn_fast.py:72"),             # T2 = T1 v2
          ("proto_nmask", "tools/proto_attn_fast.py:130"),             # T3
          ("proto_bf16s", "tools/proto_attn_bf16s.py:69"),             # T1 v1
          ("proto_expnosum", "tools/proto_attn_bf16s.py:148"),         # T1 v3
          ("proto_noexp", "tools/proto_attn_bf16s.py:124"),            # T1 v4
          ("proto_interleave", "tools/proto_attn_interleave.py:103"),  # T5, sub = 1
          ("proto_interleave_overlap", "tools/proto_attn_interleave.py:103"))),
    # the int8, W4 and elementwise-rate probes of tools/, one instantiation each
    *((name, f"physicedit_torch/csrc/{src}.cu", replaces, None)
      for name, src, replaces in (
          ("proto_mm_i32", "proto_int8_matmul", "tools/proto_int8_rate.py:55"),         # T9
          ("proto_mm_f32", "proto_int8_matmul", "tools/proto_int8_rate.py:55"),         # T9
          ("proto_w4_i32", "proto_int8_matmul", "tools/proto_prefill_blocks.py:46"),    # T10
          ("proto_w4_and", "proto_int8_matmul", "tools/proto_w4_unpack.py:72"),         # T12
          ("proto_w4_gemv_and", "proto_int8_matmul", "tools/proto_w4_gemv.py:65"),     # T11
          ("proto_int8qk", "proto_int8qk_attention", "tools/proto_attn_int8qk.py:63"),  # T4
          # T4's row quantize of q and k: XLA ops in the JAX tool's wrapper
          ("proto_int8qk_quant", "proto_int8qk_attention", "tools/proto_attn_int8qk.py:63"),
          ("proto_ew_scale_bf16", "proto_ew_scale", "tools/proto_ew_rate.py:45"),       # T6
          ("proto_ew_scale_fp32", "proto_ew_scale", "tools/proto_ew_rate.py:45"))),     # T6
]
# the loop each kernel runs: the Hopper attention mainloop of
# csrc/hopper_attention.cuh, the other TMA + wgmma kernels on
# csrc/hopper_primitives.cuh, the row pipelines fed by 1-D bulk copies, or a
# loop without TMA (dp4a, a plain row or elementwise kernel), or T11's TMA-fed
# mma.sync GEMV
KERNEL_LOOPS = {
    **dict.fromkeys(("fixedmax_attention", "gqa_causal_attention", "fixedmax_attention_bias",
                     "online_attention", "online_attention_bias", "fixedmax_bnsd",
                     "proto_fixedmax", "proto_fixedmax2", "proto_fixedmax2_overlap",
                     "proto_nobias_inscale", "proto_nobias", "proto_nmask", "proto_bf16s",
                     "proto_expnosum", "proto_noexp", "proto_interleave",
                     "proto_interleave_overlap", "proto_int8qk"), "hopper_attention"),
    **dict.fromkeys(("w4a8_matmul_tiled", "fixedmax_attention_bwd", "w4_bwd_dx",
                     "proto_mm_i32", "proto_mm_f32", "proto_w4_i32", "proto_w4_and"),
                    "tma_wgmma"),
    **dict.fromkeys(("ln_mod_quant", "gelu_quant"), "bulk_copy_rows"),
    "transpose_quant": "row_block", "w4a8_matmul_gemv": "dp4a_gemv",
    "proto_int8qk_quant": "warp_rows", "proto_w4_gemv_and": "tma_mma_gemv",
    "proto_ew_scale_bf16": "elementwise",
    "proto_ew_scale_fp32": "elementwise",
}


def bound(ops: float, nbytes: float, peak: float) -> dict:
    """The least time the card could take: the larger of ops / peak and
    bytes / memory rate (each input read once, each output written once)."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def stage_varying_mask(b: int, s: int, device):
    """A [b, s] bool key mask that changes from one 128-key stage of the
    Hopper mainloop to the next: stage j of batch row r loses its 32-key
    word (j + r) % 4, and every third stage is whole, so the two stages that
    share a slot of the 2-stage ring never carry the same liveness word."""
    import torch

    i = torch.arange(s, device=device)
    j = i // 128
    return torch.stack([~((j % 3 != 2) & ((i % 128) // 32 == (j + r) % 4)) for r in range(b)])


def stage_varying_bias(b: int, sq: int, sk: int, device, gen):
    """An fp32 [b, sq, sk] entity-style bias in exp2 units that changes from
    one 128-key stage to the next: in stage j, query row r's 32-key word
    (j + r) % 4 is blocked (-1e30) unless j % 3 == 1; the other keys carry a
    small graded bias, and key 0 stays live."""
    import torch

    from physicedit_torch.kernels.flash_attention import LOG2E

    i = torch.arange(sk, device=device)
    j = i // 128
    r = torch.arange(sq, device=device)[:, None]
    blocked = ((i % 128) // 32 == (j + r) % 4) & (j % 3 != 1)
    bias = torch.where(blocked, -1e30, 0.5 * torch.randn(b, sq, sk, device=device, generator=gen))
    bias[:, :, 0] = 0.0
    return bias * LOG2E


@contextlib.contextmanager
def decode_cut(pipe, tokens: int):
    """``pipe``'s reasoner decodes ``tokens`` at most in the block."""
    real = pipe.reason_physical_batch
    pipe.reason_physical_batch = (lambda prompts, ims, max_new_tokens=1000, **kw:
                                  real(prompts, ims, tokens, **kw))
    try:
        yield
    finally:
        del pipe.reason_physical_batch


def rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def _counter_modules():
    from physicedit_torch.kernels import flash_attention, fused_quant, quant_matmul
    from physicedit_torch.tools import _proto_int8

    return flash_attention, quant_matmul, fused_quant, _proto_int8


def reset_counts() -> None:
    for module in _counter_modules():
        module.reset_launch_counts()


def counts() -> dict:
    """Every kernel's launches, and K3's by regime (``w4a8_matmul_gemv``,
    ``w4a8_matmul_tiled``)."""
    from physicedit_torch.kernels import quant_matmul as qm

    out = {name: n for module in _counter_modules() for name, n in module.LAUNCHES.items()}
    out.update({f"w4a8_matmul_{regime}": n for regime, n in qm.REGIME_LAUNCHES.items()})
    return out


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


def k3_check(report: dict, gen, time_ms, cases, phase: str = "k3") -> None:
    """K3 against its exact plain version at each (name, M, K, N, bias) of
    ``cases``: the int32 accumulators must be equal and the bf16 outputs
    within one ulp.  Timed with weights rotating over enough copies to
    exceed the 50 MB L2, as a decode finds them cold."""
    import torch

    from physicedit_torch.kernels import quant_matmul as qm
    from physicedit_torch.tools import _bench

    for name, m, k, n, bias in cases:
        xq, w4, xs, ws, b = k3_operands(gen, m, k, n, bias)
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
        regime = "gemv" if m <= qm.GEMV_MAX_ROWS else "tiled"
        row = {"phase": phase, "case": name, "shape": [m, k, n], "bias": bias,
               "regime": regime, "acc_equal": acc_equal,
               "max_bf16_ulps": ulps, "max_abs_err": (out.float() - ref.float()).abs().max().item(),
               "ms": ms, "graph_ms": _bench.graph_ms(run), "device_ms": dev_ms,
               "plain_ms": plain_ms, "weight_copies": len(copies)}
        row.update(bound(2 * m * n * k, n * k // 2 + m * k + 4 * m + 4 * n + 2 * m * n
                         + (2 * n if bias else 0), PEAK_INT8))
        row["bound_share"] = row["bound_ms"] / ms
        t = dev_ms or ms
        if m <= 16:
            row["gb_per_s_device"] = (n * k // 2 + m * k + 2 * m * n + 4 * n) / t / 1e6
        else:
            row["tops_device"] = 2 * m * n * k / t / 1e9
        report[f"{phase}_{name}"] = row
        report.setdefault(f"w4a8_matmul_{regime}_err", []).append(row["max_abs_err"])
        emit(row)
        if not acc_equal or ulps > 1.0:
            fail(f"K3 {name} disagrees with its plain version")
        del xq, w4, xs, ws, b, out, acc, ref, acc_ref, copies
    torch.cuda.empty_cache()


def k3_operands(gen, m, k, n, bias):
    """Random int8 activations, packed int4 weights ([N, K/2]), scales and bias."""
    import torch

    dev = gen.device
    xq = torch.randint(-127, 128, (m, k), device=dev, dtype=torch.int8, generator=gen)
    w4 = torch.randint(-128, 128, (n, k // 2), device=dev, dtype=torch.int8, generator=gen)
    xs = torch.rand(m, 1, device=dev, generator=gen) * 1e-2 + 1e-3
    ws = torch.rand(n, device=dev, generator=gen) * 1e-2 + 1e-3
    b = torch.randn(n, device=dev, generator=gen).bfloat16() if bias else None
    return xq, w4, xs, ws, b


# the W4 DiT's packed linears per stream: name, K, N
DIT_LINEARS = [("qkv", 3072, 9216), ("out", 3072, 3072), ("fc1", 3072, 12288),
               ("fc2", 12288, 3072)]


def k3_phase(report: dict, gen, time_ms) -> None:
    """K3 against its exact plain version at the W4 serving lane's shapes:
    decode (M = 1), DiT modulation (M = 2), DiT text stream (M = 512), VL
    prefill (M = 1536), the ViT (784 patches, 196 merged) and a ragged M
    (``k3_check``), with ptxas's report of the tiled regime (no spills).
    Then the DiT image-stream shapes (M = 16384): K3 exact against its plain
    version, timed (CUDA events and a CUDA graph) with its bound, beside what
    the PyTorch calls and T10 take there, each a measurement
    only: the route the JAX package takes at M >= 8192 (unpack to int8,
    torch._int_mm and the fp32 epilogue), torch._int_mm alone on weights
    unpacked beforehand, and T10's ``proto_w4_i32`` (the same product on
    T12's TMA + wgmma loop, one commit group a plane)."""
    import torch

    from physicedit_torch.kernels import quant_matmul as qm
    from physicedit_torch.tools import _bench, proto_prefill_blocks as t10

    ptxas = hopper_ptxas("w4a8_matmul", "w4a8_wgmma_kernel", ())
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
    k3_check(report, gen, time_ms, cases)

    # the DiT image stream at 1024^2: M = 2 x 8192
    def int_mm_route(xq, w4, xs, ws, b):
        acc = torch._int_mm(xq, qm._unpack_w4_int8(w4).T)
        return qm._epilogue(acc, xs, ws, b, torch.bfloat16), acc

    m = 16384
    for name, k, n in DIT_LINEARS:
        xq, w4, xs, ws, b = k3_operands(gen, m, k, n, True)
        out, acc = qm.w4a8_matmul(xq, w4, xs, ws, b, return_acc=True)
        ref, acc_ref = qm.w4a8_matmul_reference(xq, w4, xs, ws, b, return_acc=True)
        route, acc_route = int_mm_route(xq, w4, xs, ws, b)
        torch.cuda.synchronize()
        w8t = qm._unpack_w4_int8(w4).T
        wsb = torch.stack([ws, b.float()])

        def kernel():
            return qm.w4a8_matmul(xq, w4, xs, ws, b)

        row = {"phase": "k3_vs_int_mm", "case": f"dit_image_{name}", "shape": [m, k, n],
               "regime": "tiled", "acc_equal": bool(torch.equal(acc, acc_ref)),
               "max_bf16_ulps": bf16_ulps(out, ref),
               "max_abs_err": (out.float() - ref.float()).abs().max().item(),
               "route_acc_equal": bool(torch.equal(acc, acc_route)),
               "max_bf16_ulps_vs_route": bf16_ulps(out, route),
               "ms": time_ms(kernel, 10), "graph_ms": _bench.graph_ms(kernel),
               "device_ms": device_ms(kernel, 10, "w4a8_"),
               "plain_ms": time_ms(lambda: qm.w4a8_matmul_reference(xq, w4, xs, ws, b), 2),
               "library_ms": None,
               "int_mm_route_ms": time_ms(lambda: int_mm_route(xq, w4, xs, ws, b), 10),
               "int_mm_preunpacked_ms": time_ms(lambda: torch._int_mm(xq, w8t), 10),
               "t10_ms": time_ms(
                   lambda: t10.i32_matmul(xq, w4, xs, wsb, torch.bfloat16), 10)}
        row.update(bound(2 * m * n * k, n * k // 2 + m * k + 4 * m + 4 * n + 2 * m * n + 2 * n,
                         PEAK_INT8))
        row["bound_share"] = row["bound_ms"] / row["ms"]
        for key in ("ms", "int_mm_route_ms", "int_mm_preunpacked_ms", "t10_ms"):
            row[key.replace("ms", "tops")] = 2 * m * n * k / row[key] / 1e9
        if name == "fc1":
            row["ptxas"] = ptxas
        report[f"k3_dit_image_{name}"] = row
        report.setdefault("w4a8_matmul_tiled_err", []).append(row["max_abs_err"])
        emit(row)
        if (not row["acc_equal"] or row["max_bf16_ulps"] > 1.0 or not row["route_acc_equal"]
                or row["max_bf16_ulps_vs_route"] > 1.0):
            fail(f"K3 disagrees with its plain version or the _int_mm route at the DiT "
                 f"image-stream {name}")
        del xq, w4, xs, ws, b, out, acc, ref, acc_ref, route, acc_route, w8t, wsb
    torch.cuda.empty_cache()


def fused_quant_ptxas(name: str, shape: tuple) -> dict:
    """Registers and spills (nvcc's report) of the K4 / K5 / K6 instantiation
    that takes ``shape``; for K4 and K5 also their row pipeline's launch
    (ring stages, dynamic shared memory, blocks per SM, grid).  Fails on a
    spill."""
    from physicedit_torch.kernels import _build
    from physicedit_torch.kernels import fused_quant as fq

    if name == "transpose_quant":
        k, rows = shape[1] * shape[3], shape[0] * shape[2]
        need = -(-k // 1024)  # 4-element vectors of 256 threads (dispatch_nv4)
        nv = next(v for v in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32) if v >= need)
        out, args = {"nv": nv, "threads": 256, "dynamic_smem_bytes": 0, "grid": rows}, (nv,)
    else:
        out = fq.row_pipeline_launch(name, shape[0] * shape[1], shape[2])
        args = (out["warps_per_row"], out["nv"])
    regs = ptxas_report(f"{_build.library_path('fused_quant')}.log", f"{name}_kernel")
    out.update(regs.get(args, {}))
    if "registers" not in out or out.get("spill_store_bytes", 0) or out.get("spill_load_bytes", 0):
        fail(f"{name}_kernel: ptxas reports spills or no entry: {out}")
    return out


def fused_quant_phase(report: dict, gen, time_ms) -> None:
    """K4, K5 and K6 against their plain versions at the 1024^2 DiT shapes
    (the image stream and, at joint 9472, the text stream) and at a ragged S
    (1001, which the kernels take though the JAX tiling predicate would send
    it to the unfused path): int8 codes identical and scales equal.  Each
    case is timed (CUDA events and a CUDA graph, the inputs rotated past the
    L2) with its bound, GB/s, registers and, for K4 and K5, the row
    pipeline's launch; the main shape of each also times the plain version."""
    import torch

    from physicedit_torch.kernels import fused_quant as fq
    from physicedit_torch.tools import _bench
    from physicedit_torch.tools._proto_int8 import l2_copies, rotated

    dev = torch.device("cuda")

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).bfloat16()

    cases = [  # kernel, case, shape; the first case of each kernel is its main shape
        ("ln_mod_quant", "image_2x8192x3072", (2, 8192, 3072)),
        ("ln_mod_quant", "text_2x1280x3072", (2, 1280, 3072)),
        ("ln_mod_quant", "ragged_2x1001x3072", (2, 1001, 3072)),
        ("gelu_quant", "image_2x8192x12288", (2, 8192, 12288)),
        ("gelu_quant", "text_2x1280x12288", (2, 1280, 12288)),
        ("gelu_quant", "ragged_2x1001x12288", (2, 1001, 12288)),
        ("transpose_quant", "joint_2x24x8448x128", (2, 24, 8448, 128)),
        ("transpose_quant", "joint_2x24x9472x128", (2, 24, 9472, 128)),
        ("transpose_quant", "ragged_2x24x1001x128", (2, 24, 1001, 128))]
    for name, case, shape in cases:
        x = randn(*shape, scale=3.0)
        if name == "ln_mod_quant":
            sh, sc = randn(shape[0], shape[2], scale=0.5), randn(shape[0], shape[2], scale=0.5)
            run = lambda t: fq._ln_mod_quant(t, sh, sc, 1e-6)  # noqa: E731
            plain = lambda: fq.ln_mod_quant_reference(x, sh, sc, 1e-6)  # noqa: E731
        elif name == "gelu_quant":
            run, plain = fq._gelu_quant, (lambda: fq.gelu_quant_reference(x))
        else:
            run, plain = fq._transpose_quant, (lambda: fq.transpose_quant_reference(x))
        (q, s), (q_ref, s_ref) = run(x), plain()
        torch.cuda.synchronize()
        mismatched = int((q != q_ref).sum().item())
        max_code_diff = (q.int() - q_ref.int()).abs().max().item()
        scales_equal = bool(torch.equal(s, s_ref))
        row = {"phase": "fused_quant", "kernel": name, "case": case, "shape": list(shape),
               "codes_mismatched": mismatched, "max_code_diff": max_code_diff,
               "scales_equal": scales_equal,
               "max_scale_rel_diff": ((s - s_ref).abs() / s_ref).max().item()}
        del q_ref, s_ref
        copies = l2_copies(x, 100 << 20)
        timed = rotated(run, copies)
        row["ms"] = time_ms(timed, 20)
        row["graph_ms"] = _bench.graph_ms(timed)
        row["device_ms"] = device_ms(timed, 20, f"{name}_kernel")
        row["input_copies"] = len(copies)
        main = name not in report
        if main:
            row["plain_ms"] = time_ms(plain, 3)
            row["library_ms"] = None
        nbytes = x.numel() * 2 + q.numel() + s.numel() * 4
        if name == "ln_mod_quant":
            nbytes += (sh.numel() + sc.numel()) * 2
        row["gb_per_s_device"] = nbytes / (row["device_ms"] or row["graph_ms"]) / 1e6
        row.update(bound(8 * x.numel(), nbytes, PEAK_FP32))
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["bound_share_graph"] = row["bound_ms"] / row["graph_ms"]
        row["ptxas"] = fused_quant_ptxas(name, shape)
        if main:
            report[name] = row
        report.setdefault(f"{name}_err", []).append(max_code_diff)
        emit(row)
        if mismatched or not scales_equal:
            fail(f"{name} {case} disagrees with its plain version")
        del x, q, s, copies, timed
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


def w8a8_int_mm_per_step(dit) -> int:
    """The torch._int_mm calls of one W8A8 DiT forward, one denoise step (the
    CFG rows run as one batch): one per quantized linear, less those of the
    slim last block's text stream (to_add_out, txt_mlp fc1 and fc2), which
    it skips."""
    from physicedit_torch.ops.quant import Int8Linear

    last = dit.blocks[-1]
    skipped = (last.attn["to_add_out"], last.txt_mlp["fc1"], last.txt_mlp["fc2"])
    return (sum(isinstance(m, Int8Linear) for m in dit.modules())
            - sum(isinstance(m, Int8Linear) for m in skipped))


def w4_regime_counts(tm: dict, steps: int, n_blocks: int, n_layers: int,
                     vit_depth: int) -> dict:
    """K3's launches of ``w4_launch_counts`` by regime.  The GEMV (M <= 16)
    takes the DiT's two modulations per block and CFG step (M = 2), the
    prefill's lm_head (its last row) and, per decode token, the text
    model's four linears per layer and the lm_head (M = 1); the tiled GEMM
    the rest: the DiT's streams, the prefill and prompt encode, the ViT."""
    gemv = steps * 2 * n_blocks + 1 + tm["decode_tokens"] * (4 * n_layers + 1)
    total = w4_launch_counts(tm, steps, n_blocks, n_layers, vit_depth)["w4a8_matmul"]
    return {"w4a8_matmul_gemv": gemv, "w4a8_matmul_tiled": total - gemv}


def k8_phase(report: dict, gen, time_ms, joint: int) -> None:
    """K8 against its plain version at B = 1, N = 24, on q', l and out from
    K1: at the training slice's joint length and at 8448, text keys masked,
    and a case whose logits pass the clamp.  K1's out and l there (the
    prescaled entry the training step calls, ``return_l``) are first held
    against K1's plain version, as in phase 3; and a ragged 8513 with a
    key-mask hole across key 128.  Every case calls K8 twice more and must
    get the same bits (no atomics).  The slice's case is timed (CUDA events
    and a CUDA graph) beside the plain version and beside PyTorch's own
    attention backward (``scaled_dot_product_attention`` with the same
    boolean key mask), with the ptxas report of both passes (no spills)."""
    import torch
    import torch.nn.functional as F

    from physicedit_torch.kernels import flash_attention as fa
    from physicedit_torch.tools import _bench

    dev = gen.device
    ptxas = {kernel: hopper_ptxas("fixedmax_attention_bwd", kernel, ("clamp",))
             for kernel in ("fm_bwd_dq_kernel", "fm_bwd_dkv_kernel")}

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def rms(x):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True))

    cases = [(f"joint_{joint}", joint, 1.0, (100, 256)), ("joint_8448", 8448, 1.0, (100, 256)),
             (f"joint_{joint}_clamp", joint, CLAMP_QK_SCALE, (100, 256)),
             ("hole_across_key_128_8513", 8513, 1.0, (100, 160))]
    for name, s, scale, (m0, m1) in cases:
        q = fa._prescale((rms(randn(1, 24, s, 128)) * scale).bfloat16()).contiguous()
        k = (rms(randn(1, 24, s, 128)) * scale).bfloat16()
        v = randn(1, 24, s, 128).bfloat16()
        go = randn(1, 24, s, 128).bfloat16()
        mask = torch.ones(1, s, dtype=torch.bool, device=dev)
        mask[0, m0:m1] = False                   # padded text keys, or a hole
        clamped = (q[0, 0].float() @ k[0, 0].float().T > fa.CLAMP).float().mean().item()
        if scale != 1.0 and clamped == 0.0:
            fail(f"K8 {name}: no logit reaches the clamp")
        out, l = fa._fixedmax_prescaled(q, k, v, mask, True, return_l=True)
        out_ref, l_ref = fa._fixedmax_prescaled_reference(q, k, v, mask, True)
        k1_err = (out.float() - out_ref.float()).abs()
        k1_bad = int((k1_err > ATOL + RTOL * out_ref.float().abs()).sum().item())
        k1 = {"phase": "k1_training", "case": name, "shape": [1, 24, s, s],
              "max_abs_err": k1_err.max().item(), "rel_l2": rel_l2(out, out_ref),
              "n_out_of_tol": k1_bad,
              "l_max_rel_err": ((l - l_ref).abs() / l_ref).max().item(), "atol": ATOL,
              "rtol": RTOL, "max_abs_limit": ATTN_MAX_ABS, "rel_l2_limit": ATTN_REL_L2}
        emit(k1)
        report["fixedmax_attention_err"].append(k1["max_abs_err"])
        if (k1_bad or k1["l_max_rel_err"] > 1e-3 or k1["max_abs_err"] > ATTN_MAX_ABS
                or k1["rel_l2"] > ATTN_REL_L2):
            fail(f"K1 {name} (prescaled, return_l) disagrees with its plain version")
        del out_ref, l_ref, k1_err
        got = fa.fixedmax_attention_bwd(q, k, v, mask, go, out, l, True)
        want = fa.fixedmax_attention_bwd_reference(q, k, v, mask, go, out, l, True)
        torch.cuda.synchronize()
        row = {"phase": "k8", "case": name, "shape": [1, 24, s, s], "clamped_logit_share":
               clamped, "finite": all(bool(torch.isfinite(x).all()) for x in got),
               "repeat_bits_equal": all(
                   all(torch.equal(x, y) for x, y in zip(
                       fa.fixedmax_attention_bwd(q, k, v, mask, go, out, l, True), got))
                   for _ in range(2))}
        errs = []
        for gname, x, y in zip(("dq", "dk", "dv"), got, want):
            err = (x.float() - y.float()).abs().max().item()
            rel = err / max(y.float().abs().max().item(), 1e-30)
            row[f"{gname}_max_abs_err"], row[f"{gname}_rel_max_err"] = err, rel
            row[f"{gname}_rel_l2"] = rel_l2(x, y)
            errs.append(err)
        ok = (row["finite"] and row["repeat_bits_equal"]
              and all(row[f"{g}_rel_l2"] <= K8_REL_L2 for g in ("dq", "dk", "dv")))
        if scale == 1.0:
            ok = ok and all(row[f"{g}_rel_max_err"] <= K8_REL for g in ("dq", "dk", "dv"))
            report.setdefault("fixedmax_attention_bwd_err", []).extend(errs)
        if name == f"joint_{joint}":
            row["ms"] = time_ms(lambda: fa.fixedmax_attention_bwd(q, k, v, mask, go, out, l),
                                10)
            row["graph_ms"] = _bench.graph_ms(
                lambda: fa.fixedmax_attention_bwd(q, k, v, mask, go, out, l))
            row["plain_ms"] = time_ms(
                lambda: fa.fixedmax_attention_bwd_reference(q, k, v, mask, go, out, l), 2)
            ql, kl, vl = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
            lib_out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask[:, None, None, :])
            row["library_ms"] = time_ms(
                lambda: torch.autograd.grad(lib_out, (ql, kl, vl), go, retain_graph=True), 10)
            row["tflops"] = 10 * 24 * s * s * 128 / row["ms"] / 1e9
            row.update(bound(10 * 24 * s * s * 128,
                             2 * (q.numel() + k.numel() + v.numel() + go.numel() + out.numel()
                                  + 3 * q.numel()) + 4 * l.numel() + s, PEAK_BF16))
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["ptxas"] = ptxas
            report["fixedmax_attention_bwd"] = dict(row)
            del ql, kl, vl, lib_out
        emit(row)
        if not ok:
            fail(f"K8 {name} disagrees with its plain version")
        del q, k, v, go, out, l, got, want
        torch.cuda.empty_cache()


def k9_phase(report: dict, gen, time_ms, m_image: int, m_text: int) -> None:
    """K9 against its plain version at the W4 DiT's backward shapes: the
    image stream (M = base + edit image tokens) and the text stream (M = the
    bucketed text length) through qkv, out, fc1 and fc2, and the modulation
    3072 -> 18432 at M = 1; every case three calls bit for bit, timed (CUDA
    events and a CUDA graph) with its bound and, as context, one bf16
    torch.matmul of the same shape on weights dequantized beforehand (not
    the same function: no unpack, no rounding of g * w_scale); with ptxas's
    report of the kernel (no spills)."""
    import torch

    from physicedit_torch.kernels import quant_matmul as qm
    from physicedit_torch.tools import _bench

    dev = gen.device
    ptxas = hopper_ptxas("w4_bwd_dx", "w4_bwd_dx_wgmma_kernel", ())
    cases = ([(f"image_{n}", m_image, k, o) for n, k, o in DIT_LINEARS]
             + [(f"text_{n}", m_text, k, o) for n, k, o in DIT_LINEARS]
             + [("mod", 1, 3072, 18432)])
    for name, m, k, n in cases:
        go = torch.randn(m, n, device=dev, generator=gen).bfloat16()
        w4 = torch.randint(-128, 128, (n, k // 2), device=dev, dtype=torch.int8, generator=gen)
        ws = torch.rand(n, device=dev, generator=gen) * 1e-2 + 1e-3
        got = qm.w4_bwd_dx(go, w4, ws)
        want = qm.w4_bwd_dx_reference(go, w4, ws)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        w_deq = qm._dequant_w4(w4, ws).bfloat16()

        def kernel():
            return qm.w4_bwd_dx(go, w4, ws)

        row = {"phase": "k9", "case": name, "shape": [m, n, k], "max_abs_err": err,
               "rel_max_err": err / max(want.float().abs().max().item(), 1e-30),
               "rel_l2": rel_l2(got, want),
               "repeat_bits_equal": all(torch.equal(kernel(), got) for _ in range(2)),
               "ms": time_ms(kernel, 20), "graph_ms": _bench.graph_ms(kernel),
               "plain_ms": time_ms(lambda: qm.w4_bwd_dx_reference(go, w4, ws), 3),
               "library_ms": None,
               "matmul_predequantized_ms": time_ms(lambda: go @ w_deq, 20)}
        row.update(bound(2 * m * n * k, 2 * m * n + n * k // 2 + 4 * n + 2 * m * k, PEAK_BF16))
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["tflops"] = 2 * m * n * k / row["ms"] / 1e9
        if name == "image_fc1":
            row["ptxas"] = ptxas
            report["w4_bwd_dx"] = dict(row)
        report.setdefault("w4_bwd_dx_err", []).append(err)
        emit(row)
        if (not bool(torch.isfinite(got).all()) or row["rel_max_err"] > K8_REL
                or not row["repeat_bits_equal"]):
            fail(f"K9 {name} disagrees with its plain version or with itself")
        del go, w4, ws, got, want, w_deq
    torch.cuda.empty_cache()


def _loss_and_grads(trainable, dit, batch, t_min, t_max):
    from physicedit_torch.train.loss import physic_training_loss

    for p in trainable.parameters():
        p.grad = None
    loss, _ = physic_training_loss(trainable, dit, batch, t_min, t_max, use_remat=True)
    loss.backward()
    return loss.item(), {n: p.grad.detach().float().cpu().clone()
                         for n, p in trainable.named_parameters()}


def small_training_phase(small, gen, dev) -> None:
    """The training step of a small head_dim-128 model on the card (K1, K8,
    and K3 and K9 when packed) against the same weights and batch on the
    CPU (plain versions), in bf16 and with the DiT packed int4: the loss
    within TRAIN_LOSS_REL, all gradients together within TRAIN_GRAD_REL and
    each leaf within TRAIN_LEAF_REL (rel-L2).  Compared after one step, so that LoRA's B is no longer 0 and
    every factor has a gradient.  Then five more steps at lr 1e-3 on the
    batch: the loss must drop."""
    import copy
    import dataclasses

    import torch

    from physicedit_torch.models.dinov2 import DinoV2Config
    from physicedit_torch.pipeline.testing import random_pipeline
    from physicedit_torch.profile_train import SyntheticVideo
    from physicedit_torch.train.trainer import TrainConfig, Trainer

    dims = dataclasses.replace(small, dinov2=DinoV2Config(hidden_size=64, num_layers=1,
                                                          num_heads=2), dino_pos_grid=20)
    data = SyntheticVideo(n=1, width=128, height=128, frames=2, seed=SEED + 7)
    for quantize in ("none", "w4"):
        pipe = random_pipeline(dims, dev, torch.bfloat16, gen)
        trainer = Trainer(pipe, data, TrainConfig(learning_rate=1e-3, lora_rank=8,
                                                  txt_len_bucket=64, quantize_frozen=quantize),
                          device=dev)
        batch = trainer.preprocess(data[0])
        first = trainer.step(batch)["loss"]
        reset_counts()
        loss_c, grads_c = _loss_and_grads(trainer.trainable, pipe.dit, batch, trainer.t_min,
                                          trainer.t_max)
        launches = counts()
        loss_h, grads_h = _loss_and_grads(copy.deepcopy(trainer.trainable).cpu(),
                                          copy.deepcopy(pipe.dit).cpu(),
                                          {k: v.cpu() for k, v in batch.items()},
                                          trainer.t_min, trainer.t_max)
        flat_c = torch.cat([g.reshape(-1) for g in grads_c.values()])
        flat_h = torch.cat([g.reshape(-1) for g in grads_h.values()])
        per_leaf = {n: rel_l2(grads_c[n], grads_h[n]) for n in grads_c}
        worst = max(per_leaf, key=per_leaf.get)
        losses = [first, loss_c] + [trainer.step(batch)["loss"] for _ in range(5)]
        row = {"phase": "small_train_vs_cpu", "quantize_frozen": quantize,
               "loss_card": loss_c, "loss_cpu": loss_h,
               "loss_rel": abs(loss_c - loss_h) / abs(loss_h), "loss_limit": TRAIN_LOSS_REL,
               "grads_rel_l2": rel_l2(flat_c, flat_h), "grads_limit": TRAIN_GRAD_REL,
               "worst_leaf": worst, "worst_leaf_rel_l2": per_leaf[worst],
               "leaf_limit": TRAIN_LEAF_REL,
               "launches": launches, "losses_lr_1e-3": losses}
        emit(row)
        used = ["fixedmax_attention", "fixedmax_attention_bwd"] + (
            ["w4a8_matmul", "w4_bwd_dx"] if quantize == "w4" else [])
        if not (row["loss_rel"] <= TRAIN_LOSS_REL and row["grads_rel_l2"] <= TRAIN_GRAD_REL
                and per_leaf[worst] <= TRAIN_LEAF_REL):
            fail(f"the small training step ({quantize}) on the card disagrees with the CPU")
        if min(launches[k] for k in used) == 0:
            fail(f"the small training step ({quantize}) skipped a kernel: {launches}")
        if not losses[-1] < losses[0]:
            fail(f"the small training loss ({quantize}) did not drop: {losses}")
        del pipe, trainer
    torch.cuda.empty_cache()


def train_lane(pipe, data, cfg, dev, n_blocks: int) -> dict:
    """One full-width training lane: a Trainer over ``pipe``, one preprocessed
    sample per step, three steps, each with exact launch counts, finite
    gradients and (from step two) every leaf moving; then a profiled step.
    Returns the lane's summary."""
    import gc

    import torch

    from physicedit_torch.profile_train import profile_train_step
    from physicedit_torch.train.trainer import ZERO_GRAD_PARAMS, Trainer

    quantized = cfg.quantize_frozen == "w4"
    lane = "w4" if quantized else "bf16"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(pipe, data, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()     # from here: the steps' peak
    sizes = trainer.trainable_counts()
    batches, pre_ms = [], []
    for i in range(len(data)):
        t0 = time.perf_counter()
        batches.append(trainer.preprocess(data[i]))
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t0) * 1e3)
    joint = int(batches[0]["prompt_emb"].shape[1] + 2 * batches[0]["edit_tokens"].shape[1])
    emit({"phase": f"train_{lane}_init", "init_s": init_s, "init_peak_gb": init_peak_gb,
          "trainable_params": sizes,
          "trainable_total": sum(sizes.values()), "preprocess_ms": pre_ms,
          "joint_tokens": joint, "text_tokens": int(batches[0]["prompt_emb"].shape[1]),
          "image_tokens": int(batches[0]["edit_tokens"].shape[1]),
          "resident_gb": torch.cuda.memory_allocated() / 1e9,
          "optimizer_state_dtype": cfg.optimizer_state_dtype,
          "quantize_frozen": cfg.quantize_frozen})
    want = {**train_launch_counts(n_blocks, quantized), **train_regime_counts(n_blocks, quantized)}
    steps = []
    for i, batch in enumerate(batches):
        before = counts()
        m = trainer.step(batch)
        after = counts()
        launched = {k: after[k] - before[k] for k in want}
        grads = {n: p.grad for n, p in trainer.trainable.named_parameters()}
        finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
        still = [n for n, g in grads.items()
                 if (g.abs().max().item() > 0) == (n in ZERO_GRAD_PARAMS)]
        row = {"phase": f"train_{lane}_step", "step": i + 1, "loss": m["loss"],
               "mse": m["mse"], "special_token_loss": m["special_token_loss"],
               "seconds": m["seconds"], "launches": launched, "launches_expected": want,
               "grads_finite": finite, "leaves_not_moving": still,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        emit(row)
        steps.append(row)
        if launched != want:
            fail(f"{lane} training step {i + 1}: launches {launched} differ from {want}")
        if not (finite and math.isfinite(m["loss"]) and math.isfinite(m["mse"])):
            fail(f"{lane} training step {i + 1}: a loss or gradient is not finite")
        if i >= 1 and still:
            fail(f"{lane} training step {i + 1}: leaves with no gradient: {still[:5]}")
    summary, table = profile_train_step(trainer, batches[-1])
    emit({"phase": f"train_{lane}_profile", **summary})
    print(table, file=sys.stderr, flush=True)
    out = {"lane": lane, "joint_tokens": joint,
           "text_tokens": int(batches[0]["prompt_emb"].shape[1]),
           "image_tokens": int(batches[0]["edit_tokens"].shape[1]),
           "s_per_step": [r["seconds"] for r in steps], "preprocess_ms": pre_ms,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "init_peak_gb": init_peak_gb,
           "resident_gb_after": torch.cuda.memory_allocated() / 1e9,
           "losses": [r["loss"] for r in steps], "profile": summary}
    emit({"phase": f"train_{lane}", **out})
    del trainer, batches, grads
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_launch_counts(n_blocks: int, quantized: bool) -> dict:
    """The launches of K1, K8, K3 and K9 that one training step's structure
    implies (LoRA on, remat on, batch 1).  Each block runs its forward twice
    (once in the forward pass, once recomputed in the backward): K1 twice,
    and in the W4 lane K3 for its ten packed linears (both modulations, both
    QKV, both output projections, both fc1 and both fc2) twice.  Its backward
    runs K8 once and, in the W4 lane, K9 for the eight packed linears whose
    input carries a gradient (the modulations' input, the timestep
    embedding, does not), but for three in the last block: its text-stream
    output is unused, so to_add_out, fc1 and fc2 of that stream get no
    gradient."""
    return {"fixedmax_attention": 2 * n_blocks, "fixedmax_attention_bwd": n_blocks,
            "w4a8_matmul": 20 * n_blocks if quantized else 0,
            "w4_bwd_dx": 8 * n_blocks - 3 if quantized else 0}


def train_regime_counts(n_blocks: int, quantized: bool) -> dict:
    """K3's launches of ``train_launch_counts`` by regime: the two
    modulations per block at M = 1 (batch 1) on the GEMV, twice under
    remat; the streams' eight linears on the tiled GEMM."""
    return {"w4a8_matmul_gemv": 4 * n_blocks if quantized else 0,
            "w4a8_matmul_tiled": 16 * n_blocks if quantized else 0}


def entity_masks(w: int, h: int) -> list:
    """Two entity masks of an EliGen request: a left block and the
    bottom-right quadrant."""
    import numpy as np
    from PIL import Image

    a = np.zeros((h, w), np.uint8)
    a[h // 8:h // 2, w // 16:w // 2] = 255
    b = np.zeros((h, w), np.uint8)
    b[h // 2:, w // 2:] = 255
    return [Image.fromarray(a), Image.fromarray(b)]


# long enough that the text-to-image drop of 34 template tokens leaves words
ENTITY_PROMPTS = [
    "a tall glass of water standing on the left edge of the wooden kitchen table "
    "in soft morning light",
    "a ceramic plate with a slice of lemon cake resting in the lower right corner "
    "of the same table",
]


def k7_ptxas() -> dict:
    """ptxas's report of K7's kernel: K7 (bias=1) and K1' scaled (bias=0)."""
    return hopper_ptxas("fixedmax_attention_bias", "fixedmax_bias_kernel", ("bias", "clamp"),
                        lambda args: "fixedmax_attention_bias_smem_bytes" if args[0]
                        else "fixedmax_attention_scaled_smem_bytes")


def k7_phase(report: dict, gen, time_ms, compare) -> None:
    """K7 against its plain version: (a) the full-width EliGen call, B = 2,
    N = 24, joint 256 + 2 x 4096, with the bias build_entity_bias makes for
    two entities (on both CFG rows) and a text key mask; (b) the slim last
    block, its 4096 base-image query rows reading their bias rows as a
    strided view; (c) a ragged S with a query row whose keys are all blocked
    (exactly 0); (d) q and k x CLAMP_QK_SCALE, where the clamp binds; (e) a
    key-mask hole across key 128 at a ragged 8513; (f) a bias and a key mask
    that change every 128-key stage.  Case (a) is timed (CUDA events and a
    CUDA graph) beside K1' scaled on the same q, k, v and mask (the same
    kernel without the bias: the difference is the bias's cost), the plain
    version and PyTorch's attention with the bias as a float mask broadcast
    over the heads, with the ptxas report (no spills)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from physicedit_torch.kernels import flash_attention as fa
    from physicedit_torch.pipeline.eligen import build_entity_bias, downsample_entity_mask
    from physicedit_torch.tools import _bench

    dev = gen.device

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def rms(x):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True))

    s_t, base = 256, 4096
    masks = [downsample_entity_mask(m, 128, 128) for m in entity_masks(1024, 1024)]
    t0 = time.perf_counter()
    rows = [build_entity_bias(masks, lens, 2 * base, base)
            for lens in ([40, 56, 160], [64, 64, 128])]
    bias_nat = torch.from_numpy(np.stack(rows)).to(dev)
    host_ms = (time.perf_counter() - t0) * 1e3
    bias = fa.bias_log2(bias_nat)
    s = s_t + 2 * base
    cases = [  # name, B, S_q, S_k, q/k scale, bias (exp2 units), text keys masked in row 1
        ("eligen_joint_8448", 2, s, s, 1.0, bias, (220, 256)),
        ("slim_4096x8448_view", 2, base, s, 1.0, bias[:, s_t:s_t + base], (220, 256)),
        ("ragged_2303_blocked_row", 1, 2303, 2303, 1.0, None, (2000, 2303)),
        ("clamp_2303", 1, 2303, 2303, CLAMP_QK_SCALE, None, (2000, 2303)),
        ("hole_across_key_128_8513", 2, 8513, 8513, 1.0, None, (100, 160)),
        ("stage_varying_mask_and_bias_8448", 2, s, s, 1.0, "per_stage", "per_stage"),
    ]
    ptxas = k7_ptxas()
    for name, b, sq, sk, scale, bias_c, dead in cases:
        if bias_c is None:          # a random entity-style bias of this shape
            bias_c = fa.bias_log2(torch.where(torch.rand(b, sq, sk, device=dev, generator=gen)
                                              < 0.3, -1e30, 0.0))
            bias_c[:, :, 0] = 0.0
        elif isinstance(bias_c, str):
            bias_c = stage_varying_bias(b, sq, sk, dev, gen)
        blocked = 17 if name.startswith("ragged") else None
        if blocked is not None:
            bias_c[:, blocked] = -1e30 * fa.LOG2E
        q = (rms(randn(b, 24, sq, 128)) * scale).bfloat16()
        k = (rms(randn(b, 24, sk, 128)) * scale).bfloat16()
        v = randn(b, 24, sk, 128).bfloat16()
        if dead == "per_stage":
            mask = stage_varying_mask(b, sk, dev)
        else:
            mask = torch.ones(b, sk, dtype=torch.bool, device=dev)
            mask[b - 1, dead[0]:dead[1]] = False
        logits = q[0, 0].float() @ k[0, 0].float().T * (fa.LOG2E / 128 ** 0.5) + bias_c[0]
        clamped = (logits > fa.CLAMP).float().mean().item()
        del logits
        if scale != 1.0 and clamped == 0.0:
            fail(f"K7 {name}: no logit reaches the clamp")
        out = fa.fixedmax_attention_bias(q, k, v, bias_c, mask)
        ref = fa.fixedmax_attention_bias_reference(q, k, v, bias_c, mask)
        torch.cuda.synchronize()
        max_err, mean_err, n_bad = compare(out, ref)
        rel = rel_l2(out, ref)
        row = {"phase": "k7", "case": name, "shape": [b, 24, sq, sk], "qk_scale": scale,
               "bias_strides": list(bias_c.stride()), "clamped_logit_share": clamped,
               "max_abs_err": max_err, "mean_abs_err": mean_err, "rel_l2": rel,
               "n_out_of_tol": n_bad, "atol": ATOL, "rtol": RTOL,
               "max_abs_limit": ATTN_MAX_ABS, "rel_l2_limit": ATTN_REL_L2}
        if blocked is not None:
            row["blocked_row_max_abs"] = out[:, :, blocked].abs().max().item()
        if name == "eligen_joint_8448":
            row["bias_blocked_share"] = (bias_nat < 0).float().mean().item()
            row["bias_build_host_ms"] = host_ms
            row["ms"] = time_ms(lambda: fa.fixedmax_attention_bias(q, k, v, bias_c, mask), 10)
            row["graph_ms"] = _bench.graph_ms(
                lambda: fa.fixedmax_attention_bias(q, k, v, bias_c, mask))
            row["k1prime_scaled_ms"] = time_ms(lambda: fa.fixedmax_bnsd(q, k, v, mask), 10)
            row["bias_cost_ms"] = row["ms"] - row["k1prime_scaled_ms"]
            row["plain_ms"] = time_ms(
                lambda: fa.fixedmax_attention_bias_reference(q, k, v, bias_c, mask), 2)
            # the same function in one PyTorch call: the bias in natural units
            # with the key mask folded in, as a float mask over the heads
            lib_mask = bias_nat.masked_fill(~mask[:, None, :], -1e30)[:, None].bfloat16()
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask), 10)
            del lib_mask
            row["tflops"] = 4 * b * 24 * sq * sk * 128 / row["ms"] / 1e9
            row.update(bound(4 * b * 24 * sq * sk * 128,
                             2 * (q.numel() + k.numel() + v.numel() + out.numel())
                             + 4 * bias_c.numel() + b * sk, PEAK_BF16))
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["ptxas"] = ptxas
            report["fixedmax_attention_bias"] = dict(row)
        report.setdefault("fixedmax_attention_bias_err", []).append(max_err)
        emit(row)
        if (n_bad or max_err > ATTN_MAX_ABS or rel > ATTN_REL_L2
                or (blocked is not None and row["blocked_row_max_abs"] != 0.0)):
            fail(f"K7 {name} disagrees with its plain version")
        del q, k, v, out, ref, bias_c
    del bias, bias_nat
    torch.cuda.empty_cache()


def _attention_row(phase, name, shape, out, ref, compare, live=None) -> dict:
    """The error of a kernel against its plain version, on the live rows
    where ``live`` ([B, N, S_q] bool) is given."""
    max_err, mean_err, n_bad = compare(out, ref, None if live is None
                                       else live[..., None].expand_as(out))
    sel = (lambda x: x) if live is None else (lambda x: x[live])
    return {"phase": phase, "case": name, "shape": shape, "max_abs_err": max_err,
            "mean_abs_err": mean_err, "rel_l2": rel_l2(sel(out), sel(ref)),
            "n_out_of_tol": n_bad, "atol": ATOL, "rtol": RTOL,
            "max_abs_limit": ATTN_MAX_ABS, "rel_l2_limit": ATTN_REL_L2}


def _attention_ok(row) -> bool:
    return (not row["n_out_of_tol"] and row["max_abs_err"] <= ATTN_MAX_ABS
            and row["rel_l2"] <= ATTN_REL_L2)


def online_ptxas() -> dict:
    """ptxas's report of K10's kernel: K10b (bias=1) and K10 (bias=0)."""
    return hopper_ptxas("online_attention", "online_kernel", ("bias",),
                        lambda args: "online_attention_bias_smem_bytes" if args[0]
                        else "online_attention_smem_bytes")


def k10_phase(report: dict, gen, time_ms, compare) -> dict:
    """K10 (online-softmax attention) at the DiT's shape, B = 2, N = 24,
    S = 8448, the last 64 keys masked.  Its path is the public API:
    ``ops.attention.attention(impl="kernels", variant="online")`` on BSND
    inputs, driven once with the counts at 0.  Then K10 against its plain
    version, timed (CUDA events and a CUDA graph) beside it, beside
    PyTorch's attention with the boolean mask and beside the bound, with
    ptxas's report of its kernel (no spills); and the unbounded-logit case
    (q and k x CLAMP_QK_SCALE, so that the fixed-max clamp binds): K10
    against its plain version and against an fp32 SDPA, with K1's distance
    from that SDPA beside it.  Every case: two more calls bit for bit.
    Returns the path's launches."""
    import torch
    import torch.nn.functional as F

    from physicedit_torch.kernels import flash_attention as fa
    from physicedit_torch.ops.attention import attention
    from physicedit_torch.tools import _bench

    dev = gen.device
    ptxas = online_ptxas()
    b, n, s = 2, 24, 8448
    mask = torch.ones(b, s, dtype=torch.bool, device=dev)
    mask[:, -64:] = False
    launches = None
    for name, scale in (("joint_8448", 1.0), ("unbounded_logits_8448", CLAMP_QK_SCALE)):
        q, k = (_rms(torch.randn(b, n, s, 128, device=dev, generator=gen)) * scale
                for _ in range(2))
        q, k = q.bfloat16(), k.bfloat16()
        # With unbounded logits each row's softmax is nearly one-hot, so the
        # output is nearly one row of v: at |v| in [2, 4) one bf16 step is
        # 0.0156, past the 4e-3 gate.  v / 8 (exact, a power of two) keeps
        # the outputs where one step is 2e-3 and scales every error by 1/8.
        v = (torch.randn(b, n, s, 128, device=dev, generator=gen) / scale).bfloat16()
        if launches is None:
            reset_counts()
            out = attention(*(x.transpose(1, 2) for x in (q, k, v)), key_mask=mask,
                            impl="kernels", variant="online").transpose(1, 2)
            torch.cuda.synchronize()
            launches = counts()
        else:
            out = fa.online_attention(q, k, v, mask)
        ref = fa.online_attention_reference(q, k, v, mask)
        torch.cuda.synchronize()
        row = _attention_row("k10", name, [b, n, s, s], out, ref, compare)
        row["qk_scale"] = scale
        row["repeat_bits_equal"] = all(torch.equal(fa.online_attention(q, k, v, mask), out)
                                       for _ in range(2))
        ok = _attention_ok(row) and row["repeat_bits_equal"]
        if scale == 1.0:
            row["ms"] = time_ms(lambda: fa.online_attention(q, k, v, mask), 10)
            row["graph_ms"] = _bench.graph_ms(lambda: fa.online_attention(q, k, v, mask))
            row["plain_ms"] = time_ms(lambda: fa.online_attention_reference(q, k, v, mask), 2)
            mask4 = mask[:, None, None, :]
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask4), 10)
            row["tflops"] = 4 * b * n * s * s * 128 / row["ms"] / 1e9
            row.update(bound(4 * b * n * s * s * 128,
                             2 * (q.numel() + k.numel() + v.numel() + out.numel()) + b * s,
                             PEAK_BF16))
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["ptxas"] = {key: e for key, e in ptxas.items() if key == "bias=0"}
            row["launches"] = launches
            report["online_attention"] = dict(row)
        else:
            logits = q[0, 0].float() @ k[0, 0].float().T * (fa.LOG2E / 128 ** 0.5)
            row["clamped_logit_share"] = (logits > fa.CLAMP).float().mean().item()
            row["v_scale"], row["max_abs_ref"] = 1.0 / scale, ref.abs().max().item()
            del logits
            sdpa = F.scaled_dot_product_attention(q.float(), k.float(), v.float(),
                                                  attn_mask=mask[:, None, None, :])
            fixed = fa.fixedmax_attention(q, k, v, mask, clamp=True)
            row["rel_l2_vs_fp32_sdpa"] = rel_l2(out, sdpa)
            row["k1_rel_l2_vs_fp32_sdpa"] = rel_l2(fixed, sdpa)
            row["rel_l2_vs_fp32_sdpa_limit"] = ATTN_REL_L2
            del sdpa, fixed
            ok = (ok and row["clamped_logit_share"] > 0.0
                  and row["rel_l2_vs_fp32_sdpa"] <= ATTN_REL_L2)
        report.setdefault("online_attention_err", []).append(row["max_abs_err"])
        emit(row)
        if not ok:
            fail(f"K10 {name} disagrees with its plain version or the fp32 softmax")
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    return launches


def k10b_phase(report: dict, gen, time_ms, compare) -> dict:
    """K10b (K10 with a head-shared bias in natural-log units), its path
    ``flash_attention_bnsd(bias=, variant="online")`` driven once with the
    counts at 0: (a) the full-width EliGen call, B = 2, N = 24, joint 256 +
    2 x 4096, with the two-entity bias ``build_entity_bias`` makes and a text
    key mask, timed (CUDA events and a CUDA graph) beside its plain version,
    beside PyTorch's attention with the bias as a bf16 float mask and beside
    the bound, with ptxas's report of its kernel (no spills); (b) the slim
    block's 4096 query rows reading their bias rows as a strided view, bit
    for bit against the same call on a contiguous copy; (c) a ragged S
    (4-byte bias copies) with a query row whose first 128-key tile (and keys
    200-239) the bias blocks, within the gates, beside rows whose keys are
    all blocked, at -1e30 and at -6e29 (-8.7e29 in exp2 units: above the
    running max's start, below the -5e29 threshold), each exactly 0.  Every
    case: two more calls bit for bit.  Returns the path's launches."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from physicedit_torch.kernels import flash_attention as fa
    from physicedit_torch.pipeline.eligen import build_entity_bias, downsample_entity_mask
    from physicedit_torch.tools import _bench

    dev = gen.device
    ptxas = online_ptxas()
    s_t, base = 256, 4096
    s = s_t + 2 * base
    masks = [downsample_entity_mask(m, 128, 128) for m in entity_masks(1024, 1024)]
    bias = torch.from_numpy(np.stack([build_entity_bias(masks, lens, 2 * base, base)
                                      for lens in ([40, 56, 160], [64, 64, 128])])).to(dev)

    def qkv(b, sq, sk):
        q = _rms(torch.randn(b, 24, sq, 128, device=dev, generator=gen)).bfloat16()
        k = _rms(torch.randn(b, 24, sk, 128, device=dev, generator=gen)).bfloat16()
        return q, k, torch.randn(b, 24, sk, 128, device=dev, generator=gen).bfloat16()

    # (a) the EliGen joint call: the path, then the check and the times
    q, k, v = qkv(2, s, s)
    mask = torch.ones(2, s, dtype=torch.bool, device=dev)
    mask[1, 220:256] = False
    reset_counts()
    out = fa.flash_attention_bnsd(q, k, v, mask, bias=bias, variant="online")
    torch.cuda.synchronize()
    launches = counts()
    ref = fa.online_attention_reference(q, k, v, mask, bias)
    row = _attention_row("k10b", "eligen_joint_8448", [2, 24, s, s], out, ref, compare)
    row["repeat_bits_equal"] = all(torch.equal(fa.online_attention(q, k, v, mask, bias), out)
                                   for _ in range(2))
    row["bias_blocked_share"] = (bias < 0).float().mean().item()
    row["ms"] = time_ms(lambda: fa.online_attention(q, k, v, mask, bias), 10)
    row["graph_ms"] = _bench.graph_ms(lambda: fa.online_attention(q, k, v, mask, bias))
    row["plain_ms"] = time_ms(lambda: fa.online_attention_reference(q, k, v, mask, bias), 2)
    lib_mask = bias.masked_fill(~mask[:, None, :], -1e30)[:, None].bfloat16()
    row["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask), 10)
    del lib_mask
    row["tflops"] = 4 * 2 * 24 * s * s * 128 / row["ms"] / 1e9
    row.update(bound(4 * 2 * 24 * s * s * 128,
                     2 * (q.numel() + k.numel() + v.numel() + out.numel()) + 4 * bias.numel()
                     + 2 * s, PEAK_BF16))
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["ptxas"] = {key: e for key, e in ptxas.items() if key == "bias=1"}
    row["launches"] = launches
    report["online_attention_bias"] = dict(row)
    rows = [row]

    # (b) the slim block's rows as a view of the joint bias
    qs = q[:, :, s_t:s_t + base].contiguous()
    view = bias[:, s_t:s_t + base]
    out_v = fa.online_attention(qs, k, v, mask, view)
    out_c = fa.online_attention(qs, k, v, mask, view.contiguous())
    ref = fa.online_attention_reference(qs, k, v, mask, view)
    row = _attention_row("k10b", "slim_4096x8448_view", [2, 24, base, s], out_v, ref, compare)
    row["bias_strides"] = list(view.stride())
    row["view_equals_copy"] = bool(torch.equal(out_v, out_c))
    row["repeat_bits_equal"] = all(torch.equal(fa.online_attention(qs, k, v, mask, view), out_v)
                                   for _ in range(2))
    rows.append(row)
    del q, k, v, qs, out, out_v, out_c, ref, view

    # (c) a ragged S: a row whose first key tile the bias blocks, beside
    # rows it blocks wholly
    sr, first, blocked, band = 2303, 16, 17, 18
    q, k, v = qkv(1, sr, sr)
    mask = torch.ones(1, sr, dtype=torch.bool, device=dev)
    mask[0, 2000:] = False
    bias_r = torch.where(torch.rand(1, sr, sr, device=dev, generator=gen) < 0.3, -1e30, 0.0)
    bias_r[:, :, 0] = 0.0
    bias_r[:, first, :128] = -1e30
    bias_r[:, first, 200:240] = -1e30
    bias_r[:, blocked] = -1e30
    bias_r[:, band] = -6e29
    out = fa.online_attention(q, k, v, mask, bias_r)
    ref = fa.online_attention_reference(q, k, v, mask, bias_r)
    live = torch.ones(1, 24, sr, dtype=torch.bool, device=dev)
    live[:, :, [blocked, band]] = False
    row = _attention_row("k10b", "ragged_2303_first_tile_and_blocked_rows", [1, 24, sr, sr],
                         out, ref, compare, live)
    first_row = _attention_row("k10b", "first_tile_blocked_row", [1, 24, 1, sr],
                               out[:, :, first], ref[:, :, first], compare)
    row["first_tile_row_max_abs_err"] = first_row["max_abs_err"]
    row["first_tile_row_rel_l2"] = first_row["rel_l2"]
    row["first_tile_row_ok"] = _attention_ok(first_row)
    row["blocked_row_max_abs"] = out[:, :, [blocked, band]].abs().max().item()
    row["repeat_bits_equal"] = all(torch.equal(fa.online_attention(q, k, v, mask, bias_r), out)
                                   for _ in range(2))
    rows.append(row)
    del q, k, v, out, ref, bias_r, bias
    for row in rows:
        report.setdefault("online_attention_bias_err", []).append(row["max_abs_err"])
        emit(row)
        if (not _attention_ok(row) or row.get("view_equals_copy") is False
                or not row["repeat_bits_equal"] or row.get("first_tile_row_ok") is False
                or row.get("blocked_row_max_abs", 0.0) != 0.0):
            fail(f"K10b {row['case']} disagrees with its plain version")
    torch.cuda.empty_cache()
    return launches


def k1prime_phase(report: dict, gen, time_ms, compare) -> dict:
    """K1' (``fixedmax_bnsd``: fixed-max attention without the row sums) at
    B = 2, N = 24, S = 8448, text keys masked in one row, in both forms:
    q prescaled (K1's kernel) and q scaled in fp32 in the kernel (K7's
    kernel without its bias), each with the clamp on and off; the path (the
    JAX package's default form, scaled with the clamp on) driven once with
    the counts at 0.  Each form timed beside its plain version; the clamp
    also where it binds (q and k x CLAMP_QK_SCALE).  Returns the path's
    launches.  The scaled rows also carry a CUDA-graph time, the bound and
    the ptxas report of K7's kernel without the bias."""
    import torch
    import torch.nn.functional as F

    from physicedit_torch.kernels import flash_attention as fa
    from physicedit_torch.tools import _bench

    dev = gen.device
    b, n, s = 2, 24, 8448
    ptxas = {key: entry for key, entry in k7_ptxas().items() if key.startswith("bias=0")}
    mask = torch.ones(b, s, dtype=torch.bool, device=dev)
    mask[1, 60:256] = False
    launches = None
    cases = [(pre, clamp, 1.0) for pre in (False, True) for clamp in (True, False)]
    cases += [(False, True, CLAMP_QK_SCALE), (True, True, CLAMP_QK_SCALE)]
    for prescaled, clamp, scale in cases:
        q, k = (_rms(torch.randn(b, n, s, 128, device=dev, generator=gen)) * scale
                for _ in range(2))
        q, k = q.bfloat16(), k.bfloat16()
        v = torch.randn(b, n, s, 128, device=dev, generator=gen).bfloat16()
        if prescaled:
            q = fa._prescale(q).contiguous()
        if launches is None:
            reset_counts()
            out = fa.fixedmax_bnsd(q, k, v, mask, clamp=clamp, prescaled=prescaled)
            torch.cuda.synchronize()
            launches = counts()
        else:
            out = fa.fixedmax_bnsd(q, k, v, mask, clamp=clamp, prescaled=prescaled)
        ref = fa.fixedmax_bnsd_reference(q, k, v, mask, clamp=clamp, prescaled=prescaled)
        torch.cuda.synchronize()
        name = f"{'prescaled' if prescaled else 'scaled'}_{'clamp' if clamp else 'noclamp'}"
        if scale != 1.0:
            name += "_binds"
        row = _attention_row("k1prime", name, [b, n, s, s], out, ref, compare)
        row.update({"prescaled": prescaled, "clamp": clamp, "qk_scale": scale})
        ok = _attention_ok(row) if scale == 1.0 else row["rel_l2"] <= ATTN_REL_L2
        if scale == 1.0:
            row["ms"] = time_ms(lambda: fa.fixedmax_bnsd(q, k, v, mask, clamp=clamp,
                                                         prescaled=prescaled), 10)
            row["plain_ms"] = time_ms(lambda: fa.fixedmax_bnsd_reference(
                q, k, v, mask, clamp=clamp, prescaled=prescaled), 2)
            report.setdefault("fixedmax_bnsd_err", []).append(row["max_abs_err"])
            if not prescaled:
                row["graph_ms"] = _bench.graph_ms(lambda: fa.fixedmax_bnsd(q, k, v, mask,
                                                                          clamp=clamp))
                row.update(bound(4 * b * n * s * s * 128,
                                 2 * (q.numel() + k.numel() + v.numel() + out.numel()) + b * s,
                                 PEAK_BF16))
                row["bound_share"] = row["bound_ms"] / row["ms"]
                row["ptxas"] = ptxas
            if not prescaled and clamp:     # the JAX package's default form
                mask4 = mask[:, None, None, :]
                row["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask4), 10)
                row["launches"] = launches
                report["fixedmax_bnsd"] = dict(row)
        emit(row)
        if not ok:
            fail(f"K1' {name} disagrees with its plain version")
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    return launches


def ptxas_report(log_path, kernel: str = "proto_hopper_kernel") -> dict:
    """Registers and spill bytes of each instantiation of the kernel
    function ``kernel`` (by default ``proto_hopper_kernel`` of
    ``csrc/proto_fixedmax_attention.cu``) from nvcc's ``-Xptxas -v`` report,
    keyed by its template arguments as ints (``Variant.template_args()``;
    () for a function that is no template)."""
    import re

    report, args = {}, None
    for line in open(log_path):
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = re.search(rf"\d{kernel}(I((?:L[bi]\d+E)+)E|E)", entry.group(1))
            args = None if name is None else tuple(
                int(x) for x in re.findall(r"L[bi](\d+)E", name.group(2) or ""))
            continue
        if args is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            report.setdefault(args, {}).update(spill_store_bytes=int(spill.group(1)),
                                               spill_load_bytes=int(spill.group(2)))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            report.setdefault(args, {})["registers"] = int(used.group(1))
    return report


def hopper_ptxas(source: str, kernel: str, switches: tuple, smem_symbol=None) -> dict:
    """Registers, spills and dynamic shared memory of each instantiation of
    a Hopper-mainloop kernel (``csrc/<source>.cu``); fails on a spill.
    Instantiations are keyed by their template switches; ``smem_symbol``
    maps an instantiation's switches to the C function that reports its
    shared memory (by default ``<source>_smem_bytes``)."""
    from physicedit_torch.kernels import _build

    report = ptxas_report(f"{_build.library_path(source)}.log", kernel)
    lib = _build.load(source)

    def smem(args):
        name = smem_symbol(args) if smem_symbol else f"{source}_smem_bytes"
        return getattr(lib, name)()

    out = {",".join(f"{k}={v}" for k, v in zip(switches, args)) or kernel:
           {**entry, "dynamic_smem_bytes": smem(args)} for args, entry in sorted(report.items())}
    if not out or any(e.get("spill_store_bytes", 0) or e.get("spill_load_bytes", 0)
                      for e in out.values()):
        fail(f"{kernel}: ptxas reports spills or no entry: {out}")
    return out


def proto_ptxas() -> dict:
    """ptxas's report of the prototypes' kernel through :func:`hopper_ptxas`
    (registers, spills and dynamic shared memory; a spill fails the run),
    keyed by variant name."""
    from physicedit_torch.tools import _proto_attention as pa

    switches = ("inscale", "bias", "clamp", "exp", "row_sum", "norm")
    # T1 v1's bf16 and the fp32 key bias take the same slot per stage
    hopper = hopper_ptxas(pa.SOURCE, "proto_hopper_kernel", switches,
                          lambda args: "proto_fixedmax_attention_bias_smem_bytes"
                          if args[1] != pa.BIAS_CODES["none"]
                          else "proto_fixedmax_attention_smem_bytes")
    return {name: hopper[",".join(f"{k}={v}" for k, v in zip(switches, var.template_args()))]
            for name, var in pa.VARIANTS.items()}


def stage_varying_key_bias(b: int, s: int, device, gen):
    """A [b, 1, s] fp32 key bias (T1 v1's, T5's) that changes from one 128-key
    stage of the Hopper mainloop to the next: the keys that
    :func:`stage_varying_mask` masks take -1e30, the others a small graded
    bias (normal x 0.5), key 0 none: two stages that share a slot of the
    2-stage ring never carry the same bias."""
    import torch

    live = stage_varying_mask(b, s, device)
    bias = torch.where(live, 0.5 * torch.randn(b, s, device=device, generator=gen), -1e30)
    bias[:, 0] = 0.0
    return bias[:, None, :]


def t5_edge_cases(b: int, device, gen) -> list:
    """T5's and T8's cases at the edges of their key-bias prefix, B = ``b``,
    N = 24:
    (case, S, key bias [b, 1, S], bias_keys, the batch rows the bias blocks
    on every key or None).  A ragged S whose bias changes every stage over
    every key (two stages that share a ring slot never carry the same
    bias); the prefix ending at key 200, inside the second 128-key tile,
    with the bias blocking keys [150, 260) of batch 0 (keys 200-259 stay
    live); the same bias with no prefix (bias_keys 0: no bias read); and
    batch 1 blocked at -1e30 on every key (its rows are NaN: l = 0 and no
    floor)."""
    import torch

    s = 8448
    normal = 0.5 * torch.randn(b, 1, s, device=device, generator=gen)
    hole = normal.clone()
    hole[0, :, 150:260] = -1e30
    blocked = normal.clone()
    blocked[1] = -1e30
    return [("ragged_8513_stage_varying_bias", 8513, stage_varying_key_bias(b, 8513, device, gen),
             8513, None),
            ("bias_keys_200", s, hole, 200, None),
            ("bias_keys_0", s, hole, 0, None),
            ("batch_blocked_on_every_key", s, blocked, s, 1)]


def proto_phase(report: dict, gen, time_ms, compare) -> dict:
    """The bf16 attention prototypes of ``tools/`` (T1 v1-v4, T2, T3, T5,
    T7, T8) at the DiT's joint attention, B = 2, N = 24, S = 8448, RMS-normed
    q and k: each instantiation of ``csrc/proto_fixedmax_attention.cu`` (all
    on the Hopper mainloop) against its plain version (the normalised ones
    under the K1 gates, T1 v3 and v4 relative to their largest output),
    three calls bit for bit, timed (CUDA events and a CUDA graph) beside
    its plain version, the one SDPA call that computes the same function
    where there is one, and the bound, with its loop, its registers, spills
    and dynamic shared memory (a spill fails the run); the last 64 keys
    masked for T3, T7 and T1 v1, keys [200, 256) of the text prefix for T8
    and T5 (bias_keys 1408, both names).  T1 v1 and T7 run again at a
    ragged S = 8513 with a key bias that changes every stage, and T7 with
    q and k scaled so that many logits pass its clamp, under the K1 gates.
    T5 and T8, both names each, also at the edges of their prefix
    (:func:`t5_edge_cases`), under the K1 gates on live rows, NaN on a
    batch the bias blocks wholly, three calls bit for bit.  A ragged S
    where one batch has no live key: NaN rows from T7 (no floor on l), 0
    from T3.  Then each
    ported tool's ``main()`` once with the counts at 0: the prototypes'
    path.  Returns its launches."""
    import torch
    import torch.nn.functional as F

    from physicedit_torch.kernels import flash_attention as fa
    from physicedit_torch.tools import _bench
    from physicedit_torch.tools import _proto_attention as pa
    from physicedit_torch.tools import proto_attn_bf16s as t1
    from physicedit_torch.tools import proto_attn_fast as t23
    from physicedit_torch.tools import proto_attn_interleave as t5
    from physicedit_torch.tools import proto_fixedmax as t7
    from physicedit_torch.tools import proto_fixedmax2 as t8

    dev = gen.device
    b, n, s, bias_keys = 2, 24, 8448, 1408
    q, k = (_rms(torch.randn(b, n, s, 128, device=dev, generator=gen)).bfloat16()
            for _ in range(2))
    v = torch.randn(b, n, s, 128, device=dev, generator=gen).bfloat16()
    qs = fa._prescale(q).contiguous()
    tail = torch.ones(b, s, dtype=torch.bool, device=dev)
    tail[:, -64:] = False
    prefix = torch.ones_like(tail)
    prefix[:, 200:256] = False
    bias_tail, bias_prefix = pa.mask_bias(tail), pa.mask_bias(prefix)
    # SDPA's float masks, [B, 1, 1, S] in the inputs' dtype
    lib_tail, lib_prefix = (x[:, None].bfloat16() for x in (bias_tail, bias_prefix))
    sdpa = F.scaled_dot_product_attention
    ln2 = 1.0 / fa.LOG2E    # SDPA's scale for a prescaled q': exp(q'k ln 2) = exp2(q'k)
    cases = {  # name: (the kernel, its plain version, the one PyTorch call or None)
        "proto_fixedmax": (lambda: t7.fixedmax_bnsd(q, k, v, bias_tail),
                           lambda: t7.fixedmax_bnsd_reference(q, k, v, bias_tail),
                           lambda: sdpa(q, k, v, attn_mask=lib_tail)),
        "proto_nobias_inscale": (lambda: t23.attn_nobias(q, k, v, True),
                                 lambda: t23.attn_nobias_reference(q, k, v, True),
                                 lambda: sdpa(q, k, v)),
        "proto_nobias": (lambda: t23.attn_nobias(qs, k, v, False),
                         lambda: t23.attn_nobias_reference(qs, k, v, False),
                         lambda: sdpa(qs, k, v, scale=ln2)),
        "proto_nmask": (lambda: t23.attn_nmask(q, k, v, tail),
                        lambda: t23.attn_nmask_reference(q, k, v, tail),
                        lambda: sdpa(q, k, v, attn_mask=tail[:, None, None, :])),
        "proto_bf16s": (lambda: t1.attn_bf16s(qs, k, v, bias_tail),
                        lambda: t1.attn_bf16s_reference(qs, k, v, bias_tail),
                        lambda: sdpa(qs, k, v, attn_mask=lib_tail, scale=ln2)),
        "proto_expnosum": (lambda: t1.attn_expnosum(qs, k, v),
                           lambda: t1.attn_expnosum_reference(qs, k, v), None),
        "proto_noexp": (lambda: t1.attn_noexp(qs, k, v),
                        lambda: t1.attn_noexp_reference(qs, k, v), None),
    }
    for suffix, overlap in (("", False), ("_overlap", True)):
        cases["proto_fixedmax2" + suffix] = (
            lambda ov=overlap: t8.fixedmax2_bnsd(q, k, v, bias_prefix, bias_keys, ov),
            lambda: t8.fixedmax2_bnsd_reference(q, k, v, bias_prefix, bias_keys),
            lambda: sdpa(q, k, v, attn_mask=lib_prefix))
        cases["proto_interleave" + suffix] = (
            lambda ov=overlap: t5.attn_interleaved(q, k, v, bias_prefix, bias_keys, ov),
            lambda: t5.attn_interleaved_reference(q, k, v, bias_prefix, bias_keys),
            lambda: sdpa(q, k, v, attn_mask=lib_prefix))
    registers = proto_ptxas()
    flops = 4 * b * n * s * s * 128
    twins = {}    # the output of each name whose "_overlap" twin follows
    for name in pa.VARIANTS:
        kernel, plain, library = cases[name]
        var = pa.VARIANTS[name]
        out = kernel()
        ref = plain()
        torch.cuda.synchronize()
        row = _attention_row("proto", name, [b, n, s, s], out, ref, compare)
        row["loop"] = KERNEL_LOOPS[name]
        if var.norm == "none":
            row["max_abs_ref"] = ref.float().abs().max().item()
            row["max_err_over_max_ref"] = row["max_abs_err"] / row["max_abs_ref"]
            row["max_err_over_max_ref_limit"] = PROTO_UNNORM_REL
            ok = (row["max_err_over_max_ref"] <= PROTO_UNNORM_REL
                  and row["rel_l2"] <= ATTN_REL_L2)
        else:
            ok = _attention_ok(row)
        row["repeat_bits_equal"] = all(torch.equal(kernel(), out) for _ in range(2))
        ok = ok and row["repeat_bits_equal"]
        if name.endswith("_overlap"):   # the same instantiation: the same bits
            row["equals_overlap_off"] = bool(torch.equal(out, twins.pop(
                name.removesuffix("_overlap"))))
        elif name + "_overlap" in pa.VARIANTS:
            twins[name] = out
        del out, ref
        row["ms"] = time_ms(kernel, 10)
        row["graph_ms"] = _bench.graph_ms(kernel)
        row["plain_ms"] = time_ms(plain, 2)
        row["library_ms"] = time_ms(library, 10) if library is not None else None
        row["tflops"] = flops / row["ms"] / 1e9
        # q, k and v read, out written (bf16), and the key bias or the mask
        extra = 4 * b * s if var.bias != "none" else (b * s if name == "proto_nmask" else 0)
        row.update(bound(flops, 2 * 4 * q.numel() + extra, PEAK_BF16))
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row.update(registers[name])
        report[name] = row
        report[f"{name}_err"] = [row["max_abs_err"]]
        emit(row)
        if not ok:
            fail(f"prototype {name} disagrees with its plain version")
    del twins, q, k, v, qs
    torch.cuda.empty_cache()

    # T1 v1 and T7 at a ragged S with a key bias that changes every stage: a
    # bias slot of the ring read after its stage was released would show
    # here; T7 again with q and k scaled so that many logits pass its clamp
    sr = 8513
    qr, kr = (_rms(torch.randn(b, n, sr, 128, device=dev, generator=gen)).bfloat16()
              for _ in range(2))
    vr = torch.randn(b, n, sr, 128, device=dev, generator=gen).bfloat16()
    bias_r = stage_varying_key_bias(b, sr, dev, gen)
    qc, kc = ((x.float() * CLAMP_QK_SCALE).bfloat16() for x in (qr, kr))
    # share of logits (batch 0, head 0, in exp2 units) past the clamp
    clamped = ((qc[0, 0].float() @ kc[0, 0].float().T) * (fa.LOG2E / math.sqrt(128))
               > fa.CLAMP).float().mean().item()
    qrs = fa._prescale(qr).contiguous()
    checks = [  # case, the kernel, its plain version, the report's name
        ("proto_bf16s_ragged_8513_stage_varying_bias",
         lambda: t1.attn_bf16s(qrs, kr, vr, bias_r),
         lambda: t1.attn_bf16s_reference(qrs, kr, vr, bias_r), "proto_bf16s"),
        ("proto_fixedmax_ragged_8513_stage_varying_bias",
         lambda: t7.fixedmax_bnsd(qr, kr, vr, bias_r),
         lambda: t7.fixedmax_bnsd_reference(qr, kr, vr, bias_r), "proto_fixedmax"),
        ("proto_fixedmax_ragged_8513_clamp_binds",
         lambda: t7.fixedmax_bnsd(qc, kc, vr, bias_r),
         lambda: t7.fixedmax_bnsd_reference(qc, kc, vr, bias_r), "proto_fixedmax"),
    ]
    for case, call, plain, name in checks:
        out = call()
        ref = plain()
        torch.cuda.synchronize()
        row = _attention_row("proto", case, [b, n, sr, sr], out, ref, compare)
        row["repeat_bits_equal"] = repeats_equal(call, out)
        ok = _attention_ok(row) and row["repeat_bits_equal"]
        if "clamp" in case:
            row["clamped_logit_share"] = clamped
            ok = ok and clamped > 0.0
        report[f"{name}_err"].append(row["max_abs_err"])
        emit(row)
        if not ok:
            fail(f"{case} disagrees with its plain version (or no logit passes the clamp)")
        del out, ref
    del qr, kr, vr, qrs, qc, kc, bias_r
    torch.cuda.empty_cache()

    # T5 and T8, both names each, at the edges of their key-bias prefix
    prefix_tools = {"proto_interleave": (t5.attn_interleaved, t5.attn_interleaved_reference),
                    "proto_fixedmax2": (t8.fixedmax2_bnsd, t8.fixedmax2_bnsd_reference)}
    for case, s_case, bias_case, bias_keys_case, dead in t5_edge_cases(b, dev, gen):
        qr, kr = (_rms(torch.randn(b, n, s_case, 128, device=dev, generator=gen)).bfloat16()
                  for _ in range(2))
        vr = torch.randn(b, n, s_case, 128, device=dev, generator=gen).bfloat16()
        live = torch.ones(b, n, s_case, dtype=torch.bool, device=dev)
        if dead is not None:
            live[dead] = False
        for base, (tool, tool_reference) in prefix_tools.items():
            ref = tool_reference(qr, kr, vr, bias_case, bias_keys_case)
            for overlap in (False, True):
                name = base + ("_overlap" if overlap else "")

                def call():
                    return tool(qr, kr, vr, bias_case, bias_keys_case, overlap)

                out = call()
                torch.cuda.synchronize()
                row = _attention_row("proto", f"{name}_{case}", [b, n, s_case, s_case], out,
                                     ref, compare, live)
                row["bias_keys"] = bias_keys_case
                row["repeat_bits_equal"] = repeats_equal(call, out)
                ok = _attention_ok(row) and row["repeat_bits_equal"]
                if dead is not None:
                    row["dead_rows_all_nan"] = bool(torch.isnan(out[dead]).all()
                                                    and torch.isnan(ref[dead]).all())
                    ok = ok and row["dead_rows_all_nan"]
                report[f"{name}_err"].append(row["max_abs_err"])
                emit(row)
                if not ok:
                    fail(f"{name} {case} disagrees with its plain version")
                del out
            del ref
        del qr, kr, vr, live
    torch.cuda.empty_cache()

    # a ragged S where batch 1 has no live key
    sr = 300
    qr, kr, vr = (torch.randn(2, 3, sr, 128, device=dev, generator=gen).bfloat16()
                  for _ in range(3))
    live = torch.ones(2, sr, dtype=torch.bool, device=dev)
    live[0, 250:] = False
    live[1] = False
    nan_rows = t7.fixedmax_bnsd(qr, kr, vr, pa.mask_bias(live))
    zero_rows = t23.attn_nmask(qr, kr, vr, live)
    row = {"phase": "proto", "case": "ragged_300_no_live_key", "shape": [2, 3, sr, sr],
           "t7_dead_batch_all_nan": bool(torch.isnan(nan_rows[1]).all()),
           "t3_dead_batch_max_abs": zero_rows[1].abs().max().item(),
           "t7_live_batch_max_abs_err": pa.max_abs_diff(
               nan_rows[0], t7.fixedmax_bnsd_reference(qr, kr, vr, pa.mask_bias(live))[0]),
           "t3_live_batch_max_abs_err": pa.max_abs_diff(
               zero_rows[0], t23.attn_nmask_reference(qr, kr, vr, live)[0]),
           "max_abs_limit": ATTN_MAX_ABS}
    emit(row)
    if not (row["t7_dead_batch_all_nan"] and row["t3_dead_batch_max_abs"] == 0.0
            and row["t7_live_batch_max_abs_err"] <= ATTN_MAX_ABS
            and row["t3_live_batch_max_abs_err"] <= ATTN_MAX_ABS):
        fail("a prototype's rows with no live key, or its ragged edge, differ from the "
             "plain version")
    report["proto_fixedmax_err"].append(row["t7_live_batch_max_abs_err"])
    report["proto_nmask_err"].append(row["t3_live_batch_max_abs_err"])

    # the prototypes' path: each ported tool, as a user runs it
    reset_counts()
    rows = [r for tool in (t7, t8, t23, t1, t5) for r in tool.main()]
    torch.cuda.synchronize()
    launches = {name: counts()[name] for name in pa.VARIANTS}
    for r in rows:
        emit({"phase": "proto_tool", **r})
    emit({"phase": "proto_tools", "launches": launches})
    torch.cuda.empty_cache()
    return launches


def same_bits(a, b) -> bool:
    """a and b hold the same bits (NaN included, which ``torch.equal``
    never finds equal)."""
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def repeats_equal(fn, first, times: int = 2) -> bool:
    """``times`` more calls of ``fn`` give ``first``'s bits."""
    return all(same_bits(fn(), first) for _ in range(times))


def graph_equals_eager(fn) -> bool:
    """One call of ``fn`` captured in a CUDA graph and replayed gives the
    eager call's bits (the kernel's tensor maps reach it by value)."""
    import torch

    eager = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    graph.replay()
    torch.cuda.synchronize()
    return bool(torch.equal(eager, captured))


# T12's edges (M, K, N): ragged M under one, just past one and past several
# 128-row tiles, and K = 384 at the tool's M and N
T12_EDGES = [(17, 3072, 12288), (129, 3072, 12288), (1000, 3072, 12288), (16384, 384, 12288)]
# T10's: K = 384 at its tool's M and N, and a ragged M
T10_EDGES = [(1536, 384, 37888), (1000, 3584, 37888)]

# T9's tile edges (M, K, N): a ragged M one row past the tool's, a ragged M of
# eight tiles, and an M under one 128-row tile with N of one and a half
# 256-column tiles
T9_EDGES = [(16385, 3072, 12288), (1000, 3072, 12288), (100, 1024, 384)]


def t9_edges(report: dict, randint, randn, max_err) -> None:
    """T9 at :data:`T9_EDGES`, both forms: i32 exact over the whole int8
    range, f32 bit for bit on integer-valued inputs and within one bf16
    step of the largest output on normal ones, each three calls bit for
    bit."""
    import torch

    from physicedit_torch.tools import proto_int8_rate as t9

    for m, k, n in T9_EDGES:
        xi, wi = randint(-128, 128, m, k), randint(-128, 128, n, k)
        got = t9.pallas_mm(xi, wi, "i32")
        row = {"phase": "int8_probe", "case": f"proto_mm_m{m}_k{k}_n{n}", "shape": [m, k, n],
               "i32_exact": bool(torch.equal(got, t9.pallas_mm_reference(xi, wi, "i32"))),
               "i32_repeat_bits_equal": repeats_equal(lambda: t9.pallas_mm(xi, wi, "i32"), got)}
        del xi, wi, got
        xb, wb = randint(-15, 16, m, k).bfloat16(), randint(-15, 16, n, k).bfloat16()
        row["f32_integer_inputs_equal"] = bool(torch.equal(
            t9.pallas_mm(xb, wb, "f32"), t9.pallas_mm_reference(xb, wb, "f32")))
        xb, wb = (randn(m, k) * 0.1).bfloat16(), (randn(n, k) * 0.1).bfloat16()
        got, want = t9.pallas_mm(xb, wb, "f32"), t9.pallas_mm_reference(xb, wb, "f32")
        row["f32_max_abs_err"] = max_err(got, want)
        row["f32_limit_bf16_step_of_max_ref"] = 2.0 ** (
            math.frexp(want.float().abs().max().item())[1] - 8)
        row["f32_repeat_bits_equal"] = repeats_equal(lambda: t9.pallas_mm(xb, wb, "f32"), got)
        del xb, wb, got, want
        torch.cuda.empty_cache()
        report["proto_mm_i32_err"].append(0.0 if row["i32_exact"] else math.inf)
        report["proto_mm_f32_err"].append(row["f32_max_abs_err"])
        emit(row)
        if not (row["i32_exact"] and row["i32_repeat_bits_equal"]
                and row["f32_integer_inputs_equal"] and row["f32_repeat_bits_equal"]
                and row["f32_max_abs_err"] <= row["f32_limit_bf16_step_of_max_ref"]):
            fail(f"T9 at M {m} K {k} N {n} disagrees with its plain version")


def int8_phase(report: dict, gen, time_ms, compare) -> dict:
    """The int8, W4 and elementwise-rate probes of ``tools/`` (T9, T10, T12,
    T11, T4 and its quantize, T6; ``csrc/proto_int8_matmul.cu``,
    ``csrc/proto_int8qk_attention.cu``, ``csrc/proto_ew_scale.cu``) at their
    tools' full shapes: each instantiation against its plain version
    (integer results exact; the W4 epilogues in fp32, bf16 (and T12's in
    int8), T4's quantized codes and scales and T6 in both dtypes bit for
    bit; T9 f32 bit for bit on integer-valued inputs, whose fp32 sums are
    exact in any order, and on normal ones within one bf16 step of its
    largest output, what a flipped rounding moves it; T4 under K1's gates,
    also at S 1088), timed beside its plain version and the one PyTorch call
    that computes the same function where there is one, with its bound,
    registers and spills.  T9, T10 and T12 also three calls bit for bit,
    from a CUDA graph, at ragged M (:data:`T9_EDGES`, :data:`T10_EDGES`,
    :data:`T12_EDGES`: T9 also under one tile, T10 and T12 also at K = 384),
    with their GEMMs' shared memory; T10 and T12 beside K3 on the same
    operands, T12 also timed without the wrapper's row sums; T11 at its
    tool's three shapes, three calls bit for bit, with its shared memory,
    beside K3's GEMV at m8 on the same rotated weights; T4 three calls bit
    for bit and from a CUDA graph, with its shared memory, timed with and
    without its quantize beside K1 on the same inputs (a spill in T9-T12, T4
    or the quantize fails the run).  Then each ported tool's ``main()`` once
    with the counts at 0: the probes' path.  Returns its launches."""
    import torch
    import torch.nn.functional as F

    from physicedit_torch.kernels import _build
    from physicedit_torch.kernels import flash_attention as fa
    from physicedit_torch.kernels import quant_matmul as qm
    from physicedit_torch.tools import _bench, _proto_int8 as pi
    from physicedit_torch.tools import proto_attn_int8qk as t4
    from physicedit_torch.tools import proto_ew_rate as t6
    from physicedit_torch.tools import proto_int8_rate as t9
    from physicedit_torch.tools import proto_prefill_blocks as t10
    from physicedit_torch.tools import proto_w4_gemv as t11
    from physicedit_torch.tools import proto_w4_unpack as t12

    dev = gen.device

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, device=dev, generator=gen, dtype=torch.int8)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def record(name, row, ok, kernel, plain, library, bound_row, rate_bytes=0):
        """Times, bound and registers into ``row``; emit it; fail if not ok.
        ``graph_ms`` is the device time per call replayed from a CUDA graph;
        ``rate_bytes`` over it, the row's GB/s."""
        var = pi.VARIANTS[name]
        row["ms"] = time_ms(kernel, 10)
        row["graph_ms"] = _bench.graph_ms(kernel)
        if rate_bytes:
            row["gb_per_s_graph"] = rate_bytes / row["graph_ms"] / 1e6
        row["plain_ms"] = time_ms(plain, 2)
        row["library_ms"] = time_ms(library, 10) if library is not None else None
        row.update(bound_row)
        row.update(ptxas_report(f"{_build.library_path(var.source)}.log", var.kernel)
                   .get(var.template_args, {}))
        report[name] = row
        report[f"{name}_err"] = [row["max_abs_err"]]
        emit(row)
        if not ok:
            fail(f"probe {name} disagrees with its plain version")

    def max_err(got, want):
        return (got.double() - want.double()).abs().max().item()

    # T9 at the DiT fc1 shape, int8 over the whole range, bf16 integer-valued
    # and normal; each form also three calls bit for bit and a CUDA graph's
    # replay equal to the eager call; its GEMM's registers, spills and
    # dynamic shared memory (a spill fails the run)
    t9_ptxas = hopper_ptxas(pi.MATMUL, "gemm_wgmma_kernel", ("kind",),
                            lambda args: "proto_int8_matmul_gemm_smem_bytes")
    m, k, n = t9.M, t9.K, t9.N
    xi, wi = randint(-128, 128, m, k), randint(-128, 128, n, k)
    got, want = t9.pallas_mm(xi, wi, "i32"), t9.pallas_mm_reference(xi, wi, "i32")
    wit = wi.T
    row = {"phase": "int8_probe", "case": "proto_mm_i32", "shape": [m, k, n],
           "exact": bool(torch.equal(got, want)), "max_abs_err": max_err(got, want),
           "int_mm_exact": bool(torch.equal(torch._int_mm(xi, wit), want)),
           "repeat_bits_equal": repeats_equal(lambda: t9.pallas_mm(xi, wi, "i32"), got),
           "graph_bits_equal": graph_equals_eager(lambda: t9.pallas_mm(xi, wi, "i32")),
           "ptxas": t9_ptxas["kind=0"]}
    record("proto_mm_i32", row,
           row["exact"] and row["repeat_bits_equal"] and row["graph_bits_equal"],
           lambda: t9.pallas_mm(xi, wi, "i32"), lambda: t9.pallas_mm_reference(xi, wi, "i32"),
           lambda: torch._int_mm(xi, wit),
           bound(2 * m * k * n, m * k + n * k + 4 * m * n, PEAK_INT8))
    del xi, wi, wit, got, want
    xb, wb = (randint(-15, 16, m, k).bfloat16(), randint(-15, 16, n, k).bfloat16())
    integers_equal = bool(torch.equal(t9.pallas_mm(xb, wb, "f32"),
                                      t9.pallas_mm_reference(xb, wb, "f32")))
    xb, wb = (randn(m, k) * 0.1).bfloat16(), (randn(n, k) * 0.1).bfloat16()
    got, want = t9.pallas_mm(xb, wb, "f32"), t9.pallas_mm_reference(xb, wb, "f32")
    row = {"phase": "int8_probe", "case": "proto_mm_f32", "shape": [m, k, n],
           "integer_inputs_equal": integers_equal, "max_abs_err": max_err(got, want),
           "max_abs_ref": want.float().abs().max().item(), "rel_l2": rel_l2(got, want),
           "repeat_bits_equal": repeats_equal(lambda: t9.pallas_mm(xb, wb, "f32"), got),
           "graph_bits_equal": graph_equals_eager(lambda: t9.pallas_mm(xb, wb, "f32")),
           "ptxas": t9_ptxas["kind=1"]}
    # one bf16 step of the largest output: 2^(e - 8) for max |ref| = f 2^e, f in [0.5, 1)
    row["limit_bf16_step_of_max_ref"] = 2.0 ** (math.frexp(row["max_abs_ref"])[1] - 8)
    record("proto_mm_f32", row,
           integers_equal and row["max_abs_err"] <= row["limit_bf16_step_of_max_ref"]
           and row["repeat_bits_equal"] and row["graph_bits_equal"],
           lambda: t9.pallas_mm(xb, wb, "f32"), lambda: t9.pallas_mm_reference(xb, wb, "f32"),
           lambda: xb @ wb.T,
           bound(2 * m * k * n, 2 * (m * k + n * k + m * n), PEAK_BF16))
    del xb, wb, got, want
    torch.cuda.empty_cache()
    t9_edges(report, randint, randn, max_err)

    # T10 at the VL prefill gate+up, T12 at the DiT fc1: any byte is a valid
    # packing; a bias row of normal x 100 makes the int8 output saturate
    def w4_operands(m, k, n):
        xq, w4 = randint(-127, 128, m, k), randint(-128, 128, n, k // 2)
        xs = torch.rand(m, 1, device=dev, generator=gen) * 1e-2 + 1e-3
        wsb = torch.stack([torch.rand(n, device=dev, generator=gen) * 1e-2 + 1e-3,
                           randn(n) * 100])
        return xq, w4, xs, wsb

    def w4_compare(row, fn, plain, operands, outs):
        """Each output dtype against the plain version: the int32
        accumulators exactly, the output bit for bit."""
        for dt in outs:
            out, acc = fn(*operands, dt, return_acc=True)
            ref, acc_ref = plain(*operands, dt, return_acc=True)
            key = str(dt).removeprefix("torch.")
            row[f"acc_exact_{key}"] = bool(torch.equal(acc, acc_ref))
            row[f"out_equal_{key}"] = bool(torch.equal(out, ref))
            row.setdefault("max_abs_err", max_err(out, ref))
            if dt == torch.int8:
                row["int8_saturated_share"] = (ref.abs() >= 127).float().mean().item()
            del out, acc, ref, acc_ref
        return all(v for key, v in row.items() if key.startswith(("acc_exact", "out_equal")))

    w4_ptxas = hopper_ptxas(pi.MATMUL, "w4_wgmma_kernel", ("unpack",),
                            lambda args: "proto_int8_matmul_w4_smem_bytes")
    w4_outs = (torch.float32, torch.bfloat16, torch.int8)
    for name, fn, plain, (m, k, n) in (
            ("proto_w4_i32", t10.i32_matmul, t10.i32_matmul_reference, (1536, 3584, 37888)),
            ("proto_w4_and", t12.w4a8_i8_matmul, t12.w4a8_i8_matmul_reference,
             (16384, 3072, 12288))):
        var = pi.VARIANTS[name]
        ops = w4_operands(m, k, n)
        row = {"phase": "int8_probe", "case": name, "shape": [m, k, n]}
        ok = w4_compare(row, fn, plain, ops, w4_outs[:2] if name == "proto_w4_i32" else w4_outs)
        first = fn(*ops, torch.bfloat16)
        row["repeat_bits_equal"] = repeats_equal(lambda: fn(*ops, torch.bfloat16), first)
        row["graph_bits_equal"] = graph_equals_eager(lambda: fn(*ops, torch.bfloat16))
        row["ptxas"] = w4_ptxas[f"unpack={var.template_args[0]}"]
        ok = ok and row["repeat_bits_equal"] and row["graph_bits_equal"]
        # K3 on the same operands; T12 also without the wrapper's row sums
        # (the torch op, computed beforehand)
        row["k3_graph_ms_same_inputs"] = _bench.graph_ms(
            lambda: qm.w4a8_matmul(ops[0], ops[1], ops[2], ops[3][0]))
        if name == "proto_w4_and":
            rs = pi.low_half_rowsum8(ops[0])
            alone = lambda: pi.launch_matmul(name, *ops, rs, torch.bfloat16)
            row["kernel_alone_ms"] = time_ms(alone, 10)
            row["kernel_alone_graph_ms"] = _bench.graph_ms(alone)
            del rs, alone
        del first
        out_bytes = 2 * m * n     # timed with bf16 out, as K3 writes
        record(name, row, ok, lambda: fn(*ops, torch.bfloat16),
               lambda: plain(*ops, torch.bfloat16), None,
               bound(2 * m * k * n, m * k + n * k // 2 + 4 * m + 8 * n + out_bytes, PEAK_INT8))
        del ops

    # T10's and T12's edges: ragged M (under one, just past one, several
    # 128-row tiles) and K = 384, whose K/2 = 192 leaves the last 128-byte
    # stage half empty (TMA's zeros in the packed box and in both halves of x:
    # T10 unpacks a zero byte to lo = -8)
    for name, fn, plain, (m, k, n) in (
            *(("proto_w4_and", t12.w4a8_i8_matmul, t12.w4a8_i8_matmul_reference, shape)
              for shape in T12_EDGES),
            *(("proto_w4_i32", t10.i32_matmul, t10.i32_matmul_reference, shape)
              for shape in T10_EDGES)):
        ops = w4_operands(m, k, n)
        row = {"phase": "int8_probe", "case": f"{name}_m{m}_k{k}_n{n}", "shape": [m, k, n]}
        ok = w4_compare(row, fn, plain, ops, w4_outs[:2] if name == "proto_w4_i32" else w4_outs)
        first = fn(*ops, torch.bfloat16)
        row["repeat_bits_equal"] = repeats_equal(lambda: fn(*ops, torch.bfloat16), first)
        report[f"{name}_err"].append(row["max_abs_err"])
        emit(row)
        del ops, first
        if not (ok and row["repeat_bits_equal"]):
            fail(f"{name} at M {m} K {k} N {n} disagrees with its plain version")
    torch.cuda.empty_cache()

    # T11 at its tool's three decode shapes (gate+up first, the kernels
    # line's), weights rotated past the L2, each exact and three calls bit
    # for bit, beside K3's GEMV at m8 on the same rotated weights (bf16 out,
    # unit scales); the GEMV's registers, spills and shared memory (a spill
    # fails the run)
    gemv_ptxas = hopper_ptxas(pi.MATMUL, "gemv_mma_kernel", (),
                              lambda args: "proto_int8_matmul_gemv_smem_bytes")
    m = t11.M_DECODE
    for label, k, n in t11.SHAPES:
        xq, w4 = randint(-127, 128, m, k), randint(-128, 128, n, k // 2)
        got, want = t11.gemv_and_only(xq, w4), t11.gemv_and_only_reference(xq, w4)
        copies = pi.l2_copies(w4)
        rotated = pi.rotated(lambda w: t11.gemv_and_only(xq, w), copies)
        xs, ws = torch.ones(m, 1, device=dev), torch.ones(n, device=dev)
        row = {"phase": "int8_probe", "case": "proto_w4_gemv_and" + (
                   "" if k == 3584 and n == 37888 else f"_k{k}_n{n}"),
               "shape": [m, k, n], "tool_shape": label, "weight_copies": len(copies),
               "exact": bool(torch.equal(got, want)), "max_abs_err": max_err(got, want),
               "repeat_bits_equal": repeats_equal(lambda: t11.gemv_and_only(xq, w4), got),
               "ptxas": gemv_ptxas["gemv_mma_kernel"],
               "k3_gemv_graph_ms_same_inputs": _bench.graph_ms(
                   pi.rotated(lambda w: qm.w4a8_matmul(xq, w, xs, ws), copies))}
        ok = row["exact"] and row["repeat_bits_equal"]
        nbytes = n * k // 2 + m * k + 4 * m * n
        if row["case"] == "proto_w4_gemv_and":
            record("proto_w4_gemv_and", row, ok, rotated,
                   lambda: t11.gemv_and_only_reference(xq, w4), None,
                   bound(2 * m * k * n, nbytes, PEAK_INT8), rate_bytes=n * k // 2)
        else:
            row["ms"] = time_ms(rotated, 10)
            row["graph_ms"] = _bench.graph_ms(rotated)
            row["gb_per_s_graph"] = n * k // 2 / row["graph_ms"] / 1e6
            row.update(bound(2 * m * k * n, nbytes, PEAK_INT8))
            report["proto_w4_gemv_and_err"].append(row["max_abs_err"])
            emit(row)
            if not ok:
                fail(f"T11 at K {k} N {n} disagrees with its plain version")
        del xq, w4, got, want, copies, rotated
        torch.cuda.empty_cache()

    # T4 at the DiT's joint attention: RMS-normed q and k, a normal key bias
    # with batch 1's last 64 keys blocked; first its quantize, codes and
    # scales against the plain version's bits, then at S 1088 (a partial
    # last 128-key tile), then at 8448 with and without the quantize, beside
    # K1 on the same q, k and v
    t4_ptxas = hopper_ptxas(pi.ATTENTION, "int8qk_hopper_kernel", ())
    quant_ptxas = ptxas_report(f"{_build.library_path(pi.ATTENTION)}.log",
                               "int8qk_rowquant_kernel").get((), {})
    if not quant_ptxas or quant_ptxas.get("spill_store_bytes") or quant_ptxas.get(
            "spill_load_bytes"):
        fail(f"int8qk_rowquant_kernel: ptxas reports spills or no entry: {quant_ptxas}")

    def t4_inputs(b, n_h, sq, sk):
        q, k = _rms(randn(b, n_h, sq, 128)).bfloat16(), _rms(randn(b, n_h, sk, 128)).bfloat16()
        v = randn(b, n_h, sk, 128).bfloat16()
        bias = randn(b, 1, sk) * 0.5
        bias[1, :, -64:] = -1e30
        return q, k, v, bias

    b, n_h, s, d = 2, 24, 1088, 128
    q, k, v, bias = t4_inputs(b, n_h, s, s)
    out, ref = t4.fixedmax_int8qk(q, k, v, bias), t4.fixedmax_int8qk_reference(q, k, v, bias)
    torch.cuda.synchronize()
    row = _attention_row("int8_probe", "proto_int8qk_s1088", [b, n_h, s, s], out, ref, compare)
    row["repeat_bits_equal"] = repeats_equal(lambda: t4.fixedmax_int8qk(q, k, v, bias), out)
    emit(row)
    t4_s1088_err = row["max_abs_err"]
    if not (_attention_ok(row) and row["repeat_bits_equal"]):
        fail("T4 at S 1088 disagrees with its plain version")
    del q, k, v, bias, out, ref

    s = 8448
    q, k, v, bias = t4_inputs(b, n_h, s, s)
    got, want = pi.launch_rowquant(q, k), pi.rowquant_scaled(q, k)
    row = {"phase": "int8_probe", "case": "proto_int8qk_quant", "shape": [b, n_h, s, d],
           "codes_and_scales_equal": all(same_bits(a, w) for a, w in zip(got, want)),
           "max_abs_err": max(max_err(a, w) for a, w in zip(got, want)),
           "repeat_bits_equal": all(same_bits(a, w) for a, w in zip(pi.launch_rowquant(q, k),
                                                                    got)),
           "ptxas": quant_ptxas}
    del got, want
    nbytes = 2 * q.numel() * 2 + 2 * q.numel() + 2 * 4 * q.numel() // d
    record("proto_int8qk_quant", row,
           row["codes_and_scales_equal"] and row["repeat_bits_equal"],
           lambda: pi.launch_rowquant(q, k), lambda: pi.rowquant_scaled(q, k), None,
           bound(0, nbytes, PEAK_INT8), rate_bytes=nbytes)
    out, ref = t4.fixedmax_int8qk(q, k, v, bias), t4.fixedmax_int8qk_reference(q, k, v, bias)
    torch.cuda.synchronize()
    row = _attention_row("int8_probe", "proto_int8qk", [b, n_h, s, s], out, ref, compare)
    row["repeat_bits_equal"] = repeats_equal(lambda: t4.fixedmax_int8qk(q, k, v, bias), out)
    row["graph_bits_equal"] = graph_equals_eager(lambda: t4.fixedmax_int8qk(q, k, v, bias))
    row["ptxas"] = t4_ptxas["int8qk_hopper_kernel"]
    row["sdpa_ms_context"] = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), 10)
    mask = torch.ones(b, s, dtype=torch.bool, device=dev)
    row["k1_ms_same_inputs"] = time_ms(lambda: fa.flash_attention_bnsd(q, k, v, key_mask=mask),
                                       10)
    row["k1_graph_ms_same_inputs"] = _bench.graph_ms(
        lambda: fa.flash_attention_bnsd(q, k, v, key_mask=mask))
    operands = t4._kernel_operands(q, k, v, bias)
    row["kernel_alone_ms"] = time_ms(lambda: pi.launch_int8qk(*operands), 10)
    row["kernel_alone_graph_ms"] = _bench.graph_ms(lambda: pi.launch_int8qk(*operands))
    del operands, mask
    qk_ops = pv_ops = 2 * b * n_h * s * s * d
    # the two products at their own peaks: operations / peak in seconds (peak 1)
    record("proto_int8qk", row,
           _attention_ok(row) and row["repeat_bits_equal"] and row["graph_bits_equal"],
           lambda: t4.fixedmax_int8qk(q, k, v, bias),
           lambda: t4.fixedmax_int8qk_reference(q, k, v, bias), None,
           bound(qk_ops / PEAK_INT8 + pv_ops / PEAK_BF16, 4 * 2 * q.numel() + 4 * b * s, 1.0))
    report["proto_int8qk_err"].append(t4_s1088_err)
    del q, k, v, bias, out, ref
    torch.cuda.empty_cache()

    # T6 at the DiT's [2 x 8448, 9216] QKV activation
    for dtype, name in ((torch.bfloat16, "proto_ew_scale_bf16"),
                        (torch.float32, "proto_ew_scale_fp32")):
        x = (randn(16896, 9216) * 0.1).to(dtype)
        c, d = (t.to(dev) for t in t6.scale_constants(dtype))
        got, want = t6.pallas_scale(x), t6.pallas_scale_reference(x)
        one_call = torch.addcmul(d, x, c)
        row = {"phase": "int8_probe", "case": name, "shape": list(x.shape),
               "equal": bool(torch.equal(got, want)), "max_abs_err": max_err(got, want),
               "addcmul_equal": bool(torch.equal(one_call, want))}
        nbytes = 2 * x.numel() * x.element_size()
        record(name, row, row["equal"], lambda: t6.pallas_scale(x),
               lambda: t6.pallas_scale_reference(x), lambda: torch.addcmul(d, x, c),
               bound(2 * x.numel(), nbytes, PEAK_FP32), rate_bytes=nbytes)
        del x, got, want, one_call
    torch.cuda.empty_cache()

    # the probes' path: each ported tool, as a user runs it
    reset_counts()
    rows = [r for tool in (t9, t10, t12, t11, t4, t6) for r in tool.main()]
    torch.cuda.synchronize()
    launches = {name: counts()[name] for name in pi.VARIANTS}
    for r in rows:
        emit({"phase": "int8_tool", **r})
    emit({"phase": "int8_tools", "launches": launches})
    torch.cuda.empty_cache()
    return launches


# the load phase's depth cut (full widths): DiT blocks, VL text layers, ViT blocks
LOAD_DEPTH = (6, 4, 8)
LOAD_REL_L2 = 1e-3       # the CLI's image against the direct call's, same weights


def load_phase(gen, steps: int, image, sweep_images: list) -> dict:
    """Checkpoint loading at full width, the depth cut to LOAD_DEPTH (about
    10 GB): a random bf16 pipeline written by
    ``tools/make_synthetic_checkpoint`` into a temporary directory (with a
    rank-128 finetuned export from ``save_checkpoint``), read back by
    ``from_pretrained`` (every parameter bit for bit), then
    ``cli.validate.main`` with the fake tokenizer, the kernels, ``steps``
    steps and the reasoner off: its PNG against the direct ``__call__`` on
    the in-memory pipeline; again with ``--lora_path`` against the in-memory
    pipeline's live LoRA; again with ``--quantize int4`` against the bf16
    call.  Rates in GB/s of tensor data.  Then phase 15(a) on the tree,
    ``sweep_phase`` over ``sweep_images`` (two 1024^2 and one 768x512).  The
    directory is removed at the end.  Returns the CLI run's launches."""
    import dataclasses
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from physicedit_torch.cli import validate as cli
    from physicedit_torch.pipeline.edit_pipeline import PhysicEditPipeline
    from physicedit_torch.pipeline.testing import SIZES, FakeTokenizer, random_pipeline
    from physicedit_torch.tools import make_synthetic_checkpoint as synth

    n_dit, n_text, n_vit = LOAD_DEPTH
    full = SIZES["full"]
    dims = dataclasses.replace(
        full, dinov2=None, dit=dataclasses.replace(full.dit, num_layers=n_dit),
        text=dataclasses.replace(full.text, num_layers=n_text),
        vision=dataclasses.replace(full.vision, depth=n_vit, fullatt_block_indexes=tuple(
            i for i in full.vision.fullatt_block_indexes if i < n_vit)))
    dev = gen.device
    pipe = random_pipeline(dims, dev, torch.bfloat16, gen)
    trainable = synth.random_trainable(pipe, 128, 768, gen)
    base = tempfile.mkdtemp(prefix="physicedit_load_")
    try:
        torch.cuda.synchronize()
        info = synth.write_tree(pipe, base, trainable)
        row = {"phase": "load", "depth_cut": {"dit_blocks": n_dit, "text_layers": n_text,
                                              "vit_blocks": n_vit},
               "tree_gb": info["bytes"] / 1e9, "write_s": info["seconds"],
               "write_gb_per_s": info["bytes"] / 1e9 / info["seconds"],
               "disk_free_gb": shutil.disk_usage(base).free / 1e9}
        paths = cli.find_model_files(base)
        read_bytes = sum(os.path.getsize(f) for p in paths
                         for f in (p if isinstance(p, list) else [p]))
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loaded = PhysicEditPipeline.from_pretrained(paths, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        row.update({"read_s": seconds, "read_gb": read_bytes / 1e9,
                    "read_gb_per_s": read_bytes / 1e9 / seconds,
                    "resident_gb_after_load": (torch.cuda.memory_allocated() - before) / 1e9,
                    "attn_impl": loaded.attn_impl})
        mismatched = [f"{name}.{k}" for name in ("dit", "vae", "text", "vision")
                      for k, v in getattr(pipe, name).state_dict().items()
                      if not torch.equal(getattr(loaded, name).state_dict()[k], v)]
        row["params_compared"] = sum(len(getattr(pipe, n).state_dict())
                                     for n in ("dit", "vae", "text", "vision"))
        row["params_not_bitwise_equal"] = mismatched[:5]
        del loaded
        gc.collect()
        torch.cuda.empty_cache()
        emit(row)
        if mismatched:
            fail(f"from_pretrained differs from the written pipeline in {mismatched[:5]}")

        def fake_tokenizer(self, path):
            tok = FakeTokenizer()
            self.tokenizer = tok
            self.boi_token_id = tok.specials["<begin_of_img>"]
            self.eoi_token_id = tok.specials["<end_of_img>"]
            # the template's prefix lengths go with the tokenizer
            self.edit_drop_idx, self.t2i_drop_idx = pipe.edit_drop_idx, pipe.t2i_drop_idx

        real_load_tokenizer = PhysicEditPipeline.load_tokenizer
        PhysicEditPipeline.load_tokenizer = fake_tokenizer
        in_path = os.path.join(base, "in.png")
        image.save(in_path)
        resized = cli.resize_image(image)

        def direct():
            return np.asarray(pipe("make the glass fall off the table", edit_image=resized,
                                   seed=SEED + 9, num_inference_steps=steps, cfg_scale=4.0,
                                   height=resized.size[1], width=resized.size[0],
                                   have_text_reasoning=False), np.float32)

        # the base tree carries no adapter (the finetuned export does)
        adapter, pipe.adapter = pipe.adapter, None
        plain = direct()
        pipe.adapter = adapter
        runs = {"cli": [], "cli_lora": ["--lora_path", info["paths"]["finetuned"]],
                "cli_int4": ["--quantize", "int4"]}
        launches = None
        for name, extra in runs.items():
            want = plain
            if name == "cli_lora":      # the export's LoRA live, and its dual adapter
                pipe.dit_lora = trainable.lora
                want = direct()
                pipe.dit_lora = None
            out_path = os.path.join(base, f"{name}.png")
            reset_counts()
            t0 = time.perf_counter()
            loaded = cli.main(["--prompt", "make the glass fall off the table", "--image_path",
                               in_path, "--save_path", out_path, "--base_model_path", base,
                               "--seed", str(SEED + 9), "--num_inference_steps", str(steps),
                               "--no_text_reasoning", "--attn_impl", "kernels", "--device",
                               str(dev), *extra])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            run_launches = counts()
            got = np.asarray(Image.open(out_path), np.float32)
            rel = float(np.linalg.norm(got - want) / np.linalg.norm(want - want.mean()))
            limit = {"cli": LOAD_REL_L2, "cli_lora": PIPE_REL_L2, "cli_int4": W4_REL_L2}[name]
            emit({"phase": "load_" + name, "seconds": seconds, "size": list(got.shape),
                  "rel_l2": rel, "limit": limit, "equal": bool(np.array_equal(got, want)),
                  "adapters": sorted(loaded.adapters), "launches": run_launches})
            del loaded
            gc.collect()
            torch.cuda.empty_cache()
            if got.shape != want.shape or not rel <= limit:
                fail(f"load {name}: the CLI's image is {rel:.2e} rel-L2 from the in-memory "
                     f"pipeline's (limit {limit})")
            kernels = ("fixedmax_attention", "gqa_causal_attention") + (
                ("w4a8_matmul",) if name == "cli_int4" else ())
            if min(run_launches[k] for k in kernels) == 0:
                fail(f"load {name}: the CLI's edit launched no {kernels}: {run_launches}")
            launches = launches or run_launches
        # 15(a): the sweep's serving path on this tree, with the fake tokenizer
        sweep_phase(base, sweep_images, dev)
        # 16: training through its CLI on this tree, with the fake tokenizer
        train_cli_phase(base, dev)
        PhysicEditPipeline.load_tokenizer = real_load_tokenizer
    finally:
        shutil.rmtree(base, ignore_errors=True)
    del pipe, trainable
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# 16. training through its CLI on the load phase's tree; the cuts: 4 videos
# (a fifth filtered out) of 49 frames at 480x832, one epoch a run, (c)
# resumes mid-epoch, (d)-(f) train from (a)'s bundles, (f) on two of them
TRAIN_CLI_VIDEOS = 4
TRAIN_CLI_FRAMES = 49
TRAIN_CLI_HW = (480, 832)
EVAL_STEPS = 40          # Trainer.evaluate's default, as the training loop calls it
DISTILL_STEPS = 4        # the distillation loss's denoise unroll
# its LoRA gradients, all together, card against CPU (rel-L2): 4x the H100
# reading (2.5e-3) and 3x the spread between two bf16 attentions on the CPU
# (the plain fixed-max and the dense softmax, 3.0e-3): every gradient here
# passes through bf16 DiT activations 4 times (bf16 against fp32: 0.13), so
# TRAIN_GRAD_REL, set where the adapters' gradients dominate, is below the
# noise of any bf16 implementation; the loss and each leaf keep TRAIN_*'s
DISTILL_GRAD_REL = 1e-2
D1_STEPS = 50            # the bf16 / fp32 drift run (read, not gated)
D1_LR = 1e-4


def write_dinov2(base: str, dev, gen) -> str:
    """A random DINOv2-B/14 (the port's ``DINOV2_BASE``: hidden 768, 12
    layers, 12 heads, patch 14, 4 registers, a 37 x 37 position table) in
    the reference layout with its config.json under ``base/dinov2``."""
    import torch

    from physicedit_torch.core.params import materialize
    from physicedit_torch.io import convert as C
    from physicedit_torch.io.safetensors_io import save_safetensors
    from physicedit_torch.models.dinov2 import (DINOV2_BASE, DINOV2_BASE_POS_GRID, DinoV2,
                                                init_dinov2_)

    dino = init_dinov2_(materialize(DinoV2(DINOV2_BASE, DINOV2_BASE_POS_GRID, torch.float32),
                                    dev), gen)
    folder = os.path.join(base, "dinov2")
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, "model.safetensors")
    save_safetensors(C.dinov2_to_state_dict(dino), path)
    with open(os.path.join(folder, "config.json"), "w") as f:
        json.dump(C.dinov2_hf_config(dino.cfg), f)
    return path


class TrainProbe:
    """Records, while it is entered, what each ``Trainer.step`` launched
    (and, with ``watch_moves``, whether the trainable moved), each
    ``Trainer.evaluate``'s launches, each step's batch noise (the first
    kept), and whether ``Trainer.resume`` left the trainable equal to the
    checkpoint's tensors bit for bit."""

    def __init__(self, want_step: dict):
        self.want_step, self.watch_moves = want_step, False
        self.steps, self.evals, self.resumes, self.first_noise = [], [], [], None

    def __enter__(self):
        import numpy as np
        import torch

        from physicedit_torch.io.safetensors_io import load_state_dict
        from physicedit_torch.train import checkpoint as ckpt
        from physicedit_torch.train.trainer import Trainer

        self.real = Trainer.step, Trainer.evaluate, Trainer.resume
        real_step, real_eval, real_resume = self.real
        probe = self

        def step(trainer, batch):
            if probe.first_noise is None:
                probe.first_noise = batch["noise"].float().cpu()
            before = [p.detach().clone() for p in trainer.trainable.parameters()] \
                if probe.watch_moves else None
            c0 = counts()
            m = real_step(trainer, batch)
            c1 = counts()
            row = {"step": trainer.global_step, "position": trainer._epoch_pos,
                   "loss": m["loss"], "seconds": m["seconds"],
                   "launches": {k: c1[k] - c0[k] for k in probe.want_step}}
            if before is not None:
                row["moved"] = any(not torch.equal(a, p)
                                   for a, p in zip(before, trainer.trainable.parameters()))
            probe.steps.append(row)
            return m

        def evaluate(trainer, *a, **kw):
            c0 = counts()
            out = real_eval(trainer, *a, **kw)
            c1 = counts()
            probe.evals.append({k: c1[k] - c0[k] for k in ("fixedmax_attention",
                                                            "gqa_causal_attention")})
            return out

        def resume(trainer, resume_from):
            real_resume(trainer, resume_from)
            from physicedit_torch.train.checkpoint import export_trainable_state_dict

            want = load_state_dict(ckpt.resolve_resume(resume_from)[0])
            got = export_trainable_state_dict(trainer.trainable)
            probe.resumes.append(sorted(got) == sorted(want) and all(
                np.array_equal(got[k], want[k].float().numpy()) for k in want))

        Trainer.step, Trainer.evaluate, Trainer.resume = step, evaluate, resume
        return self

    def __exit__(self, *exc):
        from physicedit_torch.train.trainer import Trainer

        Trainer.step, Trainer.evaluate, Trainer.resume = self.real

    def take(self) -> tuple:
        out = self.steps, self.evals, self.resumes
        self.steps, self.evals, self.resumes, self.first_noise = [], [], [], None
        return out


def train_cli_phase(base: str, dev) -> None:
    """16. ``physicedit_torch.cli.train.main`` on the load phase's tree at
    ``LOAD_DEPTH`` (full widths, random weights) with a DINOv2-B/14 beside
    it, over a PhysicTran-layout folder of 4 videos (49 frames, 480x832; a
    fifth in the filter file), with the fake tokenizer (the caller's): (a)
    the data-process mode, whose first bundle must equal a direct
    ``Trainer.preprocess`` bit for bit; (b) raw-video training with two
    loader threads, saves and evals every 2 steps: exact K1 / K8 launches a
    step, exact K1 / K2 launches an eval; (c) resume from (b)'s step-2
    checkpoint: the trainable equal to the file's tensors bit for bit,
    exactly the epoch's two remaining items trained; (d) training from
    (a)'s bundles, whose noise is drawn anew; (e) Adafactor with
    accumulation 2, the trainable moving on even calls only; (f) the W4
    lane, exact K1 / K8 / K3 / K9 launches a step.  Videos are mp4 through
    imageio where it can write and read them, else the stand-in reader of
    ``train/synthetic.py`` (the line says which)."""
    import gc
    import shutil

    import numpy as np
    import torch

    from physicedit_torch.cli import train as cli
    from physicedit_torch.train import synthetic
    from physicedit_torch.train.train_step import optimizer_state_bytes
    from physicedit_torch.train.trainer import bundle_array

    t_phase = time.perf_counter()
    n_blocks, n_text = LOAD_DEPTH[0], LOAD_DEPTH[1]
    h, w = TRAIN_CLI_HW
    dino_path = write_dinov2(base, dev, torch.Generator(dev).manual_seed(SEED + 16))
    data = os.path.join(base, "physictran")
    decoder, why = "imageio", None
    try:
        paths = synthetic.write_physictran_tree(data, TRAIN_CLI_VIDEOS, 1, TRAIN_CLI_FRAMES, w,
                                                h, SEED, encode="imageio")
        import imageio

        reader = imageio.get_reader(paths[0])
        first = next(iter(reader))
        reader.close()
        if first.shape != (h, w, 3):
            raise ValueError(f"imageio read back a frame of {first.shape}")
    except Exception as e:  # noqa: BLE001 -- no imageio or no mp4 backend: the stand-in
        decoder, why = "stand-in", f"{type(e).__name__}: {e}"[:200]
        shutil.rmtree(data, ignore_errors=True)
        synthetic.write_physictran_tree(data, TRAIN_CLI_VIDEOS, 1, TRAIN_CLI_FRAMES, w, h, SEED)
    common = ["--dataset_base_path", data, "--base_model_path", base, "--dinov2_path",
              dino_path, "--height", str(h), "--width", str(w), "--num_frames",
              str(TRAIN_CLI_FRAMES), "--num_epochs", "1", "--attn_impl", "kernels",
              "--device", str(dev), "--seed", str(SEED + 16), "--loader_workers", "0"]
    out = {name: os.path.join(base, "train_" + name) for name in "abcdef"}
    want = {False: {**train_launch_counts(n_blocks, False),
                    **train_regime_counts(n_blocks, False)},
            True: {**train_launch_counts(n_blocks, True), **train_regime_counts(n_blocks, True)}}
    want_eval = {"fixedmax_attention": EVAL_STEPS * n_blocks, "gqa_causal_attention": n_text}
    reader_ctx = contextlib.nullcontext() if decoder == "imageio" else synthetic.stand_in_reader()

    def run(argv):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = cli.main(common + argv)
        torch.cuda.synchronize()
        return trainer, time.perf_counter() - t0

    def release(trainer):
        del trainer.pipe, trainer.trainable, trainer.opt_state
        gc.collect()
        torch.cuda.empty_cache()

    def check_steps(name, steps, quantized, n):
        bad = [r for r in steps if r["launches"] != want[quantized]]
        if len(steps) != n or bad:
            fail(f"train_cli ({name}): {len(steps)} steps (wanted {n}); launches {bad[:1]} "
                 f"differ from {want[quantized]}")
        if not all(math.isfinite(r["loss"]) for r in steps):
            fail(f"train_cli ({name}): a loss is not finite: {[r['loss'] for r in steps]}")

    with reader_ctx, TrainProbe(want[False]) as probe:
        # (a) the data-process mode
        trainer, seconds = run(["--data_process_output", out["a"]])
        bundles = sorted(os.listdir(out["a"]))
        trainer.rng = np.random.default_rng(trainer.cfg.seed)
        direct = trainer.preprocess(trainer.dataset[0])
        with np.load(os.path.join(out["a"], bundles[0])) as z:
            equal = sorted(z.files) == sorted(direct) and all(
                np.array_equal(z[k], bundle_array(k, v)) for k, v in direct.items())
            bundle_noise = torch.from_numpy(z["noise"])
        emit({"card": card_name(), "phase": "train_cli_process", "decoder": decoder,
              "decoder_note": why, "videos_kept": len(trainer.dataset), "bundles": len(bundles),
              "first_bundle_bit_equal": equal, "seconds": seconds,
              "joint_tokens": int(direct["prompt_emb"].shape[1]
                                  + 2 * direct["edit_tokens"].shape[1])})
        del direct
        release(trainer)
        if len(bundles) != TRAIN_CLI_VIDEOS or not equal:
            fail(f"train_cli (a): {len(bundles)} bundles, first bit-equal {equal}")

        # (b) raw videos, loader threads, saves and evals every 2 steps
        trainer, seconds = run(["--output_path", out["b"], "--loader_workers", "2",
                                     "--save_every_n_steps", "2", "--eval_every_n_steps", "2"])
        peak = torch.cuda.max_memory_allocated() / 1e9
        steps, evals, _ = probe.take()
        files = sorted(os.listdir(out["b"]))
        emit({"card": card_name(), "phase": "train_cli_raw", "seconds": seconds,
              "s_per_step": [r["seconds"] for r in steps], "losses": [r["loss"] for r in steps],
              "launches_per_step": steps[0]["launches"], "launches_expected": want[False],
              "eval_launches": evals, "eval_expected": want_eval, "eval_steps": EVAL_STEPS,
              "peak_gb": peak, "files": files})
        check_steps("b", steps, False, TRAIN_CLI_VIDEOS)
        for f in ("step-2.safetensors", "step-4.safetensors", "eval-step-2.jpg",
                  "eval-step-4.jpg"):
            if f not in files:
                fail(f"train_cli (b) wrote no {f}: {files}")
        if evals != [want_eval, want_eval]:
            fail(f"train_cli (b): eval launches {evals}, wanted two of {want_eval}")
        release(trainer)

        # (c) resume from (b)'s mid-epoch checkpoint
        trainer, seconds = run(["--output_path", out["c"], "--resume_from",
                                     os.path.join(out["b"], "step-2.safetensors")])
        steps, _, resumes = probe.take()
        row = {"card": card_name(), "phase": "train_cli_resume", "seconds": seconds,
               "trainable_equal_to_checkpoint": resumes,
               "start": [trainer.start_epoch, trainer.skip_batches],
               "positions_trained": [r["position"] for r in steps],
               "global_step": trainer.global_step}
        emit(row)
        check_steps("c", steps, False, TRAIN_CLI_VIDEOS - 2)
        if resumes != [True] or row["positions_trained"] != [3, 4] or trainer.global_step != 4:
            fail(f"train_cli (c): resume {row}")
        release(trainer)

        # (d) training from (a)'s bundles: the noise is drawn anew
        trainer, seconds = run(["--output_path", out["d"], "--cached_inputs_path",
                                     out["a"]])
        noise = probe.first_noise
        steps, evals, _ = probe.take()
        redrawn = noise.shape == bundle_noise.shape and not torch.equal(noise, bundle_noise)
        emit({"card": card_name(), "phase": "train_cli_cached", "seconds": seconds,
              "s_per_step": [r["seconds"] for r in steps], "losses": [r["loss"] for r in steps],
              "noise_redrawn": redrawn})
        check_steps("d", steps, False, TRAIN_CLI_VIDEOS)
        if not redrawn:
            fail("train_cli (d): the cached run trained on the bundle's noise")
        release(trainer)

        # (e) Adafactor, accumulation 2: the trainable moves on even calls only
        probe.watch_moves = True
        trainer, seconds = run(["--output_path", out["e"], "--cached_inputs_path",
                                     out["a"], "--optimizer", "adafactor",
                                     "--gradient_accumulation_steps", "2"])
        probe.watch_moves = False
        steps, _, _ = probe.take()
        moved = [r["moved"] for r in steps]
        trainable_bytes = sum(p.numel() * p.element_size()
                              for p in trainer.trainable.parameters())
        emit({"card": card_name(), "phase": "train_cli_adafactor", "seconds": seconds,
              "s_per_step": [r["seconds"] for r in steps], "moved": moved,
              "optimizer_state_bytes": optimizer_state_bytes(trainer.opt_state),
              "accumulator_bytes": sum(t.numel() * t.element_size()
                                       for t in trainer.opt_state.acc.values()),
              "trainable_bytes": trainable_bytes,
              "adamw_fp32_state_bytes": 2 * trainable_bytes})
        check_steps("e", steps, False, TRAIN_CLI_VIDEOS)
        if moved != [i % 2 == 1 for i in range(TRAIN_CLI_VIDEOS)]:
            fail(f"train_cli (e): the trainable moved on calls {moved}")
        release(trainer)

        # (f) the W4 lane, on two of the bundles
        two = os.path.join(base, "train_bundles_2")
        os.makedirs(two, exist_ok=True)
        for name in bundles[:2]:
            shutil.copy(os.path.join(out["a"], name), two)
        probe.want_step = want[True]
        trainer, seconds = run(["--output_path", out["f"], "--cached_inputs_path", two,
                                     "--quantize_frozen", "w4"])
        peak = torch.cuda.max_memory_allocated() / 1e9
        steps, _, _ = probe.take()
        emit({"card": card_name(), "phase": "train_cli_w4", "seconds": seconds,
              "s_per_step": [r["seconds"] for r in steps], "losses": [r["loss"] for r in steps],
              "launches_per_step": steps[0]["launches"] if steps else None,
              "launches_expected": want[True], "peak_gb": peak})
        check_steps("f", steps, True, 2)
        release(trainer)
    emit({"card": card_name(), "phase": "train_cli", "seconds": time.perf_counter() - t_phase,
          "depth_cut": LOAD_DEPTH, "videos": TRAIN_CLI_VIDEOS, "frames": TRAIN_CLI_FRAMES,
          "size": list(TRAIN_CLI_HW), "eval_steps": EVAL_STEPS,
          "cuts": "one epoch a run; (c) resumes mid-epoch; (d)-(f) train from (a)'s "
                  "bundles, (f) from two"})


def distill_phase(small, dev) -> None:
    """16, the distillation loss on the card: ``direct_distill_loss``
    through a DISTILL_STEPS-step unroll of phase 10's small head_dim-128
    DiT in bf16 with a rank-8 LoRA (K1 forward, K8 backward at every step)
    against the same weights and inputs on the CPU (plain versions): the
    loss within TRAIN_LOSS_REL, all LoRA gradients together within
    DISTILL_GRAD_REL and each leaf within TRAIN_LEAF_REL; exact K1 / K8
    launches.  Beside it, read: the same gradients on the CPU through the
    dense softmax instead of K1's plain version (two bf16 attentions)."""
    import copy

    import torch

    from physicedit_torch.lora import init_dit_lora
    from physicedit_torch.ops import rope as m_rope
    from physicedit_torch.pipeline.testing import random_pipeline
    from physicedit_torch.sampling import flow_match as fm
    from physicedit_torch.train.loss import direct_distill_loss

    gen = torch.Generator(dev).manual_seed(SEED + 17)
    dit = random_pipeline(small, dev, torch.bfloat16, gen).dit
    lora = init_dit_lora(dit.cfg, 8, torch.float32, dev, gen)
    with torch.no_grad():
        for leaf in lora.children():
            leaf.B.normal_(0.0, 0.02, generator=gen)
    lora.requires_grad_(True)
    s_t, hw = 64, 16
    mask = torch.ones(1, s_t, dtype=torch.bool, device=dev)
    mask[0, 50:] = False
    inputs = {"latents0": torch.randn(1, hw, hw, 16, device=dev, generator=gen),
              "extra": torch.randn(1, (hw // 2) ** 2, 64, device=dev, generator=gen),
              "emb": torch.randn(1, s_t, dit.cfg.txt_in_dim, device=dev,
                                 generator=gen).bfloat16(),
              "mask": mask,
              "target": torch.randn(1, hw, hw, 16, device=dev, generator=gen)}
    ropes = [torch.as_tensor(r, dtype=torch.float32) for r in m_rope.build_rope_tables(
        [(1, hw // 2, hw // 2), (1, hw // 2, hw // 2)], s_t, axes_dim=small.rope_axes)]
    sched = fm.build_schedule(DISTILL_STEPS, fm.QWEN_IMAGE_CONFIG,
                              dynamic_shift_len=(hw // 2) ** 2)

    def loss_and_grads(dit, lora, device, attn_impl="kernels"):
        x = {k: v.to(device) for k, v in inputs.items()}
        for p in lora.parameters():
            p.grad = None
        loss = direct_distill_loss(dit, x["latents0"], x["extra"], x["emb"], x["mask"],
                                   [r.to(device) for r in ropes], sched, x["target"], lora=lora,
                                   attn_impl=attn_impl)
        loss.backward()
        return loss.item(), {n: p.grad.detach().float().cpu().clone()
                             for n, p in lora.named_parameters()}

    reset_counts()
    loss_c, grads_c = loss_and_grads(dit, lora, dev)
    launches = counts()
    dit_h, lora_h = copy.deepcopy(dit).cpu(), copy.deepcopy(lora).cpu()
    loss_h, grads_h = loss_and_grads(dit_h, lora_h, "cpu")
    _, grads_d = loss_and_grads(dit_h, lora_h, "cpu", "dense")

    def flat(grads):
        return torch.cat([g.reshape(-1) for g in grads.values()])

    per_leaf = {n: rel_l2(grads_c[n], grads_h[n]) for n in grads_c}
    worst = max(per_leaf, key=per_leaf.get)
    want = {"fixedmax_attention": DISTILL_STEPS * dit.cfg.num_layers,
            "fixedmax_attention_bwd": DISTILL_STEPS * dit.cfg.num_layers}
    row = {"card": card_name(), "phase": "train_distill_vs_cpu", "steps": DISTILL_STEPS,
           "loss_card": loss_c, "loss_cpu": loss_h, "loss_rel": abs(loss_c - loss_h) / abs(loss_h),
           "loss_limit": TRAIN_LOSS_REL,
           "grads_rel_l2": rel_l2(flat(grads_c), flat(grads_h)), "grads_limit": DISTILL_GRAD_REL,
           "cpu_plain_vs_dense_grads_rel_l2": rel_l2(flat(grads_d), flat(grads_h)),
           "worst_leaf": worst,
           "worst_leaf_rel_l2": per_leaf[worst], "leaf_limit": TRAIN_LEAF_REL,
           "launches": {k: launches[k] for k in want}, "launches_expected": want}
    emit(row)
    if not (row["loss_rel"] <= TRAIN_LOSS_REL and row["grads_rel_l2"] <= DISTILL_GRAD_REL
            and per_leaf[worst] <= TRAIN_LEAF_REL):
        fail("the distillation loss on the card disagrees with the CPU")
    if row["launches"] != want:
        fail(f"the distillation loss launched {row['launches']}, wanted {want}")
    torch.cuda.empty_cache()


def d1_drift_phase(small, dev) -> None:
    """16, deviation D1 measured (read, not gated): phase 10's small model
    trained D1_STEPS steps at lr D1_LR in the bf16 lane (the port's: bf16
    activations, K1 / K8) and in an fp32 lane (the JAX trainer's: the same
    bf16 weights with fp32 activations, through the dense attention, since
    the kernels take bf16), from the same trainable and the same five
    batches; every 10 steps the loss gap and the trainables' rel-L2 drift
    (of the parameters, and of their change since the start)."""
    import copy
    import dataclasses

    import torch

    from physicedit_torch.models.dinov2 import DinoV2Config
    from physicedit_torch.pipeline.testing import random_pipeline
    from physicedit_torch.profile_train import SyntheticVideo
    from physicedit_torch.train.train_step import train_step
    from physicedit_torch.train.trainer import TrainConfig, Trainer

    gen = torch.Generator(dev).manual_seed(SEED + 18)
    dims = dataclasses.replace(small, dinov2=DinoV2Config(hidden_size=64, num_layers=1,
                                                          num_heads=2), dino_pos_grid=20)
    pipe = random_pipeline(dims, dev, torch.bfloat16, gen)
    data = SyntheticVideo(n=5, width=128, height=128, frames=2, seed=SEED + 18)
    bf16 = Trainer(pipe, data, TrainConfig(learning_rate=D1_LR, lora_rank=8, txt_len_bucket=64),
                   device=dev)
    batches = [bf16.preprocess(data[i]) for i in range(len(data))]
    fp32, dit32 = copy.deepcopy(bf16.trainable), copy.deepcopy(pipe.dit).float()
    state32 = bf16.optimizer.init(fp32)

    def flat(module):
        return torch.cat([p.detach().float().reshape(-1) for p in module.parameters()])

    start = flat(fp32)
    rows = []
    t0 = time.perf_counter()
    for i in range(D1_STEPS):
        batch = batches[i % len(batches)]
        loss_b = bf16.step(batch)["loss"]
        loss_f = train_step(fp32, dit32, bf16.optimizer, state32,
                            dict(batch, prompt_emb=batch["prompt_emb"].float()), bf16.t_min,
                            bf16.t_max, use_remat=True, attn_impl="dense")["loss"].item()
        if (i + 1) % 10 == 0:
            pb, pf = flat(bf16.trainable), flat(fp32)
            rows.append({"step": i + 1, "loss_bf16": loss_b, "loss_fp32": loss_f,
                         "loss_gap_rel": abs(loss_b - loss_f) / abs(loss_f),
                         "params_rel_l2": rel_l2(pb, pf),
                         "change_rel_l2": rel_l2(pb - start, pf - start)})
    emit({"card": card_name(), "phase": "d1_drift", "gated": False, "lr": D1_LR,
          "steps": D1_STEPS, "batches": len(batches), "seconds": time.perf_counter() - t0,
          "rows": rows})
    del pipe, bf16, fp32, dit32, state32, batches
    torch.cuda.empty_cache()


def _rms(x):
    """The DiT RMS-norms q and k before attention."""
    import torch

    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True))


def eligen_phase(pipe, image, steps: int, n_blocks: int, n_layers: int) -> dict:
    """Two full-width EliGen edits at 1024^2 (two entity prompts and masks,
    CFG 4 with the entities on the negative row too, reasoner off): full CFG,
    then ``cfg_truncate_step = steps // 2``.  Each must launch K7 once per
    block and step and K1 never, and K2 once per layer for the prompt encode
    and the entity encode (one chunk each).  Returns the launches of the
    full-CFG edit."""
    import numpy as np
    import torch

    k2_want = n_layers * (1 + -(-len(ENTITY_PROMPTS) // 4))
    first = None
    for trunc in (None, steps // 2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = pipe("make the glass fall off the table and shatter", edit_image=image,
                   cfg_scale=4.0, cfg_truncate_step=trunc, height=1024, width=1024,
                   seed=SEED + 6, num_inference_steps=steps, have_text_reasoning=False,
                   eligen_entity_prompts=ENTITY_PROMPTS,
                   eligen_entity_masks=entity_masks(1024, 1024), eligen_enable_on_negative=True)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
        launches = counts()
        arr = np.asarray(out, np.float32)
        tm = pipe.timings
        row = {"phase": "eligen_edit", "size": [1024, 1024], "steps": steps,
               "cfg_truncate_step": trunc, "joint_tokens": tm["joint_tokens"],
               "total_ms": total, "eligen_bias_ms": tm["eligen_bias"],
               "prompt_encode_ms": tm["prompt_encode"], "denoise_ms": tm["denoise"],
               "denoise_ms_per_step": tm["denoise"] / steps,
               "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
               "image_std": float(arr.std()), "launches": launches,
               "k7_expected": steps * n_blocks, "k2_expected": k2_want}
        emit(row)
        if (launches["fixedmax_attention_bias"] != steps * n_blocks
                or launches["fixedmax_attention"] != 0
                or launches["gqa_causal_attention"] != k2_want):
            fail(f"EliGen launch counts {launches} differ from K7 {steps * n_blocks}, K1 0, "
                 f"K2 {k2_want}")
        if out.size != (1024, 1024) or not np.isfinite(arr).all() or arr.std() == 0.0:
            fail("the EliGen image is not finite, is constant or has the wrong size")
        first = first or launches
    return first


def serving_phase(pipe, images: dict, steps: int, n_blocks: int, edit):
    """Batched serving at full width, reasoner off: the two single edits,
    then ``edit_batch`` of both (one denoise at B = 4: K1 once per block and
    step), each image within PIPE_REL_L2 of its single edit; then
    ``edit_batch_mixed`` over 1024^2 and 768x512 (sizes and order); then the
    reasoner's decode of 100 tokens at N = 1 and N = 2 rows.  ``edit`` runs a
    single edit with the smoke's prompt.  Returns the first single edit's
    image, the bf16 reference of the W4 lane."""
    import numpy as np
    import torch

    prompts = ["make the glass fall off the table and shatter",
               "melt the ice cube on the warm stove top"]
    ims = [images[(1024, 1024)], images[(1024, 1024, "b")]]
    seeds = [SEED + 4, SEED + 7]
    singles = []
    for p, im, seed in zip(prompts, ims, seeds):
        arr, row = edit(1024, 1024, seed, False, prompt=p, image=im)
        emit({"phase": "serving_single_edit_bf16", **row})
        singles.append(arr)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = pipe.edit_batch(prompts, ims, height=1024, width=1024, seeds=seeds,
                           num_inference_steps=steps, have_text_reasoning=False)
    torch.cuda.synchronize()
    total = (time.perf_counter() - t0) * 1e3
    launches = counts()
    rels = [float(np.linalg.norm(np.asarray(o, np.float32) - s) / np.linalg.norm(s - s.mean()))
            for o, s in zip(outs, singles)]
    tm = pipe.timings
    emit({"phase": "edit_batch", "n": 2, "size": [1024, 1024], "steps": steps,
          "total_ms": total, "denoise_ms_per_step": tm["denoise"] / steps,
          "vae_decode_ms": tm["vae_decode"], "prompt_encode_ms": tm["prompt_encode"],
          "rel_l2_vs_single": rels, "limit": PIPE_REL_L2, "launches": launches,
          "k1_expected": steps * n_blocks,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9})
    if launches["fixedmax_attention"] != steps * n_blocks or launches["fixedmax_attention_bias"]:
        fail(f"edit_batch launches {launches}: K1 must run {steps * n_blocks} times, K7 never")
    if max(rels) > PIPE_REL_L2:
        fail(f"edit_batch images are {rels} rel-L2 from the single edits")

    mixed_ims = [images[(1024, 1024)], images[(768, 512)]]
    t0 = time.perf_counter()
    outs = pipe.edit_batch_mixed(prompts, mixed_ims, seeds=seeds, num_inference_steps=steps,
                                 have_text_reasoning=False)
    torch.cuda.synchronize()
    sizes = [o.size for o in outs]
    emit({"phase": "edit_batch_mixed", "sizes": [list(x) for x in sizes],
          "total_ms": (time.perf_counter() - t0) * 1e3})
    if sizes != [im.size for im in mixed_ims] or not all(
            np.asarray(o, np.float32).std() > 0 for o in outs):
        fail(f"edit_batch_mixed returned sizes {sizes} (or a constant image)")

    for n in (1, 2):
        pipe.timings = {}
        t0 = time.perf_counter()
        pipe.reason_physical_batch(prompts[:n], ims[:n], max_new_tokens=100)
        torch.cuda.synchronize()
        tm = pipe.timings
        emit({"phase": "reasoner_batch", "rows": n, "decode_steps": tm["decode_tokens"],
              "prefill_ms": tm["reasoner_prefill"], "decode_ms": tm["reasoner_decode"],
              "ms_per_decode_step": tm["reasoner_decode"] / max(1, tm["decode_tokens"]),
              "ms_per_row_token": tm["reasoner_decode"] / max(1, n * tm["decode_tokens"]),
              "total_ms": (time.perf_counter() - t0) * 1e3})
    return singles[0]


# ---------------------------------------------------------------------------
# 15. the serving surface
# ---------------------------------------------------------------------------

SWEEP_STEPS = 32          # past --cfg_truncate_step 30: the last two steps run positives only
SWEEP_DECODE_TOKENS = 100  # the sweep's reasoner decode, cut for time (random weights never stop)
SWEEP_PROMPTS = ["make the glass fall off the table and shatter",
                 "melt the ice cube on the warm stove top"]
# The W8A8 edit against the same edit in bf16 (1024^2, 4 steps, reasoner off):
# between the sound readings (about 0.04) and the control with every weight
# code on an int4 grid (about twice that; PERF.md section 6, PR 18).
# Activation-side faults (per-tensor scales, truncated codes) read within a
# tenth of the sound edit, which no image limit can tell apart, so the route
# is also held layer by layer against the CPU, bit for bit (W8A8_ROUTE_ROWS)
W8A8_REL_L2 = 0.05
W8A8_ROUTE_ROWS = 256     # rows of each checked linear's input, evenly spaced
W8A8_DECODE_TOKENS = 50   # the W8A8 reasoner's decode cap (random weights never emit EOS)
W8A8_PROMPT = "make the glass fall off the table and shatter"
REFINER_PROMPT = "一只猫 sits on a red chair by the open window at dusk"
REFINER_TOKENS = 16       # greedy tokens held against the CPU, teacher-forced there
BLOOM_REPEAT_TOKENS = 32  # sampled tokens drawn twice under one seed
QWEN_REFINER_TOKENS = 64  # QwenPrompt's public call, cut from its 512 for time
# bf16 on the card against fp32 on the CPU, the same weights: rel-L2 over the
# compared logit rows (BLOOM, Qwen2); Marian runs fp32 on both (the
# Translator's dtype), TF32 off
REFINER_BF16_REL_L2 = 0.05
REFINER_FP32_REL_L2 = 1e-4


def sweep_phase(base: str, images: list, dev) -> None:
    """15(a). The sweep's serving path on the load phase's full-width tree:
    the port's ``add_serving_args`` with ``--batch_size 2
    --cfg_truncate_step 30 --prompt_rewriter_cmd <a local executable>``,
    ``build_pipeline`` and ``make_prompt_preprocessor``, then
    ``BucketBatcher`` (reasoner on, its decode cut to SWEEP_DECODE_TOKENS;
    SWEEP_STEPS steps) in uniform mode over two 1024^2 items and in mixed
    mode over 1024^2 and 768x512.  Each image
    must equal, bit for bit, a direct ``edit_batch`` / ``edit_batch_mixed``
    call with the rewritten prompts, the same seeds and kwargs; each batch
    must launch K1 SWEEP_STEPS x blocks times per denoise and K2 once per
    layer for each reasoner prefill row and each 4-row prompt-encode chunk."""
    import argparse
    import gc

    import numpy as np
    import torch

    from physicedit_torch.cli import serving
    from physicedit_torch.eval.sweep import BucketBatcher

    p = argparse.ArgumentParser()
    p.add_argument("--base_model_path")
    p.add_argument("--lora_path", default=None)
    p.add_argument("--tokenizer_path", default=None)
    serving.add_serving_args(p, with_rewriter=True)
    rewriter = (f"{sys.executable} -c \"import sys; "
                f"print('serving: ' + sys.stdin.read().strip())\"")
    args = p.parse_args(["--base_model_path", base, "--batch_size", "2", "--cfg_truncate_step",
                         "30", "--prompt_rewriter_cmd", rewriter, "--attn_impl", "kernels",
                         "--device", str(dev)])
    t0 = time.perf_counter()
    pipe = serving.build_pipeline(args)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    real_reason = pipe.reason_physical_batch
    pipe.reason_physical_batch = (lambda prompts, ims, max_new_tokens=1000, **kw:
                                  real_reason(prompts, ims, SWEEP_DECODE_TOKENS, **kw))
    preprocess = serving.make_prompt_preprocessor(args)
    prompts = [preprocess(q) for q in SWEEP_PROMPTS]
    if prompts != ["serving: " + q for q in SWEEP_PROMPTS]:
        fail(f"the prompt rewriter gave {prompts}")
    n_blocks, n_layers = pipe.dit.cfg.num_layers, pipe.text.cfg.num_layers
    seed = SEED + 12
    kw = dict(num_inference_steps=SWEEP_STEPS, cfg_truncate_step=args.cfg_truncate_step)
    for mode, ims in (("uniform", images[:2]), ("mixed", [images[0], images[2]])):
        batcher = BucketBatcher(pipe, args.batch_size, seed, SWEEP_STEPS,
                                pipe_kwargs={"cfg_truncate_step": args.cfg_truncate_step},
                                mixed=mode == "mixed")
        done = {}
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        for i, (q, im) in enumerate(zip(prompts, ims)):
            batcher.add(q, im, i, lambda out, key: done.__setitem__(key, out))
        batcher.flush_all()
        torch.cuda.synchronize()
        batch_ms = (time.perf_counter() - t0) * 1e3
        launches = counts()
        tm = dict(pipe.timings)
        seeds = [seed] * len(ims)
        if mode == "mixed":
            direct = pipe.edit_batch_mixed(prompts, ims, heights=[im.size[1] for im in ims],
                                           widths=[im.size[0] for im in ims], seeds=seeds, **kw)
        else:
            direct = pipe.edit_batch(prompts, ims, height=ims[0].size[1],
                                     width=ims[0].size[0], seeds=seeds, **kw)
        outs = [np.asarray(done[i]) for i in range(len(ims))]
        equal = [bool(np.array_equal(o, np.asarray(d))) for o, d in zip(outs, direct)]
        groups = 2 if mode == "mixed" else 1
        k1_want = groups * SWEEP_STEPS * n_blocks
        k2_want = n_layers * (len(ims) + 1)     # a prefill per row; 2N encodes in one chunk
        emit({"card": card_name(), "phase": "serving_sweep", "mode": mode,
              "depth_cut": list(LOAD_DEPTH),
              "sizes": [list(im.size) for im in ims], "steps": SWEEP_STEPS,
              "cfg_truncate_step": args.cfg_truncate_step, "batch_size": args.batch_size,
              "decode_cap": SWEEP_DECODE_TOKENS,
              "build_pipeline_s": load_s, "batch_ms": batch_ms,
              "denoise_ms": tm.get("denoise"), "decode_tokens": tm.get("decode_tokens"),
              "reasoner_decode_ms": tm.get("reasoner_decode"),
              "prompts": prompts, "bit_equal_to_direct": equal,
              "image_std": [float(o.std()) for o in outs], "launches": launches,
              "k1_expected": k1_want, "k2_expected": k2_want})
        if not all(equal) or [o.shape[:2] for o in outs] != [im.size[::-1] for im in ims]:
            fail(f"BucketBatcher ({mode}) images differ from the direct call: {equal}")
        if not all(np.isfinite(o).all() and o.std() > 0 for o in outs):
            fail(f"BucketBatcher ({mode}) made a constant image")
        if (launches["fixedmax_attention"] != k1_want
                or launches["gqa_causal_attention"] != k2_want):
            fail(f"the {mode} sweep launched K1 {launches['fixedmax_attention']} / K2 "
                 f"{launches['gqa_causal_attention']} times, wanted {k1_want} / {k2_want}")
    del pipe
    gc.collect()
    torch.cuda.empty_cache()


def _per_tensor_rows(x):
    """A W8A8 control: one activation scale for the whole [M, K] tensor in
    place of one a row."""
    import torch

    xf = x.float()
    scale = (xf.abs().amax() / torch.full((), 127.0, device=x.device)).clamp_min(1e-8)
    return (xf / scale).round().clamp(-127, 127).to(torch.int8), scale.expand(x.shape[0], 1)


def _truncated_rows(x):
    """A W8A8 control: activation codes truncated toward zero, not rounded."""
    import torch

    xf = x.float()
    scale = (xf.abs().amax(-1, keepdim=True)
             / torch.full((), 127.0, device=x.device)).clamp_min(1e-8)
    return (xf / scale).clamp(-127, 127).to(torch.int8), scale


def _int4_grid_(model) -> None:
    """A W8A8 control, in place: every int8 weight code moved to the nearest
    of 15 levels (a per-channel int4 grid, scale times 127 / 7)."""
    import torch

    from physicedit_torch.ops.quant import Int8Linear

    for m in model.modules():
        if isinstance(m, Int8Linear):
            step = torch.full((), 127.0 / 7.0, device=m.w_q.device)
            m.w_q.copy_((m.w_q.float() / step).round().clamp(-7, 7).to(torch.int8))
            m.w_scale.mul_(step)


def w8a8_route_vs_cpu(pipe, image, outer_bf16: dict) -> None:
    """15(b)'s route check: one 1-step W8A8 edit with hooks on every
    quantized linear of the DiT's first block, its outer layers and the text
    model's first layer, each keeping W8A8_ROUTE_ROWS evenly spaced rows of
    its input and output; then the CPU's ``int8_linear`` on those rows with
    the same codes and scales must give the card's outputs bit for bit, and
    the CPU's ``quantize_weight`` of the outer layers' bf16 weights
    (``outer_bf16``) the card's codes and scales."""
    import copy

    import torch
    from torch import nn

    from physicedit_torch.ops import quant as q8

    mods = {f"dit.{k}.{n}".rstrip("."): m for k in outer_bf16
            for n, m in getattr(pipe.dit, k).named_modules()}
    mods.update({f"dit.blocks.0.{n}": m for n, m in pipe.dit.blocks[0].named_modules()})
    mods.update({f"text.layers.0.{n}": m for n, m in pipe.text.layers[0].named_modules()})
    mods = {n: m for n, m in mods.items() if isinstance(m, q8.Int8Linear)}
    got = {}

    def keep(name):
        def hook(m, inp, out):
            if name not in got:
                x, y = inp[0].reshape(-1, m.in_features), out.reshape(-1, m.out_features)
                rows = torch.arange(0, len(x), max(1, len(x) // W8A8_ROUTE_ROWS),
                                    device=x.device)
                got[name] = (x[rows].cpu(), y[rows].cpu())
        return hook

    hooks = [m.register_forward_hook(keep(n)) for n, m in mods.items()]
    pipe(W8A8_PROMPT, negative_prompt="", edit_image=image, cfg_scale=4.0, height=1024,
         width=1024, seed=SEED + 4, num_inference_steps=1, have_text_reasoning=False)
    for h in hooks:
        h.remove()
    unequal = [n for n, (x, y) in got.items()
               if not torch.equal(q8.int8_linear(copy.deepcopy(mods[n]).cpu(), x), y)]
    codes_unequal = []
    for k, bf16 in outer_bf16.items():
        for n, lin in bf16.named_modules():
            if isinstance(lin, nn.Linear):
                card = mods[f"dit.{k}.{n}".rstrip(".")]
                w_q, w_scale = q8.quantize_weight(lin.weight.cpu())
                if not (torch.equal(w_q, card.w_q.cpu())
                        and torch.equal(w_scale, card.w_scale.cpu())):
                    codes_unequal.append(k + n)
    emit({"card": card_name(), "phase": "w8a8_route_vs_cpu", "linears": len(mods),
          "linears_run": len(got), "rows_each": W8A8_ROUTE_ROWS,
          "outputs_unequal": unequal, "codes_checked": sum(
              isinstance(m, nn.Linear) for b in outer_bf16.values() for m in b.modules()),
          "codes_unequal": codes_unequal})
    if len(got) != len(mods) or unequal or codes_unequal:
        fail(f"the W8A8 route on the card differs from the CPU's: {len(got)} of {len(mods)} "
             f"linears run, outputs {unequal}, codes {codes_unequal}")


def w8a8_phase(gen_state, bf16_img, image, steps: int, dev) -> None:
    """15(b). The W8A8 lane at full width: the pipeline of phase 8 built
    again from its generator state, whose bf16 edit (phase 8's first single
    edit: 1024^2, SEED + 4, reasoner off) must equal ``bf16_img`` bit for
    bit; then ``quantize_("int8")`` in place (the DiT and the VL text model;
    the ViT and the KV cache stay bf16) and the same edit within
    W8A8_REL_L2 of ``bf16_img``, with one ``torch._int_mm`` per quantized
    DiT linear a forward (``w8a8_int_mm_per_step``); then the edit with the
    reasoner on, its decode capped at W8A8_DECODE_TOKENS, one
    ``torch._int_mm`` per quantized text linear a decode token.  The route
    is held against the CPU layer by layer (``w8a8_route_vs_cpu``).  Then,
    read and not gated, the edit with the DiT's outer layers
    (DIT_OUTER_KEYS) back in bf16, and with two activation-side faults
    (scales per tensor, codes truncated); last, in place, the control that
    must land above W8A8_REL_L2: every weight code on an int4 grid."""
    import copy
    import gc

    import numpy as np
    import torch
    from torch import nn

    from physicedit_torch.kernels.quant_matmul import DIT_OUTER_KEYS
    from physicedit_torch.ops import quant as q8
    from physicedit_torch.pipeline.testing import build_random_pipeline

    gen = torch.Generator(dev)
    gen.set_state(gen_state)
    t0 = time.perf_counter()
    pipe = build_random_pipeline("full", device=dev, generator=gen)
    torch.cuda.synchronize()
    bf16_gb = torch.cuda.memory_allocated() / 1e9
    build_s = time.perf_counter() - t0

    def edit_vs_bf16():
        t0 = time.perf_counter()
        out = pipe(W8A8_PROMPT, negative_prompt="", edit_image=image, cfg_scale=4.0,
                   height=1024, width=1024, seed=SEED + 4, num_inference_steps=steps,
                   have_text_reasoning=False)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        arr = np.asarray(out, np.float32)
        return arr, float(np.linalg.norm(arr - bf16_img) / np.linalg.norm(bf16_img - 127.5)), ms

    arr, rel, _ = edit_vs_bf16()
    emit({"card": card_name(), "phase": "w8a8_bf16_rebuilt", "build_s": build_s,
          "bit_equal_to_phase_8": bool(np.array_equal(arr, bf16_img)), "rel_l2": rel})
    if not np.array_equal(arr, bf16_img):
        fail(f"the rebuilt bf16 pipeline's edit is {rel:.3e} rel-L2 from phase 8's, not equal")
    outer_bf16 = {k: copy.deepcopy(getattr(pipe.dit, k)) for k in DIT_OUTER_KEYS}
    real_rows = q8.quantize_rows
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    pipe.quantize_("int8")
    torch.cuda.synchronize()

    def kinds(m):
        return {"int8": sum(isinstance(x, q8.Int8Linear) for x in m.modules()),
                "float": sum(isinstance(x, nn.Linear) for x in m.modules())}

    n = {name: kinds(getattr(pipe, name)) for name in ("dit", "text", "vision")}
    emit({"card": card_name(), "phase": "w8a8_quantize", "quantize_s": time.perf_counter() - t1,
          "bf16_resident_gb": bf16_gb, "resident_gb": torch.cuda.memory_allocated() / 1e9,
          "peak_gb_during_quantize": torch.cuda.max_memory_allocated() / 1e9,
          "linears": n, "kv_int8": pipe.kv_int8})
    # at full width every DiT and text linear is over the 65,536-element threshold
    if n["dit"]["float"] or n["text"]["float"] or n["vision"]["int8"] or pipe.kv_int8:
        fail(f"quantize_('int8') left {n} (kv_int8 {pipe.kv_int8})")

    per_denoise = []
    real_denoise = pipe._run_denoise

    def spy(*a, **kw):
        before = q8.CALLS["int_mm"]
        out = real_denoise(*a, **kw)
        per_denoise.append(q8.CALLS["int_mm"] - before)
        return out

    pipe._run_denoise = spy
    per_step = w8a8_int_mm_per_step(pipe.dit)
    n_blocks = pipe.dit.cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    q8.reset_call_counts()
    arr, rel, total = edit_vs_bf16()
    tm = pipe.timings
    launches = counts()
    emit({"card": card_name(), "phase": "w8a8_edit_vs_bf16", "size": [1024, 1024], "steps": steps,
          "reasoning": False, "total_ms": total, "denoise_ms_per_step": tm["denoise"] / steps,
          "prompt_encode_ms": tm["prompt_encode"], "rel_l2": rel, "limit": W8A8_REL_L2,
          "int_mm_per_denoise": per_denoise, "int_mm_per_step_expected": per_step,
          "int8_dit_linears": n["dit"]["int8"], "int_mm_calls": q8.CALLS["int_mm"],
          "k1_launches": launches["fixedmax_attention"], "k1_expected": steps * n_blocks,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "image_std": float(arr.std())})
    if not rel <= W8A8_REL_L2:
        fail(f"the W8A8 edit is {rel:.4f} rel-L2 from the bf16 edit (limit {W8A8_REL_L2})")
    if per_denoise != [steps * per_step] or launches["fixedmax_attention"] != steps * n_blocks:
        fail(f"W8A8 denoise: {per_denoise} torch._int_mm calls (wanted {steps * per_step}), "
             f"K1 {launches['fixedmax_attention']} (wanted {steps * n_blocks})")
    w8a8_route_vs_cpu(pipe, image, outer_bf16)

    real_reason = pipe.reason_physical_batch
    pipe.reason_physical_batch = (lambda prompts, ims, max_new_tokens=1000, **kw:
                                  real_reason(prompts, ims, W8A8_DECODE_TOKENS, **kw))
    decode_calls = []
    real_decode = pipe.text.greedy_decode

    def decode_spy(*a, **kw):
        before = q8.CALLS["int_mm"]
        toks, n_steps = real_decode(*a, **kw)
        decode_calls.append((q8.CALLS["int_mm"] - before, n_steps))
        return toks, n_steps

    pipe.text.greedy_decode = decode_spy
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = pipe(W8A8_PROMPT, edit_image=image, cfg_scale=4.0, height=1024, width=1024,
               seed=SEED + 4, num_inference_steps=steps, have_text_reasoning=True)
    torch.cuda.synchronize()
    total = (time.perf_counter() - t0) * 1e3
    arr = np.asarray(out, np.float32)
    tm = pipe.timings
    (dec_calls, dec_steps), = decode_calls
    launches = counts()
    n_layers = pipe.text.cfg.num_layers
    emit({"card": card_name(), "phase": "w8a8_edit", "size": [1024, 1024], "steps": steps,
          "reasoning": True,
          "decode_cap": W8A8_DECODE_TOKENS, "total_ms": total,
          "reasoner_prefill_ms": tm["reasoner_prefill"], "decode_tokens": tm["decode_tokens"],
          "decode_ms": tm["reasoner_decode"],
          "decode_ms_per_token": tm["reasoner_decode"] / max(1, tm["decode_tokens"]),
          "denoise_ms_per_step": tm["denoise"] / steps,
          "int_mm_per_decode_token": dec_calls / max(1, dec_steps),
          "int8_text_linears": n["text"]["int8"], "kv_int8": pipe.kv_int8,
          "k1_launches": launches["fixedmax_attention"],
          "k2_launches": launches["gqa_causal_attention"], "k2_expected": 2 * n_layers,
          "resident_gb": torch.cuda.memory_allocated() / 1e9,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "image_std": float(arr.std())})
    if out.size != (1024, 1024) or not np.isfinite(arr).all() or arr.std() == 0.0:
        fail("the W8A8 edit with the reasoner is not finite, is constant or the wrong size")
    if (dec_steps < 1 or dec_steps > W8A8_DECODE_TOKENS
            or dec_calls != dec_steps * n["text"]["int8"]
            or launches["gqa_causal_attention"] != 2 * n_layers):
        fail(f"W8A8 decode: {dec_calls} torch._int_mm calls over {dec_steps} tokens "
             f"({n['text']['int8']} a token wanted), K2 {launches['gqa_causal_attention']}")

    # read, not gated: the DiT's outer layers back in bf16 (the W4 lane's spec)
    outer_int8 = {k: getattr(pipe.dit, k) for k in DIT_OUTER_KEYS}
    for k, m in outer_bf16.items():
        setattr(pipe.dit, k, m)
    _, rel_outer, _ = edit_vs_bf16()
    for k, m in outer_int8.items():
        setattr(pipe.dit, k, m)
    # faults on the activation side, read (the route check above catches them)
    blind = {}
    for name, rows in (("per_tensor_activation_scale", _per_tensor_rows),
                       ("truncated_activation_codes", _truncated_rows)):
        q8.quantize_rows = rows
        blind[name] = edit_vs_bf16()[1]
        q8.quantize_rows = real_rows
    # the control the limit must catch, last (it rewrites the codes in place)
    _int4_grid_(pipe.dit)
    _int4_grid_(pipe.text)
    control = edit_vs_bf16()[1]
    emit({"card": card_name(), "phase": "w8a8_divergence", "steps": steps, "rel_l2": rel,
          "limit": W8A8_REL_L2, "rel_l2_dit_outer_bf16": rel_outer,
          "control_int4_weight_grid": control, "activation_faults_not_gated": blind})
    if not control > W8A8_REL_L2:
        fail(f"the W8A8 control (an int4 weight grid) reads {control:.4f}, inside the limit "
             f"{W8A8_REL_L2}")
    del pipe, out
    gc.collect()
    torch.cuda.empty_cache()


def _cpu_twin(make, model):
    """``make(torch.float32)`` materialised on the CPU with ``model``'s
    weights (the card's bf16 values, exactly, in fp32)."""
    import torch

    from physicedit_torch.core.params import materialize

    cpu = materialize(make(torch.float32), "cpu")
    cpu.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    return cpu.eval()


def _tokens_vs_cpu(card_toks, cpu_logits, max_err: float, stop: int) -> dict:
    """The card's greedy tokens against the CPU's argmax, teacher-forced on
    the card's sequence (up to ``stop``, EOS, when it comes): the leading
    run of equal tokens, and whether every other token is a near-tie (its
    CPU logit within twice the measured logit error of the CPU's best)."""
    toks = card_toks.cpu().long()
    if (toks == stop).any():
        toks = toks[:int((toks == stop).nonzero()[0]) + 1]
    logits = cpu_logits[:len(toks)].double()
    equal = logits.argmax(-1) == toks
    gap = logits.max(-1).values - logits.gather(1, toks[:, None])[:, 0]
    return {"tokens": len(toks), "tokens_equal": int(equal.sum()),
            "equal_prefix": int(equal.long().cumprod(0).sum()),
            "worst_gap": float(gap.max()), "near_tie_limit": 2 * max_err,
            "ok": len(toks) > 0 and bool((equal | (gap <= 2 * max_err)).all())}


def _logit_row(card, cpu, limit: float) -> dict:
    card = card.float().cpu()
    err = (card - cpu).abs().max().item()
    return {"logits_rel_l2": rel_l2(card, cpu), "logits_max_abs_err": err,
            "logits_max_abs": cpu.abs().max().item(), "limit": limit}


def refiner_phase(gen) -> None:
    """15(c). The three prompt refiners at their published widths with
    random weights (nothing is fetched): BLOOM as
    alibaba-pai/pai-bloom-1b1-text2prompt-sd and QwenPrompt as
    Qwen/Qwen2-1.5B-Instruct in bf16, Marian as Helsinki-NLP/opus-mt-zh-en in
    fp32 (each refiner's dtype), each against the same weights in fp32 on
    the CPU: logits within REFINER_BF16_REL_L2 / REFINER_FP32_REL_L2 (BLOOM
    and Marian teacher-forced on the card, QwenPrompt's prefill row and
    each step of its decode through the KV cache, against the CPU's forward
    teacher-forced on the card's tokens), and REFINER_TOKENS greedy tokens
    equal to the CPU's argmax but for near-ties.  QwenPrompt's prefill must
    launch K2 exactly once per layer.  Then each refiner's public call, timed,
    and BLOOM's sampling drawn twice under one seed (the same tokens)."""
    import gc

    import torch

    from physicedit_torch.core.params import init_random_, materialize
    from physicedit_torch.kernels import flash_attention as fa
    from physicedit_torch.models import bloom, marian
    from physicedit_torch.models.qwen_vl import QwenVLText
    from physicedit_torch.pipeline import prompt_refiners as pr
    from physicedit_torch.pipeline.testing import FakeTokenizer

    dev = gen.device
    tok = FakeTokenizer()
    n_new = REFINER_TOKENS

    def random(make, dtype, std=0.02):
        model = init_random_(materialize(make(dtype), dev), gen)
        model.embed.normal_(0.0, std, generator=gen)
        return model.eval()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # BLOOM (BeautifulPrompt)
    cfg = bloom.PAI_BLOOM_1B1_TEXT2PROMPT
    card = random(lambda dt: bloom.Bloom(cfg, dt), torch.bfloat16).reset_alibi_()
    cpu = _cpu_twin(lambda dt: bloom.Bloom(cfg, dt), card)
    ref = pr.BeautifulPrompt(card, tok)
    ids = tok.encode(ref.template.format(raw_prompt=REFINER_PROMPT))
    pad = pr._bucket(len(ids))
    input_ids = torch.full((1, pad), cfg.pad_token_id, dtype=torch.long, device=dev)
    mask = torch.zeros((1, pad), dtype=torch.long, device=dev)
    input_ids[0, pad - len(ids):] = torch.tensor(ids, device=dev)
    mask[0, pad - len(ids):] = 1
    toks, greedy_ms = timed(lambda: bloom.bloom_generate(card, input_ids, mask,
                                                         max_new_tokens=n_new))
    seq = torch.cat([input_ids, toks], 1)
    seq_mask = torch.cat([mask, torch.ones_like(toks)], 1)
    rows = slice(pad - 1, pad - 1 + n_new)
    card_logits = bloom.bloom_logits(card, seq, seq_mask)[0, rows]
    cpu_logits = bloom.bloom_logits(cpu, seq.cpu(), seq_mask.cpu())[0, rows]
    row = {"card": card_name(), "phase": "refiner", "refiner": "BeautifulPrompt", "model": "bloom",
           "widths": "alibaba-pai/pai-bloom-1b1-text2prompt-sd",
           "config": dict(vars(cfg)), "card_dtype": "bfloat16", "prompt_tokens": len(ids),
           "greedy_ms_per_token": greedy_ms / n_new,
           **_logit_row(card_logits, cpu_logits, REFINER_BF16_REL_L2)}
    row.update(_tokens_vs_cpu(toks[0], cpu_logits, row["logits_max_abs_err"],
                              cfg.eos_token_id))
    del cpu
    out, sample_ms = timed(lambda: ref(REFINER_PROMPT, seed=SEED))
    draws = [bloom.bloom_generate(card, input_ids, mask, BLOOM_REPEAT_TOKENS, do_sample=True,
                                  temperature=0.9, top_k=50, top_p=0.95, repetition_penalty=1.1,
                                  generator=torch.Generator(dev).manual_seed(SEED))
             for _ in range(2)]
    row.update({"call_new_tokens": 384, "call_ms": sample_ms,
                "call_words": len(out.split()) - len(REFINER_PROMPT.split()),
                "sampled_repeat_tokens": BLOOM_REPEAT_TOKENS,
                "sampled_repeatable": bool(torch.equal(*draws))})
    emit(row)
    if (not row["logits_rel_l2"] <= REFINER_BF16_REL_L2 or not row["ok"]
            or not row["sampled_repeatable"] or not out.startswith(REFINER_PROMPT + ", ")):
        fail(f"BeautifulPrompt on the card disagrees with the CPU: {row}")
    del card, ref

    # Marian (Translator), fp32 as the Translator loads it
    cfg = marian.OPUS_MT_ZH_EN

    def make_marian(dt):
        return marian.Marian(cfg, dt)

    card = random(make_marian, torch.float32)
    with torch.no_grad():
        card.pos.copy_(torch.from_numpy(marian.sinusoidal_table(cfg.max_positions,
                                                                 cfg.d_model)))
        card.final_logits_bias.zero_()
    cpu = _cpu_twin(make_marian, card)
    tr = pr.Translator(card, tok)
    ids = tok.encode(REFINER_PROMPT)
    pad = pr._bucket(len(ids))
    src = torch.full((1, pad), cfg.pad_token_id, dtype=torch.long, device=dev)
    src_mask = torch.zeros((1, pad), dtype=torch.long, device=dev)
    src[0, :len(ids)] = torch.tensor(ids, device=dev)
    src_mask[0, :len(ids)] = 1
    toks, greedy_ms = timed(lambda: marian.marian_greedy_generate(card, src, src_mask, n_new))
    dec = torch.cat([torch.full((1, 1), cfg.decoder_start_token_id, device=dev),
                     toks[:, :-1]], 1)
    card_logits = marian.marian_decode_logits(
        card, dec, marian.marian_encode(card, src, src_mask), src_mask)[0]
    cpu_src, cpu_mask = src.cpu(), src_mask.cpu()
    cpu_logits = marian.marian_decode_logits(
        cpu, dec.cpu(), marian.marian_encode(cpu, cpu_src, cpu_mask), cpu_mask)[0]
    row = {"card": card_name(), "phase": "refiner", "refiner": "Translator", "model": "marian",
           "widths": "Helsinki-NLP/opus-mt-zh-en", "config": dict(vars(cfg)),
           "card_dtype": "float32", "prompt_tokens": len(ids),
           "greedy_ms_per_token": greedy_ms / n_new,
           **_logit_row(card_logits, cpu_logits, REFINER_FP32_REL_L2)}
    row.update(_tokens_vs_cpu(toks[0], cpu_logits, row["logits_max_abs_err"],
                              cfg.eos_token_id))
    del cpu
    out, call_ms = timed(lambda: tr(REFINER_PROMPT))
    row.update({"call_new_tokens": 512, "call_ms": call_ms, "call_words": len(out.split())})
    emit(row)
    if not row["logits_rel_l2"] <= REFINER_FP32_REL_L2 or not row["ok"]:
        fail(f"the Translator on the card disagrees with the CPU: {row}")
    del card, tr

    # Qwen2 (QwenPrompt): the VL text decoder, K2 in its prefill
    cfg = pr.qwen_text_cfg_from_hf(pr.QWEN2_1_5B_INSTRUCT)

    def make_qwen(dt):
        return QwenVLText(cfg, dt)

    card = random(make_qwen, torch.bfloat16)
    with torch.no_grad():
        card.lm_head.weight.copy_(card.embed)          # tied embeddings
    cpu = _cpu_twin(make_qwen, card)
    q = pr.QwenPrompt(card, tok)
    ids, embeds, pos, mask = q.inputs(REFINER_PROMPT)
    pad = mask.shape[1]
    reset_counts()
    (logits, caches, _), prefill_ms = timed(lambda: card.prefill(embeds, pos, mask,
                                                                 pad + n_new))
    k2 = fa.LAUNCHES["gqa_causal_attention"]
    key_mask = torch.cat([mask, torch.zeros((1, n_new), dtype=torch.bool, device=dev)], 1)
    decode_logits = []      # each decode step's logits, through the card's KV cache
    hook = card.lm_head.register_forward_hook(lambda m, i, o: decode_logits.append(o))
    (toks, steps), decode_ms = timed(lambda: card.greedy_decode(
        caches, logits.argmax(-1), pad, torch.tensor([len(ids)], device=dev), n_new,
        key_mask=key_mask))
    hook.remove()
    # the prefill's last row, then each decode step's (the last step's token is not kept)
    card_logits = torch.cat([logits, *decode_logits])[:n_new]
    # the CPU teacher-forced over the prompt and the card's tokens
    gen_toks = toks[0, :n_new - 1].cpu()
    emb = torch.cat([embeds.float().cpu(), cpu.embed_tokens(gen_toks)[None]], 1)
    cpu_pos = torch.cat([pos.cpu(), (len(ids) + torch.arange(n_new - 1)).expand(3, 1, -1)], 2)
    cpu_mask = torch.cat([mask.cpu(), torch.ones((1, n_new - 1), dtype=torch.bool)], 1)
    hidden = cpu.text_forward(emb, cpu_pos, cpu_mask)
    with torch.no_grad():
        cpu_logits = cpu.lm_head(hidden[0, pad - 1:pad - 1 + n_new])
    row = {"card": card_name(), "phase": "refiner", "refiner": "QwenPrompt", "model": "qwen2",
           "widths": "Qwen/Qwen2-1.5B-Instruct",
           "config": {k: list(v) if isinstance(v, tuple) else v for k, v in vars(cfg).items()},
           "card_dtype": "bfloat16", "prompt_tokens": len(ids), "prefill_len": pad,
           "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms / max(1, steps),
           "k2_prefill_launches": k2, "k2_expected": cfg.num_layers,
           **_logit_row(card_logits, cpu_logits[:len(card_logits)], REFINER_BF16_REL_L2)}
    row.update(_tokens_vs_cpu(toks[0, :n_new], cpu_logits, row["logits_max_abs_err"],
                              cfg.eos_token_id))
    del cpu, caches, decode_logits
    reset_counts()
    out, call_ms = timed(lambda: q(REFINER_PROMPT, max_new_tokens=QWEN_REFINER_TOKENS))
    row.update({"call_new_tokens": QWEN_REFINER_TOKENS, "call_ms": call_ms,
                "call_k2_launches": fa.LAUNCHES["gqa_causal_attention"],
                "call_words": len(out.split())})
    emit(row)
    if k2 != cfg.num_layers or row["call_k2_launches"] != cfg.num_layers:
        fail(f"QwenPrompt's prefill launched K2 {k2} / {row['call_k2_launches']} times, "
             f"wanted {cfg.num_layers}")
    if not row["logits_rel_l2"] <= REFINER_BF16_REL_L2 or not row["ok"] or not out:
        fail(f"QwenPrompt on the card disagrees with the CPU: {row}")
    del card, q
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 17. the multi-GPU slice (parallel/) on one card
# ---------------------------------------------------------------------------

# (a): the DiT's joint attention at 1024^2 with the reasoner on (text 1280 +
# image 4096 + edit 4096), over RING_RANKS virtual ranks, the last
# RING_MASKED_KEYS keys masked
RING_SHAPE = (2, 24, 9472, 128)
RING_RANKS = 4
RING_MASKED_KEYS = 64
# (b): one block's fc1 / fc2 pair from its tp-4 shards, the partial sums of
# fc2 added in fp32, against the unsharded pair in bf16 (rel-L2): each bf16
# partial rounds on its own, about 2^-9 relative, 1e-2 leaves 5x room
SHARD_PAIR_REL = 1e-2


def ring_virtual_phase(report: dict, gen, time_ms) -> dict:
    """(a) The kernels lane of ``parallel/ring_attention.py`` for RING_RANKS
    virtual ranks in one process, through the hop functions the
    ``torch.distributed`` ring calls: the forward against one K1 call
    (ATTN_MAX_ABS, ATTN_REL_L2), the backward's dq', dk and dv against one
    K8 call on the same out and l (K8_REL), with n^2 launches of each.
    Returns the launches."""
    import torch

    from physicedit_torch.kernels import flash_attention as fa
    from physicedit_torch.parallel import ring_attention as ra

    dev = torch.device("cuda")
    b, n, s, d = RING_SHAPE

    def rms_randn(*shape):
        x = torch.randn(*shape, device=dev, generator=gen)
        return (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True))).bfloat16()

    q, k = rms_randn(b, n, s, d), rms_randn(b, n, s, d)
    v = torch.randn(b, n, s, d, device=dev, generator=gen).bfloat16()
    g = torch.randn(b, n, s, d, device=dev, generator=gen).bfloat16()
    mask = torch.ones(b, s, dtype=torch.bool, device=dev)
    mask[:, -RING_MASKED_KEYS:] = False
    want, l_want = fa.fixedmax_attention(q, k, v, mask, True, return_l=True)
    reset_counts()
    out, l = ra.virtual_ring_fixedmax(q, k, v, mask, RING_RANKS)
    torch.cuda.synchronize()
    fwd_launches = counts()["fixedmax_attention"]
    qs = fa._prescale(q).contiguous()
    grads_want = fa.fixedmax_attention_bwd(qs, k, v, mask, g, want, l_want, True)
    reset_counts()
    grads = ra.virtual_ring_fixedmax_bwd(qs, k, v, mask, g, want, l_want, RING_RANKS)
    torch.cuda.synchronize()
    bwd_launches = counts()["fixedmax_attention_bwd"]
    err = (out.float() - want.float()).abs().max().item()
    rel = rel_l2(out, want)
    l_rel = ((l - l_want).abs() / l_want).max().item()
    g_rel = {name: ((a.float() - w.float()).abs().max() / w.float().abs().max()).item()
             for name, a, w in zip(("dq", "dk", "dv"), grads, grads_want)}
    row = {"phase": "ring_virtual", "shape": list(RING_SHAPE), "ranks": RING_RANKS,
           "chunk": s // RING_RANKS, "masked_keys": RING_MASKED_KEYS,
           "max_abs_err": err, "rel_l2": rel, "l_max_rel_err": l_rel,
           "max_abs_limit": ATTN_MAX_ABS, "rel_l2_limit": ATTN_REL_L2,
           "grad_max_rel_err": g_rel, "grad_limit": K8_REL,
           "k1_launches": fwd_launches, "k8_launches": bwd_launches,
           "launches_expected": RING_RANKS ** 2,
           "ring_ms": time_ms(lambda: ra.virtual_ring_fixedmax(q, k, v, mask, RING_RANKS), 5),
           "k1_ms": time_ms(lambda: fa.fixedmax_attention(q, k, v, mask, True,
                                                          return_l=True), 5),
           "ring_bwd_ms": time_ms(lambda: ra.virtual_ring_fixedmax_bwd(
               qs, k, v, mask, g, want, l_want, RING_RANKS), 3),
           "k8_ms": time_ms(lambda: fa.fixedmax_attention_bwd(qs, k, v, mask, g, want,
                                                              l_want, True), 3),
           "card": card_name()}
    emit(row)
    if err > ATTN_MAX_ABS or rel > ATTN_REL_L2 or l_rel > 1e-3:
        fail(f"the virtual ring's forward disagrees with one K1 call: {row}")
    if max(g_rel.values()) > K8_REL:
        fail(f"the virtual ring's backward disagrees with one K8 call: {g_rel}")
    if fwd_launches != RING_RANKS ** 2 or bwd_launches != RING_RANKS ** 2:
        fail(f"the virtual ring launched K1 {fwd_launches} / K8 {bwd_launches} times, "
             f"not {RING_RANKS ** 2}")
    del q, k, v, g, out, want, grads, grads_want, qs
    torch.cuda.empty_cache()
    return {"fixedmax_attention": fwd_launches, "fixedmax_attention_bwd": bwd_launches}


def shard_phase(pipe, gen) -> None:
    """(b) ``parallel/sharding.py`` on phase 8's full-width weights: every
    split weight of the DiT and of the VL text model, cut for tp 2 and 4 by
    ``shard_tensor`` (what ``shard_params`` keeps on each rank) and put back
    by ``unshard_tensor``, bit for bit; the groups that stay whole (D3)
    counted.  Then the DiT's first block's image MLP from its tp-4 shards,
    fc2's partial sums added in fp32, against the unsharded pair within
    SHARD_PAIR_REL."""
    import torch
    import torch.nn.functional as F

    from physicedit_torch.ops.norms import approximate_gelu
    from physicedit_torch.parallel import sharding as shd

    t0 = time.perf_counter()
    for label, model, specs in (
            ("dit", pipe.dit, shd.dit_param_specs(pipe.dit)),
            ("vl_text", pipe.text, shd.qwen_vl_text_param_specs(pipe.text))):
        params = dict(model.named_parameters())
        for tp in (2, 4):
            whole = shd.whole_groups(model, specs, tp)
            n_split = n_bytes = 0
            for name, split in specs.items():
                if split is None or split.group in whole:
                    continue
                t = params[name]
                back = shd.unshard_tensor([shd.shard_tensor(t, split, r, tp)
                                           for r in range(tp)], split)
                if not torch.equal(back, t):
                    fail(f"{label} {name}: the tp-{tp} shards do not reassemble it")
                n_split += 1
                n_bytes += t.numel() * t.element_size()
            emit({"phase": "shard_reassembly", "model": label, "tp": tp,
                  "split_tensors": n_split, "split_gb": n_bytes / 1e9,
                  "whole_groups": len(whole), "bit_for_bit": True,
                  "seconds": time.perf_counter() - t0})
            if n_split == 0:
                fail(f"{label}: no weight splits at tp {tp}")
    mlp = pipe.dit.blocks[0].img_mlp
    x = torch.randn(1, 4096, 3072, device="cuda", generator=gen).bfloat16()
    want = mlp["fc2"](approximate_gelu(mlp["fc1"](x)))
    acc = torch.zeros(want.shape, dtype=torch.float32, device="cuda")
    col, row = shd.Split(0), shd.Split(1)
    for r in range(4):
        h = approximate_gelu(F.linear(x, shd.shard_tensor(mlp["fc1"].weight, col, r, 4),
                                      shd.shard_tensor(mlp["fc1"].bias, col, r, 4)))
        acc += F.linear(h, shd.shard_tensor(mlp["fc2"].weight, row, r, 4)).float()
    got = (acc + mlp["fc2"].bias.float()).bfloat16()
    rel = rel_l2(got, want)
    emit({"phase": "shard_mlp_pair", "tp": 4, "rows": 4096, "rel_l2": rel,
          "limit": SHARD_PAIR_REL, "max_abs_err": (got.float() - want.float()).abs().max().item()})
    if not rel <= SHARD_PAIR_REL:
        fail(f"the tp-4 fc1 / fc2 pair is {rel} rel-L2 from the unsharded pair")


def ring_world1_phase(pipe, edit, bf16_img, image, steps: int, n_blocks: int) -> None:
    """(c) A real NCCL process group of one rank: phase 8's bf16 pipeline
    through ``shard(create_mesh(1, 1))`` with ``attn_impl="ring"`` (one hop a
    block: K1 once per block and step, the slim last block off) edits the
    serving phase's first single edit (1024^2, reasoner off), held to that
    edit on the kernels route within PIPE_REL_L2; the group's all-reduce and
    all-gather checked on the card.  A control (read, not gated) is the
    kernels route with the slim last block off too (a hot-loaded rank-1
    LoRA whose B is 0 adds exactly 0 and turns it off): the ring against it
    is the ring's own error, it against the slim edit the slim block's.
    The pipeline is put back afterwards."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from physicedit_torch.lora import init_dit_lora
    from physicedit_torch.models.dit import set_ring_context
    from physicedit_torch.parallel import comm
    from physicedit_torch.parallel.sharding import MODEL_AXIS, create_mesh

    pipe.dit_lora = init_dit_lora(pipe.dit.cfg, 1, torch.bfloat16, "cuda")
    try:
        control, _ = edit(1024, 1024, SEED + 4, False, image=image)
    finally:
        pipe.dit_lora = None
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            x = torch.arange(8.0, device="cuda")
            dist.all_reduce(x)
            gathered = comm.all_gather_cat(x, 0, dist.group.WORLD)
            mesh = create_mesh(1, 1, "cuda")
            pipe.shard(mesh)
            set_ring_context(mesh, MODEL_AXIS)
            pipe.attn_impl = "ring"
            reset_counts()
            arr, row = edit(1024, 1024, SEED + 4, False, image=image)
            launches = counts()
        finally:
            pipe.attn_impl, pipe.mesh = "kernels", None
            set_ring_context(None)
            dist.destroy_process_group()
    def img_rel(got, want):
        return float(np.linalg.norm(got - want) / np.linalg.norm(want - want.mean()))

    rel = img_rel(arr, bf16_img)
    k1 = launches["fixedmax_attention"]
    emit({"phase": "ring_world1_edit", **row, "backend": "nccl", "world": 1,
          "all_reduce_ok": bool(torch.equal(x, torch.arange(8.0, device="cuda"))),
          "all_gather_ok": bool(torch.equal(gathered, x)),
          "rel_l2_vs_kernels_route": rel, "limit": PIPE_REL_L2,
          "rel_l2_vs_slim_off_control": img_rel(arr, control),
          "control_rel_l2_vs_kernels_route": img_rel(control, bf16_img),
          "k1_launches": k1, "k1_expected": steps * n_blocks, "card": card_name()})
    if not rel <= PIPE_REL_L2:
        fail(f"the ring edit (world 1) is {rel} rel-L2 from the kernels route's")
    if k1 != steps * n_blocks or launches["fixedmax_attention_bias"]:
        fail(f"the ring edit launched K1 {k1} times, not {steps * n_blocks}")
    if not torch.equal(x, torch.arange(8.0, device="cuda")) or not torch.equal(gathered, x):
        fail("the world-1 NCCL group's all-reduce or all-gather changed its input")


# (d): the NCCL world's size and its time limit
MULTI_GPU_WORLD = 2
MULTI_GPU_TIMEOUT = 600


def small_dims():
    """Phase 7's small head_dim-128 model (two heads: they split over two
    ranks), with phase 10's DINOv2 for training."""
    from physicedit_torch.models.dinov2 import DinoV2Config
    from physicedit_torch.models.dit import DiTConfig
    from physicedit_torch.models.qwen_vl import QwenVLTextConfig
    from physicedit_torch.models.qwen_vl_vision import QwenVLVisionConfig
    from physicedit_torch.models.vae import VAEConfig
    from physicedit_torch.pipeline.testing import PipelineDims

    return PipelineDims(
        dit=DiTConfig(num_layers=2, dim=256, num_heads=2, head_dim=128,
                      txt_in_dim=256, patch_dim=64, time_dim=64),
        text=QwenVLTextConfig(hidden_size=256, num_layers=2, num_heads=2, num_kv_heads=1,
                              head_dim=128, intermediate_size=512, vocab_size=512),
        vision=QwenVLVisionConfig(depth=2, hidden_size=64, num_heads=2,
                                  intermediate_size=128, fullatt_block_indexes=(1,),
                                  out_hidden_size=256),
        vae=VAEConfig(base_dim=16), adapter_dim=256, rope_axes=(16, 56, 56),
        edit_drop_idx=2, t2i_drop_idx=2,
        dinov2=DinoV2Config(hidden_size=64, num_layers=1, num_heads=2), dino_pos_grid=20)


def multi_gpu_cases(world: int | None) -> dict:
    """(d)'s runs on the small model, each from the same seeded weights: a
    ring edit, a tensor-parallel edit, a data-parallel ``edit_batch`` of two
    and a data-parallel training step on a global batch of two; on one card
    (``world`` None: the kernels route, no mesh) or on this process's rank of
    an NCCL world (the ring and tensor parallelism over (1, world), data
    parallelism over (world, 1))."""
    import numpy as np
    import torch
    from PIL import Image

    from physicedit_torch.models.dit import set_ring_context
    from physicedit_torch.parallel.sharding import MODEL_AXIS, create_mesh
    from physicedit_torch.pipeline.testing import random_pipeline
    from physicedit_torch.profile_train import SyntheticVideo
    from physicedit_torch.train.trainer import TrainConfig, Trainer

    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(SEED + 17)
    ims = [Image.fromarray(rng.integers(0, 255, (4, 4, 3), dtype=np.uint8)).resize(
        (128, 128), Image.BILINEAR) for _ in range(2)]
    kw = dict(height=128, width=128, num_inference_steps=2, have_text_reasoning=False)

    def build():
        return random_pipeline(small_dims(), dev, torch.bfloat16,
                               torch.Generator(dev).manual_seed(SEED + 17))

    out = {}
    pipe = build()
    if world:
        set_ring_context(create_mesh(1, world, "cuda"), MODEL_AXIS)
        pipe.attn_impl = "ring"
    out["ring"] = np.asarray(pipe("tilt the cup", edit_image=ims[0], seed=11, **kw), np.float32)
    set_ring_context(None)
    pipe = build()
    if world:
        pipe.shard(create_mesh(1, world, "cuda"))
    out["tp"] = np.asarray(pipe("tilt the cup", edit_image=ims[0], seed=11, **kw), np.float32)
    pipe = build()
    if world:
        pipe.shard(create_mesh(world, 1, "cuda"))
    out["dp"] = [np.asarray(im, np.float32) for im in pipe.edit_batch(
        ["tilt the cup", "slide the red box"], ims, seeds=[3, 4], **kw)]
    data = SyntheticVideo(n=2, width=128, height=128, frames=2, seed=SEED + 7)
    trainer = Trainer(build(), data, TrainConfig(learning_rate=1e-3, lora_rank=8,
                                                 txt_len_bucket=64, batch_size=2),
                      mesh=create_mesh(world, 1, "cuda") if world else None, device=dev)
    metrics = trainer.step(trainer.collate([trainer.preprocess(data[i]) for i in range(2)]))
    out["train"] = {"loss": metrics["loss"],
                    "grads": torch.cat([p.grad.float().reshape(-1).cpu()
                                        for p in trainer.trainable.parameters()])}
    return out


def dist_worker(rank: int, world: int, folder: str) -> None:
    """One rank of (d)'s NCCL world: ``multi_gpu_cases`` on its GPU, the
    result saved for the parent."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(folder, "store"), world),
                            rank=rank, world_size=world)
    try:
        torch.save(multi_gpu_cases(world), os.path.join(folder, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def multi_gpu_phase() -> None:
    """(d) With two GPUs or more: an NCCL world of MULTI_GPU_WORLD processes
    (this script with ``--dist-worker``) runs ``multi_gpu_cases`` and each
    rank's ring, tensor-parallel and data-parallel edits are held to one
    card's within PIPE_REL_L2, its data-parallel training step's loss and
    gradients within TRAIN_LOSS_REL / TRAIN_GRAD_REL.  With one GPU the
    phase prints that it did not run, and why."""
    import tempfile

    import numpy as np
    import torch

    n_gpus = torch.cuda.device_count()
    if n_gpus < MULTI_GPU_WORLD:
        emit({"phase": "multi_gpu", "run": False, "gpus": n_gpus,
              "reason": f"{n_gpus} GPU: an NCCL world of {MULTI_GPU_WORLD} needs one GPU a "
                        f"rank", "card": card_name()})
        return
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dist-worker",
                                   str(r), "--dist-world", str(MULTI_GPU_WORLD),
                                   "--dist-dir", tmp]) for r in range(MULTI_GPU_WORLD)]
        try:
            codes = [p.wait(timeout=MULTI_GPU_TIMEOUT) for p in procs]
        except subprocess.TimeoutExpired:
            codes = None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if codes is None or any(codes):
            fail(f"the NCCL world of {MULTI_GPU_WORLD} failed or hung: exit codes {codes}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(MULTI_GPU_WORLD)]
    world_s = time.perf_counter() - t0
    ref = multi_gpu_cases(None)

    def img_rel(got, want):
        return float(np.linalg.norm(got - want) / np.linalg.norm(want - want.mean()))

    for r, got in enumerate(ranks):
        rels = {"ring": img_rel(got["ring"], ref["ring"]), "tp": img_rel(got["tp"], ref["tp"]),
                "dp": max(img_rel(g, w) for g, w in zip(got["dp"], ref["dp"]))}
        loss_rel = abs(got["train"]["loss"] - ref["train"]["loss"]) / abs(ref["train"]["loss"])
        grads_rel = rel_l2(got["train"]["grads"], ref["train"]["grads"])
        emit({"phase": "multi_gpu", "run": True, "rank": r, "world": MULTI_GPU_WORLD,
              "gpus": n_gpus, "image_rel_l2": rels, "image_limit": PIPE_REL_L2,
              "train_loss_rel": loss_rel, "train_grads_rel_l2": grads_rel,
              "loss_limit": TRAIN_LOSS_REL, "grads_limit": TRAIN_GRAD_REL,
              "world_seconds": world_s, "card": card_name()})
        if max(rels.values()) > PIPE_REL_L2:
            fail(f"rank {r}'s multi-GPU edits are {rels} rel-L2 from one card's")
        if not (loss_rel <= TRAIN_LOSS_REL and grads_rel <= TRAIN_GRAD_REL):
            fail(f"rank {r}'s data-parallel step disagrees with one card's: loss "
                 f"{loss_rel}, gradients {grads_rel}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4, help="denoise steps per edit")
    # one rank of phase 17(d)'s NCCL world (the script starts them itself)
    ap.add_argument("--dist-worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dist-world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dist-dir", type=str, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.dist_worker is not None:
        dist_worker(args.dist_worker, args.dist_world, args.dist_dir)
        return 0
    import numpy as np
    from PIL import Image

    from physicedit_torch.kernels import _build
    from physicedit_torch.kernels import flash_attention as fa
    from physicedit_torch.tools import _bench

    # 1. the card
    card = card_name()
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
    k1_cases = [  # name, B, N, S_q, S_k, clamp, keys masked in row 1 (or "per_stage")
        ("joint_8448_noclamp", 2, 24, 8448, 8448, False, (60, 256)),
        ("joint_8448_clamp", 2, 24, 8448, 8448, True, (60, 256)),
        ("slim_4096x8448", 2, 24, 4096, 8448, False, (60, 256)),
        ("ragged_2303", 2, 24, 2303, 2303, True, (2000, 2303)),
        # the Hopper mainloop's 128-key stages: a hole across stage edges, a
        # ragged last stage
        ("hole_across_tiles_8448", 2, 24, 8448, 8448, False, (1000, 1300)),
        ("ragged_8513_clamp", 2, 24, 8513, 8513, True, (60, 256)),
        # a mask that changes from stage to stage: no tile may be masked with
        # the liveness word of the tile that next takes its ring slot
        ("mask_changes_every_stage_8448", 2, 24, 8448, 8448, False, "per_stage"),
    ]
    k1_ptxas = hopper_ptxas("fixedmax_attention", "fixedmax_kernel", ("clamp",))
    for name, b, n, sq, sk, clamp, dead in k1_cases:
        scale = CLAMP_QK_SCALE if clamp else 1.0
        q = (rms(randn(b, n, sq, 128)) * scale).bfloat16()
        k = (rms(randn(b, n, sk, 128)) * scale).bfloat16()
        v = randn(b, n, sk, 128).bfloat16()
        if dead == "per_stage":
            mask = stage_varying_mask(b, sk, dev)
        else:
            mask = torch.ones(b, sk, dtype=torch.bool, device=dev)
            mask[1, dead[0]:dead[1]] = False
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
        rel = rel_l2(out, ref)
        l_rel = ((l - l_ref).abs() / l_ref).max().item()
        row = {"phase": "k1", "case": name, "shape": [b, n, sq, sk], "clamp": clamp,
               "qk_scale": scale, "clamped_logit_share": clamped,
               "max_abs_err": max_err, "mean_abs_err": mean_err, "rel_l2": rel,
               "n_out_of_tol": n_bad, "l_max_rel_err": l_rel, "atol": ATOL, "rtol": RTOL,
               "max_abs_limit": ATTN_MAX_ABS, "rel_l2_limit": ATTN_REL_L2}
        if name == "joint_8448_noclamp":
            qs = fa._prescale(q).contiguous()
            row["ms"] = time_ms(lambda: fa.fixedmax_attention(q, k, v, mask, clamp), 10)
            row["graph_ms"] = _bench.graph_ms(lambda: fa.fixedmax_attention(q, k, v, mask,
                                                                            clamp))
            # the kernel alone on the prescaled q', and with the clamp on
            row["kernel_ms"] = time_ms(
                lambda: fa._fixedmax_prescaled(qs, k, v, mask, clamp, False), 10)
            row["clamp_on_ms"] = time_ms(
                lambda: fa._fixedmax_prescaled(qs, k, v, mask, True, False), 10)
            row["plain_ms"] = time_ms(
                lambda: fa.fixedmax_attention_reference(q, k, v, mask, clamp), 3)
            mask4 = mask[:, None, None, :]
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask4), 10)
            row["tflops"] = 4 * b * n * sq * sk * 128 / row["ms"] / 1e9
            row.update(bound(4 * b * n * sq * sk * 128,
                             2 * (q.numel() + k.numel() + v.numel() + out.numel()) + b * sk,
                             PEAK_BF16))
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["ptxas"] = k1_ptxas
            del qs
            report["fixedmax_attention"] = dict(row)
        report.setdefault("fixedmax_attention_err", []).append(max_err)
        emit(row)
        if n_bad or l_rel > 1e-3 or max_err > ATTN_MAX_ABS or rel > ATTN_REL_L2:
            fail(f"K1 {name} disagrees with its plain version")
        del q, k, v, out, ref, l, l_ref
    q = randn(1, 2, 200, 128).bfloat16()
    out = fa.fixedmax_attention(q, q, q, torch.zeros(1, 200, dtype=torch.bool, device=dev))
    torch.cuda.synchronize()
    emit({"phase": "k1", "case": "fully_masked_rows", "max_abs": out.abs().max().item()})
    if out.abs().max().item() != 0.0:
        fail("K1 fully masked rows are not exactly 0")
    torch.cuda.empty_cache()

    # 3b. K7 at the EliGen path's shapes
    k7_phase(report, gen, time_ms, compare)
    # 3c. K10, K10b and K1' through the attention API at the DiT's shapes
    attention_launches = {
        "online_attention": k10_phase(report, gen, time_ms, compare)["online_attention"],
        "online_attention_bias":
            k10b_phase(report, gen, time_ms, compare)["online_attention_bias"],
        "fixedmax_bnsd": k1prime_phase(report, gen, time_ms, compare)["fixedmax_bnsd"]}

    # 4. K2 at the reasoner prefill / prompt-encode shapes
    k2_ptxas = hopper_ptxas("gqa_causal_attention", "gqa_causal_kernel", ())
    for name, b, s, pads in [("prefill_1536", 1, 1536, (0,)),
                             ("left_padded_2x1536", 2, 1536, (300, 17)),
                             ("left_padded_2x1500", 2, 1500, (300, 130))]:
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
        pad_rows_zero = bool((out[~live] == 0).all())
        row = {"phase": "k2", "case": name, "shape": [b, s, 28, 4], "left_pad": list(pads),
               "max_abs_err_live_rows": max_err, "mean_abs_err_live_rows": mean_err,
               "rel_l2_live_rows": rel_l2(out[live], ref[live]), "n_out_of_tol": n_bad,
               "pad_rows_zero": pad_rows_zero, "atol": ATOL, "rtol": RTOL,
               "rel_l2_limit": ATTN_REL_L2}
        if name == "prefill_1536":
            # at ~0.05 ms a CUDA-event time of back-to-back calls may be the
            # host's; the graph times replay the calls from a CUDA graph
            row["ms"] = time_ms(lambda: fa.gqa_causal_attention(q, k, v, mask), 20)
            row["graph_ms"] = _bench.graph_ms(lambda: fa.gqa_causal_attention(q, k, v, mask), 20)
            row["plain_ms"] = time_ms(lambda: fa.gqa_causal_attention_reference(q, k, v, mask), 5)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

            def sdpa_causal():
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                      enable_gqa=True)

            row["library_ms"] = time_ms(sdpa_causal, 20)
            row["library_graph_ms"] = _bench.graph_ms(sdpa_causal, 20)
            row["ptxas"] = k2_ptxas
            row["tflops"] = 2 * b * 28 * s * s * 128 / row["ms"] / 1e9
            # causal: each query row reads the keys up to its own position
            row.update(bound(4 * b * 28 * (s * (s + 1) // 2) * 128,
                             2 * (q.numel() + k.numel() + v.numel() + out.numel()) + b * s,
                             PEAK_BF16))
            del qt, kt, vt
            report["gqa_causal_attention"] = dict(row)
        report.setdefault("gqa_causal_attention_err", []).append(max_err)
        emit(row)
        if n_bad or row["rel_l2_live_rows"] > ATTN_REL_L2:
            fail(f"K2 {name} disagrees with its plain version on live rows")
        if not pad_rows_zero:
            fail(f"K2 {name}: a left-pad row (no live key) is not exactly 0")
    del q, k, v, out, ref
    torch.cuda.empty_cache()

    # 5. K3 at the W4 lane's shapes; 6. K4-K6
    k3_phase(report, gen, time_ms)
    fused_quant_phase(report, gen, time_ms)

    from physicedit_torch.pipeline.testing import build_random_pipeline, random_pipeline

    rng = np.random.default_rng(SEED)

    def image(w, h, rng=rng):
        # a smooth random picture: low-resolution noise, upsampled
        small = rng.integers(0, 256, (h // 32, w // 32, 3), dtype=np.uint8)
        return Image.fromarray(small).resize((w, h), Image.BILINEAR)

    # 7. small pipeline: kernels on the card against plain versions on the CPU,
    # in bf16 and then quantized int4 (the fused W4 DiT path, K3-K6)
    small = dataclasses.replace(small_dims(), dinov2=None)
    small_edit = image(128, 128)
    edits = {  # name: (kwargs, the kernels the edit must launch on the card)
        "edit": (dict(edit_image=small_edit), ("fixedmax_attention", "gqa_causal_attention")),
        "eligen": (dict(edit_image=small_edit, eligen_entity_prompts=["a cup", "a plate"],
                        eligen_entity_masks=entity_masks(128, 128),
                        eligen_enable_on_negative=True),
                   ("fixedmax_attention_bias", "gqa_causal_attention")),
    }
    for quantize in (None, "int4"):
        pipe = random_pipeline(small, dev, torch.bfloat16, gen)
        if quantize:
            pipe.quantize_(quantize)
        common = dict(height=128, width=128, seed=11, num_inference_steps=2,
                      have_text_reasoning=False)
        got, launches = {}, {}
        for name, (kw, _) in edits.items():
            reset_counts()
            got[name] = np.asarray(pipe("tilt the cup", **kw, **common), np.float32)
            launches[name] = counts()
        pipe.to("cpu")
        for name, (kw, used) in edits.items():
            want = np.asarray(pipe("tilt the cup", **kw, **common), np.float32)
            rel = float(np.linalg.norm(got[name] - want) / np.linalg.norm(want - want.mean()))
            used = used + (("w4a8_matmul", "ln_mod_quant", "gelu_quant", "transpose_quant")
                           if quantize else ())
            emit({"phase": "small_pipeline_vs_cpu", "quantize": quantize, "path": name,
                  "rel_l2": rel, "limit": PIPE_REL_L2,
                  "max_abs_levels": float(np.abs(got[name] - want).max()),
                  "launches": launches[name]})
            if not rel <= PIPE_REL_L2 or min(launches[name][k] for k in used) == 0:
                fail(f"the small pipeline's {name} (quantize={quantize}) on the card disagrees "
                     "with the CPU run or skipped a kernel")
        del pipe

    # 10. a small training step: kernels on the card against plain versions on the CPU;
    # 16, on the same model: the distillation loss, and D1's drift over 50 steps
    small_training_phase(small, gen, dev)
    distill_phase(small, dev)
    d1_drift_phase(small, dev)

    # 7b. checkpoint loading at full width (depth cut): write, from_pretrained, the CLI;
    # and 15(a), the sweep's serving path on that tree (images of their own stream)
    sweep_rng = np.random.default_rng(SEED + 15)
    load_phase(gen, args.steps, image(1024, 1024),
               [image(w, h, sweep_rng) for w, h in ((1024, 1024), (1024, 1024), (768, 512))])

    # 8. the full-width slice (its generator state kept: 15(b) builds the same weights)
    full_gen_state = gen.get_state()
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
    edit_images[(1024, 1024, "b")] = image(1024, 1024)

    def edit(w, h, seed, reasoning, prompt=prompt, image=None):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = pipe(prompt, negative_prompt="",
                   edit_image=edit_images[(w, h)] if image is None else image,
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
    for i, (w, h, seed) in enumerate(requests):
        before = counts()
        with decode_cut(pipe, 1000 if i == 0 else EDIT_DECODE_CUT):
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

    # 8b. EliGen at full width (K7); 8c. batched serving
    eligen_launches = eligen_phase(pipe, edit_images[(1024, 1024)], args.steps, n_blocks,
                                   n_layers)
    bf16_img = serving_phase(pipe, edit_images, args.steps, n_blocks, edit)

    # 17. the multi-GPU slice on one card: (a) the ring's kernels lane over
    # virtual ranks, (b) the tensor-parallel splits of phase 8's weights, (c)
    # a world-1 NCCL group's ring edit, (d) an NCCL world of two where there
    # are two GPUs
    ring_launches = ring_virtual_phase(report, gen, time_ms)
    shard_phase(pipe, gen)
    ring_world1_phase(pipe, edit, bf16_img, edit_images[(1024, 1024)], args.steps, n_blocks)
    multi_gpu_phase()

    # 9. the W4 serving lane at full width, against the serving phase's first
    # single edit (1024^2, SEED + 4, reasoner off)
    w, h, seed = 1024, 1024, SEED + 4
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
    with decode_cut(pipe, EDIT_DECODE_CUT):
        _, row = edit(w, h, seed, True)
    launches = counts()
    # an edit runs no backward, no entity bias, no K10 / K10b / K1' and no
    # prototype: every other count is 0
    want = {**dict.fromkeys(launches, 0),
            **w4_launch_counts(pipe.timings, args.steps, n_blocks, n_layers,
                               pipe.vision.cfg.depth),
            **w4_regime_counts(pipe.timings, args.steps, n_blocks, n_layers,
                               pipe.vision.cfg.depth)}
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

    # 11. training at full width, on a freshly built pipeline
    import gc

    from physicedit_torch.profile_train import SyntheticVideo
    from physicedit_torch.train.trainer import TrainConfig

    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pipe = build_random_pipeline("full", device=dev, generator=gen)
    torch.cuda.synchronize()
    emit({"phase": "train_full_init", "seconds": time.perf_counter() - t0,
          "resident_gb": torch.cuda.memory_allocated() / 1e9,
          "dinov2": [pipe.dinov2.cfg.hidden_size, pipe.dinov2.cfg.num_layers,
                     pipe.dinov2.cfg.num_heads]})
    data = SyntheticVideo(n=3, width=832, height=480, frames=3, seed=SEED + 11)
    reset_counts()
    lanes = [train_lane(pipe, data, TrainConfig(lora_rank=128,
                                                optimizer_state_dtype="bfloat16"),
                        dev, n_blocks),
             train_lane(pipe, data, TrainConfig(lora_rank=128, quantize_frozen="w4"), dev,
                        n_blocks)]
    train_launches = counts()
    # the W4 lane packed the DiT in place: the pipeline still serves edits
    out = pipe(prompt, edit_image=image(512, 512), height=512, width=512, seed=SEED + 5,
               num_inference_steps=2, have_text_reasoning=False)
    arr = np.asarray(out, np.float32)
    emit({"phase": "edit_after_w4_training", "size": list(out.size), "image_std": float(arr.std())})
    if out.size != (512, 512) or not np.isfinite(arr).all() or arr.std() == 0.0:
        fail("the pipeline packed by the W4 training lane does not edit")
    joint, text_tokens, image_tokens = (lanes[0][k] for k in ("joint_tokens", "text_tokens",
                                                              "image_tokens"))
    del pipe, out
    gc.collect()
    torch.cuda.empty_cache()

    # 12. K8 and K9 at the training shapes, and K3 at the W4 lane's forward
    # shapes (the image and text streams, and the modulations at M = 1)
    k8_phase(report, gen, time_ms, joint)
    k9_phase(report, gen, time_ms, 2 * image_tokens, text_tokens)
    k3_check(report, gen, time_ms,
             [(f"image_{n}", 2 * image_tokens, k, o, True) for n, k, o in DIT_LINEARS]
             + [(f"text_{n}", text_tokens, k, o, True) for n, k, o in DIT_LINEARS]
             + [("mod", 1, 3072, 18432, True)], phase="k3_training")

    # 13. the attention prototypes, and their tools
    proto_launches = proto_phase(report, gen, time_ms, compare)

    # 14. the int8, W4 and elementwise-rate probes, and their tools
    int8_launches = int8_phase(report, gen, time_ms, compare)

    # 15(b). the W8A8 lane at full width, against the serving phase's first
    # single edit; 15(c). the three prompt refiners at their published widths
    w8a8_phase(full_gen_state, bf16_img, edit_images[(1024, 1024)], args.steps, dev)
    refiner_phase(gen)

    # each kernel's launches on its own path: K1 and K2 in the bf16 edits,
    # K3-K6 in the W4 edit, K8 and K9 in the training lanes, K7 in the
    # full-CFG EliGen edit, the prototypes and the probes in their tools
    path_launches = {**w4_launches,
                     **{k: main_launches[k] for k in ("fixedmax_attention",
                                                      "gqa_causal_attention")},
                     **{k: train_launches[k] for k in ("fixedmax_attention_bwd", "w4_bwd_dx")},
                     "fixedmax_attention_bias": eligen_launches["fixedmax_attention_bias"],
                     **attention_launches, **proto_launches, **int8_launches}
    if min(path_launches[name] for name, *_ in KERNEL_ROWS) == 0:
        fail(f"a kernel was not launched on its path: {path_launches}")
    kernels = []
    for name, src, replaces, ms_case in KERNEL_ROWS:
        launches = path_launches[name]
        timing = report[ms_case] if ms_case else report[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "loop": KERNEL_LOOPS[name], "launches": launches, "max_abs_err": max(report[f"{name}_err"]),
                        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
                        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
                        "library_ms": timing.get("library_ms")})
        if name in ring_launches:   # phase 17(a): n^2 launches over n virtual ranks
            kernels[-1]["ring_launches"] = ring_launches[name]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The serving flags of the sweep CLIs (``physicedit_tpu/cli/serving.py``):
batched denoise (``--batch_size``, ``eval/sweep.BucketBatcher``), the
quantized lanes (``--quantize int4|int8``), the attention route, the CFG
truncation, and two prompt preprocessors: an in-process refiner model
(``--prompt_refiner``, ``pipeline/prompt_refiners.py``) and any executable
(``--prompt_rewriter_cmd``, the injectable stand-in for the reference's
external rewriter, ``scripts/inference/inference_pica.py:29-122``).

``--data_parallel`` / ``--model_parallel`` are parsed as in the JAX package,
but a mesh (a value above 1) needs the multi-GPU slice of the port and
exits with a message saying so.
"""

from __future__ import annotations

import argparse
import os


def add_serving_args(p: argparse.ArgumentParser, with_rewriter: bool = False) -> None:
    from physicedit_torch.ops.attention import IMPLS

    g = p.add_argument_group("serving")
    g.add_argument("--batch_size", type=int, default=1,
                   help="Batch same-resolution edits into one denoise and one batched "
                        "reasoner call (eval/sweep.BucketBatcher)")
    g.add_argument("--quantize", type=str, default=None, choices=["int8", "int4"],
                   help="int4: the W4A8 lane (packed-int4 DiT, VL and ViT, int8 KV cache); "
                        "int8: the W8A8 lane (int8 DiT and VL text model)")
    g.add_argument("--data_parallel", type=int, default=1,
                   help="Mesh data axis size (above 1 needs the multi-GPU slice)")
    g.add_argument("--model_parallel", type=int, default=1,
                   help="Mesh model axis size (above 1 needs the multi-GPU slice; "
                        "exclusive with --quantize)")
    g.add_argument("--attn_impl", type=str, default=None, choices=list(IMPLS),
                   help="kernels: the hand-written CUDA attention; dense: a plain "
                        "softmax; default kernels where CUDA is present")
    g.add_argument("--cfg_truncate_step", type=int, default=None,
                   help="Run CFG only for the first K steps and the positive row alone "
                        "after (K=30 is the serving configuration; K=0 is positives-only "
                        "throughout; a negative K errors).  Default: CFG at every step")
    g.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    if with_rewriter:
        g.add_argument("--prompt_rewriter_cmd", type=str, default=None,
                       help="Executable that reads a prompt on stdin and writes the "
                            "rewritten prompt to stdout")
        g.add_argument("--prompt_refiner", type=str, default=None,
                       help="kind:/model/path in-process prompt refiner (kind: beautiful | "
                            "qwen | translate); runs before --prompt_rewriter_cmd")


def make_prompt_rewriter(cmd: str | None):
    """A shell command as a prompt -> prompt callable: the prompt goes to
    its stdin, the rewritten prompt comes from its stdout.  A failure, a
    non-zero exit or an empty output keeps the original prompt (the
    reference's rewriter keeps it after failed retries)."""
    if cmd is None:
        return None
    import shlex
    import subprocess

    argv = shlex.split(cmd)

    def rewrite(prompt: str) -> str:
        try:
            proc = subprocess.run(argv, input=prompt, capture_output=True, text=True,
                                  timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            print(f"[rewriter] failed ({e}); keeping original prompt", flush=True)
            return prompt
        out = proc.stdout.strip()
        if proc.returncode != 0 or not out:
            print(f"[rewriter] rc={proc.returncode}; keeping original prompt", flush=True)
            return prompt
        return out

    return rewrite


def make_prompt_preprocessor(args):
    """``--prompt_refiner`` (a model, on ``--device``) then
    ``--prompt_rewriter_cmd`` (an executable) as one prompt -> prompt
    callable for the sweeps' ``prompt_rewriter``; None when neither is given."""
    from physicedit_torch.pipeline.prompt_refiners import make_prompt_refiner

    stages = [f for f in (make_prompt_refiner(getattr(args, "prompt_refiner", None),
                                              device=getattr(args, "device", "cuda")),
                          make_prompt_rewriter(getattr(args, "prompt_rewriter_cmd", None)))
              if f is not None]
    if not stages:
        return None
    if len(stages) == 1:
        return stages[0]

    def chain(prompt: str) -> str:
        for f in stages:
            prompt = f(prompt)
        return prompt

    return chain


def build_pipeline(args):
    """The pipeline of the parsed serving args: ``from_pretrained`` on
    ``--base_model_path`` with ``--lora_path``, ``--quantize``,
    ``--attn_impl`` and ``--device``."""
    from physicedit_torch.cli.validate import find_model_files
    from physicedit_torch.ops.attention import default_impl
    from physicedit_torch.pipeline.edit_pipeline import PhysicEditPipeline

    n_mesh = args.data_parallel * args.model_parallel
    if n_mesh > 1 and args.quantize:
        raise SystemExit(
            "--quantize and --data_parallel/--model_parallel are alternative memory "
            "strategies (quantized single-card residency vs bf16 tensor parallelism); "
            "pick one")
    if n_mesh > 1:
        raise SystemExit(
            f"--data_parallel {args.data_parallel} x --model_parallel {args.model_parallel}: "
            "a mesh needs the multi-GPU slice of the port (M10: parallel/sharding.py, "
            "PhysicEditPipeline.shard), which is not ported; run one card per worker with "
            "--start_idx / --end_idx")
    tokenizer_path = args.tokenizer_path or os.path.join(args.base_model_path, "tokenizer")
    return PhysicEditPipeline.from_pretrained(
        find_model_files(args.base_model_path),
        tokenizer_path=tokenizer_path if os.path.isdir(tokenizer_path) else None,
        attn_impl=args.attn_impl or default_impl(), finetuned_path=args.lora_path,
        quantize=args.quantize, device=getattr(args, "device", "cuda"))

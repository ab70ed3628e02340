"""The serving flags of the sweep CLIs (``physicedit_tpu/cli/serving.py``):
batched denoise (``--batch_size``, ``eval/sweep.BucketBatcher``), the
quantized lanes (``--quantize int4|int8``), the attention route, the CFG
truncation, and two prompt preprocessors: an in-process refiner model
(``--prompt_refiner``, ``pipeline/prompt_refiners.py``) and any executable
(``--prompt_rewriter_cmd``, the injectable stand-in for the reference's
external rewriter, ``scripts/inference/inference_pica.py:29-122``).

``--data_parallel`` / ``--model_parallel`` lay a mesh over the GPUs, one
process each, started by ``torchrun --nproc_per_node N`` (N their product):
the DiT and the VL text model tensor-parallel over ``model``, batched
edits split over ``data`` (``PhysicEditPipeline.shard``).
``--attn_impl ring`` splits the DiT's joint sequence over ``model`` (on one
process, a mesh of one).
"""

from __future__ import annotations

import argparse
import os


def add_mesh_args(g) -> None:
    """The mesh and attention flags (:func:`build_pipeline` reads them)."""
    from physicedit_torch.ops.attention import IMPLS

    g.add_argument("--data_parallel", type=int, default=1,
                   help="Mesh data axis size: batched edits split over it")
    g.add_argument("--model_parallel", type=int, default=1,
                   help="Mesh model axis size: the DiT and the VL text model tensor-parallel "
                        "over it; run under torchrun with data_parallel x model_parallel "
                        "processes (exclusive with --quantize)")
    g.add_argument("--attn_impl", type=str, default=None, choices=list(IMPLS),
                   help="kernels: the hand-written CUDA attention; dense: a plain "
                        "softmax; ring: the joint sequence split over the model axis; "
                        "default kernels where CUDA is present")
    g.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")


def add_serving_args(p: argparse.ArgumentParser, with_rewriter: bool = False) -> None:
    g = p.add_argument_group("serving")
    g.add_argument("--batch_size", type=int, default=1,
                   help="Batch same-resolution edits into one denoise and one batched "
                        "reasoner call (eval/sweep.BucketBatcher)")
    g.add_argument("--quantize", type=str, default=None, choices=["int8", "int4"],
                   help="int4: the W4A8 lane (packed-int4 DiT, VL and ViT, int8 KV cache); "
                        "int8: the W8A8 lane (int8 DiT and VL text model)")
    add_mesh_args(g)
    g.add_argument("--cfg_truncate_step", type=int, default=None,
                   help="Run CFG only for the first K steps and the positive row alone "
                        "after (K=30 is the serving configuration; K=0 is positives-only "
                        "throughout; a negative K errors).  Default: CFG at every step")
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


def build_mesh(data_parallel: int, model_parallel: int, device: str, need: bool = False):
    """The (data, model) mesh of the flags, or None for a mesh of one unless
    ``need``: the process group is started from the launcher's environment
    (``multihost.initialize_distributed``), and its processes must be the
    mesh's devices, one each (the JAX package checks its device count)."""
    n_mesh = data_parallel * model_parallel
    if n_mesh == 1 and not need:
        return None
    import torch
    import torch.distributed as dist

    from physicedit_torch.parallel import multihost

    multihost.initialize_distributed(device=device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_mesh:
        raise SystemExit(
            f"mesh {data_parallel}x{model_parallel} needs {n_mesh} processes (one per GPU), "
            f"found {world}: run under torchrun --nproc_per_node {n_mesh}")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    if torch.device(device).type == "cuda" and torch.cuda.device_count() < local:
        raise SystemExit(f"mesh {data_parallel}x{model_parallel}: {local} processes on this "
                         f"node, {torch.cuda.device_count()} GPUs")
    return multihost.create_hybrid_mesh(data_parallel, model_parallel, device)


def build_pipeline(args):
    """The pipeline of the parsed serving args: ``from_pretrained`` on
    ``--base_model_path`` with ``--lora_path``, ``--quantize``,
    ``--attn_impl`` and ``--device``, sharded over the mesh of
    ``--data_parallel`` x ``--model_parallel`` (the ring's axis is the
    mesh's ``model``)."""
    from physicedit_torch.cli.validate import find_model_files
    from physicedit_torch.models.dit import set_ring_context
    from physicedit_torch.ops.attention import default_impl
    from physicedit_torch.parallel.sharding import MODEL_AXIS
    from physicedit_torch.pipeline.edit_pipeline import PhysicEditPipeline

    quantize = getattr(args, "quantize", None)
    if args.data_parallel * args.model_parallel > 1 and quantize:
        raise SystemExit(
            "--quantize and --data_parallel/--model_parallel are alternative memory "
            "strategies (quantized single-card residency vs bf16 tensor parallelism); "
            "pick one")
    device = getattr(args, "device", "cuda")
    attn_impl = args.attn_impl or default_impl()
    mesh = build_mesh(args.data_parallel, args.model_parallel, device,
                      need=attn_impl == "ring")
    tokenizer_path = args.tokenizer_path or os.path.join(args.base_model_path, "tokenizer")
    pipe = PhysicEditPipeline.from_pretrained(
        find_model_files(args.base_model_path),
        tokenizer_path=tokenizer_path if os.path.isdir(tokenizer_path) else None,
        attn_impl=attn_impl, finetuned_path=getattr(args, "lora_path", None),
        quantize=quantize, device=device)
    if mesh is not None:
        pipe.shard(mesh)
        if attn_impl == "ring":
            set_ring_context(mesh, MODEL_AXIS)
    return pipe

"""Training from the command line (``physicedit_tpu/cli/train.py``): the
JAX package's flags, on one card or on a mesh of them.

    python -m physicedit_torch.cli.train --dataset_base_path DATA \
        --base_model_path TREE --dinov2_path DINO.safetensors \
        [--output_path ./ckpt] [--quantize_frozen w4] [--optimizer adafactor] \
        [--gradient_accumulation_steps K] [--eval_every_n_steps N] \
        [--resume_from CKPT] [--data_process_output DIR | --cached_inputs_path DIR] \
        [--attn_impl kernels|dense|ring] [--device cuda|cpu]
    torchrun --nproc_per_node N -m physicedit_torch.cli.train ... \
        --data_parallel D --model_parallel M      # N = D * M

The tree is read by ``PhysicEditPipeline.from_pretrained`` (the files
``cli.validate.find_model_files`` finds), DINOv2 from its safetensors file
(with the ``config.json`` beside it when there is one, else DINOv2-B's).
``--data_process_output`` preprocesses every sample once into ``.npz``
bundles and exits; ``--cached_inputs_path`` trains from them.  A mesh
(``--data_parallel`` / ``--model_parallel``, one process per GPU, as
``cli/serving.build_mesh`` checks) trains the JAX package's way: the frozen
DiT tensor-parallel over ``model``, the global ``--batch_size`` split over
``data`` (``train/trainer.py``); the first process writes the files.
"""

from __future__ import annotations

import argparse
import json
import os


def build_parser() -> argparse.ArgumentParser:
    from physicedit_torch.ops.attention import IMPLS

    p = argparse.ArgumentParser(description="PhysicEdit training (GPU)")
    p.add_argument("--dataset_base_path", type=str, required=True)
    p.add_argument("--output_path", type=str, default="./ckpt")
    p.add_argument("--base_model_path", type=str, required=True)
    p.add_argument("--dinov2_path", type=str, required=True)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--num_frames", type=int, default=49)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--weight_decay", type=float, default=1e-2)
    p.add_argument("--num_epochs", type=int, default=5)
    p.add_argument("--lora_rank", type=int, default=128)
    p.add_argument("--save_every_n_steps", type=int, default=500)
    p.add_argument("--eval_every_n_steps", type=int, default=None)
    p.add_argument("--dataset_repeat", type=int, default=1)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--data_parallel", type=int, default=1)
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--resume_from", type=str, default=None)
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quantize_frozen", choices=("none", "w4"), default="none",
                   help="w4: pack the frozen DiT to int4 in place (K3 forward, K9 backward)")
    p.add_argument("--data_process_output", type=str, default=None,
                   help="preprocess every sample once into .npz bundles here, then exit")
    p.add_argument("--cached_inputs_path", type=str, default=None,
                   help="train from a --data_process_output folder instead of videos")
    p.add_argument("--optimizer_state_dtype", default="float32",
                   choices=("float32", "bfloat16"), help="Adam moment storage dtype")
    p.add_argument("--lora_dtype", default="float32", choices=("float32", "bfloat16"))
    p.add_argument("--optimizer", default="adamw", choices=("adamw", "adafactor"),
                   help="adafactor: a factored second moment, almost no optimizer state")
    p.add_argument("--loader_workers", type=int, default=2,
                   help="threads decoding videos ahead of the card; 0 = synchronous")
    p.add_argument("--adapters_dtype", default="float32", choices=("float32", "bfloat16"))
    p.add_argument("--attn_impl", type=str, default=None, choices=list(IMPLS),
                   help="kernels: the hand-written CUDA attention (K1 forward, K8 backward); "
                        "dense: a plain softmax; ring: the joint sequence split over the "
                        "model axis; default kernels where CUDA is present")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    return p


def load_dinov2(path: str, device):
    """DINOv2 in fp32 from a safetensors file, its ``config.json`` read from
    the same folder when there is one."""
    import torch

    from physicedit_torch.io.convert import dinov2_from_state_dict
    from physicedit_torch.io.safetensors_io import load_state_dict

    hf = None
    cfg_json = os.path.join(os.path.dirname(os.path.abspath(path)), "config.json")
    if os.path.exists(cfg_json):
        with open(cfg_json) as f:
            hf = json.load(f)
    return dinov2_from_state_dict(load_state_dict(path), hf, torch.float32, device)


def main(argv=None):
    """Run the command; returns the ``Trainer``."""
    from physicedit_torch.cli.serving import build_mesh
    from physicedit_torch.cli.validate import find_model_files
    from physicedit_torch.models.dit import set_ring_context
    from physicedit_torch.ops.attention import default_impl
    from physicedit_torch.parallel.multihost import is_main_process
    from physicedit_torch.parallel.sharding import MODEL_AXIS
    from physicedit_torch.pipeline.edit_pipeline import PhysicEditPipeline
    from physicedit_torch.train.dataset import CachedPreprocessedDataset, PhysicTranDataset
    from physicedit_torch.train.logging_utils import TrainLogger
    from physicedit_torch.train.trainer import TrainConfig, Trainer

    args = build_parser().parse_args(argv)
    attn_impl = args.attn_impl or default_impl()
    mesh = build_mesh(args.data_parallel, args.model_parallel, args.device,
                      need=attn_impl == "ring")

    tokenizer_path = args.tokenizer_path or os.path.join(args.base_model_path, "tokenizer")
    pipe = PhysicEditPipeline.from_pretrained(
        find_model_files(args.base_model_path),
        tokenizer_path=tokenizer_path if os.path.isdir(tokenizer_path) else None,
        attn_impl=attn_impl, device=args.device)
    if attn_impl == "ring":
        set_ring_context(mesh, MODEL_AXIS)
    pipe.dinov2 = load_dinov2(args.dinov2_path, args.device)

    if args.cached_inputs_path:
        dataset = CachedPreprocessedDataset(args.cached_inputs_path, repeat=args.dataset_repeat)
    else:
        dataset = PhysicTranDataset(args.dataset_base_path, num_frames=args.num_frames,
                                    height=args.height, width=args.width,
                                    repeat=args.dataset_repeat)

    cfg = TrainConfig(
        output_path=args.output_path, learning_rate=args.learning_rate,
        weight_decay=args.weight_decay, num_epochs=args.num_epochs,
        lora_rank=args.lora_rank, save_every_n_steps=args.save_every_n_steps,
        eval_every_n_steps=args.eval_every_n_steps,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        batch_size=args.batch_size, height=args.height, width=args.width, seed=args.seed,
        quantize_frozen=args.quantize_frozen,
        cached_inputs=args.cached_inputs_path is not None,
        optimizer_state_dtype=args.optimizer_state_dtype, lora_dtype=args.lora_dtype,
        optimizer=args.optimizer, adapters_dtype=args.adapters_dtype,
        loader_workers=args.loader_workers)

    trainer = Trainer(pipe, dataset, cfg,
                      logger=TrainLogger(args.use_wandb) if is_main_process() else None,
                      mesh=mesh, device=args.device)
    if args.data_process_output:
        trainer.cache_preprocessed(args.data_process_output)
        return trainer
    if args.resume_from:
        trainer.resume(args.resume_from)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()

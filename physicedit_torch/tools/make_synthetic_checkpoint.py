"""Write a pipeline's weights as a checkpoint tree in the HF / ModelScope
layout of the published Qwen-Image-Edit-2509 files, through the inverse of
the key maps in ``io/convert.py``:

    <out>/
      transformer/diffusion_pytorch_model-0000{1,2}-of-00002.safetensors
      transformer/diffusion_pytorch_model.safetensors.index.json
      text_encoder/model-0000{1,2}-of-00002.safetensors
      text_encoder/model.safetensors.index.json
      text_encoder/config.json
      vae/diffusion_pytorch_model.safetensors
      dinov2/model.safetensors, dinov2/config.json   (when the pipeline has DINOv2)
      tokenizer/                                     (an empty placeholder)
      physicedit_checkpoint.safetensors              (with ``trainable``)

The finetuned checkpoint is the published format as
``train/checkpoint.save_checkpoint`` writes it (peft LoRA keys without
prefix, the adapters under ``pipe.*``).  The tensors the loaders do not read
(the VAE's temporal ``time_conv``, DINOv2's ``mask_token`` and final norm)
are written as zeros (ones for a norm weight), so a tree has the published
key set.  ``shape_only_state_dicts`` gives the key/shape sets of the full
configs on the ``meta`` device, allocating nothing.

    python -m physicedit_torch.tools.make_synthetic_checkpoint --out /tmp/synth \\
        [--size tiny|full] [--layers N] [--device cuda|cpu]

writes the tree of a random-weight pipeline (``pipeline/testing.py``); then
``python -m physicedit_torch.cli.validate --base_model_path /tmp/synth ...``
loads it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import time

import torch

from physicedit_torch.io import convert as C
from physicedit_torch.io.safetensors_io import save_safetensors

FAMILIES = ("transformer", "text_encoder", "vae")


def reference_state_dicts(pipe) -> dict:
    """The pipeline's float weights in the published key spaces:
    ``{"transformer", "text_encoder", "vae"[, "dinov2"]: {key: tensor}}``,
    views of the parameters where the layouts agree."""
    out = {"transformer": C.dit_to_state_dict(pipe.dit),
           "text_encoder": C.text_encoder_to_state_dict(pipe.text, pipe.vision),
           "vae": C.vae_to_state_dict(pipe.vae)}
    if pipe.dinov2 is not None:
        out["dinov2"] = C.dinov2_to_state_dict(pipe.dinov2)
    return out


def shape_only_state_dicts(dims) -> dict:
    """The key/shape sets of ``dims`` (``pipeline.testing.PipelineDims``),
    as ``meta`` tensors: the DiT, the text encoder (text model and ViT) and
    the VAE."""
    from physicedit_torch.models.dit import DiT
    from physicedit_torch.models.qwen_vl import QwenVLText
    from physicedit_torch.models.qwen_vl_vision import QwenVLVision
    from physicedit_torch.models.vae import VAE

    bf16 = torch.bfloat16
    return {"transformer": C.dit_to_state_dict(DiT(dims.dit, bf16)),
            "text_encoder": C.text_encoder_to_state_dict(QwenVLText(dims.text, bf16),
                                                         QwenVLVision(dims.vision, bf16)),
            "vae": C.vae_to_state_dict(VAE(dims.vae, bf16))}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def save_sharded(sd: dict, folder: str, stem: str, n_shards: int = 2) -> int:
    """``sd`` as ``n_shards`` files and the HF ``.safetensors.index.json``
    weight map; returns the bytes of tensor data."""
    os.makedirs(folder, exist_ok=True)
    keys = sorted(sd)
    per = -(-len(keys) // n_shards)
    weight_map, total = {}, 0
    for i in range(n_shards):
        fname = f"{stem}-{i + 1:05d}-of-{n_shards:05d}.safetensors"
        shard = {k: sd[k] for k in keys[i * per:(i + 1) * per]}
        total += save_safetensors(shard, os.path.join(folder, fname))
        weight_map.update(dict.fromkeys(shard, fname))
    with open(os.path.join(folder, f"{stem}.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=1)
    return total


@torch.no_grad()
def random_trainable(pipe, rank: int, dino_dim: int, generator: torch.Generator):
    """A ``train.trainer.Trainable`` for ``pipe``: LoRA factors of ``rank``
    (A as ``init_dit_lora`` draws it, B ~ N(0, (0.02 / sqrt(rank))^2) rather
    than 0, so the merge changes the DiT) and the training adapters with
    ``init_trainable``'s distributions, the pipeline's dual adapter copied."""
    from physicedit_torch.core.params import init_random_, materialize
    from physicedit_torch.lora import init_dit_lora
    from physicedit_torch.models.adapters import init_perceiver_
    from physicedit_torch.train.trainer import Trainable, TrainingAdapters

    dev = pipe.device
    adapters = materialize(TrainingAdapters(pipe.dit.cfg.txt_in_dim, dino_dim,
                                            dtype=torch.float32), dev)
    init_random_(adapters, generator)
    for name in ("dino_resampler", "vae_resampler"):
        init_perceiver_(getattr(adapters, name), generator)
    for name in ("dino_time_embed", "vae_time_embed"):
        getattr(adapters, name).normal_(0.0, 0.02, generator=generator)
    if pipe.adapter is not None:
        for dst, src in zip(adapters.visual_thinking_adapter.parameters(),
                            pipe.adapter.parameters()):
            dst.copy_(src)
    lora = init_dit_lora(pipe.dit.cfg, rank, torch.float32, dev, generator)
    for leaf in lora.children():
        leaf.B.normal_(0.0, 0.02 / math.sqrt(rank), generator=generator)
    return Trainable(lora, adapters)


def write_tree(pipe, out: str, trainable=None, n_shards: int = 2) -> dict:
    """Write ``pipe``'s tree (and, with ``trainable``, its finetuned
    checkpoint through ``save_checkpoint``) under ``out``.  The text
    encoder's ``config.json`` carries the pipeline's image-pad and
    vision-start token ids.  The pipeline must be in its float layout (not
    after ``quantize_``).  Returns ``{"bytes", "seconds", "paths"}``."""
    from physicedit_torch.train.checkpoint import save_checkpoint

    t0 = time.perf_counter()
    os.makedirs(out, exist_ok=True)
    sds = reference_state_dicts(pipe)
    total = save_sharded(sds.pop("transformer"), os.path.join(out, "transformer"),
                         "diffusion_pytorch_model", n_shards)
    folder = os.path.join(out, "text_encoder")
    total += save_sharded(sds.pop("text_encoder"), folder, "model", n_shards)
    hf = C.text_encoder_hf_config(dataclasses.replace(
        pipe.text.cfg, image_token_id=pipe.image_pad_id,
        vision_start_token_id=pipe.vision_start_id), pipe.vision.cfg)
    with open(os.path.join(folder, "config.json"), "w") as f:
        json.dump(hf, f, indent=1)
    os.makedirs(os.path.join(out, "vae"), exist_ok=True)
    total += save_safetensors(sds.pop("vae"),
                              os.path.join(out, "vae", "diffusion_pytorch_model.safetensors"))
    if "dinov2" in sds:
        os.makedirs(os.path.join(out, "dinov2"), exist_ok=True)
        total += save_safetensors(sds.pop("dinov2"), os.path.join(out, "dinov2",
                                                                  "model.safetensors"))
        with open(os.path.join(out, "dinov2", "config.json"), "w") as f:
            json.dump(C.dinov2_hf_config(pipe.dinov2.cfg), f, indent=1)
    os.makedirs(os.path.join(out, "tokenizer"), exist_ok=True)
    paths = {"base": out}
    if trainable is not None:
        ckpt = save_checkpoint(os.path.join(out, "train"), trainable, global_step=0, epoch=0)
        paths["finetuned"] = os.path.join(out, "physicedit_checkpoint.safetensors")
        total += os.path.getsize(ckpt)
        os.replace(ckpt, paths["finetuned"])
        shutil.rmtree(os.path.join(out, "train"))
    return {"bytes": total, "seconds": time.perf_counter() - t0, "paths": paths}


def main(argv=None) -> dict:
    from physicedit_torch.pipeline.testing import SIZES, random_pipeline

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--size", choices=sorted(SIZES), default="tiny")
    ap.add_argument("--layers", type=int, default=None,
                        help="DiT blocks and VL text layers (default: the size's own)")
    ap.add_argument("--lora_rank", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dims = SIZES[args.size]
    if args.layers is not None:
        dims = dataclasses.replace(
            dims, dit=dataclasses.replace(dims.dit, num_layers=args.layers),
            text=dataclasses.replace(dims.text, num_layers=args.layers))
    dtype = torch.bfloat16 if args.size == "full" else torch.float32
    gen = torch.Generator(args.device).manual_seed(args.seed)
    pipe = random_pipeline(dims, args.device, dtype, gen)
    dino_dim = pipe.dinov2.cfg.hidden_size if pipe.dinov2 is not None else 64
    info = write_tree(pipe, args.out, random_trainable(pipe, args.lora_rank, dino_dim, gen))
    print(json.dumps({"out": args.out, "gb": info["bytes"] / 1e9, "seconds": info["seconds"]}))
    return info


if __name__ == "__main__":
    main()

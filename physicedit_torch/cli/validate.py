"""The single-image edit CLI (``physicedit_tpu/cli/validate.py``, the
reference's ``scripts/inference/validate.py``):

    python -m physicedit_torch.cli.validate --prompt "..." --image_path in.png \\
        --save_path out.png --base_model_path <Qwen-Image-Edit-2509 tree> \\
        [--lora_path physicedit_checkpoint.safetensors] [--attn_impl kernels|dense] \\
        [--quantize int4|int8] [--device cuda|cpu]

The input is resized to about 1024² (each side a multiple of 32), the model
files are found in the HF/ModelScope layout under ``--base_model_path``, the
finetuned checkpoint's DiT LoRA is merged and its adapters loaded, and the
edit runs at the resized size.  ``--attn_impl``: ``kernels`` (the
hand-written CUDA attention; the JAX package's ``pallas``) or ``dense`` (a
plain softmax; its ``xla``); by default ``kernels`` where CUDA is present.
"""

from __future__ import annotations

import argparse
import glob
import math
import os


def resize_image(image, target_area: int = 1024 * 1024):
    """About ``target_area`` pixels at the image's aspect ratio, each side
    rounded to a multiple of 32."""
    width = math.sqrt(target_area * image.size[0] / image.size[1])
    height = width / (image.size[0] / image.size[1])
    width = round(width / 32) * 32
    height = round(height / 32) * 32
    return image.resize((int(width), int(height)))


def find_model_files(base: str) -> list:
    """The transformer, text-encoder and VAE files of a Qwen-Image-Edit
    layout under ``base`` (shards as one list); any safetensors under
    ``base`` when none is found."""
    patterns = ["transformer/diffusion_pytorch_model*.safetensors",
                "text_encoder/model*.safetensors",
                "vae/diffusion_pytorch_model.safetensors"]
    paths = []
    for sub in ("Qwen/Qwen-Image-Edit-2509", "Qwen/Qwen-Image", ""):
        for pat in patterns:
            hits = sorted(glob.glob(os.path.join(base, sub, pat)))
            if hits:
                paths.append(hits if len(hits) > 1 else hits[0])
    if not paths:
        paths = sorted(glob.glob(os.path.join(base, "**/*.safetensors"), recursive=True))
    return paths


def main(argv=None):
    from PIL import Image

    from physicedit_torch.ops.attention import IMPLS, default_impl
    from physicedit_torch.pipeline.edit_pipeline import PhysicEditPipeline

    parser = argparse.ArgumentParser(description="Single-image physics-aware edit (GPU)")
    parser.add_argument("--prompt", type=str, required=True)
    parser.add_argument("--image_path", type=str, required=True)
    parser.add_argument("--save_path", type=str, required=True)
    parser.add_argument("--base_model_path", type=str, required=True,
                        help="Folder containing the Qwen-Image-Edit-2509 "
                             "transformer/text_encoder/vae safetensors")
    parser.add_argument("--dinov2_path", type=str, default=None,
                        help="DINOv2 path (the training prior; accepted, not needed here)")
    parser.add_argument("--lora_path", type=str, default=None,
                        help="Finetuned PhysicEdit checkpoint (.safetensors)")
    parser.add_argument("--tokenizer_path", type=str, default=None,
                        help="Tokenizer folder (defaults to base/tokenizer)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--num_inference_steps", type=int, default=40)
    parser.add_argument("--cfg_scale", type=float, default=4.0)
    parser.add_argument("--no_text_reasoning", action="store_true")
    parser.add_argument("--attn_impl", type=str, default=None, choices=list(IMPLS),
                        help="kernels: the hand-written CUDA attention (the JAX package's "
                             "'pallas'); dense: a plain softmax (its 'xla'); default "
                             "kernels where CUDA is present, else dense")
    parser.add_argument("--quantize", type=str, default=None, choices=["int8", "int4"],
                        help="int4: the W4A8 lane (packed-int4 DiT, VL and ViT); "
                             "int8: the W8A8 lane (int8 DiT and VL text model)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu (the kernels' plain versions)")
    args = parser.parse_args(argv)

    tokenizer_path = args.tokenizer_path or os.path.join(args.base_model_path, "tokenizer")
    pipe = PhysicEditPipeline.from_pretrained(
        find_model_files(args.base_model_path),
        tokenizer_path=tokenizer_path if os.path.isdir(tokenizer_path) else None,
        attn_impl=args.attn_impl or default_impl(), finetuned_path=args.lora_path,
        quantize=args.quantize, device=args.device)

    image = resize_image(Image.open(args.image_path).convert("RGB"))
    out = pipe(args.prompt, edit_image=image, seed=args.seed,
               num_inference_steps=args.num_inference_steps, cfg_scale=args.cfg_scale,
               height=image.size[1], width=image.size[0],
               have_text_reasoning=not args.no_text_reasoning)
    os.makedirs(os.path.dirname(os.path.abspath(args.save_path)), exist_ok=True)
    out.save(args.save_path)
    print(f"[DONE] saved {args.save_path}")
    return pipe


if __name__ == "__main__":
    main()

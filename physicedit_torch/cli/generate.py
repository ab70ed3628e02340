"""The text-to-image CLI (``physicedit_tpu/cli/generate.py``): the base
Qwen-Image generation path with no edit image (the T2I template, noise-only
latents, the CFG denoise, the decode):

    python -m physicedit_torch.cli.generate --prompt "..." --save_path out.png \\
        --base_model_path <tree> [--height 1328 --width 1328] [--device cuda|cpu] \
        [--data_parallel D --model_parallel M] [--attn_impl kernels|dense|ring]

The mesh flags are ``cli/serving.py``'s (``build_pipeline``): under
``torchrun`` the DiT and the VL text model run tensor-parallel, and the
first process writes the image.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    from physicedit_torch.cli.serving import add_mesh_args, build_pipeline
    from physicedit_torch.parallel.multihost import is_main_process

    p = argparse.ArgumentParser(description="Text-to-image generation (GPU)")
    p.add_argument("--prompt", type=str, required=True)
    p.add_argument("--negative_prompt", type=str, default="")
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--base_model_path", type=str, required=True)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--height", type=int, default=1328)
    p.add_argument("--width", type=int, default=1328)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_inference_steps", type=int, default=40)
    p.add_argument("--cfg_scale", type=float, default=4.0)
    add_mesh_args(p)
    args = p.parse_args(argv)

    pipe = build_pipeline(args)
    out = pipe(args.prompt, negative_prompt=args.negative_prompt, height=args.height,
               width=args.width, seed=args.seed, num_inference_steps=args.num_inference_steps,
               cfg_scale=args.cfg_scale, have_text_reasoning=False)
    if is_main_process():
        os.makedirs(os.path.dirname(os.path.abspath(args.save_path)), exist_ok=True)
        out.save(args.save_path)
        print(f"[DONE] saved {args.save_path}")
    return pipe


if __name__ == "__main__":
    main()

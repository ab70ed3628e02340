"""The text-to-image CLI (``physicedit_tpu/cli/generate.py``): the base
Qwen-Image generation path with no edit image (the T2I template, noise-only
latents, the CFG denoise, the decode):

    python -m physicedit_torch.cli.generate --prompt "..." --save_path out.png \\
        --base_model_path <tree> [--height 1328 --width 1328] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    from physicedit_torch.cli.validate import find_model_files
    from physicedit_torch.ops.attention import default_impl
    from physicedit_torch.pipeline.edit_pipeline import PhysicEditPipeline

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
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    args = p.parse_args(argv)

    tokenizer_path = args.tokenizer_path or os.path.join(args.base_model_path, "tokenizer")
    pipe = PhysicEditPipeline.from_pretrained(
        find_model_files(args.base_model_path),
        tokenizer_path=tokenizer_path if os.path.isdir(tokenizer_path) else None,
        attn_impl=default_impl(), device=args.device)
    out = pipe(args.prompt, negative_prompt=args.negative_prompt, height=args.height,
               width=args.width, seed=args.seed, num_inference_steps=args.num_inference_steps,
               cfg_scale=args.cfg_scale, have_text_reasoning=False)
    os.makedirs(os.path.dirname(os.path.abspath(args.save_path)), exist_ok=True)
    out.save(args.save_path)
    print(f"[DONE] saved {args.save_path}")
    return pipe


if __name__ == "__main__":
    main()

"""The PICABench sweep CLI (``physicedit_tpu/cli/inference_pica.py``, the
reference's ``scripts/inference/inference_pica.py`` flags):

    python -m physicedit_torch.cli.inference_pica --base_model_path <tree> \\
        --output_dir out/ [--prompt_type intermediate] [--start_idx 0 --end_idx N] \\
        [--local_dataset_path ds/] [--batch_size 2] [--quantize int4|int8] \\
        [--prompt_rewriter_cmd CMD] [--prompt_refiner kind:path] [--device cuda|cpu]

Each worker owns a disjoint ``[--start_idx, --end_idx)``; the serving flags
are ``cli/serving.py``'s.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from physicedit_torch.cli.serving import (add_serving_args, build_pipeline,
                                              make_prompt_preprocessor)
    from physicedit_torch.eval import sweep

    p = argparse.ArgumentParser(description="PICABench sweep (GPU)")
    p.add_argument("--base_model_path", type=str, required=True)
    p.add_argument("--lora_path", type=str, default=None)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--prompt_type", type=str, default="intermediate",
                   choices=["superficial", "intermediate", "explicit"])
    p.add_argument("--start_idx", type=int, default=0)
    p.add_argument("--end_idx", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--num_inference_steps", type=int, default=40)
    p.add_argument("--local_dataset_path", type=str, default=None)
    p.add_argument("--tokenizer_path", type=str, default=None)
    add_serving_args(p, with_rewriter=True)
    args = p.parse_args(argv)

    pipe = build_pipeline(args)
    sweep.run_pica_sweep(pipe, args.output_dir, prompt_type=args.prompt_type,
                         start_idx=args.start_idx, end_idx=args.end_idx, seed=args.seed,
                         num_inference_steps=args.num_inference_steps,
                         local_dataset_path=args.local_dataset_path,
                         prompt_rewriter=make_prompt_preprocessor(args),
                         batch_size=args.batch_size, cfg_truncate_step=args.cfg_truncate_step)
    return pipe


if __name__ == "__main__":
    main()

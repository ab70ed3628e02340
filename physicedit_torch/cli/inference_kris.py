"""The KRIS-Bench sweep CLI (``physicedit_tpu/cli/inference_kris.py``, the
reference's ``scripts/inference/inference_kris.py`` flags):

    python -m physicedit_torch.cli.inference_kris --base_model_path <tree> \\
        --output_dir out/ [--start_idx 0 --end_idx N] [--local_dataset_path ds/] \\
        [--batch_size 2] [--quantize int4|int8] [--device cuda|cpu]

One output folder per category; the serving flags are ``cli/serving.py``'s.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from physicedit_torch.cli.serving import add_serving_args, build_pipeline
    from physicedit_torch.eval import sweep

    p = argparse.ArgumentParser(description="KRIS-Bench sweep (GPU)")
    p.add_argument("--base_model_path", type=str, required=True)
    p.add_argument("--lora_path", type=str, default=None)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--start_idx", type=int, default=0)
    p.add_argument("--end_idx", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--num_inference_steps", type=int, default=40)
    p.add_argument("--local_dataset_path", type=str, default=None)
    p.add_argument("--tokenizer_path", type=str, default=None)
    add_serving_args(p)
    args = p.parse_args(argv)

    pipe = build_pipeline(args)
    sweep.run_kris_sweep(pipe, args.output_dir, start_idx=args.start_idx,
                         end_idx=args.end_idx, seed=args.seed,
                         num_inference_steps=args.num_inference_steps,
                         local_dataset_path=args.local_dataset_path,
                         batch_size=args.batch_size, cfg_truncate_step=args.cfg_truncate_step)
    return pipe


if __name__ == "__main__":
    main()

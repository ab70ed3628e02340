"""Where the device time of one full-width training step goes, by
``torch.profiler``.

    python -m physicedit_torch.profile_train [--quantize w4] > profile_train.txt

Builds the full-width pipeline (random bf16 weights, one GPU), a trainer in
the bf16 lane (LoRA r128, bf16 Adam moments) or, with ``--quantize w4``, the
W4 lane (the DiT packed int4 in place, fp32 moments), preprocesses one
synthetic 480x832 video sample, runs one step to warm up and profiles the
next.  Prints one JSON line (wall time with and without the profiler,
device-busy time as the union of kernel intervals, the device time of K1,
K8, K3, K9, of the library GEMMs and of the fp32 ones among them, kernels
launched) and the profiler's top entries by device time.  On the card only
device activity is traced: a step launches ~50 k kernels, and tracing the
host's operators too costs a minute of post-processing per step.
``chip_smoke.py`` calls :func:`profile_train_step` in both lanes.
"""

from __future__ import annotations

import json

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from physicedit_torch.profile_edit import _busy_ms, _device_events, _device_ms, _table, _timed


class SyntheticVideo:
    """Random 'video' samples (``tests/test_trainer.py::SyntheticDataset`` at
    any size): noise frames for the target, the edit image and the key
    frames, and the dataset triplet."""

    def __init__(self, n: int = 3, width: int = 832, height: int = 480, frames: int = 3,
                 seed: int = 0):
        self.n, self.size, self.frames, self.seed = n, (height, width), frames, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        from PIL import Image

        rng = np.random.default_rng(self.seed + i)

        def img():
            return Image.fromarray(rng.integers(0, 255, (*self.size, 3), dtype=np.uint8))

        return {"image": img(), "edit_image": img(),
                "middle_key_frames": [img() for _ in range(self.frames)],
                "prompt": f"sample {i}: make the glass fall off the table and shatter",
                "triplet": {"middle_transition_prompt": "the glass tips over the edge",
                            "final_state_prompt": "shards lie on the floor"}}


def profile_train_step(trainer, batch: dict, rows: int = 20):
    """One profiled ``Trainer.step`` on ``batch`` (after the caller's warm
    steps).  Returns (summary dict, profiler table)."""
    dev = trainer.device
    activity = ProfilerActivity.CUDA if dev.type == "cuda" else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        _, wall_prof = _timed(lambda: trainer.step(batch), dev)
    busy = _busy_ms(prof)

    def library_ms(*parts):   # cuBLAS names its kernels *gemm* or nvjet*
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if any(p in e.key.lower() for p in parts)) / 1e3

    return {"stage": "train_step", "quantize_frozen": trainer.cfg.quantize_frozen,
            "joint_tokens": int(batch["prompt_emb"].shape[1] + 2 * batch["edit_tokens"].shape[1]),
            "wall_ms_profiled": wall_prof, "device_busy_ms": busy,
            "device_busy_share_of_profiled_wall": busy / wall_prof,
            "k1_device_ms": _device_ms(prof, "fixedmax_kernel"),
            "k8_device_ms": _device_ms(prof, "fm_bwd_"),
            "k3_device_ms": _device_ms(prof, "w4a8_"),
            "k9_device_ms": _device_ms(prof, "w4_bwd_dx"),
            "gemm_device_ms": library_ms("gemm", "nvjet", "cutlass"),
            "fp32_gemm_device_ms": library_ms("f32f32"),
            "kernels": len(_device_events(prof))}, _table(prof, rows)


def main(argv=None) -> int:
    import argparse
    import subprocess

    from physicedit_torch.pipeline.testing import build_random_pipeline
    from physicedit_torch.train.trainer import TrainConfig, Trainer

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quantize", choices=["w4"], default=None,
                    help="profile the W4 lane (TrainConfig.quantize_frozen='w4')")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    dev = torch.device("cuda")
    pipe = build_random_pipeline("full", device=dev,
                                 generator=torch.Generator(dev).manual_seed(0))
    cfg = (TrainConfig(quantize_frozen="w4") if args.quantize
           else TrainConfig(optimizer_state_dtype="bfloat16"))
    data = SyntheticVideo(n=1)
    trainer = Trainer(pipe, data, cfg, device=dev)
    batch = trainer.preprocess(data[0])
    _, wall = _timed(lambda: trainer.step(batch), dev)
    summary, table = profile_train_step(trainer, batch)
    print(json.dumps({**summary, "first_step_wall_ms": wall}), flush=True)
    print(table, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Where the device time of the full-width edit goes, by ``torch.profiler``.

    python -m physicedit_torch.profile_edit [--quantize int4] > profile.txt

Builds the full-width pipeline (random bf16 weights, one GPU; with
``--quantize int4`` then quantized in place to the W4 lane) and profiles
the two stages that dominate an edit:

  * one DiT forward at the CFG shape of a 1024x1024 edit (B=2, base + edit
    image = 8192 tokens, slim last block) for text lengths 256 (joint 8448,
    a real prompt) and 1280 (joint 9472, what the random reasoner's 1000
    tokens make);
  * reasoner greedy decode per token after a 512-token prefill.

Each measurement prints one JSON line (wall time with and without the
profiler, device-busy time as the union of kernel intervals, K1's device
time, kernels launched) and the profiler's top entries by device time.
"""

from __future__ import annotations

import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from physicedit_torch.ops import rope as m_rope


def _activities(dev: torch.device):
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _device_events(prof):
    """Device kernels and copies; CUPTI's "Command Buffer Full" marks a host
    stall on a full launch queue, not work on the device, and is left out."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name != "Command Buffer Full"]


def _busy_ms(prof) -> float:
    """Union of the device kernels' intervals, in ms."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((ev.time_range.start, ev.time_range.end) for ev in _device_events(prof)):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def _device_ms(prof, name_part: str) -> float:
    return sum(e.self_device_time_total for e in prof.key_averages()
               if name_part in e.key) / 1e3


def _table(prof, rows: int) -> str:
    return prof.key_averages().table(sort_by="self_device_time_total", row_limit=rows)


def _timed(fn, dev: torch.device):
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, (time.perf_counter() - t0) * 1e3


@torch.no_grad()
def profile_dit_step(pipe, txt_len: int, grid: tuple[int, int] = (64, 64),
                     generator: torch.Generator | None = None, rows: int = 18):
    """One CFG DiT forward: B=2, two images of ``grid`` patches, ``txt_len``
    text tokens (the second row's second half masked, as a shorter negative
    prompt).  Returns (summary dict, profiler table)."""
    dit, dev = pipe.dit, pipe.device
    cfg = dit.cfg
    n_img = grid[0] * grid[1]

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=generator).to(pipe.dtype)

    img, txt = randn(2, 2 * n_img, cfg.patch_dim), randn(2, txt_len, cfg.txt_in_dim)
    mask = torch.ones(2, txt_len, dtype=torch.bool, device=dev)
    mask[1, txt_len // 2:] = False
    ropes = [torch.from_numpy(r).to(dev) for r in m_rope.build_rope_tables(
        [(1, *grid), (1, *grid)], txt_len, axes_dim=pipe.rope_axes)]
    t = torch.full((2,), 0.5, device=dev, dtype=pipe.dtype)

    def step():
        return dit(img, txt, t, *ropes, txt_key_mask=mask, slim_last=n_img,
                   attn_clamp=pipe.attn_clamp)

    for _ in range(2):
        step()
    _, wall = _timed(step, dev)
    with profile(activities=_activities(dev)) as prof:
        _, wall_prof = _timed(step, dev)
    busy = _busy_ms(prof)
    return {"stage": "dit_cfg_step", "joint_tokens": 2 * n_img + txt_len, "batch": 2,
            "wall_ms": wall, "wall_ms_profiled": wall_prof, "device_busy_ms": busy,
            "device_busy_share_of_profiled_wall": busy / wall_prof,
            "k1_device_ms": _device_ms(prof, "fixedmax_kernel"),
            "k3_device_ms": _device_ms(prof, "w4a8_"),
            "k4_k6_device_ms": sum(_device_ms(prof, f"{n}_kernel") for n in
                                   ("ln_mod_quant", "gelu_quant", "transpose_quant")),
            "kernels": len(_device_events(prof))}, _table(prof, rows)


@torch.no_grad()
def profile_decode(pipe, prompt_len: int = 512, tokens: int = 20, profiled: int = 5,
                   generator: torch.Generator | None = None, rows: int = 12):
    """Reasoner greedy decode, B=1, after a ``prompt_len`` prefill of random
    embeddings (with the pipeline's KV cache: int8 on the W4 lane).
    Returns (summary dict, profiler table)."""
    text, dev = pipe.text, pipe.device
    cfg = text.cfg
    emb = (torch.randn(1, prompt_len, cfg.hidden_size, device=dev, generator=generator)
           * 0.02).to(pipe.dtype)
    pos = torch.arange(prompt_len, device=dev)[None, None].expand(3, 1, prompt_len)
    am = torch.ones(1, prompt_len, dtype=torch.bool, device=dev)
    logits, caches, _ = text.prefill(emb, pos.contiguous(), am,
                                     prompt_len + tokens + profiled + 3,
                                     kv_int8=pipe.kv_int8)
    first = logits.argmax(-1)
    start = torch.full((1,), prompt_len, device=dev, dtype=torch.long)

    def decode(n):
        return text.greedy_decode(caches, first, prompt_len, start, n)[1]

    decode(3)
    steps, wall = _timed(lambda: decode(tokens), dev)
    with profile(activities=_activities(dev)) as prof:
        psteps, _ = _timed(lambda: decode(profiled), dev)
    psteps = max(1, psteps)
    return {"stage": "reasoner_decode", "cache_len": prompt_len, "tokens": steps,
            "ms_per_token": wall / max(1, steps),
            "device_busy_ms_per_token": _busy_ms(prof) / psteps,
            "kernels_per_token": len(_device_events(prof)) / psteps}, _table(prof, rows)


def main(argv=None) -> int:
    import argparse
    import subprocess

    from physicedit_torch.pipeline.testing import build_random_pipeline

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quantize", choices=["int4"], default=None,
                    help="profile the W4 lane (PhysicEditPipeline.quantize_)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_edit: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    pipe = build_random_pipeline("full", device=dev, generator=gen, quantize=args.quantize)
    runs = [lambda: profile_dit_step(pipe, 256, generator=gen),
            lambda: profile_dit_step(pipe, 1280, generator=gen),
            lambda: profile_decode(pipe, generator=gen)]
    for run in runs:
        summary, table = run()
        print(json.dumps(summary), flush=True)
        print(table, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Training logs and timings (``physicedit_tpu/train/logging_utils.py``):
per-step scalars to wandb when it is installed and asked for, tagged stdout
lines otherwise; named wall-clock stages; a ``torch.profiler`` trace in
place of the JAX package's ``jax.profiler`` one.
"""

from __future__ import annotations

import contextlib
import os
import time


class TrainLogger:
    def __init__(self, use_wandb: bool = False, project: str = "physicedit-tpu",
                 run_name: str | None = None, log_every: int = 10):
        self.log_every = log_every
        self.wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(project=project, name=run_name)
                self.wandb = wandb
            except ImportError:
                print("[LOG] wandb not installed; falling back to stdout")
        self._window = []

    def log_step(self, step: int, epoch: int, metrics: dict, step_time: float):
        """Record one step; every ``log_every`` steps print the window's means."""
        scalars = {k: float(v) for k, v in metrics.items()}
        scalars["step_time_s"] = step_time
        self._window.append(scalars)
        if self.wandb is not None:
            self.wandb.log({"train/" + k: v for k, v in scalars.items()}, step=step)
        if step % self.log_every == 0:
            avg = {k: sum(s[k] for s in self._window) / len(self._window) for k in scalars}
            self._window.clear()
            msg = " ".join(f"{k}={v:.4f}" for k, v in avg.items())
            print(f"[TRAIN] step={step} epoch={epoch} {msg}", flush=True)

    def log_eval_image(self, step: int, image, caption: str = ""):
        if self.wandb is not None:
            self.wandb.log({"eval/image": self.wandb.Image(image, caption=caption)}, step=step)

    def finish(self):
        if self.wandb is not None:
            self.wandb.finish()


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Trace the block with ``torch.profiler`` (host, and the card when
    there is one) and write ``<log_dir>/trace.json`` (Chrome trace format);
    yields the profiler, or None when ``log_dir`` is None."""
    if log_dir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Wall-clock timing of named stages; ``summary()`` gives each mean."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        return " | ".join(f"{k}: {self.totals[k] / max(self.counts[k], 1) * 1e3:.1f}ms"
                          for k in self.totals)

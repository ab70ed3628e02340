"""Training logs (``physicedit_tpu/train/logging_utils.py``): per-step
scalars to wandb when it is installed and asked for, tagged stdout lines
otherwise.  Timing inside the program is ``torch.profiler`` over the spans
of ``core/trace.py``.
"""

from __future__ import annotations


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

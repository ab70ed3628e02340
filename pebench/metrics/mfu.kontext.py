"""The whole Kontext step's share of the chip's bf16 peak: the least time
of the step's model FLOPs (``roofline/flux_step.py``), times the steps
run, over the traced window."""

from pebench.roofline import load


def read(run):
    if not run.kernels or run.steps == 0 or run.window_s <= 0:
        return None
    return 100.0 * load("flux_step").step_least_s(run.shapes) * run.steps / run.window_s

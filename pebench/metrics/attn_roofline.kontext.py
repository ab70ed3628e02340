"""The Kontext step's joint attention forward (K1) against its roofline:
the bound of every call of the traced steps (``roofline/flux_step.py``,
``roofline/attn_fwd.call_bound_s``) over the device time of K1."""

from pebench.roofline import load


def read(run):
    t = run.device_s(load("attn_fwd").KERNELS)
    if t <= 0 or run.steps == 0:
        return None
    return 100.0 * load("flux_step").attn_step_bound_s(run.shapes) * run.steps / t

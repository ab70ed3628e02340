"""The joint attention forward's share of its roofline: the bound of every
call of the window (``roofline/attn_fwd.py``) over the device time of the
kernels that ran it."""

from pebench.roofline import load


def read(run):
    op = load("attn_fwd")
    t = run.device_s(op.KERNELS)
    if t <= 0 or run.steps == 0:
        return None
    return 100.0 * op.step_bound_s(run.shapes) * run.steps / t

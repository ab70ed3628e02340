"""The W4A8 block linears' share of their roofline: the bound of every K3
call of the window (``roofline/w4_gemm.py``) over K3's device time."""

from pebench.roofline import load


def read(run):
    op = load("w4_gemm")
    t = run.device_s(op.KERNELS)
    if t <= 0 or run.steps == 0:
        return None
    return 100.0 * op.step_bound_s(run.shapes) * run.steps / t

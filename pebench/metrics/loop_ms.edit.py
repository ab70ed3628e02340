"""Device ms a denoise step of what the step loop launches outside the DiT
(``sampling/denoise.py``): the adapter's rewrite, patchify, the concat and
repeat, the CFG combine and the fp32 Euler update; over the steps whose
``pe.denoise.step`` span lies wholly inside the traced window."""

from pebench.spans import whole_steps


def read(run):
    steps = whole_steps(run)
    if not steps:
        return None
    return sum(e - s for _, kernels in steps for _, s, e, in_dit in kernels
               if not in_dit) / 1e3 / len(steps)

"""How long a denoise step's work waits in the launch queue: the device
start of the step's first kernel less the host start of its
``pe.denoise.step`` span, the median over the steps wholly inside the
traced window.  It falls toward 0 as the host comes to pace the card."""

import statistics

from pebench.spans import whole_steps


def read(run):
    leads = [min(s for _, s, _, _ in kernels) - start
             for start, kernels in whole_steps(run) if kernels]
    return statistics.median(leads) / 1e3 if leads else None

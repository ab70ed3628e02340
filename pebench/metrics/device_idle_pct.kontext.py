"""The share of the traced window in which no device event ran: one less
the union of the device events' intervals over the window."""


def read(run):
    if not run.kernels or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)

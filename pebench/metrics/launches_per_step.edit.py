"""Device kernels launched per denoise step (copies and fills left out)."""


def read(run):
    n = run.launches()
    if n == 0 or run.steps == 0:
        return None
    return n / run.steps

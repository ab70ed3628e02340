"""Device ms a Kontext step of the glue inside the FLUX DiT's single-stream
blocks: the kernels launched inside a ``pe.single.*`` span
(``models/flux.py``) but the matmuls and the attention; the q / k kernel
counts as glue.  ``by_segment`` splits it by segment."""

from pebench import spans as S

SEGMENT = "pe.single."
# cuBLAS and K1 (``fixedmax``)
NOT_GLUE = ("nvjet", "gemm", "cutlass", "fixedmax")


def by_segment(run) -> dict:
    """Glue device ms a step per span (``pe.single.<name>``)."""
    sp = S.of(run)
    out: dict = {}
    for (name, s, e), owner in zip(run.kernels, sp.owners):
        if owner < 0 or any(p in name for p in NOT_GLUE):
            continue
        seg = sp.spans[owner][0]
        if seg.startswith(SEGMENT):
            out[seg] = out.get(seg, 0.0) + (e - s) / 1e3 / run.steps
    return out


def read(run):
    if run.steps == 0:
        return None
    segments = by_segment(run)
    return sum(segments.values()) if segments else None

"""Device ms a CFG step of the eager glue inside the DiT's blocks: the
kernels launched inside a ``pe.block.*`` span (``models/dit.py``) but the
matmuls and the attention.  K4-K6 count as glue: in the W4 lane they do the
modulated norm, the GELU and the heads-to-features transpose."""

from pebench import spans as S

# cuBLAS, K3 (``w4a8_``), K1 and K7 (``fixedmax``)
NOT_GLUE = ("nvjet", "gemm", "cutlass", "w4a8_", "fixedmax")


def by_segment(run) -> dict:
    """Glue device ms a CFG step per block segment (``pe.block.<name>``)."""
    sp = S.of(run)
    out: dict = {}
    for (name, s, e), owner in zip(run.kernels, sp.owners):
        if owner < 0 or any(p in name for p in NOT_GLUE):
            continue
        seg = sp.spans[owner][0]
        if seg.startswith(S.SEGMENT):
            out[seg] = out.get(seg, 0.0) + (e - s) / 1e3 / run.steps
    return out


def read(run):
    if run.steps == 0:
        return None
    segments = by_segment(run)
    return sum(segments.values()) if segments else None

"""T6, one elementwise pass ``x * c + d`` (the port of
``tools/proto_ew_rate.py``), and the tool that pins the card's elementwise
memory rate with it:

    python -m physicedit_torch.tools.proto_ew_rate

c = 0.999 and d = 1e-4 are rounded to x's dtype first, as the JAX tool's
``jnp.asarray(0.999, x.dtype)`` (in bf16 c = 1.0 and d = 1.0014e-4), and the
product and the sum are each rounded (fp32 with no FMA; bf16 as torch's and
the kernel's fp32 arithmetic rounded to bf16, which here equals bf16
arithmetic).  The kernel is ``csrc/proto_ew_scale.cu``, one grid-stride pass
with 16-byte accesses; instantiations ``proto_ew_scale_bf16`` and
``proto_ew_scale_fp32``.  The JAX tool swept TPU block shapes; the kernel
has one, so per dtype and shape the tool prints the eager ``x * c + d`` (two
launches, as users write it), one call that computes it
(``torch.addcmul(d, x, c)``), ``x.clone()`` (the copy rate) and T6, in ms
and GB/s of one read and one write.  [4096, 1024] fits in the 50 MB L2 with
its output, so every row takes the next of enough copies of x to fill twice
the L2 and keeps as many outputs alive (``_proto_int8.l2_copies``,
``rotated``); the other shapes exceed it.
"""

from __future__ import annotations

import torch

from physicedit_torch.tools import _bench, _proto_int8 as pi

NAME = "proto_ew_rate"
SHAPES = [(16896, 9216), (16896, 3072), (4096, 1024)]


def scale_constants(dtype):
    """c and d as 0-dim tensors of ``dtype``, rounded once from 0.999 and
    1e-4."""
    return torch.tensor(0.999, dtype=dtype), torch.tensor(1e-4, dtype=dtype)


def pallas_scale(x):
    """T6: ``x * c + d`` in x's dtype; the kernel for CUDA tensors (bf16 or
    fp32, contiguous), :func:`pallas_scale_reference` for CPU ones."""
    if x.device.type == "cpu":
        return pallas_scale_reference(x)
    c, d = scale_constants(x.dtype)
    return pi.launch_ew_scale(x, c.item(), d.item())


def pallas_scale_reference(x):
    """The plain version of T6: two torch ops on the rounded constants."""
    c, d = scale_constants(x.dtype)
    return x * c + d


def main() -> list:
    """On the card: T6 against its plain version at [4096, 1024] (bit for
    bit, both dtypes), then per dtype and shape the eager pass, the one
    call, the copy and T6, with x normal x 0.1."""
    dev = _bench.require_cuda(NAME)
    gen = torch.Generator(dev).manual_seed(0)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        x = (torch.randn(4096, 1024, device=dev, generator=gen) * 0.1).to(dtype)
        rows.append(pi.check_row(NAME, f"{dtype}_4096x1024", equal=bool(torch.equal(
            pallas_scale(x), pallas_scale_reference(x)))))
    for dtype in (torch.bfloat16, torch.float32):
        c, d = (t.to(dev) for t in scale_constants(dtype))
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        for m, n in SHAPES:
            xs = pi.l2_copies((torch.randn(m, n, device=dev, generator=gen) * 0.1).to(dtype))
            nbytes = 2 * xs[0].numel() * xs[0].element_size()
            label = f"{name} [{m}, {n}]" + (f" ({len(xs)} copies)" if len(xs) > 1 else "")
            for form, fn in (("eager x * c + d", pallas_scale_reference),
                             ("torch.addcmul", lambda x: torch.addcmul(d, x, c)),
                             ("x.clone()", torch.clone), ("T6", pallas_scale)):
                rows.append(_bench.timing_row(NAME, f"{label} {form}", pi.rotated(fn, xs),
                                              nbytes=nbytes))
            del xs
    return rows


if __name__ == "__main__":
    main()

"""Time the attention prototypes (T7, T8 and T5 under both names, T2 with
the scale inside and outside the kernel, T3, T1 v1, v3 and v4, T4), T9's
two forms, T12, T10 and T11 in two checkouts of this repository on one
card, in turns: before, after, after, before.

    python -m physicedit_torch.tools.proto_before_after --before DIR [--after DIR]

DIR is the root of a checkout (for example an unpacked ``git archive`` of
an earlier commit); ``--after`` defaults to the checkout this module is in.
Each turn is a fresh process (``tools/_turns.py``) that builds the
checkout's ``csrc/proto_fixedmax_attention.cu``,
``csrc/proto_int8qk_attention.cu`` and ``csrc/proto_int8_matmul.cu`` into
its own ``build/`` and times each instantiation of :data:`NAMES` through
the checkout's ``tools/_proto_attention.run`` at the DiT's joint attention
(B2 N24 S8448 D128, RMS-normed q and k, q prescaled unless the scale is
inside; T3's K and V zeroed on the last 64 keys beforehand, with the masked
count; T1 v1's and T7's key bias -1e30 there; T8's and T5's on keys [200,
256) of their 1408-key prefix), T4 through
``tools/proto_attn_int8qk.fixedmax_int8qk`` (its row quantize included)
with that key bias, T9 through ``tools/proto_int8_rate.pallas_mm`` at its
tool's shape (M16384 K3072 N12288, int8 over the whole range or bf16
normal x 0.1), T12 through ``tools/proto_w4_unpack.w4a8_i8_matmul`` at
the same shape (bf16 out, int8 x over [-127, 127], any byte a packed
weight, uniform scales), T10 through ``tools/proto_prefill_blocks.i32_matmul``
at its tool's two shapes (M1536 K3584 N37888 and M1536 K18944 N3584, the
same operands' kind) and T11 through ``tools/proto_w4_gemv.gemv_and_only``
at its tool's three (m8 K3584 N37888, K18944 N3584, K3584 N5632; the
wrapper's row sums included where the checkout's wrapper takes them), its
weights rotated past the L2 (``_proto_int8.l2_copies``): the median of 20
calls between CUDA events
after two warm-up calls, and 10 calls replayed from a CUDA graph
(``graph_ms``, the checkout's own ``tools/_bench.graph_ms``).  One JSON
line per instantiation and turn, then one per instantiation with both
checkouts' mean and the ratio, on stdout.  Without a card it exits 2.
"""

from __future__ import annotations

import json
import sys

from physicedit_torch.tools import _turns

NAMES = ("proto_fixedmax", "proto_fixedmax2", "proto_fixedmax2_overlap",
         "proto_nobias_inscale", "proto_nobias", "proto_nmask", "proto_bf16s",
         "proto_expnosum", "proto_noexp", "proto_interleave", "proto_interleave_overlap",
         "proto_int8qk", "proto_mm_i32", "proto_mm_f32", "proto_w4_and", "proto_w4_i32",
         "proto_w4_gemv_and")
SHAPE = (2, 24, 8448)    # B, N, S of the attention prototypes

# run in a fresh process with the checkout on sys.path: its argument is the
# JSON of [NAMES, SHAPE]
_WORKER = r"""
import json, statistics, sys
import torch
from physicedit_torch.kernels import _build, flash_attention as fa
from physicedit_torch.tools import _proto_attention as pa, _proto_int8 as pi
from physicedit_torch.tools import proto_attn_int8qk as t4
from physicedit_torch.tools import proto_int8_rate as t9
from physicedit_torch.tools import proto_prefill_blocks as t10
from physicedit_torch.tools import proto_w4_gemv as t11
from physicedit_torch.tools import proto_w4_unpack as t12
from physicedit_torch.tools._bench import graph_ms

def median_ms(fn, iters=20):
    fn(); fn()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    for a, b in ev:
        a.record(); fn(); b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)

names, (b, n, s) = json.loads(sys.argv[1])
dev = torch.device("cuda")
_build.build_all([pa.SOURCE, pi.ATTENTION, pi.MATMUL])
gen = torch.Generator(dev).manual_seed(0)
q, k = ((x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True))).bfloat16()
        for x in (torch.randn(b, n, s, 128, device=dev, generator=gen) for _ in range(2)))
v = torch.randn(b, n, s, 128, device=dev, generator=gen).bfloat16()
qs = fa._prescale(q).contiguous()
live = torch.ones(b, s, dtype=torch.bool, device=dev)
live[:, -64:] = False
kz, vz = (torch.where(live[:, None, :, None], x, 0) for x in (k, v))
nm = (~live).sum(1).float()
bias = pa.mask_bias(live)
prefix = torch.ones(b, s, dtype=torch.bool, device=dev)
prefix[:, 200:256] = False
bias_prefix = pa.mask_bias(prefix)
calls = {"proto_fixedmax": lambda: pa.run("proto_fixedmax", q, k, v, bias, s),
         "proto_fixedmax2": lambda: pa.run("proto_fixedmax2", qs, k, v, bias_prefix, 1408),
         "proto_fixedmax2_overlap":
             lambda: pa.run("proto_fixedmax2_overlap", qs, k, v, bias_prefix, 1408),
         "proto_nobias_inscale": lambda: pa.run("proto_nobias_inscale", q, k, v),
         "proto_nobias": lambda: pa.run("proto_nobias", qs, k, v),
         "proto_nmask": lambda: pa.run("proto_nmask", qs, kz, vz, n_masked=nm),
         "proto_bf16s": lambda: pa.run("proto_bf16s", qs, k, v, bias, s),
         "proto_expnosum": lambda: pa.run("proto_expnosum", qs, k, v),
         "proto_noexp": lambda: pa.run("proto_noexp", qs, k, v),
         "proto_interleave": lambda: pa.run("proto_interleave", qs, k, v, bias_prefix, 1408),
         "proto_interleave_overlap":
             lambda: pa.run("proto_interleave_overlap", qs, k, v, bias_prefix, 1408),
         "proto_int8qk": lambda: t4.fixedmax_int8qk(q, k, v, bias)}
for name in names:
    if name in calls:
        print(json.dumps({"kernel": name, "case": f"b{b}_n{n}_s{s}", "shape": [b, n, s, s],
                          "ms": median_ms(calls[name]), "graph_ms": graph_ms(calls[name])}),
              flush=True)
del q, k, v, qs, kz, vz
torch.cuda.empty_cache()
m, kk, nn = t9.M, t9.K, t9.N
def w4_operands(m, k, n):
    return (torch.randint(-127, 128, (m, k), device=dev, generator=gen, dtype=torch.int8),
            torch.randint(-128, 128, (n, k // 2), device=dev, generator=gen, dtype=torch.int8))
operands = {"proto_mm_i32": lambda m, k, n: tuple(
                torch.randint(-128, 128, (r, k), device=dev, generator=gen, dtype=torch.int8)
                for r in (m, n)),
            "proto_mm_f32": lambda m, k, n: tuple(
                (torch.randn(r, k, device=dev, generator=gen) * 0.1).bfloat16() for r in (m, n)),
            "proto_w4_and": w4_operands, "proto_w4_i32": w4_operands,
            "proto_w4_gemv_and": w4_operands}
shapes = {"proto_mm_i32": [(m, kk, nn)], "proto_mm_f32": [(m, kk, nn)],
          "proto_w4_and": [(m, kk, nn)],
          "proto_w4_i32": [(1536, 3584, 37888), (1536, 18944, 3584)],
          "proto_w4_gemv_and": [(t11.M_DECODE, k_, n_) for _, k_, n_ in t11.SHAPES]}
for name in names:
    for mm, k_, n_ in shapes.get(name, ()):
        x, w = operands[name](mm, k_, n_)
        xs = torch.rand(mm, 1, device=dev, generator=gen) * 1e-2 + 1e-3
        wsb = torch.rand(2, n_, device=dev, generator=gen) * 1e-2 + 1e-3
        if name == "proto_w4_and":
            fn = lambda: t12.w4a8_i8_matmul(x, w, xs, wsb, torch.bfloat16)
        elif name == "proto_w4_i32":
            fn = lambda: t10.i32_matmul(x, w, xs, wsb, torch.bfloat16)
        elif name == "proto_w4_gemv_and":
            fn = pi.rotated(lambda w_: t11.gemv_and_only(x, w_), pi.l2_copies(w))
        else:
            acc = "i32" if name == "proto_mm_i32" else "f32"
            fn = lambda: t9.pallas_mm(x, w, acc)
        print(json.dumps({"kernel": name, "case": f"m{mm}_k{k_}_n{n_}", "shape": [mm, k_, n_],
                          "ms": median_ms(fn), "graph_ms": graph_ms(fn)}), flush=True)
        del x, w, fn
        torch.cuda.empty_cache()
"""


def main(argv=None) -> int:
    return _turns.main("proto_before_after", __doc__.splitlines()[0], _WORKER,
                       json.dumps([NAMES, SHAPE]), argv)


if __name__ == "__main__":
    sys.exit(main())

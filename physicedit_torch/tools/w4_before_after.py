"""Time the W4 lane's kernels of two checkouts of this repository on one
card, in turns: before, after, after, before.  K3 (the W4A8 matmul), K9
(the W4 input gradient) and the fused activation quantizes K4
(``ln_mod_quant``), K5 (``gelu_quant``) and K6 (``transpose_quant``).

    python -m physicedit_torch.tools.w4_before_after --before DIR [--after DIR]

DIR is the root of a checkout (for example an unpacked ``git archive`` of
an earlier commit); ``--after`` defaults to the checkout this module is in.
Each turn is a fresh process that builds that checkout's kernel sources
into its own ``build/`` and times every shape of :data:`K3_SHAPES`,
:data:`K9_SHAPES` and :data:`QUANT_SHAPES` with the checkout's wrappers
(``w4a8_matmul``, ``w4_bwd_dx``, ``_ln_mod_quant``, ``_gelu_quant``,
``_transpose_quant``): the median of 20 calls between CUDA events after two
warm-up calls, on operands made on the card from a fixed seed.  The
quantizes, whose small shapes take a few microseconds, also replay 10 calls
from a CUDA graph (``graph_ms``), with their inputs rotated over copies of
at least 100 MB so that no call finds its row in L2 (the checkout's own
``tools/_bench.graph_ms`` and ``tools/_proto_int8.rotated``).  One JSON line per
shape and turn, then one per shape with both checkouts' mean and the
ratio, on stdout.  Without a card it exits 2.
"""

from __future__ import annotations

import json
import sys

from physicedit_torch.tools import _turns

# name, M, K, N: the DiT image stream at 1024^2 under CFG, the VL prefill's
# gate_up, the W4 training lane's image and text streams (480x832)
K3_SHAPES = [("dit_image_qkv", 16384, 3072, 9216), ("dit_image_out", 16384, 3072, 3072),
             ("dit_image_fc1", 16384, 3072, 12288), ("dit_image_fc2", 16384, 12288, 3072),
             ("prefill_gate_up", 1536, 3584, 37888),
             ("train_image_qkv", 3120, 3072, 9216), ("train_image_fc1", 3120, 3072, 12288),
             ("train_image_fc2", 3120, 12288, 3072), ("train_text_fc1", 384, 3072, 12288)]
# name, M, N (g's width, the contraction), K (dx's width)
K9_SHAPES = [("image_qkv", 3120, 9216, 3072), ("image_out", 3120, 3072, 3072),
             ("image_fc1", 3120, 12288, 3072), ("image_fc2", 3120, 3072, 12288),
             ("text_qkv", 384, 9216, 3072), ("text_out", 384, 3072, 3072),
             ("text_fc1", 384, 12288, 3072), ("text_fc2", 384, 3072, 12288)]
# kernel, name, input shape: the DiT's image stream at 1024^2 under CFG, its
# text stream at joint 9472, a ragged S (K6: the joint attention output at
# joint 8448 and 9472)
QUANT_SHAPES = [("k4", "image", [2, 8192, 3072]), ("k4", "text", [2, 1280, 3072]),
                ("k4", "ragged", [2, 1001, 3072]),
                ("k5", "image", [2, 8192, 12288]), ("k5", "text", [2, 1280, 12288]),
                ("k5", "ragged", [2, 1001, 12288]),
                ("k6", "joint_8448", [2, 24, 8448, 128]), ("k6", "joint_9472", [2, 24, 9472, 128]),
                ("k6", "ragged", [2, 24, 1001, 128])]

# run in a fresh process with the checkout on sys.path: its argument is the
# JSON of [K3_SHAPES, K9_SHAPES, QUANT_SHAPES]
_WORKER = r"""
import json, statistics, sys
import torch
from physicedit_torch.kernels import _build, fused_quant as fq, quant_matmul as qm
from physicedit_torch.tools._bench import graph_ms
from physicedit_torch.tools._proto_int8 import l2_copies, rotated

def median_ms(fn, iters=20):
    fn(); fn()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    for a, b in ev:
        a.record(); fn(); b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)

k3_shapes, k9_shapes, quant_shapes = json.loads(sys.argv[1])
dev = torch.device("cuda")
_build.build_all(["w4a8_matmul", "w4_bwd_dx", "fused_quant"])
gen = torch.Generator(dev).manual_seed(0)
for name, m, k, n in k3_shapes:
    xq = torch.randint(-127, 128, (m, k), device=dev, dtype=torch.int8, generator=gen)
    w4 = torch.randint(-128, 128, (n, k // 2), device=dev, dtype=torch.int8, generator=gen)
    xs = torch.rand(m, 1, device=dev, generator=gen) * 1e-2 + 1e-3
    ws = torch.rand(n, device=dev, generator=gen) * 1e-2 + 1e-3
    b = torch.randn(n, device=dev, generator=gen).bfloat16()
    print(json.dumps({"kernel": "k3", "case": name, "shape": [m, k, n],
                      "ms": median_ms(lambda: qm.w4a8_matmul(xq, w4, xs, ws, b))}), flush=True)
    del xq, w4
for name, m, n, k in k9_shapes:
    go = torch.randn(m, n, device=dev, generator=gen).bfloat16()
    w4 = torch.randint(-128, 128, (n, k // 2), device=dev, dtype=torch.int8, generator=gen)
    ws = torch.rand(n, device=dev, generator=gen) * 1e-2 + 1e-3
    print(json.dumps({"kernel": "k9", "case": name, "shape": [m, n, k],
                      "ms": median_ms(lambda: qm.w4_bwd_dx(go, w4, ws))}), flush=True)
for kernel, name, shape in quant_shapes:
    x = (torch.randn(*shape, device=dev, generator=gen) * 3).bfloat16()
    if kernel == "k4":
        sh, sc = ((torch.randn(shape[0], shape[2], device=dev, generator=gen) * 0.5).bfloat16()
                  for _ in range(2))
        fn = rotated(lambda t: fq._ln_mod_quant(t, sh, sc, 1e-6), l2_copies(x, 100 << 20))
    else:
        fn = rotated(fq._gelu_quant if kernel == "k5" else fq._transpose_quant,
                     l2_copies(x, 100 << 20))
    print(json.dumps({"kernel": kernel, "case": name, "shape": shape, "ms": median_ms(fn),
                      "graph_ms": graph_ms(fn)}), flush=True)
    del x, fn
    torch.cuda.empty_cache()
"""


def main(argv=None) -> int:
    return _turns.main("w4_before_after", __doc__.splitlines()[0], _WORKER,
                       json.dumps([K3_SHAPES, K9_SHAPES, QUANT_SHAPES]), argv)


if __name__ == "__main__":
    sys.exit(main())

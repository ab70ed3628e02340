"""How the plain reference computes a linear layer: in fp32 (TF32 off), or
in the precision a configuration states for its weights and activations.

- ``fp32``: ``x @ W^T + b`` in fp32.
- ``w4a8``: the W4A8 lane as the configuration states it.  Block weights
  are int4 per output row, symmetric to [-7, 7] with ``scale = max(amax /
  7, 1e-8)``; activations are int8 per row with ``scale = max(amax / 127,
  1e-8)``; the product and its epilogue are fp32.  A layer that the lane's
  kernels cannot tile (``K / 2`` or ``N`` not a multiple of 128) keeps its
  int4 weights and takes the activations as they are, in fp32.
- the controls, each part one step below the precision the configuration
  states for it: ``fp8`` (weights and activations of every linear through
  float8 e4m3, per row, against bf16) and ``w4a4`` (the W4 block weights
  with int4 activations against int8, and ``fp8`` for the linears the W4A8
  lane keeps in bf16: the DiT's outer layers and the adapter).  Both lanes
  hold their activations in bf16 between operations, so both controls also
  hold them in float8 per row: the DiT's residual streams after every
  update, q, k and v over the head dim, and the attention's probabilities
  over the keys before they meet v.
"""

from __future__ import annotations

import torch

MODES = ("fp32", "fp8", "w4a8", "w4a4")
FP8_MAX = 448.0


def _rows_int(x: torch.Tensor, qmax: int) -> torch.Tensor:
    """Per-row symmetric integer rounding, returned dequantized in fp32."""
    scale = (x.abs().amax(-1, keepdim=True) / float(qmax)).clamp_min(1e-8)
    return (x / scale).round().clamp(-qmax, qmax) * scale


def _rows_fp8(x: torch.Tensor) -> torch.Tensor:
    scale = (x.abs().amax(-1, keepdim=True) / FP8_MAX).clamp_min(1e-12)
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def tileable(w: torch.Tensor) -> bool:
    n, k = w.shape
    return (k // 2) % 128 == 0 and n % 128 == 0


class Arith:
    def __init__(self, mode: str = "fp32"):
        if mode not in MODES:
            raise ValueError(f"unknown arithmetic {mode!r}; one of {MODES}")
        self.mode = mode

    def weight(self, w: torch.Tensor, block: bool) -> torch.Tensor:
        """A layer's fp32 weight as this arithmetic holds it."""
        w = w.float()
        if self.mode in ("w4a8", "w4a4") and block:
            return _rows_int(w, 7)
        if self.mode == "fp8" or self.mode == "w4a4":
            return _rows_fp8(w)
        return w

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An activation the program holds in bf16 between operations, as
        this arithmetic holds it (fp32 outside the controls)."""
        return _rows_fp8(x.float()) if self.mode in ("fp8", "w4a4") else x

    def linear(self, x, w, b, block: bool):
        """``x @ W^T + b`` for a layer of the DiT's blocks (``block``) or not."""
        wq = self.weight(w, block)
        x = x.float()
        if self.mode in ("w4a8", "w4a4") and block:
            if tileable(wq):
                x = _rows_int(x, 127 if self.mode == "w4a8" else 7)
        elif self.mode in ("fp8", "w4a4"):
            x = _rows_fp8(x)
        y = x @ wq.T
        return y if b is None else y + b.float()

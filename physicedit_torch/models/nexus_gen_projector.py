"""Nexus-Gen's projector modules (``physicedit_tpu/models/nexus_gen_projector.py``).

- :class:`NexusGenAdapter`: Linear -> LayerNorm -> ReLU -> Linear ->
  LayerNorm (fp32 statistics, eps 1e-5), mapping the LLM's image embeddings
  (3584) to a generation decoder's conditioning width (4096).
- :class:`NexusGenImageEmbeddingMerger`: Qwen2-style decoder layers at the
  7B text config (``MERGER_CFG``: width 3584, 28 heads over 4 KV heads,
  intermediate 18944) over the predicted embeddings, with BIDIRECTIONAL
  attention (a zero bias, the dense :func:`ops.attention.gqa_attention`;
  kernel K2 is causal and never runs here) and FRACTIONAL M-RoPE positions
  (the indices rescaled onto a 72x72 base grid, float all the way into
  ``mrope_cos_sin``), then a projector RMS -> fc1 -> RMS -> SiLU -> fc2 ->
  RMS.  Reference embeddings join on the sequence axis with their own
  positions.

Both default to fp32, as in the JAX package; an input of another dtype (the
bf16 Nexus-Gen output on the card) is cast to the module's dtype first,
where JAX promotes it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from physicedit_torch.core.params import Leaf, linear, materialize
from physicedit_torch.models.qwen_vl import (QWEN25_VL_7B_TEXT, QwenVLTextConfig, TextLayer,
                                             mrope_cos_sin)
from physicedit_torch.ops.attention import gqa_attention
from physicedit_torch.ops.norms import layer_norm, rms_norm

MERGER_CFG = QWEN25_VL_7B_TEXT      # hidden 3584, 28 heads / 4 kv
BASE_GRID = (1, 72, 72)
SPATIAL_MERGE = 2
TOKENS_PER_SECOND = 2


# ---------------------------------------------------------------------------
# Adapter
# ---------------------------------------------------------------------------

class NexusGenAdapter(nn.Module):
    """Children named as the JAX tree's keys (``ln*``: ``{"w", "b"}``)."""

    def __init__(self, input_dim=3584, output_dim=4096, dtype=torch.float32):
        super().__init__()
        self.fc1 = linear(input_dim, output_dim, dtype=dtype)
        self.ln1 = Leaf(w=(output_dim,), b=(output_dim,), dtype=dtype)
        self.fc2 = linear(output_dim, output_dim, dtype=dtype)
        self.ln2 = Leaf(w=(output_dim,), b=(output_dim,), dtype=dtype)


@torch.no_grad()
def init_adapter_(adapter: NexusGenAdapter, generator: torch.Generator) -> NexusGenAdapter:
    """Random linears (``core/params.init_random_``), LayerNorms 1 / 0."""
    from physicedit_torch.core.params import init_random_

    init_random_(adapter, generator)
    adapter.ln1.b.zero_()
    adapter.ln2.b.zero_()
    return adapter


@torch.no_grad()
def adapter_forward(adapter: NexusGenAdapter, x: torch.Tensor) -> torch.Tensor:
    """nexus_gen_projector.py:393-401."""
    x = x.to(adapter.fc1.weight.dtype)
    x = F.relu(layer_norm(adapter.fc1(x), 1e-5, adapter.ln1.w, adapter.ln1.b))
    return layer_norm(adapter.fc2(x), 1e-5, adapter.ln2.w, adapter.ln2.b)


def adapter_from_torch(sd: dict, dtype=torch.float32, device="cuda") -> NexusGenAdapter:
    """Keys ``adapter.{0,1,3,4}.{weight,bias}`` (nn.Sequential indices; 2 is
    the ReLU)."""
    from physicedit_torch.io.convert import COPY, load_module_

    d_out, d_in = np.shape(sd["adapter.0.weight"])
    rows = [(f"{p}.{n}", (f"adapter.{i}.{r}",), COPY)
            for p, i in (("fc1", 0), ("fc2", 3)) for n, r in (("weight", "weight"),
                                                              ("bias", "bias"))]
    rows += [(f"{p}.{n}", (f"adapter.{i}.{r}",), COPY)
             for p, i in (("ln1", 1), ("ln2", 4)) for n, r in (("w", "weight"), ("b", "bias"))]
    module = materialize(NexusGenAdapter(d_in, d_out, dtype), device)
    return load_module_(module, {k: torch.as_tensor(v) for k, v in sd.items()}, rows).eval()


# ---------------------------------------------------------------------------
# Embedding merger
# ---------------------------------------------------------------------------

class MergerLayer(TextLayer):
    """A Qwen2 decoder layer (the VL text layer's weights and glue) with
    full, unmasked attention."""

    def forward(self, x, cos, sin):
        q, k, v = self._qkv(x, cos, sin)
        b, s = x.shape[:2]
        zero_bias = torch.zeros(b, 1, s, s, dtype=torch.float32, device=x.device)
        return self._tail(x, gqa_attention(q, k, v, zero_bias))


class NexusGenImageEmbeddingMerger(nn.Module):
    """``layers`` + ``proj``, named as the JAX tree's keys."""

    def __init__(self, cfg: QwenVLTextConfig = MERGER_CFG, num_layers=1, out_channel=4096,
                 expand_ratio=4, dtype=torch.float32):
        super().__init__()
        d, mid = cfg.hidden_size, out_channel * expand_ratio
        self.cfg = cfg
        self.layers = nn.ModuleList(MergerLayer(cfg, dtype) for _ in range(num_layers))
        self.proj = nn.ModuleDict({
            "norm_in": Leaf(scale=(d,), dtype=dtype),
            "fc1": linear(d, mid, dtype=dtype),
            "norm_mid": Leaf(scale=(mid,), dtype=dtype),
            "fc2": linear(mid, out_channel, dtype=dtype),
            "norm_out": Leaf(scale=(out_channel,), dtype=dtype)})


def merger_position_ids(grid, base_grid=BASE_GRID):
    """nexus_gen_projector.py:336-356: (t, h, w) M-RoPE indices over the
    embedding grid, H/W rescaled onto the 72x72 base grid (fractional
    positions: the reference keeps them float)."""
    t, h, w = grid
    gh, gw = h // SPATIAL_MERGE, w // SPATIAL_MERGE
    scale_h = base_grid[1] / h
    scale_w = base_grid[2] / w
    t_idx = np.repeat(np.arange(t) * TOKENS_PER_SECOND, gh * gw).astype(np.float32)
    h_idx = np.tile(np.repeat(np.arange(gh), gw), t).astype(np.float32) * scale_h
    w_idx = np.tile(np.arange(gw), t * gh).astype(np.float32) * scale_w
    return np.stack([t_idx, h_idx, w_idx])[:, None, :]        # [3, 1, L]


@torch.no_grad()
def merger_forward(merger: NexusGenImageEmbeddingMerger, embeds, grid, ref_embeds=None,
                   ref_grid=None) -> torch.Tensor:
    """nexus_gen_projector.py:357-371: embeds [B, L, D] on the merger's
    device; optional reference-image embeddings are joined on the sequence
    axis with their own grid positions."""
    cfg = merger.cfg
    dtype = merger.proj["fc1"].weight.dtype
    pos = merger_position_ids(grid)
    x = embeds.to(dtype)
    if ref_embeds is not None:
        pos = np.concatenate([pos, merger_position_ids(ref_grid)], axis=-1)
        x = torch.cat([x, ref_embeds.to(dtype)], dim=1)
    cos, sin = mrope_cos_sin(torch.from_numpy(pos).to(x.device), cfg)
    for layer in merger.layers:
        x = layer(x, cos, sin)
    pr = merger.proj
    h = pr["fc1"](rms_norm(x, pr["norm_in"].scale, cfg.eps))
    h = pr["fc2"](F.silu(rms_norm(h, pr["norm_mid"].scale, cfg.eps)))
    return rms_norm(h, pr["norm_out"].scale, cfg.eps)


def merger_from_torch(sd: dict, cfg: QwenVLTextConfig = MERGER_CFG, dtype=torch.float32,
                      device="cuda") -> NexusGenImageEmbeddingMerger:
    """Keys ``layers.{i}.*`` + ``projector.{0,1,2,4,5}.*`` (Sequential: RMS,
    Linear, RMS, act, Linear, RMS); the ``embedding_merger.`` checkpoint
    prefix is accepted."""
    from physicedit_torch.io.convert import COPY, _layer_count, _lin, load_module_

    sd = {(k[len("embedding_merger."):] if k.startswith("embedding_merger.") else k):
          torch.as_tensor(v) for k, v in sd.items()}
    n_layers = _layer_count(sd, "layers.")
    rows: list = []
    for i in range(n_layers):
        p, r = f"layers.{i}", f"layers.{i}"
        rows.append((f"{p}.ln1.scale", (f"{r}.input_layernorm.weight",), COPY))
        for n in ("q", "k", "v"):
            _lin(rows, f"{p}.{n}", f"{r}.self_attn.{n}_proj")
        _lin(rows, f"{p}.o", f"{r}.self_attn.o_proj", bias=False)
        rows.append((f"{p}.ln2.scale", (f"{r}.post_attention_layernorm.weight",), COPY))
        for n in ("gate", "up", "down"):
            _lin(rows, f"{p}.mlp.{n}", f"{r}.mlp.{n}_proj", bias=False)
    for name, i in (("norm_in", 0), ("norm_mid", 2), ("norm_out", 5)):
        rows.append((f"proj.{name}.scale", (f"projector.{i}.weight",), COPY))
    _lin(rows, "proj.fc1", "projector.1")
    _lin(rows, "proj.fc2", "projector.4")
    mid = np.shape(sd["projector.1.weight"])[0]
    out_channel = np.shape(sd["projector.4.weight"])[0]
    module = NexusGenImageEmbeddingMerger(cfg, n_layers, out_channel, mid // out_channel, dtype)
    return load_module_(materialize(module, device), sd, rows).eval()

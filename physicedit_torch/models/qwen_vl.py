"""Qwen2.5-VL-7B text model (``physicedit_tpu/models/qwen_vl.py``): the
prompt encoder and the greedy physical reasoner.

28 layers, hidden 3584, 28 query / 4 KV heads (GQA), SwiGLU MLP, RMSNorm and
M-RoPE with sections [16, 24, 24] over (t, h, w) positions.  Full-sequence
attention (prefill, prompt encode) runs through kernel K2
(``kernels/flash_attention.gqa_causal_attention``) on the card; the
single-token decode attention is plain PyTorch, as it is XLA in the JAX
package.  The KV cache is preallocated and written in place: bf16, or with
``kv_int8`` int8 with one bf16 scale per (position, KV head).

The quantized lane (``PhysicEditPipeline.quantize_``) adds packed-int4
linears (``kernels/quant_matmul.W4Linear``), fused ``qkv`` / ``gate_up``
projections (:func:`fuse_decode_projections`) and an int8 token table
(:func:`quantize_embedding_int8`).  The JAX package's ``split_layers`` has
no counterpart here: it turns the stacked ``lax.scan`` weights into
per-layer trees so that the kernels read each layer in place, and an
``nn.ModuleList`` already runs every layer on its own weights.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from physicedit_torch.core.params import Leaf, linear
from physicedit_torch.kernels.flash_attention import gqa_causal_attention
from physicedit_torch.kernels.quant_matmul import W4Linear, true_div
from physicedit_torch.ops.attention import NEG_INF, causal_bias, gqa_attention
from physicedit_torch.ops.norms import rms_norm


@dataclasses.dataclass(frozen=True)
class QwenVLTextConfig:
    hidden_size: int = 3584
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    head_dim: int = 128
    intermediate_size: int = 18944
    vocab_size: int = 152064
    rope_theta: float = 1e6
    mrope_section: tuple = (16, 24, 24)
    eps: float = 1e-6
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    eos_token_id: int = 151645


QWEN25_VL_7B_TEXT = QwenVLTextConfig()

TINY_TEXT = QwenVLTextConfig(
    hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
    intermediate_size=128, vocab_size=512)


def mrope_cos_sin(position_ids: torch.Tensor, cfg: QwenVLTextConfig):
    """position_ids [3, B, S] (t, h, w) -> cos, sin [B, S, head_dim] fp32.

    Frequency dims [0:16) take t positions, [16:40) h and [40:64) w; the
    second half of the head dim repeats the first."""
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, cfg.head_dim, 2) / cfg.head_dim))
    inv_freq = torch.from_numpy(inv_freq.astype(np.float32)).to(position_ids.device)
    freqs = position_ids.float()[..., None] * inv_freq
    sec = np.cumsum([0] + list(cfg.mrope_section))
    merged = torch.cat([freqs[i, ..., sec[i]:sec[i + 1]] for i in range(3)], dim=-1)
    emb = torch.cat([merged, merged], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope_half(x, cos, sin):
    """HF rotate-half RoPE in x's dtype.  x: [B, S, N, D]; cos/sin: [B, S, D]."""
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * c + rot * s


def _prefill_attention(q, k, v, mask_bias, key_mask):
    """Full-sequence causal attention: kernel K2 when the shapes fit it and
    the tensors are on the card (the JAX package's test is "the platform is
    TPU"); otherwise the dense plain version."""
    s, d = q.shape[1], q.shape[-1]
    if (key_mask is not None and s > 1 and d == 128
            and q.shape[2] % k.shape[2] == 0 and q.is_cuda):
        return gqa_causal_attention(q, k, v, key_mask)
    return gqa_attention(q, k, v, mask_bias)


class TextLayer(nn.Module):
    def __init__(self, cfg: QwenVLTextConfig, dtype=None):
        super().__init__()
        d, qd = cfg.hidden_size, cfg.num_heads * cfg.head_dim
        kvd = cfg.num_kv_heads * cfg.head_dim
        self.cfg = cfg
        self.ln1 = Leaf(scale=(d,), dtype=dtype)
        self.q = linear(d, qd, dtype=dtype)
        self.k = linear(d, kvd, dtype=dtype)
        self.v = linear(d, kvd, dtype=dtype)
        self.o = linear(qd, d, bias=False, dtype=dtype)
        self.ln2 = Leaf(scale=(d,), dtype=dtype)
        self.mlp = nn.ModuleDict({
            "gate": linear(d, cfg.intermediate_size, bias=False, dtype=dtype),
            "up": linear(d, cfg.intermediate_size, bias=False, dtype=dtype),
            "down": linear(cfg.intermediate_size, d, bias=False, dtype=dtype)})

    def _qkv(self, x, cos, sin):
        cfg = self.cfg
        b, s, _ = x.shape
        n, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        h = rms_norm(x, self.ln1.scale, cfg.eps)
        if "qkv" in self._modules:       # fuse_decode_projections
            q, k, v = self.qkv(h).split([n * d, kvh * d, kvh * d], dim=-1)
        else:
            q, k, v = self.q(h), self.k(h), self.v(h)
        q = q.reshape(b, s, n, d)
        k = k.reshape(b, s, kvh, d)
        v = v.reshape(b, s, kvh, d).contiguous()
        return apply_rope_half(q, cos, sin), apply_rope_half(k, cos, sin), v

    def _tail(self, x, attn):
        x = x + self.o(attn)
        h = rms_norm(x, self.ln2.scale, self.cfg.eps)
        mlp = self.mlp
        if "gate_up" in mlp:
            g, u = mlp["gate_up"](h).chunk(2, dim=-1)
        else:
            g, u = mlp["gate"](h), mlp["up"](h)
        return x + mlp["down"](F.silu(g) * u)

    def forward(self, x, cos, sin, mask_bias, key_mask):
        """Full-sequence layer; returns (x, k, v) so prefill can cache k/v."""
        q, k, v = self._qkv(x, cos, sin)
        if x.shape[1] > 1:
            attn = _prefill_attention(q, k, v, mask_bias, key_mask)
        else:
            attn = gqa_attention(q, k, v, mask_bias)
        return self._tail(x, attn), k, v

    def decode(self, x, cos, sin, bias_cache, kc, vc):
        """One token against this layer's cache (two-part softmax: the fresh
        token is handled beside the cache, not written first); returns
        (x, k_new, v_new).  kc/vc are [B, S, KV, D] tensors, or (int8
        values, bf16 scales [B, S, KV]) pairs of an int8 cache."""
        q, k, v = self._qkv(x, cos, sin)
        if isinstance(kc, tuple):
            attn = _gqa_attention_decode(q, kc[0], vc[0], k, v, bias_cache,
                                         k_scale=kc[1], v_scale=vc[1])
        else:
            attn = _gqa_attention_decode(q, kc, vc, k, v, bias_cache)
        return self._tail(x, attn), k, v


def _gqa_attention_decode(q, kc, vc, k_new, v_new, bias_cache, k_scale=None,
                          v_scale=None):
    """q [B, 1, N, D]; kc/vc [B, S, KV, D]; k_new/v_new [B, 1, KV, D];
    bias_cache [B, 1, 1, S] additive.  Returns [B, 1, N * D].

    An int8 cache comes with k_scale/v_scale [B, S, KV]: k's scale
    multiplies the logits and v's is folded into the probabilities before
    the PV product (exact: the scale is constant along D), so the int8
    values are only cast, once each, as any cache is: k to fp32 for the
    logits and v to the PV product's dtype.  The JAX package casts the int8
    values to q's dtype first, which changes no value."""
    b, _, n, d = q.shape
    kv = kc.shape[2]
    qg = q.reshape(b, 1, kv, n // kv, d).float()
    lc = torch.einsum("bskgd,btkd->bkgst", qg, kc.float()) / (d ** 0.5)
    if k_scale is not None:
        lc = lc * k_scale.float().permute(0, 2, 1)[:, :, None, None]
    lc = lc + bias_cache[:, None]
    ln = torch.einsum("bskgd,btkd->bkgst", qg, k_new.float()) / (d ** 0.5)
    m = torch.maximum(lc.amax(-1), ln[..., 0])
    pc = torch.exp(lc - m[..., None])
    pn = torch.exp(ln - m[..., None])
    den = pc.sum(-1) + pn[..., 0]
    if v_scale is not None:
        pc = pc * v_scale.float().permute(0, 2, 1)[:, :, None, None]
    # the probabilities are rounded to bf16 before the PV product, as in the
    # JAX package; the product itself runs in the promoted dtype
    dt = torch.promote_types(torch.bfloat16, q.dtype)
    oc = torch.einsum("bkgst,btkd->bskgd", pc.to(torch.bfloat16).to(dt), vc.to(dt))
    on = pn.permute(0, 3, 1, 2, 4) * v_new[:, :, :, None].float()
    out = (oc.float() + on) / den.permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, 1, n * d).to(q.dtype)


def _kv_quantize(kv):
    """[..., KV, D] -> (int8 [..., KV, D], bf16 scale per (position, head)
    [..., KV]), one scale per vector of the last axis (also the token
    table's scheme); all-zero slots get scale 1e-8 / 127 and zero codes."""
    kf = kv.float()
    a = kf.abs().amax(-1).clamp_min(1e-8)
    return ((kf / a[..., None] * 127.0).round().to(torch.int8),
            true_div(a, 127.0).to(torch.bfloat16))


def _kv_dequantize(q, s, dtype):
    return (q.float() * s.float()[..., None]).to(dtype)


class Int8Embedding(nn.Module):
    """The token table of the quantized lane: int8 rows ``e8 [V, D]`` with
    one bf16 scale each (``e_scale [V]``).  A lookup returns rows in the
    scales' dtype (bf16), as the JAX package's ``embed_tokens`` does."""

    def __init__(self, e8: torch.Tensor, e_scale: torch.Tensor):
        super().__init__()
        self.register_buffer("e8", e8)
        self.register_buffer("e_scale", e_scale)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        rows = self.e8[ids].float() * self.e_scale[ids].float()[..., None]
        return rows.to(self.e_scale.dtype)


class QwenVLText(nn.Module):
    """Built on the ``meta`` device; see ``core/params.materialize``."""

    def __init__(self, cfg: QwenVLTextConfig = QWEN25_VL_7B_TEXT, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty((cfg.vocab_size, cfg.hidden_size),
                                              dtype=dtype, device="meta"),
                                  requires_grad=False)
        self.layers = nn.ModuleList(TextLayer(cfg, dtype) for _ in range(cfg.num_layers))
        self.norm = Leaf(scale=(cfg.hidden_size,), dtype=dtype)
        self.lm_head = linear(cfg.hidden_size, cfg.vocab_size, bias=False, dtype=dtype)

    def embed_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        if isinstance(self.embed, Int8Embedding):
            return self.embed(input_ids)
        return self.embed[input_ids]

    def _final(self, x):
        return rms_norm(x, self.norm.scale, self.cfg.eps)

    @torch.no_grad()
    def text_forward(self, inputs_embeds, position_ids, attn_mask):
        """Full-sequence forward -> last-layer hidden states [B, S, D].
        position_ids [3, B, S]; attn_mask [B, S] bool."""
        cos, sin = mrope_cos_sin(position_ids, self.cfg)
        key_mask = attn_mask.bool()
        bias = causal_bias(key_mask)
        x = inputs_embeds
        for layer in self.layers:
            x, _, _ = layer(x, cos, sin, bias, key_mask)
        return self._final(x)

    @torch.no_grad()
    def prefill(self, inputs_embeds, position_ids, attn_mask, max_total_len: int,
                kv_int8: bool = False):
        """Run the prompt and build the KV cache padded to ``max_total_len``.
        Returns (last-token logits [B, V], caches, hidden [B, S, D]); the
        caches are (k, v) each [L, B, max_total_len, KV, D] in the input
        dtype, or with ``kv_int8`` (k8, k_scale, v8, v_scale): int8 entries
        and bf16 scales [L, B, max_total_len, KV], the zero tail included."""
        cfg = self.cfg
        b, s, _ = inputs_embeds.shape
        cos, sin = mrope_cos_sin(position_ids, cfg)
        key_mask = attn_mask.bool()
        bias = causal_bias(key_mask)
        shape = (cfg.num_layers, b, max_total_len, cfg.num_kv_heads, cfg.head_dim)
        kbuf = torch.zeros(shape, dtype=inputs_embeds.dtype, device=inputs_embeds.device)
        vbuf = torch.zeros_like(kbuf)
        x = inputs_embeds
        for i, layer in enumerate(self.layers):
            x, k, v = layer(x, cos, sin, bias, key_mask)
            kbuf[i, :, :s] = k
            vbuf[i, :, :s] = v
        hidden = self._final(x)
        caches = (kbuf, vbuf)
        if kv_int8:
            caches = (*_kv_quantize(kbuf), *_kv_quantize(vbuf))
        return self.lm_head(hidden[:, -1]), caches, hidden

    @torch.no_grad()
    def greedy_decode(self, caches, first_token, start_pos: int,
                      start_rope_pos, max_new_tokens: int, key_mask=None):
        """Greedy decoding until every row has emitted EOS or
        ``max_new_tokens`` are out.

        caches: (k, v) or the int8 (k8, k_scale, v8, v_scale) from
        :meth:`prefill`, updated in place; a fresh token's k/v stay in the
        working dtype for its own step and are quantized into the cache
        after it.
        first_token [B]; start_pos: cache position of the first new token
        (the padded prompt length); start_rope_pos [B]; key_mask [B, S_max]
        marks the live prompt slots of a padded prompt.  Returns the tokens
        [B, max_new_tokens] (EOS-filled after a row stops) and the number
        of decode steps run.
        """
        cfg = self.cfg
        int8_cache = len(caches) == 4
        if int8_cache:
            k8, ks, v8, vs = caches
        else:
            kbuf, vbuf = caches
        b = first_token.shape[0]
        s_max = caches[0].shape[2]
        dev = first_token.device
        eos = cfg.eos_token_id
        toks = torch.full((b, max_new_tokens), eos, dtype=torch.long, device=dev)
        k_pos = torch.arange(s_max, device=dev)[None, :]
        tok = first_token.long()
        rope_pos = start_rope_pos.long()
        done = tok == eos
        steps = 0
        for i in range(max_new_tokens):
            if bool(done.all()):
                break
            toks[:, i] = tok
            pos = start_pos + i
            x = self.embed_tokens(tok)[:, None, :]
            cos, sin = mrope_cos_sin(rope_pos[None, :, None].expand(3, b, 1), cfg)
            ok = k_pos < pos
            if key_mask is not None:
                ok = ok & (key_mask | (k_pos >= start_pos))
            bias = torch.where(ok, 0.0, NEG_INF).float()[:, None, None, :]
            for li, layer in enumerate(self.layers):
                if int8_cache:
                    x, k_new, v_new = layer.decode(x, cos, sin, bias, (k8[li], ks[li]),
                                                   (v8[li], vs[li]))
                    k8[li, :, pos], ks[li, :, pos] = _kv_quantize(k_new[:, 0])
                    v8[li, :, pos], vs[li, :, pos] = _kv_quantize(v_new[:, 0])
                else:
                    x, k_new, v_new = layer.decode(x, cos, sin, bias, kbuf[li], vbuf[li])
                    kbuf[li, :, pos] = k_new[:, 0]
                    vbuf[li, :, pos] = v_new[:, 0]
            logits = self.lm_head(self._final(x)[:, -1])
            nxt = torch.where(done, eos, logits.argmax(-1))
            done = done | (nxt == eos)
            tok = nxt
            rope_pos = rope_pos + 1
            steps += 1
        return toks, steps


def _cat_linears(mods: list) -> nn.Module:
    """One layer computing ``mods`` side by side: per-output-channel
    weights, scales and biases concatenate unchanged, float and packed
    alike, so the fused layer's outputs are those of the parts."""
    first = mods[0]
    n_out = sum(m.out_features for m in mods)
    has_bias = first.bias is not None
    if isinstance(first, W4Linear):
        fused = W4Linear(first.in_features, n_out, bias=False, device="meta")
        fused.w4 = torch.cat([m.w4 for m in mods])
        fused.w_scale = torch.cat([m.w_scale for m in mods])
    else:
        fused = nn.Linear(first.in_features, n_out, bias=False, device="meta")
        fused.weight = nn.Parameter(torch.cat([m.weight for m in mods]), requires_grad=False)
    if has_bias:
        fused.bias = nn.Parameter(torch.cat([m.bias for m in mods]), requires_grad=False)
    return fused


def _same_kind(mods: list) -> bool:
    return (len({type(m) for m in mods}) == 1
            and len({m.bias is None for m in mods}) == 1)


@torch.no_grad()
def fuse_decode_projections(text: QwenVLText) -> QwenVLText:
    """Concatenate each layer's q/k/v into ``qkv`` and gate/up into
    ``gate_up`` along the output axis, in place (the JAX package's
    ``fuse_decode_projections``): one GEMM and one activation row-quantize
    where there were three, which is what the M = 1 decode pays for.  A
    group fuses only when its parts are alike (all packed or all float,
    biases on all or none), as the JAX package fuses leaves of one key set."""
    for layer in text.layers:
        if "q" in layer._modules and _same_kind([layer.q, layer.k, layer.v]):
            layer.qkv = _cat_linears([layer.q, layer.k, layer.v])
            del layer.q, layer.k, layer.v
        mlp = layer.mlp
        if "gate" in mlp and _same_kind([mlp["gate"], mlp["up"]]):
            mlp["gate_up"] = _cat_linears([mlp["gate"], mlp["up"]])
            del mlp["gate"], mlp["up"]
    return text


@torch.no_grad()
def quantize_embedding_int8(text: QwenVLText) -> QwenVLText:
    """Per-row int8 token table, in place (the JAX package's
    ``quantize_embedding_int8``): ``e8 = round(e / amax * 127)`` with
    ``amax = max(|row|, 1e-8)`` and bf16 scales ``amax / 127``, the KV
    cache's scheme.  Rows are quantized in chunks, so the full table needs
    little scratch."""
    e = text.embed
    if isinstance(e, Int8Embedding):
        return text
    v, d = e.shape
    e8 = torch.empty((v, d), dtype=torch.int8, device=e.device)
    e_scale = torch.empty((v,), dtype=torch.bfloat16, device=e.device)
    step = max(1, (1 << 26) // d)
    for r0 in range(0, v, step):
        e8[r0:r0 + step], e_scale[r0:r0 + step] = _kv_quantize(e[r0:r0 + step])
    del text.embed
    text.embed = Int8Embedding(e8, e_scale)
    return text

"""Qwen2.5-VL-7B text model (``physicedit_tpu/models/qwen_vl.py``): the
prompt encoder and the greedy physical reasoner.

28 layers, hidden 3584, 28 query / 4 KV heads (GQA), SwiGLU MLP, RMSNorm and
M-RoPE with sections [16, 24, 24] over (t, h, w) positions.  Full-sequence
attention (prefill, prompt encode) runs through kernel K2
(``kernels/flash_attention.gqa_causal_attention``) on the card; the
single-token decode attention is plain PyTorch, as it is XLA in the JAX
package.  The KV cache is bf16, preallocated, and written in place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from physicedit_torch.core.params import Leaf, linear
from physicedit_torch.kernels.flash_attention import gqa_causal_attention
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
        h = rms_norm(x, self.ln1.scale, cfg.eps)
        q = self.q(h).view(b, s, cfg.num_heads, cfg.head_dim)
        k = self.k(h).view(b, s, cfg.num_kv_heads, cfg.head_dim)
        v = self.v(h).view(b, s, cfg.num_kv_heads, cfg.head_dim).contiguous()
        return apply_rope_half(q, cos, sin), apply_rope_half(k, cos, sin), v

    def _tail(self, x, attn):
        x = x + self.o(attn)
        h = rms_norm(x, self.ln2.scale, self.cfg.eps)
        return x + self.mlp["down"](F.silu(self.mlp["gate"](h)) * self.mlp["up"](h))

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
        (x, k_new, v_new)."""
        q, k, v = self._qkv(x, cos, sin)
        return self._tail(x, _gqa_attention_decode(q, kc, vc, k, v, bias_cache)), k, v


def _gqa_attention_decode(q, kc, vc, k_new, v_new, bias_cache):
    """q [B, 1, N, D]; kc/vc [B, S, KV, D]; k_new/v_new [B, 1, KV, D];
    bias_cache [B, 1, 1, S] additive.  Returns [B, 1, N * D]."""
    b, _, n, d = q.shape
    kv = kc.shape[2]
    qg = q.reshape(b, 1, kv, n // kv, d).float()
    lc = torch.einsum("bskgd,btkd->bkgst", qg, kc.float()) / (d ** 0.5)
    lc = lc + bias_cache[:, None]
    ln = torch.einsum("bskgd,btkd->bkgst", qg, k_new.float()) / (d ** 0.5)
    m = torch.maximum(lc.amax(-1), ln[..., 0])
    pc = torch.exp(lc - m[..., None])
    pn = torch.exp(ln - m[..., None])
    den = pc.sum(-1) + pn[..., 0]
    # the probabilities are rounded to bf16 before the PV product, as in the
    # JAX package; the product itself runs in the promoted dtype
    dt = torch.promote_types(torch.bfloat16, vc.dtype)
    oc = torch.einsum("bkgst,btkd->bskgd", pc.to(torch.bfloat16).to(dt), vc.to(dt))
    on = pn.permute(0, 3, 1, 2, 4) * v_new[:, :, :, None].float()
    out = (oc.float() + on) / den.permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, 1, n * d).to(q.dtype)


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
    def prefill(self, inputs_embeds, position_ids, attn_mask, max_total_len: int):
        """Run the prompt and build the bf16 KV cache padded to
        ``max_total_len``.  Returns (last-token logits [B, V],
        (k, v) each [L, B, max_total_len, KV, D], hidden [B, S, D])."""
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
        return self.lm_head(hidden[:, -1]), (kbuf, vbuf), hidden

    @torch.no_grad()
    def greedy_decode(self, caches, first_token, start_pos: int,
                      start_rope_pos, max_new_tokens: int, key_mask=None):
        """Greedy decoding until every row has emitted EOS or
        ``max_new_tokens`` are out.

        caches: (k, v) from :meth:`prefill`, updated in place.
        first_token [B]; start_pos: cache position of the first new token
        (the padded prompt length); start_rope_pos [B]; key_mask [B, S_max]
        marks the live prompt slots of a padded prompt.  Returns the tokens
        [B, max_new_tokens] (EOS-filled after a row stops) and the number
        of decode steps run.
        """
        cfg = self.cfg
        kbuf, vbuf = caches
        b = first_token.shape[0]
        s_max = kbuf.shape[2]
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

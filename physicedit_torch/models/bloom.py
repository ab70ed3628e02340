"""BLOOM causal LM, the BeautifulPrompt backbone (``physicedit_tpu/models/bloom.py``;
the reference loads ``alibaba-pai/pai-bloom-1b1-text2prompt-sd`` through
transformers).

HF ``BloomForCausalLM`` semantics: word embeddings and an embedding
LayerNorm; ALiBi attention (per-head slopes times each row's mask-aware key
position, no RoPE); pre-LN blocks with a fused QKV projection whose output
axis is per head ``[heads, 3, head_dim]``, then ``dense``, and a tanh-GELU
MLP; a final LayerNorm and an ``lm_head`` tied to the embeddings.

:func:`bloom_generate` decodes greedily or samples with the reference's
generate kwargs (temperature, top-k, top-p, repetition penalty), drawing
from an explicit ``torch.Generator``; the JAX package draws from
``jax.random``, so sampled tokens are not the JAX package's (greedy ones
are).  Its K/V cache is preallocated per layer and written in place.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from physicedit_torch.core.params import Leaf, linear, materialize
from physicedit_torch.kernels.quant_matmul import true_div
from physicedit_torch.ops.norms import layer_norm

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class BloomConfig:
    vocab_size: int
    hidden_size: int = 1536
    num_layers: int = 24
    num_heads: int = 16
    eos_token_id: int = 2
    pad_token_id: int = 3
    eps: float = 1e-5

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


# alibaba-pai/pai-bloom-1b1-text2prompt-sd, config.json (a bloom-1b1)
PAI_BLOOM_1B1_TEXT2PROMPT = BloomConfig(vocab_size=250880, hidden_size=1536, num_layers=24,
                                        num_heads=16, eos_token_id=2, pad_token_id=3,
                                        eps=1e-5)


def alibi_slopes(num_heads: int) -> np.ndarray:
    """HF ``build_alibi_tensor``'s slope schedule (non-powers of two too)."""
    cp2 = 2 ** math.floor(math.log2(num_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(cp2) - 3)))
    slopes = base ** np.arange(1, 1 + cp2, dtype=np.float64)
    if cp2 != num_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * cp2) - 3)))
        n_rem = min(cp2, num_heads - cp2)
        extra = extra_base ** np.arange(1, 1 + 2 * n_rem, 2, dtype=np.float64)
        slopes = np.concatenate([slopes, extra])
    return slopes.astype(np.float32)


class BloomLayer(nn.Module):
    def __init__(self, cfg: BloomConfig, dtype=None):
        super().__init__()
        d = cfg.hidden_size
        self.ln1 = Leaf(scale=(d,), bias=(d,), dtype=dtype)
        self.qkv = linear(d, 3 * d, dtype=dtype)
        self.dense = linear(d, d, dtype=dtype)
        self.ln2 = Leaf(scale=(d,), bias=(d,), dtype=dtype)
        self.fc1 = linear(d, 4 * d, dtype=dtype)
        self.fc2 = linear(4 * d, d, dtype=dtype)


class Bloom(nn.Module):
    """Built on the ``meta`` device; see ``core/params.materialize``.  The
    ALiBi slopes are an fp32 buffer (:meth:`reset_alibi_`)."""

    def __init__(self, cfg: BloomConfig, dtype=None):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty((cfg.vocab_size, d), dtype=dtype, device="meta"),
                                  requires_grad=False)
        self.ln_emb = Leaf(scale=(d,), bias=(d,), dtype=dtype)
        self.layers = nn.ModuleList(BloomLayer(cfg, dtype) for _ in range(cfg.num_layers))
        self.ln_f = Leaf(scale=(d,), bias=(d,), dtype=dtype)
        self.register_buffer("alibi_slopes", torch.empty((cfg.num_heads,), dtype=torch.float32,
                                                         device="meta"))

    @torch.no_grad()
    def reset_alibi_(self) -> "Bloom":
        self.alibi_slopes.copy_(torch.from_numpy(alibi_slopes(self.cfg.num_heads)))
        return self


def _ln(p: Leaf, x, eps):
    return layer_norm(x, eps, p.scale, p.bias)


def _embed(model: Bloom, ids):
    return _ln(model.ln_emb, model.embed[ids], model.cfg.eps)


def _alibi_bias(model: Bloom, attn_mask):
    """[B, H, 1, S]: slope times HF's mask-aware position of each key (per
    row cumulative, so rows with different pads bias correctly)."""
    pos = (torch.cumsum(attn_mask, -1) - 1) * attn_mask
    return model.alibi_slopes[None, :, None, None] * pos[:, None, None, :].float()


def _attention(layer: BloomLayer, cfg: BloomConfig, x, alibi, bias, cache=None, pos=None):
    """x [B, S, D]; alibi [B, H, 1, S_k]; bias additive [B, 1, S, S_k].
    Without ``cache`` a full pass over the S keys; with it ((k, v) slabs
    [B, S_max, H, Hd]) one token at ``pos``, written into the slabs, over
    keys 0..pos.  Returns (out, k, v)."""
    b, s, d = x.shape
    n, hd = cfg.num_heads, cfg.head_dim
    q, k, v = layer.qkv(x).view(b, s, n, 3, hd).unbind(3)
    if cache is not None:
        cache[0][:, pos] = k[:, 0]
        cache[1][:, pos] = v[:, 0]
        k, v = cache[0][:, :pos + 1], cache[1][:, :pos + 1]
    sk = k.shape[1]
    scores = torch.einsum("bqnd,bknd->bnqk", q, k).float()
    scores = scores * (hd ** -0.5) + alibi[..., :sk] + bias
    a = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bnqk,bknd->bqnd", a, v).reshape(b, s, d)
    return layer.dense(out), k, v


def _block(layer: BloomLayer, cfg: BloomConfig, x, alibi, bias, cache=None, pos=None):
    h = _ln(layer.ln1, x, cfg.eps)
    attn, k, v = _attention(layer, cfg, h, alibi, bias, cache, pos)
    x = x + attn
    h = _ln(layer.ln2, x, cfg.eps)
    return x + layer.fc2(F.gelu(layer.fc1(h), approximate="tanh")), k, v


def _prefix_bias(attn_mask):
    """[B, 1, S, S]: causal and the row's pads masked with NEG_INF."""
    s = attn_mask.shape[1]
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=attn_mask.device))
    keep = causal[None, None] & attn_mask[:, None, None, :].bool()
    return torch.where(keep, 0.0, NEG_INF)


def _head(model: Bloom, x):
    x = _ln(model.ln_f, x, model.cfg.eps)
    return x @ model.embed.T.to(x.dtype)


@torch.no_grad()
def bloom_logits(model: Bloom, input_ids, attn_mask):
    """Teacher-forced logits [B, S, V] (the parity oracle)."""
    cfg = model.cfg
    x = _embed(model, input_ids)
    alibi = _alibi_bias(model, attn_mask)
    bias = _prefix_bias(attn_mask)
    for layer in model.layers:
        x, _, _ = _block(layer, cfg, x, alibi, bias)
    return _head(model, x)


def _apply_rep_penalty(logits, counts, penalty: float):
    """HF repetition_penalty: seen tokens' logits divided by the penalty
    where positive, multiplied by it elsewhere."""
    pen = torch.where(logits > 0, true_div(logits, penalty), logits * penalty)
    return torch.where(counts > 0, pen, logits)


def _top_k_top_p(logits, top_k: int, top_p: float):
    """HF's TopK then TopP warpers, the filtered logits set to NEG_INF."""
    v = logits.shape[-1]
    if 0 < top_k < v:
        kth = torch.sort(logits, dim=-1).values[..., v - top_k, None]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens until the cumulative probability passes top_p (the
        # first always kept)
        keep_sorted = cum - probs < top_p
        cutoff = torch.where(keep_sorted, srt, torch.inf).amin(-1, keepdim=True)
        logits = torch.where(logits < cutoff, NEG_INF, logits)
    return logits


@torch.no_grad()
def bloom_generate(model: Bloom, input_ids, attn_mask, max_new_tokens: int = 384,
                   do_sample: bool = False, temperature: float = 1.0, top_k: int = 0,
                   top_p: float = 1.0, repetition_penalty: float = 1.0,
                   generator: torch.Generator | None = None):
    """Continuations [B, max_new_tokens] (pad after EOS) of left-padded
    prompts.  The BeautifulPrompt call samples with temperature 0.9, top-k
    50, top-p 0.95 and repetition penalty 1.1; ``generator`` (on the model's
    device) makes a sampled run repeatable."""
    cfg = model.cfg
    b, s0 = input_ids.shape
    smax = s0 + max_new_tokens
    dev = input_ids.device
    attn_mask = attn_mask.long()
    mask_full = torch.cat([attn_mask, torch.ones((b, max_new_tokens), dtype=torch.long,
                                                 device=dev)], dim=1)
    alibi = _alibi_bias(model, mask_full)
    live = (mask_full > 0)[:, None, None, :]

    caches = []
    x = _embed(model, input_ids)
    bias = _prefix_bias(attn_mask)
    for layer in model.layers:
        x, k, v = _block(layer, cfg, x, alibi, bias)
        kc = torch.zeros((b, smax, cfg.num_heads, cfg.head_dim), dtype=k.dtype, device=dev)
        vc = torch.zeros_like(kc)
        kc[:, :s0], vc[:, :s0] = k, v
        caches.append((kc, vc))
    logits = _head(model, x[:, -1])

    counts = torch.zeros((b, cfg.vocab_size), dtype=torch.int32, device=dev)
    counts.scatter_add_(1, input_ids.long(), attn_mask.int())

    def pick(logits):
        lf = logits.float()
        if repetition_penalty != 1.0:
            lf = _apply_rep_penalty(lf, counts, repetition_penalty)
        if do_sample:
            lf = _top_k_top_p(true_div(lf, temperature), top_k, top_p)
            return torch.multinomial(torch.softmax(lf, -1), 1, generator=generator)[:, 0]
        return lf.argmax(-1)

    toks = torch.full((b, max_new_tokens), cfg.pad_token_id, dtype=torch.long, device=dev)
    tok = pick(logits)
    toks[:, 0] = tok
    done = tok == cfg.eos_token_id
    counts.scatter_add_(1, tok[:, None], torch.ones_like(tok[:, None], dtype=torch.int32))
    for i in range(1, max_new_tokens):
        if bool(done.all()):
            break
        pos = s0 + i - 1
        x = _embed(model, tok[:, None])
        bias = torch.where(live[..., :pos + 1], 0.0, NEG_INF)
        for layer, cache in zip(model.layers, caches):
            x, _, _ = _block(layer, cfg, x, alibi, bias, cache, pos)
        nxt = torch.where(done, cfg.pad_token_id, pick(_head(model, x[:, 0])))
        toks[:, i] = nxt
        done = done | (nxt == cfg.eos_token_id)
        counts.scatter_add_(1, nxt[:, None], torch.ones_like(nxt[:, None], dtype=torch.int32))
        tok = nxt
    return toks


def config_from_hf(hf_cfg) -> BloomConfig:
    """A BloomConfig from an HF config object (or a dict of its fields)."""
    get = hf_cfg.get if isinstance(hf_cfg, dict) else (lambda k, d=None: getattr(hf_cfg, k, d))
    return BloomConfig(
        vocab_size=get("vocab_size"), hidden_size=get("hidden_size") or get("n_embed"),
        num_layers=get("n_layer"), num_heads=get("n_head"),
        eos_token_id=get("eos_token_id", 2),
        pad_token_id=get("pad_token_id") or get("eos_token_id", 2),
        eps=get("layer_norm_epsilon", 1e-5))


def bloom_key_map(cfg: BloomConfig, base: str = "transformer.") -> list:
    """Rows ``(parameter, HF keys, kind)`` of ``io/convert.load_module_``
    for an HF ``BloomForCausalLM`` state dict (the fused QKV keeps HF's per
    head ``[heads, 3, head_dim]`` output layout)."""
    from physicedit_torch.io.convert import COPY, _lin

    def ln(rows, param, ref):
        rows.append((f"{param}.scale", (f"{ref}.weight",), COPY))
        rows.append((f"{param}.bias", (f"{ref}.bias",), COPY))

    rows: list = [("embed", (base + "word_embeddings.weight",), COPY)]
    ln(rows, "ln_emb", base + "word_embeddings_layernorm")
    for i in range(cfg.num_layers):
        p, r = f"layers.{i}", f"{base}h.{i}"
        ln(rows, f"{p}.ln1", f"{r}.input_layernorm")
        _lin(rows, f"{p}.qkv", f"{r}.self_attention.query_key_value")
        _lin(rows, f"{p}.dense", f"{r}.self_attention.dense")
        ln(rows, f"{p}.ln2", f"{r}.post_attention_layernorm")
        _lin(rows, f"{p}.fc1", f"{r}.mlp.dense_h_to_4h")
        _lin(rows, f"{p}.fc2", f"{r}.mlp.dense_4h_to_h")
    ln(rows, "ln_f", base + "ln_f")
    return rows


@torch.no_grad()
def bloom_from_state_dict(sd: dict, cfg: BloomConfig, dtype=torch.float32,
                          device="cuda") -> Bloom:
    """An HF ``BloomForCausalLM`` state dict (torch layout) -> :class:`Bloom`
    (the JAX package's ``bloom_from_torch``)."""
    from physicedit_torch.io.convert import COPY, load_module_

    model = materialize(Bloom(cfg, dtype), device)
    # the slopes are computed, not read
    slopes = torch.from_numpy(alibi_slopes(cfg.num_heads))
    load_module_(model, {**sd, "alibi_slopes": slopes},
                 bloom_key_map(cfg) + [("alibi_slopes", ("alibi_slopes",), COPY)])
    return model.eval()

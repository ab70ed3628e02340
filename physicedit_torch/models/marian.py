"""MarianMT encoder-decoder (opus-mt), the prompt Translator's backbone
(``physicedit_tpu/models/marian.py``; the reference loads
``Helsinki-NLP/opus-mt-zh-en`` through transformers).

HF ``MarianMTModel`` semantics: a shared token embedding scaled by
sqrt(d_model); a fixed sinusoidal position table (the sin half, then the
cos half, not interleaved); post-LN layers (LayerNorm after each residual
add); the encoder is self-attention, LN, FFN, LN; the decoder causal
self-attention, LN, cross-attention over the encoder, LN, FFN, LN; the
logits are the shared embedding transposed plus ``final_logits_bias``.

:func:`marian_greedy_generate` projects the cross-attention K/V once per
generation and keeps the self-attention K/V in preallocated per-layer
caches written in place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from physicedit_torch.core.params import Leaf, linear, materialize
from physicedit_torch.ops.norms import layer_norm

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class MarianConfig:
    vocab_size: int
    d_model: int = 512
    encoder_layers: int = 6
    decoder_layers: int = 6
    num_heads: int = 8
    ffn_dim: int = 2048
    max_positions: int = 512
    scale_embedding: bool = True
    activation: str = "swish"   # opus-mt: "swish" (= silu)
    pad_token_id: int = 0
    eos_token_id: int = 0
    decoder_start_token_id: int = 0   # Marian: the pad id
    eps: float = 1e-5

    @property
    def head_dim(self):
        return self.d_model // self.num_heads

    @property
    def embed_scale(self):
        return float(np.sqrt(self.d_model)) if self.scale_embedding else 1.0


# Helsinki-NLP/opus-mt-zh-en, config.json
OPUS_MT_ZH_EN = MarianConfig(vocab_size=65001, d_model=512, encoder_layers=6,
                             decoder_layers=6, num_heads=8, ffn_dim=2048, max_positions=512,
                             scale_embedding=True, activation="swish", pad_token_id=65000,
                             eos_token_id=0, decoder_start_token_id=65000)

_ACTS = {"swish": F.silu, "silu": F.silu, "gelu": F.gelu, "relu": F.relu}


def sinusoidal_table(n_pos: int, dim: int) -> np.ndarray:
    """HF Marian's layout: sin features in [:, :ceil(dim/2)], cos after."""
    pos = np.arange(n_pos)[:, None]
    j = np.arange(dim)[None, :]
    enc = pos / np.power(10000.0, 2 * (j // 2) / dim)
    sentinel = dim // 2 if dim % 2 == 0 else dim // 2 + 1
    out = np.empty((n_pos, dim), np.float32)
    out[:, :sentinel] = np.sin(enc[:, 0::2])
    out[:, sentinel:] = np.cos(enc[:, 1::2])
    return out


def _attn(d: int, dtype) -> nn.ModuleDict:
    return nn.ModuleDict({n: linear(d, d, dtype=dtype) for n in ("q", "k", "v", "o")})


class EncoderLayer(nn.Module):
    def __init__(self, cfg: MarianConfig, dtype=None):
        super().__init__()
        d = cfg.d_model
        self.attn = _attn(d, dtype)
        self.ln1 = Leaf(scale=(d,), bias=(d,), dtype=dtype)
        self.fc1 = linear(d, cfg.ffn_dim, dtype=dtype)
        self.fc2 = linear(cfg.ffn_dim, d, dtype=dtype)
        self.ln2 = Leaf(scale=(d,), bias=(d,), dtype=dtype)


class DecoderLayer(EncoderLayer):
    def __init__(self, cfg: MarianConfig, dtype=None):
        super().__init__(cfg, dtype)
        d = cfg.d_model
        self.cross = _attn(d, dtype)
        self.ln3 = Leaf(scale=(d,), bias=(d,), dtype=dtype)


class Marian(nn.Module):
    """Built on the ``meta`` device; see ``core/params.materialize``.  The
    position table and ``final_logits_bias`` are fp32."""

    def __init__(self, cfg: MarianConfig, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty((cfg.vocab_size, cfg.d_model), dtype=dtype,
                                              device="meta"), requires_grad=False)
        self.register_buffer("pos", torch.empty((cfg.max_positions, cfg.d_model),
                                                dtype=torch.float32, device="meta"))
        self.register_buffer("final_logits_bias", torch.empty((1, cfg.vocab_size),
                                                              dtype=torch.float32,
                                                              device="meta"))
        self.enc_layers = nn.ModuleList(EncoderLayer(cfg, dtype)
                                        for _ in range(cfg.encoder_layers))
        self.dec_layers = nn.ModuleList(DecoderLayer(cfg, dtype)
                                        for _ in range(cfg.decoder_layers))


def _heads(x, cfg: MarianConfig):
    b, s, _ = x.shape
    return x.view(b, s, cfg.num_heads, cfg.head_dim)


def _softmax_pv(q, k, v, bias, dtype):
    s = torch.einsum("bqnd,bknd->bnqk", q, k).float()
    if bias is not None:
        s = s + bias
    a = torch.softmax(s, dim=-1).to(dtype)
    return torch.einsum("bnqk,bknd->bqnd", a, v)


def _mha(p: nn.ModuleDict, cfg: MarianConfig, q_x, kv_x, bias):
    """Multi-head attention; bias additive [B, 1|H, S_q, S_k] or None."""
    q = _heads(p["q"](q_x), cfg) * (cfg.head_dim ** -0.5)
    out = _softmax_pv(q, _heads(p["k"](kv_x), cfg), _heads(p["v"](kv_x), cfg), bias,
                      q_x.dtype)
    return p["o"](out.reshape(q_x.shape))


def _ffn(layer, cfg: MarianConfig, x):
    return layer.fc2(_ACTS[cfg.activation](layer.fc1(x)))


def _post_ln(p: Leaf, cfg: MarianConfig, x):
    return layer_norm(x, cfg.eps, p.scale, p.bias)


def _embed(model: Marian, ids, pos0: int = 0):
    emb = model.embed
    x = emb[ids] * torch.tensor(model.cfg.embed_scale, dtype=emb.dtype)
    return x + model.pos[pos0:pos0 + ids.shape[1]].to(x.dtype)


def _key_bias(mask):
    return torch.where(mask[:, None, None, :].bool(), 0.0, NEG_INF)


@torch.no_grad()
def marian_encode(model: Marian, input_ids, attn_mask):
    """input_ids, attn_mask [B, S] -> encoder hidden states [B, S, D]."""
    cfg = model.cfg
    x = _embed(model, input_ids)
    bias = _key_bias(attn_mask)
    for layer in model.enc_layers:
        x = _post_ln(layer.ln1, cfg, x + _mha(layer.attn, cfg, x, x, bias))
        x = _post_ln(layer.ln2, cfg, x + _ffn(layer, cfg, x))
    return x


def _logits(model: Marian, x):
    return (x @ model.embed.T.to(x.dtype)) + model.final_logits_bias


@torch.no_grad()
def marian_decode_logits(model: Marian, decoder_ids, enc_hidden, enc_mask):
    """Teacher-forced decoder pass -> logits [B, S_dec, V] (the parity oracle)."""
    cfg = model.cfg
    s = decoder_ids.shape[1]
    x = _embed(model, decoder_ids)
    causal = torch.where(torch.tril(torch.ones((s, s), dtype=torch.bool,
                                               device=x.device))[None, None], 0.0, NEG_INF)
    enc_bias = _key_bias(enc_mask)
    for layer in model.dec_layers:
        x = _post_ln(layer.ln1, cfg, x + _mha(layer.attn, cfg, x, x, causal))
        x = _post_ln(layer.ln2, cfg, x + _mha(layer.cross, cfg, x, enc_hidden, enc_bias))
        x = _post_ln(layer.ln3, cfg, x + _ffn(layer, cfg, x))
    return _logits(model, x)


def _decode_step(model: Marian, tok, pos: int, caches: list, cross_kv: list, enc_bias):
    """One greedy step of the token ``tok`` [B] at position ``pos``: its
    self-attention K/V are written into ``caches`` (per layer (k, v)
    [B, S_max, N, Hd]); returns the logits [B, V]."""
    cfg = model.cfg
    x = _embed(model, tok[:, None], pos)
    for layer, (kc, vc), (ck, cv) in zip(model.dec_layers, caches, cross_kv):
        a = layer.attn
        q = _heads(a["q"](x), cfg) * (cfg.head_dim ** -0.5)
        kc[:, pos] = _heads(a["k"](x), cfg)[:, 0]
        vc[:, pos] = _heads(a["v"](x), cfg)[:, 0]
        o = _softmax_pv(q, kc[:, :pos + 1], vc[:, :pos + 1], None, x.dtype)
        x = _post_ln(layer.ln1, cfg, x + a["o"](o.reshape(x.shape)))
        c = layer.cross
        q = _heads(c["q"](x), cfg) * (cfg.head_dim ** -0.5)
        o = _softmax_pv(q, ck, cv, enc_bias, x.dtype)
        x = _post_ln(layer.ln2, cfg, x + c["o"](o.reshape(x.shape)))
        x = _post_ln(layer.ln3, cfg, x + _ffn(layer, cfg, x))
    return _logits(model, x[:, 0])


@torch.no_grad()
def marian_greedy_generate(model: Marian, input_ids, attn_mask, max_new_tokens: int = 512):
    """HF generate's greedy search: encode, start at ``decoder_start``, argmax
    to EOS.  Returns [B, max_new_tokens]; positions after EOS hold the pad
    id, as HF pads finished rows."""
    cfg = model.cfg
    b = input_ids.shape[0]
    dev = input_ids.device
    enc_h = marian_encode(model, input_ids, attn_mask)
    enc_bias = _key_bias(attn_mask)
    cross_kv = [(_heads(layer.cross["k"](enc_h), cfg), _heads(layer.cross["v"](enc_h), cfg))
                for layer in model.dec_layers]
    shape = (b, max_new_tokens, cfg.num_heads, cfg.head_dim)
    caches = [(torch.zeros(shape, dtype=enc_h.dtype, device=dev),
               torch.zeros(shape, dtype=enc_h.dtype, device=dev)) for _ in model.dec_layers]
    toks = torch.full((b, max_new_tokens), cfg.pad_token_id, dtype=torch.long, device=dev)
    tok = torch.full((b,), cfg.decoder_start_token_id, dtype=torch.long, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    for pos in range(max_new_tokens):
        if bool(done.all()):
            break
        nxt = _decode_step(model, tok, pos, caches, cross_kv, enc_bias).argmax(-1)
        nxt = torch.where(done, cfg.pad_token_id, nxt)
        done = done | (nxt == cfg.eos_token_id)
        toks[:, pos] = nxt
        tok = nxt
    return toks


def config_from_hf(hf_cfg) -> MarianConfig:
    """A MarianConfig from an HF config object or a config.json dict."""
    get = hf_cfg.get if isinstance(hf_cfg, dict) else (lambda k, d=None: getattr(hf_cfg, k, d))
    return MarianConfig(
        vocab_size=get("vocab_size"), d_model=get("d_model"),
        encoder_layers=get("encoder_layers"), decoder_layers=get("decoder_layers"),
        num_heads=get("encoder_attention_heads"), ffn_dim=get("encoder_ffn_dim"),
        max_positions=get("max_position_embeddings"),
        scale_embedding=get("scale_embedding", True),
        activation={"swish": "swish", "silu": "swish", "gelu": "gelu",
                    "relu": "relu"}[get("activation_function", "swish")],
        pad_token_id=get("pad_token_id"), eos_token_id=get("eos_token_id"),
        decoder_start_token_id=get("decoder_start_token_id"))


def marian_key_map(cfg: MarianConfig) -> list:
    """Rows ``(parameter, HF keys, kind)`` of ``io/convert.load_module_`` for
    an HF ``MarianMTModel`` state dict (the position table and
    ``final_logits_bias`` excepted: :func:`marian_from_state_dict`)."""
    from physicedit_torch.io.convert import COPY, _lin

    def ln(rows, param, ref):
        rows.append((f"{param}.scale", (f"{ref}.weight",), COPY))
        rows.append((f"{param}.bias", (f"{ref}.bias",), COPY))

    def attn(rows, param, ref):
        for n, r in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
            _lin(rows, f"{param}.{n}", f"{ref}.{r}")

    rows: list = [("embed", ("model.shared.weight",), COPY)]
    for side, n in (("enc", cfg.encoder_layers), ("dec", cfg.decoder_layers)):
        for i in range(n):
            p = f"{side}_layers.{i}"
            r = f"model.{'encoder' if side == 'enc' else 'decoder'}.layers.{i}"
            attn(rows, f"{p}.attn", f"{r}.self_attn")
            ln(rows, f"{p}.ln1", f"{r}.self_attn_layer_norm")
            if side == "dec":
                attn(rows, f"{p}.cross", f"{r}.encoder_attn")
                ln(rows, f"{p}.ln2", f"{r}.encoder_attn_layer_norm")
                ln(rows, f"{p}.ln3", f"{r}.final_layer_norm")
            else:
                ln(rows, f"{p}.ln2", f"{r}.final_layer_norm")
            _lin(rows, f"{p}.fc1", f"{r}.fc1")
            _lin(rows, f"{p}.fc2", f"{r}.fc2")
    return rows


@torch.no_grad()
def marian_from_state_dict(sd: dict, cfg: MarianConfig, dtype=torch.float32,
                           device="cuda") -> Marian:
    """An HF ``MarianMTModel`` state dict (torch layout) -> :class:`Marian`
    (the JAX package's ``marian_from_torch``): the position table from
    ``model.encoder.embed_positions.weight`` when the file has it, else
    computed; ``final_logits_bias`` zero when absent."""
    from physicedit_torch.io.convert import COPY, load_module_

    model = materialize(Marian(cfg, dtype), device)
    pos_key = "model.encoder.embed_positions.weight"
    extra = {"pos": sd[pos_key] if pos_key in sd
             else torch.from_numpy(sinusoidal_table(cfg.max_positions, cfg.d_model)),
             "final_logits_bias": sd.get("final_logits_bias",
                                         torch.zeros((1, cfg.vocab_size)))}
    rows = marian_key_map(cfg) + [(k, (k,), COPY) for k in extra]
    load_module_(model, {**sd, **extra}, rows)
    return model.eval()

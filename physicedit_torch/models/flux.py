"""The FLUX.1 DiT (``FluxTransformer2DModel`` of diffusers, FLUX.1 Kontext
[dev]'s ``transformer/config.json``) as ``nn.Module``s: 19 double-stream
blocks, then 38 single-stream blocks over the joint sequence.

- Inputs: the packed image tokens [B, S_i, 64] (the target's first, then
  Kontext's context image), the T5 rows [B, S_t, 4096], the timestep in
  [0, 1], the distilled guidance and the pooled CLIP vector [B, 768].  The
  timestep and the guidance are scaled by 1,000 inside the model and
  embedded sinusoidally (``models.dit.timestep_embedding``, cos then sin);
  each embedding and the pooled vector go through their own two-layer SiLU
  MLP, and the three sum into the conditioning vector.
- The double-stream blocks are ``models.dit.DiTBlock`` with FLUX's tanh
  GELU: the same 6-way modulation, fused QKV with bias, per-head q/k
  RMSNorm, joint attention over the text then the image, and gated
  residuals.  The text input has no RMSNorm (Qwen-Image's ``txt_norm``).
- A single-stream block (:class:`FluxSingleBlock`): ``x = cat(txt, img)``;
  ``shift, scale, gate`` from one modulation; ``h = LN(x) * (1 + scale) +
  shift`` (``kernels/ln_mod.ln_mod``); q, k, v from one QKV projection of
  ``h`` with one q/k gain pair and RoPE over the joint sequence
  (``kernels/qk_norm_rope.qk_norm_rope_joint``); the attention (K1);
  ``m = gelu_tanh(proj_mlp(h))`` beside it; ``x = x + gate *
  proj_out(cat(attn, m))``.  The last one runs slim: only the first
  ``slim_last`` image rows (the target's) are queried and carried on.
- The final layer: ``scale, shift`` (diffusers' order) from
  ``norm_out.linear``, then ``proj_out`` over the target rows.

Under ``torch.profiler`` (``core/trace.py``) the forward is ``pe.dit``; a
double-stream block is ``pe.dit.block`` with ``DiTBlock``'s five segments
``pe.block.*``; a single-stream block is ``pe.single.block`` with the
segments ``pe.single.mod`` (the modulation linear), ``pe.single.qkv`` (the
modulated LayerNorm, the QKV projection and the q/k kernel),
``pe.single.attn``, ``pe.single.mlp`` (``proj_mlp`` and the GELU) and
``pe.single.out`` (heads to features, the concatenation, ``proj_out`` and
the gated residual).

The q/k and ``ln_mod`` kernels have no backward: with grad on, as on the
CPU, their wrappers run the plain versions, which autograd differentiates.

``io/convert.flux_key_map`` maps diffusers' state-dict keys onto these
modules.  No LoRA, EliGen, ControlNet, dense, ring or W4 lane, and no text
key mask: the forward refuses them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from physicedit_torch.core.params import Leaf, linear
from physicedit_torch.core.trace import span
from physicedit_torch.kernels.flash_attention import fixedmax_attention
from physicedit_torch.kernels.ln_mod import ln_mod
from physicedit_torch.kernels.qk_norm_rope import qk_norm_rope_joint
from physicedit_torch.models.dit import DiTBlock, timestep_embedding
from physicedit_torch.ops.norms import tanh_gelu


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    num_layers: int = 19            # double-stream blocks
    num_single_layers: int = 38
    dim: int = 3072                 # num_attention_heads x attention_head_dim
    num_heads: int = 24
    head_dim: int = 128
    txt_in_dim: int = 4096          # joint_attention_dim (T5-XXL)
    pooled_dim: int = 768           # pooled_projection_dim (CLIP-L)
    patch_dim: int = 64             # in_channels
    time_dim: int = 256
    eps: float = 1e-6

    @property
    def mlp_dim(self) -> int:
        return self.dim * 4


FLUX_KONTEXT_CONFIG = FluxConfig()


def _two_layer(d_in: int, d: int, dtype) -> nn.ModuleDict:
    return nn.ModuleDict({"linear_1": linear(d_in, d, dtype=dtype),
                          "linear_2": linear(d, d, dtype=dtype)})


def _embed(mlp: nn.ModuleDict, x):
    return mlp["linear_2"](F.silu(mlp["linear_1"](x)))


class FluxSingleBlock(nn.Module):
    def __init__(self, cfg: FluxConfig, dtype=None):
        super().__init__()
        d, hd = cfg.dim, cfg.head_dim
        self.cfg = cfg
        self.mod = linear(d, 3 * d, dtype=dtype)
        self.attn = nn.ModuleDict({"qkv": linear(d, 3 * d, dtype=dtype),
                                   "norm_q": Leaf(scale=(hd,), dtype=dtype),
                                   "norm_k": Leaf(scale=(hd,), dtype=dtype)})
        self.proj_mlp = linear(d, cfg.mlp_dim, dtype=dtype)
        self.proj_out = linear(d + cfg.mlp_dim, d, dtype=dtype)

    def forward(self, x, s_t: int, temb_silu, img_cos, img_sin, txt_cos, txt_sin,
                slim_base: int = 0, attn_clamp: bool = True):
        """x [B, S_t + S_i, D], the text rows first; returns the new x, or
        its first ``slim_base`` image rows [B, slim_base, D] when
        ``slim_base > 0``."""
        b, _, d = x.shape
        a = self.attn
        with span("pe.single.mod"):
            shift, scale, gate = self.mod(temb_silu).chunk(3, -1)
        with span("pe.single.qkv"):
            h = ln_mod(x, shift, scale, self.cfg.eps)
            q, k, v = qk_norm_rope_joint(a["qkv"](h), s_t, (a["norm_q"].scale, a["norm_k"].scale),
                                         img_cos, img_sin, txt_cos, txt_sin, self.cfg.eps,
                                         slim_base)
        with span("pe.single.attn"):
            out = fixedmax_attention(q, k, v, clamp=attn_clamp)
        if slim_base:
            x, h = x[:, s_t:s_t + slim_base], h[:, s_t:s_t + slim_base]
        with span("pe.single.mlp"):
            m = tanh_gelu(self.proj_mlp(h))
        with span("pe.single.out"):
            o = out.transpose(1, 2).reshape(b, x.shape[1], d)
            return x + gate[:, None, :] * self.proj_out(torch.cat([o, m], dim=-1))


class FluxDiT(nn.Module):
    """Built on the ``meta`` device; see ``core/params.materialize``."""

    def __init__(self, cfg: FluxConfig = FLUX_KONTEXT_CONFIG, dtype=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        self.x_embedder = linear(cfg.patch_dim, d, dtype=dtype)
        self.context_embedder = linear(cfg.txt_in_dim, d, dtype=dtype)
        self.time_embed = _two_layer(cfg.time_dim, d, dtype)
        self.guidance_embed = _two_layer(cfg.time_dim, d, dtype)
        self.pooled_embed = _two_layer(cfg.pooled_dim, d, dtype)
        self.blocks = nn.ModuleList(DiTBlock(cfg, dtype, act=tanh_gelu)
                                    for _ in range(cfg.num_layers))
        self.single_blocks = nn.ModuleList(FluxSingleBlock(cfg, dtype)
                                           for _ in range(cfg.num_single_layers))
        self.norm_out = nn.ModuleDict({"linear": linear(d, 2 * d, dtype=dtype)})
        self.proj_out = linear(d, cfg.patch_dim, dtype=dtype)

    def forward(self, img_tokens, txt_tokens, timestep, img_cos, img_sin, txt_cos, txt_sin,
                txt_key_mask=None, slim_last: int = 0, attn_clamp: bool = True,
                guidance=None, pooled=None, attn_impl: str = "kernels", lora=None,
                control=None, attn_bias_log2=None):
        """img_tokens [B, S_i, 64] (the target's tokens first); txt_tokens
        [B, S_t, 4096], every row attended; timestep [B] in [0, 1]; guidance
        [B] (the distilled guidance scale, 2.5 at Kontext's default); pooled
        [B, 768]; the tables of ``ops.rope.flux_rope_tables``.  Returns [B,
        S_i, 64], or [B, slim_last, 64] when the last block runs slim.
        ``sampling/denoise.denoise`` passes every DiT the Qwen-Image lanes'
        inputs: a text key mask, LoRA, ControlNet, an EliGen bias or an
        attention other than K1 is refused."""
        if (txt_key_mask is not None or lora is not None or control is not None
                or attn_bias_log2 is not None or attn_impl != "kernels"):
            raise ValueError("the FLUX DiT attends every text row through K1: it has no key "
                             "mask, LoRA, ControlNet, EliGen, dense or ring lane")
        with span("pe.dit"):
            cfg = self.cfg
            dtype = img_tokens.dtype
            s_t = txt_tokens.shape[1]
            image = self.x_embedder(img_tokens)
            text = self.context_embedder(txt_tokens)
            vec = (_embed(self.time_embed, timestep_embedding(timestep, cfg.time_dim, dtype))
                   + _embed(self.guidance_embed,
                            timestep_embedding(guidance, cfg.time_dim, dtype))
                   + _embed(self.pooled_embed, pooled))
            temb_silu = F.silu(vec)
            for block in self.blocks:
                with span("pe.dit.block"):
                    text, image = block(image, text, temb_silu, img_cos, img_sin, txt_cos,
                                        txt_sin, None, attn_clamp=attn_clamp)
            x = torch.cat([text, image], dim=1)
            last = len(self.single_blocks) - 1
            for i, block in enumerate(self.single_blocks):
                with span("pe.single.block"):
                    x = block(x, s_t, temb_silu, img_cos, img_sin, txt_cos, txt_sin,
                              slim_base=slim_last if i == last else 0, attn_clamp=attn_clamp)
            if not (slim_last and self.single_blocks):
                x = x[:, s_t:]

            scale, shift = self.norm_out["linear"](temb_silu).chunk(2, -1)
            return self.proj_out(ln_mod(x, shift, scale, 1e-6))

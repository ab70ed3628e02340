"""Qwen-Image MM-DiT (``physicedit_tpu/models/dit.py``) as ``nn.Module``s.

60 dual-stream blocks in an ``nn.ModuleList``; per-stream QKV projections
are fused ([dim, 3 * dim], as in the JAX package); RoPE tables come from
the host (``ops/rope.py``); text padding is a key-side mask, so the CFG
positive and negative rows ride one batch.  The joint attention runs
through kernel K1 (``kernels/flash_attention.fixedmax_attention``).

With packed-int4 block weights (``PhysicEditPipeline.quantize_``) a block
takes the fused path of the JAX package: K4 ``ln_mod_quant`` feeds the QKV
and fc1 projections, K5 ``gelu_quant`` feeds fc2 and K6 ``transpose_quant``
feeds the attention output projections, each straight into
``w4a8_linear_q``.

Module attribute names follow the JAX parameter tree, so ``io/from_jax.py``
can carry weights across by name.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from physicedit_torch.core.params import Leaf, linear
from physicedit_torch.kernels.flash_attention import CLAMP, LOG2E, fixedmax_attention
from physicedit_torch.kernels.fused_quant import gelu_quant, ln_mod_quant, transpose_quant
from physicedit_torch.kernels.quant_matmul import W4Linear, w4a8_linear_q
from physicedit_torch.ops.norms import approximate_gelu, layer_norm, rms_norm
from physicedit_torch.ops.rope import apply_rope


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    num_layers: int = 60
    dim: int = 3072
    num_heads: int = 24
    head_dim: int = 128
    txt_in_dim: int = 3584
    patch_dim: int = 64
    time_dim: int = 256
    eps: float = 1e-6

    @property
    def mlp_dim(self) -> int:
        return self.dim * 4


QWEN_IMAGE_CONFIG = DiTConfig()


def timestep_embedding(t: torch.Tensor, dim: int, dtype) -> torch.Tensor:
    """Sinusoidal embedding with the reference's scale of 1000 applied here,
    inside the model; the frequency table is rounded through ``dtype``."""
    half = dim // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half, dtype=np.float32) / half)
    freqs = torch.from_numpy(np.asarray(freqs, np.float32)).to(
        t.device).to(dtype).float()
    ang = t.float()[:, None] * freqs[None, :] * 1000.0
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1).to(dtype)


def _modulate(x, shift, scale, eps):
    return layer_norm(x, eps=eps) * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _mod_linear(lin, x, shift, scale, eps, fused: bool):
    """``lin(modulate(x))``; on the fused path K4 makes the int8 input."""
    if fused and isinstance(lin, W4Linear):
        fq = ln_mod_quant(x, shift, scale, eps)
        if fq is not None:
            return w4a8_linear_q(lin, *fq, x.dtype)
    return lin(_modulate(x, shift, scale, eps))


def _mlp(p: nn.ModuleDict, x, shift, scale, eps, fused: bool):
    """``fc2(gelu(fc1(modulate(x))))``; on the fused path K5 makes fc2's
    int8 input."""
    h = _mod_linear(p["fc1"], x, shift, scale, eps, fused)
    if fused and isinstance(p["fc2"], W4Linear):
        gq = gelu_quant(h)
        if gq is not None:
            return w4a8_linear_q(p["fc2"], *gq, x.dtype)
    return p["fc2"](approximate_gelu(h))


class DiTBlock(nn.Module):
    def __init__(self, cfg: DiTConfig, dtype=None):
        super().__init__()
        d, hd = cfg.dim, cfg.head_dim
        self.cfg = cfg
        self.img_mod = linear(d, 6 * d, dtype=dtype)
        self.txt_mod = linear(d, 6 * d, dtype=dtype)
        self.attn = nn.ModuleDict({
            "img_qkv": linear(d, 3 * d, dtype=dtype),
            "txt_qkv": linear(d, 3 * d, dtype=dtype),
            "norm_q": Leaf(scale=(hd,), dtype=dtype),
            "norm_k": Leaf(scale=(hd,), dtype=dtype),
            "norm_added_q": Leaf(scale=(hd,), dtype=dtype),
            "norm_added_k": Leaf(scale=(hd,), dtype=dtype),
            "to_out": linear(d, d, dtype=dtype),
            "to_add_out": linear(d, d, dtype=dtype),
        })
        self.img_mlp = nn.ModuleDict({"fc1": linear(d, cfg.mlp_dim, dtype=dtype),
                                      "fc2": linear(cfg.mlp_dim, d, dtype=dtype)})
        self.txt_mlp = nn.ModuleDict({"fc1": linear(d, cfg.mlp_dim, dtype=dtype),
                                      "fc2": linear(cfg.mlp_dim, d, dtype=dtype)})

    def forward(self, image, text, temb_silu, img_cos, img_sin, txt_cos, txt_sin,
                joint_key_mask, slim_base: int = 0, attn_clamp: bool = True):
        """One dual-stream block; returns (text, image).

        ``slim_base > 0`` runs it as the last block: only the first
        ``slim_base`` image rows are queried and carried on (the denoise loop
        keeps only those), the text stream and edit-image rows skip their
        projections and MLPs, and the return is (None, image[:, :slim_base]).
        """
        cfg = self.cfg
        b, s_i, d = image.shape
        s_t = text.shape[1]
        n, hd, eps = cfg.num_heads, cfg.head_dim, cfg.eps
        a = self.attn
        # the JAX package's use_fq: packed block weights the kernels can tile
        fq = isinstance(a["img_qkv"], W4Linear) and (a["img_qkv"].in_features // 2) % 128 == 0

        im_sh1, im_sc1, im_g1, im_sh2, im_sc2, im_g2 = self.img_mod(temb_silu).chunk(6, -1)
        tx_sh1, tx_sc1, tx_g1, tx_sh2, tx_sc2, tx_g2 = self.txt_mod(temb_silu).chunk(6, -1)

        img_qkv = _mod_linear(a["img_qkv"], image, im_sh1, im_sc1, eps, fq)
        txt_qkv = _mod_linear(a["txt_qkv"], text, tx_sh1, tx_sc1, eps, fq)
        iq, ik, iv = img_qkv.view(b, s_i, 3, n, hd).permute(2, 0, 3, 1, 4)
        tq, tk, tv = txt_qkv.view(b, s_t, 3, n, hd).permute(2, 0, 3, 1, 4)

        iq = apply_rope(rms_norm(iq, a["norm_q"].scale, eps), img_cos, img_sin)
        ik = apply_rope(rms_norm(ik, a["norm_k"].scale, eps), img_cos, img_sin)
        tq = apply_rope(rms_norm(tq, a["norm_added_q"].scale, eps), txt_cos, txt_sin)
        tk = apply_rope(rms_norm(tk, a["norm_added_k"].scale, eps), txt_cos, txt_sin)

        # text prefix, image suffix on the joint axis; [B, N, S, D] contiguous
        if slim_base:
            q = iq[:, :, :slim_base].contiguous()
        else:
            q = torch.cat([tq, iq], dim=2)
        k = torch.cat([tk, ik], dim=2)
        v = torch.cat([tv, iv], dim=2)
        out = fixedmax_attention(q, k, v, key_mask=joint_key_mask, clamp=attn_clamp)

        # K6: the heads-to-features transpose and the row quantize in one pass
        if slim_base:
            if fq and isinstance(a["to_out"], W4Linear):
                fq_attn = transpose_quant(out)
                if fq_attn is None:
                    # the JAX package has no unfused path here either
                    raise ValueError(f"transpose_quant cannot tile the slim last block's "
                                     f"{slim_base} rows")
                img_o = w4a8_linear_q(a["to_out"], *fq_attn, image.dtype)
            else:
                img_o = a["to_out"](out.transpose(1, 2).reshape(b, slim_base, d))
            image = image[:, :slim_base] + im_g1[:, None, :] * img_o
            image = image + im_g2[:, None, :] * _mlp(self.img_mlp, image, im_sh2,
                                                     im_sc2, eps, fq)
            return None, image

        fq_attn = None
        if fq and isinstance(a["to_out"], W4Linear) and isinstance(a["to_add_out"], W4Linear):
            fq_attn = transpose_quant(out)
        if fq_attn is not None:
            q_all, sc_all = fq_attn
            img_o = w4a8_linear_q(a["to_out"], q_all[:, s_t:], sc_all[:, s_t:], image.dtype)
            txt_o = w4a8_linear_q(a["to_add_out"], q_all[:, :s_t], sc_all[:, :s_t],
                                  image.dtype)
        else:
            out = out.transpose(1, 2).reshape(b, s_t + s_i, d)
            img_o = a["to_out"](out[:, s_t:])
            txt_o = a["to_add_out"](out[:, :s_t])
        image = image + im_g1[:, None, :] * img_o
        text = text + tx_g1[:, None, :] * txt_o
        image = image + im_g2[:, None, :] * _mlp(self.img_mlp, image, im_sh2, im_sc2, eps, fq)
        text = text + tx_g2[:, None, :] * _mlp(self.txt_mlp, text, tx_sh2, tx_sc2, eps, fq)
        return text, image


class DiT(nn.Module):
    """Built on the ``meta`` device; see ``core/params.materialize``."""

    def __init__(self, cfg: DiTConfig = QWEN_IMAGE_CONFIG, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.img_in = linear(cfg.patch_dim, cfg.dim, dtype=dtype)
        self.txt_norm = Leaf(scale=(cfg.txt_in_dim,), dtype=dtype)
        self.txt_in = linear(cfg.txt_in_dim, cfg.dim, dtype=dtype)
        self.time_embed = nn.ModuleDict({
            "linear_1": linear(cfg.time_dim, cfg.dim, dtype=dtype),
            "linear_2": linear(cfg.dim, cfg.dim, dtype=dtype)})
        self.norm_out = nn.ModuleDict({"linear": linear(cfg.dim, 2 * cfg.dim, dtype=dtype)})
        self.proj_out = linear(cfg.dim, cfg.patch_dim, dtype=dtype)
        self.blocks = nn.ModuleList(DiTBlock(cfg, dtype) for _ in range(cfg.num_layers))

    def forward(self, img_tokens, txt_tokens, timestep, img_cos, img_sin,
                txt_cos, txt_sin, txt_key_mask=None, slim_last: int = 0,
                attn_clamp: bool = True):
        """img_tokens [B, S_i, 64] (base image first, then edit tokens);
        txt_tokens [B, S_t, txt_in_dim]; timestep [B] in [0, 1];
        txt_key_mask [B, S_t] bool.  Returns [B, S_i, 64], or
        [B, slim_last, 64] when the last block runs slim."""
        cfg = self.cfg
        s_i = img_tokens.shape[1]
        image = self.img_in(img_tokens)
        text = self.txt_in(rms_norm(txt_tokens, self.txt_norm.scale, cfg.eps))

        temb = timestep_embedding(timestep, cfg.time_dim, img_tokens.dtype)
        temb = self.time_embed["linear_2"](F.silu(self.time_embed["linear_1"](temb)))
        temb_silu = F.silu(temb)

        joint_key_mask = None
        if txt_key_mask is not None:
            joint_key_mask = F.pad(txt_key_mask.bool(), (0, s_i), value=True)

        last = len(self.blocks) - 1
        for i, block in enumerate(self.blocks):
            text, image = block(image, text, temb_silu, img_cos, img_sin,
                                txt_cos, txt_sin, joint_key_mask,
                                slim_base=slim_last if i == last else 0,
                                attn_clamp=attn_clamp)

        scale, shift = self.norm_out["linear"](temb_silu).chunk(2, -1)
        image = layer_norm(image, eps=1e-6) * (1.0 + scale[:, None, :]) + shift[:, None, :]
        return self.proj_out(image)


def attn_clamp_needed(dit: DiT) -> bool:
    """Decide at load whether K1 needs its overflow clamp.

    With per-head RMS-normed q/k scaled by gammas, |q.k| / sqrt(d) <=
    sqrt(d) * |gamma_q|_inf * |gamma_k|_inf (RoPE preserves norms).  When
    that bound in exp2 units sits well below CLAMP the clamp is inert.
    """
    def gmax(name):
        return max(float(blk.attn[name].scale.detach().float().abs().max())
                   for blk in dit.blocks)

    d = dit.cfg.head_dim
    bound = (d ** 0.5) * max(gmax("norm_q"), gmax("norm_added_q")) \
        * max(gmax("norm_k"), gmax("norm_added_k")) * LOG2E
    return bound >= CLAMP / 2

"""Qwen-Image MM-DiT (``physicedit_tpu/models/dit.py``) as ``nn.Module``s.

60 dual-stream blocks in an ``nn.ModuleList``; per-stream QKV projections
are fused ([dim, 3 * dim], as in the JAX package); RoPE tables come from
the host (``ops/rope.py``); text padding is a key-side mask, so the CFG
positive and negative rows ride one batch.  The joint attention runs
through kernel K1 (``kernels/flash_attention.fixedmax_attention``), or,
when an EliGen entity bias is given, through kernel K7
(``fixedmax_attention_bias``) in every block, the slim last block included:
the fixed-max branch of ``kernels.flash_attention.flash_attention_bnsd``.
``attn_impl="dense"`` takes the JAX package's ``attn_impl="xla"`` instead,
the plain ``ops.attention.sdpa_bnsd`` with the bias; ``attn_impl="ring"``
splits the joint sequence over a mesh axis (:func:`set_ring_context`,
``parallel/ring_attention.py``: K1 on every hop, the bias through the
dense lane), the slim last block off.

Under tensor parallelism (``parallel/sharding.shard_params``) a block's
split projections are ``TPLinear``s: it runs on this rank's heads (read
from the QKV output's width) and this rank's MLP features, the collectives
inside the layers, and LoRA deltas through ``sharding.lora_delta_tp``.

A blockwise ControlNet (``models/controlnet.py``) adds its residual to the
base image rows after each block; the slim last block is off then, as it is
with LoRA.

With packed-int4 block weights (``PhysicEditPipeline.quantize_``) a block
takes the fused path of the JAX package: K4 ``ln_mod_quant`` feeds the QKV
and fc1 projections, K5 ``gelu_quant`` feeds fc2 and K6 ``transpose_quant``
feeds the attention output projections, each straight into
``w4a8_linear_q``.

Training passes the trainable LoRA factors (``lora.DiTLoRA``) through
``DiT.forward(lora=...)``: deltas on the modulations, the fused QKV
projections, both attention output projections and both fc2 (fc1 has
none), as the JAX package places them.  With LoRA a block takes the
unfused path and the slim last block is off; ``use_remat`` recomputes each
block in the backward (``torch.utils.checkpoint``, the JAX package's
``jax.checkpoint`` per block).

Under ``torch.profiler`` (``core/trace.py``) the forward is the span
``pe.dit``, each block call ``pe.dit.block``, and a block's five segments
``pe.block.mod`` (the modulation linears), ``pe.block.qkv`` (modulated norm,
QKV, q/k RMSNorm and RoPE into the joint q, k, v), ``pe.block.attn`` (the
attention), ``pe.block.out`` (heads to features or K6, the output linears)
and ``pe.block.mlp`` (each stream's tail: the first gated residual, the
MLP's modulated LayerNorm, the MLP and its gated residual).

A block writes its joint q, k and v through
``kernels/qk_norm_rope.qk_norm_rope`` (one CUDA kernel for both streams on
the card, which takes bf16 at head_dim 128 and refuses the rest), its
modulated LayerNorms through ``kernels/ln_mod.ln_mod``, and, off the fused
W4 path, a stream's first gated residual with the MLP's modulated LayerNorm
through ``kernels/ln_mod.residual_ln_mod``.  These kernels have no backward:
with grad on, as on the CPU, the wrappers run their plain versions, which
autograd differentiates.  A stream's tail (:func:`_residual_mlp`) is one
function for both streams and both block shapes: the slim last block runs
the image stream's over its first ``slim_base`` rows and none for the text.

Module attribute names follow the JAX parameter tree, so ``io/from_jax.py``
can carry weights across by name.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from physicedit_torch.core.params import Leaf, linear
from physicedit_torch.core.trace import span
from physicedit_torch.kernels.flash_attention import (CLAMP, LOG2E, fixedmax_attention,
                                                      fixedmax_attention_bias)
from physicedit_torch.kernels.fused_quant import gelu_quant, ln_mod_quant, transpose_quant
from physicedit_torch.kernels.ln_mod import ln_mod, residual_ln_mod
from physicedit_torch.kernels.qk_norm_rope import qk_norm_rope
from physicedit_torch.kernels.quant_matmul import W4Linear, w4a8_linear_q
from physicedit_torch.lora import lora_delta, lora_delta_fused
from physicedit_torch.ops.attention import sdpa_bnsd
from physicedit_torch.ops.norms import approximate_gelu, rms_norm
from physicedit_torch.parallel.sharding import TPLinear, lora_delta_tp


# Sequence-parallel (ring) attention context: attn_impl="ring" splits the
# joint sequence over this mesh axis (parallel/ring_attention.py); set it
# once with set_ring_context before the first ring call.
_RING_CTX = {"mesh": None, "axis": "model"}


def set_ring_context(mesh, axis: str = "model") -> None:
    _RING_CTX["mesh"] = mesh
    _RING_CTX["axis"] = axis


def ring_joint_attention(q, k, v, key_mask, bias=None, tp_group=None, impl=None):
    """The joint attention under ``attn_impl="ring"``: full-sequence q/k/v
    [B, N', S, D] through ``ring_attention.sequence_parallel_attention``
    over the ring context's axis; ``tp_group``, the group the block's heads
    are split over (tensor parallelism), trades heads for sequence when it
    is the ring's own.  bias: [B, S, S] in natural-log units or None.
    impl: the ring's lane (``ring_attention.default_ring_impl`` when None)."""
    import torch.distributed as dist

    from physicedit_torch.parallel.ring_attention import sequence_parallel_attention

    mesh = _RING_CTX["mesh"]
    if mesh is None:
        raise RuntimeError("attn_impl='ring': call models.dit.set_ring_context(mesh) first")
    group = mesh.get_group(_RING_CTX["axis"])
    same = tp_group is not None and (dist.get_process_group_ranks(tp_group)
                                     == dist.get_process_group_ranks(group))
    return sequence_parallel_attention(q, k, v, key_mask, group, bias=bias, impl=impl,
                                       heads_split=same)


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


def _no_lora(y, x):
    return y


def _with_lora(leaf, fused: bool = False, lin=None):
    """``y + delta(x)`` in y's dtype for one layer's factors, or no delta;
    on the slice of ``lin`` when it is tensor-parallel."""
    if leaf is None:
        return _no_lora

    def add(y, x):
        if isinstance(lin, TPLinear):
            delta = lora_delta_tp(lin, leaf, x, fused)
        else:
            delta = lora_delta_fused(leaf, x) if fused else lora_delta(leaf, x)
        return y + delta.to(y.dtype)

    return add


def _mod_linear(lin, x, shift, scale, eps, fused: bool, add_lora=_no_lora):
    """``lin(modulate(x))`` plus its LoRA delta; on the fused path K4 makes
    the int8 input."""
    if fused and isinstance(lin, W4Linear):
        fq = ln_mod_quant(x, shift, scale, eps)
        if fq is not None:
            return w4a8_linear_q(lin, *fq, x.dtype)
    xn = ln_mod(x, shift, scale, eps)
    return add_lora(lin(xn), xn)


def _residual_mlp(p: nn.ModuleDict, x, o, gate1, gate2, shift, scale, eps, fused: bool,
                  add_lora=_no_lora, act=approximate_gelu):
    """A stream's tail: ``x' + gate2 * fc2(act(fc1(modulate(x'))))`` for the
    first gated residual ``x' = x + gate1 * o``, with fc2's LoRA delta.  On
    the fused path x' is eager, K4 makes fc1's int8 input and K5 fc2's (K5
    computes ``approximate_gelu``); otherwise ``residual_ln_mod`` computes
    x' with the modulated LayerNorm in one kernel.  Each intermediate is let
    go as the next is made."""
    if fused:
        x = x + gate1[:, None, :] * o
        h = _mod_linear(p["fc1"], x, shift, scale, eps, fused)
        if act is approximate_gelu and isinstance(p["fc2"], W4Linear):
            gq = gelu_quant(h)
            if gq is not None:
                y = w4a8_linear_q(p["fc2"], *gq, x.dtype)
                del h, gq   # let them go before the residual is made
                return x + gate2[:, None, :] * y
    else:
        x, h = residual_ln_mod(x, o, gate1, shift, scale, eps)
        h = p["fc1"](h)
    h = act(h)
    return x + gate2[:, None, :] * add_lora(p["fc2"](h), h)


class DiTBlock(nn.Module):
    """One dual-stream block.  ``act`` is the MLPs' activation: Qwen-Image's
    ``approximate_gelu`` (``x * sigmoid(1.702 x)``), or FLUX's tanh GELU
    (``models/flux.py``, whose double-stream blocks are this block); ``cfg``
    needs ``dim``, ``head_dim``, ``mlp_dim`` and ``eps``."""

    def __init__(self, cfg: DiTConfig, dtype=None, act=approximate_gelu):
        super().__init__()
        d, hd = cfg.dim, cfg.head_dim
        self.cfg = cfg
        self.act = act
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
                joint_key_mask, slim_base: int = 0, attn_clamp: bool = True, lora=None,
                attn_bias_log2=None, attn_impl: str = "kernels"):
        """One dual-stream block; returns (text, image).

        ``slim_base > 0`` runs it as the last block: only the first
        ``slim_base`` image rows are queried and carried on (the denoise loop
        keeps only those), the text stream and edit-image rows skip their
        projections and MLPs, and the return is (None, image[:, :slim_base]).
        ``lora`` is this layer's factors (an entry of ``DiTLoRA.layers()``)
        or None.  ``attn_bias_log2`` is the joint [B, S, S] entity bias in
        exp2 units: the attention then runs through K7, the slim block's
        reading the rows of its queries as a view.  ``attn_impl``: "kernels"
        (K1 / K7), "dense" (the plain softmax, the bias back in natural-log
        units) or "ring" (:func:`ring_joint_attention`; not with ``slim_base``).
        """
        cfg = self.cfg
        b, s_t = image.shape[0], text.shape[1]
        eps = cfg.eps
        a = self.attn
        lora = lora or {}
        # the JAX package's use_fq: packed block weights the kernels can tile,
        # and no LoRA
        fq = (not lora and isinstance(a["img_qkv"], W4Linear)
              and (a["img_qkv"].in_features // 2) % 128 == 0)

        with span("pe.block.mod"):
            img_mod = _with_lora(lora.get("img_mod"))(self.img_mod(temb_silu), temb_silu)
            txt_mod = _with_lora(lora.get("txt_mod"))(self.txt_mod(temb_silu), temb_silu)
            im_sh1, im_sc1, im_g1, im_sh2, im_sc2, im_g2 = img_mod.chunk(6, -1)
            tx_sh1, tx_sc1, tx_g1, tx_sh2, tx_sc2, tx_g2 = txt_mod.chunk(6, -1)

        with span("pe.block.qkv"):
            img_qkv = _mod_linear(a["img_qkv"], image, im_sh1, im_sc1, eps, fq,
                                  _with_lora(lora.get("img_qkv"), True, a["img_qkv"]))
            txt_qkv = _mod_linear(a["txt_qkv"], text, tx_sh1, tx_sc1, eps, fq,
                                  _with_lora(lora.get("txt_qkv"), True, a["txt_qkv"]))
            # text prefix, image suffix on the joint axis; [B, N, S, D] contiguous
            gains = (a["norm_q"].scale, a["norm_k"].scale, a["norm_added_q"].scale,
                     a["norm_added_k"].scale)
            q, k, v = qk_norm_rope(img_qkv, txt_qkv, gains, img_cos, img_sin, txt_cos, txt_sin,
                                   eps, slim_base)

        with span("pe.block.attn"):
            rows = attn_bias_log2
            if rows is not None and slim_base:
                rows = rows[:, s_t:s_t + slim_base]
            if attn_impl == "kernels":
                if rows is None:
                    out = fixedmax_attention(q, k, v, key_mask=joint_key_mask,
                                             clamp=attn_clamp)
                else:
                    out = fixedmax_attention_bias(q, k, v, rows, key_mask=joint_key_mask)
            elif attn_impl == "dense":
                out = sdpa_bnsd(q, k, v, key_mask=joint_key_mask,
                                bias=None if rows is None else (rows / LOG2E)[:, None])
            elif attn_impl == "ring":
                if slim_base:
                    raise ValueError("the slim last block is a single-GPU lane: it is off "
                                     "under the ring")
                out = ring_joint_attention(q, k, v, joint_key_mask,
                                           None if rows is None else rows / LOG2E,
                                           a["img_qkv"].group
                                           if isinstance(a["img_qkv"], TPLinear) else None)
            else:
                raise ValueError(f"attn_impl {attn_impl!r}: the DiT takes 'kernels', 'dense' "
                                 "or 'ring'")

        with span("pe.block.out"):
            # out's rows: the text stream's [:t], then the image stream's.  The
            # slim block queried only its first slim_base image rows, and its
            # text stream ends at the attention
            t = 0 if slim_base else s_t
            image = image[:, :slim_base] if slim_base else image
            lins = [a["to_out"]] if slim_base else [a["to_out"], a["to_add_out"]]
            fq_attn = None
            if fq and all(isinstance(lin, W4Linear) for lin in lins):
                # K6: the heads-to-features transpose and the row quantize in one pass
                fq_attn = transpose_quant(out)
                if fq_attn is None and slim_base:
                    # the JAX package has no unfused path here either
                    raise ValueError(f"transpose_quant cannot tile the slim last block's "
                                     f"{slim_base} rows")
            if fq_attn is None:
                out = out.transpose(1, 2).reshape(b, t + image.shape[1], -1)

            def project(lin, part, leaf):
                if fq_attn is not None:
                    return w4a8_linear_q(lin, fq_attn[0][:, part], fq_attn[1][:, part],
                                         image.dtype)
                return _with_lora(leaf, lin=lin)(lin(out[:, part]), out[:, part])

            img_o = project(a["to_out"], slice(t, None), lora.get("to_out"))
            if not slim_base:
                txt_o = project(a["to_add_out"], slice(0, t), lora.get("to_add_out"))
        with span("pe.block.mlp"):
            img_fc2_lora = _with_lora(lora.get("img_mlp_fc2"), lin=self.img_mlp["fc2"])
            image = _residual_mlp(self.img_mlp, image, img_o, im_g1, im_g2, im_sh2, im_sc2, eps,
                                  fq, img_fc2_lora, self.act)
            text = None if slim_base else _residual_mlp(
                self.txt_mlp, text, txt_o, tx_g1, tx_g2, tx_sh2, tx_sc2, eps, fq,
                _with_lora(lora.get("txt_mlp_fc2"), lin=self.txt_mlp["fc2"]), self.act)
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
                attn_clamp: bool = True, lora=None, use_remat: bool = False,
                attn_bias_log2=None, control=None, attn_impl: str = "kernels"):
        """img_tokens [B, S_i, 64] (base image first, then edit tokens);
        txt_tokens [B, S_t, txt_in_dim]; timestep [B] in [0, 1];
        txt_cos/txt_sin [S_t, 64], or [B, 1, S_t, 64] for a table per row;
        txt_key_mask [B, S_t] bool.  Returns [B, S_i, 64], or
        [B, slim_last, 64] when the last block runs slim (never with
        ``lora``, a ``DiTLoRA``, nor with ``control``).  ``use_remat``
        recomputes each block in the backward instead of keeping its
        activations.  ``attn_bias_log2``: the EliGen entity bias [B, S_t +
        S_i, S_t + S_i] in exp2 units (``kernels.flash_attention.bias_log2``
        of the 0 / -1e30 bias, made once per edit).  ``control``: a
        ``models.controlnet.Control`` at this step.  ``attn_impl``: "kernels",
        "dense" or "ring" (``DiTBlock.forward``; the slim last block is off
        under the ring)."""
        with span("pe.dit"):
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
            slim_last = 0 if lora is not None or control is not None or attn_impl == "ring" \
                else slim_last
            layer_lora = [None] * len(self.blocks) if lora is None else lora.layers()
            remat = use_remat and torch.is_grad_enabled()
            for i, block in enumerate(self.blocks):
                def run(image, text, block=block, i=i):
                    with span("pe.dit.block"):
                        text, image = block(image, text, temb_silu, img_cos, img_sin, txt_cos,
                                            txt_sin, joint_key_mask,
                                            slim_base=slim_last if i == last else 0,
                                            attn_clamp=attn_clamp, lora=layer_lora[i],
                                            attn_bias_log2=attn_bias_log2, attn_impl=attn_impl)
                        if control is not None:
                            image = control.add_residual(i, image)
                        return text, image

                text, image = (checkpoint(run, image, text, use_reentrant=False) if remat
                               else run(image, text))

            scale, shift = self.norm_out["linear"](temb_silu).chunk(2, -1)
            return self.proj_out(ln_mod(image, shift, scale, 1e-6))


def attn_clamp_needed(dit: nn.Module) -> bool:
    """Decide at load whether K1 needs its overflow clamp.

    With per-head RMS-normed q/k scaled by gammas, |q.k| / sqrt(d) <=
    sqrt(d) * |gamma_q|_inf * |gamma_k|_inf (RoPE preserves norms).  When
    that bound in exp2 units sits well below CLAMP the clamp is inert.
    The gains are every block's ``attn.norm_*q`` / ``attn.norm_*k``: the
    dual-stream ``blocks`` and, in the FLUX DiT, its ``single_blocks``.
    """
    blocks = list(dit.blocks) + list(getattr(dit, "single_blocks", ()))

    def gmax(kind):
        return max(float(leaf.scale.detach().float().abs().max())
                   for blk in blocks for name, leaf in blk.attn.items()
                   if name.startswith("norm_") and name.endswith(kind))

    d = dit.cfg.head_dim
    bound = (d ** 0.5) * gmax("q") * gmax("k") * LOG2E
    return bound >= CLAMP / 2

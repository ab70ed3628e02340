"""Checkpoint export, the save half of ``physicedit_tpu/train/checkpoint.py``.

The trainable surface is written in the reference's key space: the DiT LoRA
in peft keys without prefix, the adapters under ``pipe.*``, in a
safetensors file beside a JSON metadata sidecar and a ``latest.json``
pointer.  The file is written by ``io/safetensors_io.save_safetensors``,
without the ``safetensors`` package.  Resuming is not ported yet.
"""

from __future__ import annotations

import datetime
import json
import os

import numpy as np

from physicedit_torch.io.safetensors_io import save_safetensors
from physicedit_torch.lora import export_dit_lora


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _lin_out(sd: dict, prefix: str, lin) -> None:
    sd[prefix + ".weight"] = _np(lin.weight)        # torch's [out, in] already
    if lin.bias is not None:
        sd[prefix + ".bias"] = _np(lin.bias)


def _ln_out(sd: dict, prefix: str, leaf) -> None:
    sd[prefix + ".weight"] = _np(leaf.scale)
    sd[prefix + ".bias"] = _np(leaf.bias)


def export_adapters_state_dict(adapters, prefix: str = "pipe.") -> dict:
    """Training adapters (``train.trainer.TrainingAdapters``) -> the
    reference's ``pipe.*`` keys (NumPy fp32)."""
    sd: dict = {}
    va = adapters.visual_thinking_adapter
    for head in ("head_dino", "head_vae"):
        _lin_out(sd, f"{prefix}visual_thinking_adapter.{head}.0", getattr(va, head)["fc1"])
        _lin_out(sd, f"{prefix}visual_thinking_adapter.{head}.2", getattr(va, head)["fc2"])
    for name in ("dino_resampler", "vae_resampler"):
        r = getattr(adapters, name)
        base = prefix + name
        sd[base + ".latents"] = _np(r.latents)
        sd[base + ".pos_emb.weight"] = _np(r.pos_emb)
        for i, layer in enumerate(r.layers):
            a = f"{base}.layers.{i}.0"
            attn = layer["attn"]
            _ln_out(sd, a + ".norm_media", attn["norm_media"])
            _ln_out(sd, a + ".norm_latents", attn["norm_latents"])
            for nm in ("to_q", "to_kv", "to_out"):
                sd[f"{a}.{nm}.weight"] = _np(attn[nm].weight)
            f = f"{base}.layers.{i}.1"
            _ln_out(sd, f + ".net.0", layer["ff"]["norm"])
            _lin_out(sd, f + ".net.1", layer["ff"]["fc1"])
            _lin_out(sd, f + ".net.3", layer["ff"]["fc2"])
        _ln_out(sd, base + ".norm", r.norm)
        ad = getattr(adapters, name + "_adapter")
        _lin_out(sd, f"{prefix}{name}_adapter.net.0", ad["fc1"])
        _lin_out(sd, f"{prefix}{name}_adapter.net.2", ad["fc2"])
    for name in ("dino_time_embed", "vae_time_embed"):
        sd[f"{prefix}{name}.weight"] = _np(getattr(adapters, name))
    return sd


def export_trainable_state_dict(trainable) -> dict:
    """``Trainable`` -> one reference-format state dict: LoRA keys without
    prefix (the reference strips ``pipe.dit.`` at save time), adapter keys
    under ``pipe.``."""
    sd = export_dit_lora(trainable.lora, prefix="")
    sd.update(export_adapters_state_dict(trainable.adapters))
    return sd


def save_checkpoint(output_dir: str, trainable, global_step: int, epoch: int,
                    num_processes: int = 1, batches_per_epoch: int = 0,
                    gradient_accumulation_steps: int = 1,
                    sample_index: int | None = None) -> str:
    """``step-{N}.safetensors`` + ``step-{N}.json`` + ``latest.json`` in
    ``output_dir``; returns the safetensors path."""
    os.makedirs(output_dir, exist_ok=True)
    name = f"step-{global_step}"
    ckpt_path = os.path.join(output_dir, name + ".safetensors")
    save_safetensors(export_trainable_state_dict(trainable), ckpt_path)
    meta = {"global_step": global_step, "epoch": epoch, "num_processes": num_processes,
            "batches_per_epoch": batches_per_epoch,
            "gradient_accumulation_steps": gradient_accumulation_steps,
            "timestamp": datetime.datetime.now().isoformat()}
    if sample_index is not None:
        # the exact dataset position within `epoch`
        meta["sample_index"] = int(sample_index)
    with open(os.path.join(output_dir, name + ".json"), "w") as f:
        json.dump(meta, f, indent=2)
    with open(os.path.join(output_dir, "latest.json"), "w") as f:
        json.dump({"checkpoint": name + ".safetensors", **meta}, f, indent=2)
    return ckpt_path

"""Checkpoint export and resume (``physicedit_tpu/train/checkpoint.py``).

The trainable surface is written in the reference's key space: the DiT LoRA
in peft keys without prefix, the adapters under ``pipe.*``, in a
safetensors file beside a JSON metadata sidecar and a ``latest.json``
pointer.  The file is written by ``io/safetensors_io.save_safetensors``,
without the ``safetensors`` package.  The JAX package also saves an Orbax
tree beside it; the port keeps the safetensors file as its only checkpoint.

Resume is weights-only, as in the reference: :func:`resolve_resume` finds
the file and its sidecar, :func:`resume_position` turns a legacy sidecar
(one without ``sample_index``) into a start epoch and a number of batches
to skip, rescaled when the world size changed.
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


def resolve_resume(resume_from: str) -> tuple[str, dict]:
    """A checkpoint file, or a directory with ``latest.json`` -> (checkpoint
    path, metadata); a file without its ``.json`` sidecar gives ``{}``."""
    if os.path.isdir(resume_from):
        with open(os.path.join(resume_from, "latest.json")) as f:
            meta = json.load(f)
        return os.path.join(resume_from, meta["checkpoint"]), meta
    meta_path = os.path.splitext(resume_from)[0] + ".json"
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return resume_from, meta


def resume_position(meta: dict, num_processes: int,
                    batches_per_epoch: int) -> tuple[int, int, int]:
    """(global_step, start_epoch, skip_batches) from sidecar metadata, the
    step rescaled by the saved world size over ``num_processes``."""
    step = int(meta.get("global_step", 0))
    old_np = int(meta.get("num_processes", num_processes)) or 1
    eff_step = step * old_np // max(num_processes, 1)
    if batches_per_epoch <= 0:
        return step, int(meta.get("epoch", 0)), 0
    return step, eff_step // batches_per_epoch, eff_step % batches_per_epoch

"""The training harness (``physicedit_tpu/train/trainer.py``): per-sample
preprocessing through the frozen encoders, the training loop and
checkpoint export.

- :meth:`Trainer.preprocess` runs the frozen encoders once per sample: VAE
  target and edit latents, the VL prompt embedding with the special-token
  suffix, DINOv2 and VAE features of the key frames for the prior branches.
  It draws from one NumPy generator in the JAX package's order (the key
  frames' crops, the source crop, the timestep index, the noise), so a
  sample's crops, sigma and noise are bitwise the JAX package's.
- frames are padded to ``MAX_KEY_FRAMES`` and masked out of the resampler
  keys, and prompt embeddings are padded to a bucketed length.
- :meth:`Trainer.train` loads synchronously, steps, and saves every
  ``save_every_n_steps`` and at each epoch's end.

``quantize_frozen="w4"`` packs the pipeline's DiT to int4 in place (the JAX
package keeps a second, packed tree: on one 80 GB card the two would not
fit beside the VL model, and the numbers are the same); the pipeline then
serves the W4 lane for inference too.

The DiT runs in the pipeline's dtype: the prompt embedding is handed to it
in that dtype (the JAX trainer keeps it fp32 and lets ``jnp`` promote; at
fp32 the two agree; ``tests/test_torch_train.py`` holds the bf16 loss and
gradients against the JAX package fed the same bf16 embedding).  Not ported
yet: ``resume``, ``evaluate`` (and so the periodic eval), ``cache_preprocessed``
(and so training from cached batches), the loader threads, the mesh path,
Adafactor and gradient accumulation.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch import nn

from physicedit_torch.core.params import init_random_, materialize
from physicedit_torch.kernels.quant_matmul import DIT_OUTER_KEYS, quantize_module_int4
from physicedit_torch.lora import DiTLoRA, init_dit_lora
from physicedit_torch.models import adapters as m_ad
from physicedit_torch.ops import rope as m_rope
from physicedit_torch.ops.patchify import patchify
from physicedit_torch.pipeline import visual_prior
from physicedit_torch.pipeline.vl_host import bucket_pad_text
from physicedit_torch.sampling import flow_match as fm
from physicedit_torch.train import checkpoint as ckpt
from physicedit_torch.train.train_step import make_optimizer, train_step

MAX_KEY_FRAMES = 6   # nn.Embedding(6, .) in the reference
# The resampler adapters' output biases cancel in the pseudo targets' mid -
# source difference: their gradient is exactly 0, in the JAX package too.
ZERO_GRAD_PARAMS = ("adapters.dino_resampler_adapter.fc2.bias",
                    "adapters.vae_resampler_adapter.fc2.bias")


@dataclasses.dataclass
class TrainConfig:
    output_path: str = "./ckpt"
    learning_rate: float = 1e-5
    weight_decay: float = 1e-2
    num_epochs: int = 5
    lora_rank: int = 128
    save_every_n_steps: int = 500
    gradient_accumulation_steps: int = 1
    batch_size: int = 1
    height: int = 480
    width: int = 832
    txt_len_bucket: int = 128   # prompt embeddings padded to multiples of this
    use_remat: bool = True
    seed: int = 0
    quantize_frozen: str = "none"      # 'none' | 'w4': the frozen DiT packed int4
    quantize_min_size: int = 1 << 16   # smaller layers stay in the working dtype
    optimizer_state_dtype: str = "float32"   # Adam moments: 'float32' | 'bfloat16'
    lora_dtype: str = "float32"
    optimizer: str = "adamw"
    adapters_dtype: str = "float32"


class TrainingAdapters(nn.Module):
    """The JAX ``trainable["adapters"]`` tree: the dual adapter, both
    resampler branches with their adapters, and both frame-index
    embeddings.  Built on the ``meta`` device."""

    def __init__(self, txt_dim: int, dino_dim: int, vae_dim: int = 64, dtype=None):
        super().__init__()
        self.visual_thinking_adapter = m_ad.DualAdapter(txt_dim, txt_dim, dtype)
        self.dino_resampler = m_ad.PerceiverResampler(dino_dim, dtype=dtype)
        self.dino_resampler_adapter = m_ad.visual_thinking_head(dino_dim, txt_dim, dtype)
        self.dino_time_embed = nn.Parameter(
            torch.empty((MAX_KEY_FRAMES, dino_dim), dtype=dtype, device="meta"),
            requires_grad=False)
        self.vae_resampler = m_ad.PerceiverResampler(vae_dim, max_num_media_tokens=10240,
                                                     dtype=dtype)
        self.vae_resampler_adapter = m_ad.visual_thinking_head(vae_dim, txt_dim, dtype)
        self.vae_time_embed = nn.Parameter(
            torch.empty((MAX_KEY_FRAMES, vae_dim), dtype=dtype, device="meta"),
            requires_grad=False)


class Trainable(nn.Module):
    """The trained surface: ``lora`` (a ``DiTLoRA``) and ``adapters``."""

    def __init__(self, lora: DiTLoRA, adapters: TrainingAdapters):
        super().__init__()
        self.lora = lora
        self.adapters = adapters


@torch.no_grad()
def init_trainable(pipe, cfg: TrainConfig, device) -> Trainable:
    """Fresh LoRA factors and training adapters on ``device``: the
    pipeline's dual adapter is copied in ``adapters_dtype``; the resampler
    branches start from the JAX package's init distribution."""
    gen = torch.Generator(device).manual_seed(cfg.seed)
    adt = getattr(torch, cfg.adapters_dtype)
    adapters = materialize(TrainingAdapters(pipe.dit.cfg.txt_in_dim, pipe.dinov2.cfg.hidden_size,
                                            dtype=adt), device)
    init_random_(adapters, gen)
    for name in ("dino_resampler", "vae_resampler"):
        m_ad.init_perceiver_(getattr(adapters, name), gen)
    for name in ("dino_time_embed", "vae_time_embed"):
        getattr(adapters, name).normal_(0.0, 0.02, generator=gen)
    if pipe.adapter is not None:
        for dst, src in zip(adapters.visual_thinking_adapter.parameters(),
                            pipe.adapter.parameters()):
            dst.copy_(src)
    lora = init_dit_lora(pipe.dit.cfg, cfg.lora_rank, getattr(torch, cfg.lora_dtype), device,
                         gen)
    return Trainable(lora, adapters).requires_grad_(True)


class Trainer:
    def __init__(self, pipe, dataset, cfg: TrainConfig, logger=None, mesh=None,
                 device="cuda"):
        if mesh is not None:
            raise NotImplementedError("multi-device training (mesh=) is not ported")
        self.device = torch.device(device)
        if pipe.device != self.device:
            raise ValueError(f"the pipeline is on {pipe.device}, the trainer on {self.device}")
        if pipe.dinov2 is None:
            raise ValueError("training needs the pipeline's DINOv2 (pipe.dinov2)")
        self.pipe = pipe
        self.dataset = dataset
        self.cfg = cfg
        self.logger = logger
        # pack the frozen DiT first: its bf16 weights go before the trainable
        # surface and the optimizer state are allocated
        if cfg.quantize_frozen == "w4":
            quantize_module_int4(pipe.dit, min_size=cfg.quantize_min_size,
                                 skip_top=DIT_OUTER_KEYS)
        elif cfg.quantize_frozen != "none":
            raise ValueError(f"unknown quantize_frozen: {cfg.quantize_frozen}")
        self.optimizer = make_optimizer(
            cfg.learning_rate, cfg.weight_decay, cfg.gradient_accumulation_steps,
            state_dtype=(None if cfg.optimizer_state_dtype == "float32"
                         else getattr(torch, cfg.optimizer_state_dtype)),
            name=cfg.optimizer)
        self.trainable = init_trainable(pipe, cfg, self.device)
        self.opt_state = self.optimizer.init(self.trainable)
        self.rng = np.random.default_rng(cfg.seed)
        self.t_min, self.t_max = fm.adapter_t_range()
        self.train_sched = fm.qwen_training_schedule()
        self.global_step = 0
        self.history: list = []     # per step: loss, mse, special_token_loss, seconds

    def trainable_counts(self) -> dict:
        """Parameter counts of the trainable surface: lora and each adapter."""
        ad = self.trainable.adapters
        counts = {"lora": sum(p.numel() for p in self.trainable.lora.parameters())}
        counts.update({n: sum(p.numel() for p in m.parameters()) for n, m in ad.named_children()})
        counts.update({n: p.numel() for n, p in ad.named_parameters(recurse=False)})
        return counts

    # ------------------------------------------------------------------

    def _tensor(self, arr, dtype=torch.float32):
        return torch.as_tensor(np.asarray(arr)).to(self.device, dtype)

    @torch.no_grad()
    def preprocess(self, sample: dict) -> dict | None:
        """One dataset sample -> a fixed-shape batch of one (None when the
        sample has no key frames or no special tokens)."""
        pipe = self.pipe
        edit_image = sample["edit_image"]
        keys = (sample.get("middle_key_frames") or [])[:MAX_KEY_FRAMES]
        if not keys:
            return None
        input_latents = pipe.encode_image(sample["image"])
        edit_latents = pipe.encode_image(edit_image)
        edit_tokens = patchify(edit_latents)

        # the reference's train-time conditioning: the dataset triplet
        # appended with no separator and title-case labels
        triplet = sample.get("triplet") or {}
        physical_txt = (
            f"Middle Transition Prompt: {triplet.get('middle_transition_prompt', '')}\n"
            f"Final State Prompt: {triplet.get('final_state_prompt', '')}")
        emb, special = pipe.encode_prompt_edit(sample["prompt"] + physical_txt, edit_image)
        if special is None:
            return None

        dino_mid = visual_prior.dino_preprocess(keys, self.rng)
        dino_src = visual_prior.dino_preprocess([edit_image], self.rng)
        feats_mid = pipe.dinov2(self._tensor(dino_mid)).float()
        feats_src = pipe.dinov2(self._tensor(dino_src)).float()
        vae_mid = patchify(visual_prior.encode_frames(pipe.vae, keys)).float()
        vae_src = edit_tokens.float()

        # pad the frames to MAX_KEY_FRAMES; mid_frame_mask keeps the pad out
        # of the resampler keys
        f = feats_mid.shape[0]
        mid_frame_mask = np.arange(MAX_KEY_FRAMES) < f
        feats_mid = torch.cat([feats_mid, feats_mid.new_zeros(
            (MAX_KEY_FRAMES - f,) + feats_mid.shape[1:])])
        vae_mid = torch.cat([vae_mid, vae_mid.new_zeros((MAX_KEY_FRAMES - f,) + vae_mid.shape[1:])])

        prompt_emb, txt_mask = bucket_pad_text([emb], self.cfg.txt_len_bucket)
        h, w = input_latents.shape[1], input_latents.shape[2]
        eh, ew = edit_latents.shape[1], edit_latents.shape[2]
        ropes = m_rope.build_rope_tables([(1, h // 2, w // 2), (1, eh // 2, ew // 2)],
                                         txt_mask.shape[1], axes_dim=pipe.rope_axes)

        tid = int(self.rng.integers(0, fm.NUM_TRAIN_TIMESTEPS))
        noise = self.rng.standard_normal(tuple(input_latents.shape)).astype(np.float32)
        sched = self.train_sched
        return {
            "input_latents": input_latents.float(),
            "noise": self._tensor(noise),
            "edit_tokens": edit_tokens.float(),
            "prompt_emb": self._tensor(prompt_emb, pipe.dtype),
            "txt_mask": self._tensor(txt_mask, torch.bool),
            "special_idx": self._tensor(special[None], torch.long),
            "dino_mid_feats": feats_mid[None], "dino_src_feats": feats_src[None],
            "vae_mid_tokens": vae_mid[None], "vae_src_tokens": vae_src[None],
            "mid_frame_mask": self._tensor(mid_frame_mask[None], torch.bool),
            "img_cos": self._tensor(ropes[0]), "img_sin": self._tensor(ropes[1]),
            "txt_cos": self._tensor(ropes[2]), "txt_sin": self._tensor(ropes[3]),
            "sigma": self._tensor([sched.sigmas[tid]]),
            "timestep": self._tensor([sched.timesteps[tid]]),
            "weight": self._tensor([sched.weights[tid]]),
        }

    def collate(self, batches: list) -> dict:
        """Stack batches of one into one batch, padding the text axis to the
        longest bucket; the shared RoPE tables come from the widest sample."""
        if len(batches) == 1:
            return batches[0]
        s_t = max(int(b["prompt_emb"].shape[1]) for b in batches)
        widest = max(batches, key=lambda b: int(b["prompt_emb"].shape[1]))
        out = {}
        for k in batches[0]:
            if k in ("img_cos", "img_sin", "txt_cos", "txt_sin"):
                out[k] = widest[k]
            elif k in ("prompt_emb", "txt_mask"):
                parts = []
                for b in batches:
                    pad = s_t - b[k].shape[1]
                    widths = [0, 0] * (b[k].dim() - 2) + [0, pad]
                    parts.append(torch.nn.functional.pad(b[k], widths) if pad else b[k])
                out[k] = torch.cat(parts)
            else:
                out[k] = torch.cat([b[k] for b in batches])
        return out

    def cache_preprocessed(self, output_dir: str) -> int:
        raise NotImplementedError("cache_preprocessed (the cached data-process mode) is not ported")

    def resume(self, resume_from: str):
        raise NotImplementedError("resume is not ported")

    def evaluate(self, sample_idx: int = 0, seed: int = 42, num_inference_steps: int = 40):
        raise NotImplementedError("evaluate (the train-time eval probe) is not ported")

    # ------------------------------------------------------------------

    def step(self, batch: dict) -> dict:
        """One optimizer step on ``batch``; returns its metrics as floats
        with the step's wall time (ended by a device synchronise)."""
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        metrics = train_step(self.trainable, self.pipe.dit, self.optimizer, self.opt_state,
                             batch, self.t_min, self.t_max, use_remat=self.cfg.use_remat)
        metrics = {k: float(v) for k, v in metrics.items()}
        sync()
        metrics["seconds"] = time.perf_counter() - t0
        self.global_step += 1
        self.history.append(metrics)
        return metrics

    def train(self):
        cfg = self.cfg
        pending = []
        skipped = 0
        for epoch in range(cfg.num_epochs):
            usable = 0
            for i in range(len(self.dataset)):
                sample = self.dataset[i]
                self._epoch_pos = i + 1
                if sample is None:
                    continue
                micro = self.preprocess(sample)
                if micro is None:
                    skipped += 1
                    continue
                pending.append(micro)
                usable += 1
                if len(pending) < cfg.batch_size:
                    continue
                batch = self.collate(pending)
                pending = []
                metrics = self.step(batch)
                if self.logger is not None:
                    self.logger.log_step(self.global_step, epoch, metrics, metrics["seconds"])
                if cfg.save_every_n_steps and self.global_step % cfg.save_every_n_steps == 0:
                    self.save(epoch)
            if self.global_step == 0 and usable == 0:
                raise RuntimeError(
                    f"epoch {epoch} produced no usable samples ({skipped} skipped): the "
                    f"PhysicEdit loss requires middle_key_frames (video data)")
            if skipped:
                print(f"[TRAIN] epoch {epoch}: skipped {skipped} samples without usable key "
                      f"frames/special tokens")
                skipped = 0
            self.save(epoch)
        if self.global_step == 0:
            raise RuntimeError(f"no training step ran: batch_size={cfg.batch_size} exceeds the "
                               f"{len(pending)} usable samples")
        if pending:
            print(f"[TRAIN] {len(pending)} usable samples left in a partial batch were not "
                  f"trained on")

    def save(self, epoch: int) -> str:
        path = ckpt.save_checkpoint(self.cfg.output_path, self.trainable, self.global_step,
                                    epoch, batches_per_epoch=len(self.dataset),
                                    sample_index=getattr(self, "_epoch_pos", 0))
        print(f"[ckpt] saved {path}")
        return path

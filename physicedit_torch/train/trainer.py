"""The training harness (``physicedit_tpu/train/trainer.py``): per-sample
preprocessing through the frozen encoders, the training loop, checkpoints,
resume and the train-time eval.

- :meth:`Trainer.preprocess` runs the frozen encoders once per sample: VAE
  target and edit latents, the VL prompt embedding with the special-token
  suffix, DINOv2 and VAE features of the key frames for the prior branches.
  It draws from one NumPy generator in the JAX package's order (the key
  frames' crops, the source crop, the timestep index, the noise), so a
  sample's crops, sigma and noise are bitwise the JAX package's.
- frames are padded to ``MAX_KEY_FRAMES`` and masked out of the resampler
  keys, and prompt embeddings are padded to a bucketed length.
- :meth:`Trainer.train` decodes items ahead in ``loader_workers`` threads
  (``train/prefetch.py``; preprocessing and the draws stay on this thread,
  in index order), steps, saves every ``save_every_n_steps`` and at each
  epoch's end, and runs :meth:`evaluate` every ``eval_every_n_steps``.
  With ``cached_inputs`` the items are the ``.npz`` bundles of
  :meth:`cache_preprocessed` and :meth:`_refresh_noise` draws their timestep
  and noise anew.
- :meth:`resume` loads a checkpoint's weights into the trainable surface
  (in its configured dtypes; the JAX package loads them as fp32), starts a
  fresh optimizer state, and restarts at the saved dataset position.

``quantize_frozen="w4"`` packs the pipeline's DiT to int4 in place (the JAX
package keeps a second, packed tree: on one 80 GB card the two would not
fit beside the VL model, and the numbers are the same); the pipeline then
serves the W4 lane for inference too.

The DiT runs in the pipeline's dtype: the prompt embedding is handed to it
in that dtype (the JAX trainer keeps it fp32 and lets ``jnp`` promote; at
fp32 the two agree; ``tests/test_torch_train.py`` holds the bf16 loss and
gradients against the JAX package fed the same bf16 embedding).

With a ``mesh`` (``parallel/sharding.create_mesh``, one process per GPU)
the frozen DiT is tensor-parallel over ``model`` (or, packed W4,
replicated: W4 with a model axis above one raises, as in the JAX package),
the trainable surface and the optimizer state are replicated (every process
builds them alike from ``cfg.seed``), each step's rows go by the ``data``
axis (``multihost.host_local_batch_slice``) and the gradients and metrics
are all-reduce-averaged over it, so the update is the JAX package's over
the global batch.  Every process reads and preprocesses every item (the
draws stay in lockstep); only the first writes checkpoints, bundles and
eval strips.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch
from torch import nn

from physicedit_torch.core.params import init_random_, materialize
from physicedit_torch.io.convert import physic_adapters_from_state_dict
from physicedit_torch.io.safetensors_io import load_state_dict
from physicedit_torch.kernels.quant_matmul import DIT_OUTER_KEYS, quantize_module_int4
from physicedit_torch.lora import (DiTLoRA, import_dit_lora, init_dit_lora,
                                   split_finetuned_checkpoint)
from physicedit_torch.models import adapters as m_ad
from physicedit_torch.ops import rope as m_rope
from physicedit_torch.ops.patchify import patchify
from physicedit_torch.parallel import sharding as shd
from physicedit_torch.parallel.multihost import host_local_batch_slice, is_main_process
from physicedit_torch.pipeline import visual_prior
from physicedit_torch.pipeline.vl_host import bucket_pad_text
from physicedit_torch.sampling import flow_match as fm
from physicedit_torch.train import checkpoint as ckpt
from physicedit_torch.train.prefetch import prefetch_samples
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
    eval_every_n_steps: int | None = None
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
    optimizer: str = "adamw"            # 'adamw' | 'adafactor'
    adapters_dtype: str = "float32"
    cached_inputs: bool = False         # items are cache_preprocessed bundles
    loader_workers: int = 2             # decode threads; 0 = synchronous


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
        self.device = torch.device(device)
        if pipe.device != self.device:
            raise ValueError(f"the pipeline is on {pipe.device}, the trainer on {self.device}")
        if pipe.dinov2 is None:
            raise ValueError("training needs the pipeline's DINOv2 (pipe.dinov2)")
        self.pipe = pipe
        self.dataset = dataset
        self.cfg = cfg
        self.logger = logger
        self.mesh = mesh
        self.is_main = is_main_process()
        # pack (or split) the frozen DiT first: its bf16 weights go before the
        # trainable surface and the optimizer state are allocated
        if cfg.quantize_frozen == "w4":
            if mesh is not None and mesh.size(mesh.mesh_dim_names.index(shd.MODEL_AXIS)) != 1:
                raise ValueError("quantize_frozen='w4' is the single-GPU / data-parallel "
                                 "residency plan; tensor-parallel meshes use bf16 sharding "
                                 "(pick one)")
            quantize_module_int4(pipe.dit, min_size=cfg.quantize_min_size,
                                 skip_top=DIT_OUTER_KEYS)
        elif cfg.quantize_frozen != "none":
            raise ValueError(f"unknown quantize_frozen: {cfg.quantize_frozen}")
        elif mesh is not None:
            shd.shard_params(pipe.dit, shd.dit_param_specs(pipe.dit), mesh)
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
        self.start_epoch = 0
        self.skip_batches = 0       # dataset items skipped in start_epoch
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

    def _cached_batch(self, micro: dict) -> dict:
        """A cached bundle's arrays as a batch on the device: the prompt
        embedding in the pipeline's dtype, masks bool, indices long, the
        rest fp32."""
        kinds = {"prompt_emb": self.pipe.dtype, "txt_mask": torch.bool,
                 "mid_frame_mask": torch.bool, "special_idx": torch.long}
        return {k: torch.as_tensor(v).to(self.device, kinds.get(k, torch.float32))
                for k, v in micro.items()}

    def _refresh_noise(self, micro: dict) -> dict:
        """A cached bundle as a batch with its stochastic fields drawn anew
        from ``self.rng`` in the JAX package's order (the timestep index,
        then the noise): the cache keeps the encoders' outputs, the noising
        differs on every visit, as on the inline path."""
        tid = int(self.rng.integers(0, fm.NUM_TRAIN_TIMESTEPS))
        noise = self.rng.standard_normal(tuple(np.shape(micro["input_latents"])))
        sched = self.train_sched
        batch = self._cached_batch(micro)
        batch.update({"noise": self._tensor(noise.astype(np.float32)),
                      "sigma": self._tensor([sched.sigmas[tid]]),
                      "timestep": self._tensor([sched.timesteps[tid]]),
                      "weight": self._tensor([sched.weights[tid]])})
        return batch

    def cache_preprocessed(self, output_dir: str) -> int:
        """Preprocess every item once and write it as ``{i:06d}.npz`` (the
        reference's data-process mode; ``train.dataset.CachedPreprocessedDataset``
        reads them back): the JAX package's arrays and dtypes (fp32, bool,
        int32 special indices; the prompt embedding's values in fp32).
        Returns the number of bundles."""
        os.makedirs(output_dir, exist_ok=True)
        n = 0
        for i in range(len(self.dataset)):
            sample = self.dataset[i]
            if sample is None:
                continue
            micro = self.preprocess(sample)
            if micro is None:
                continue
            if self.is_main:
                np.savez_compressed(os.path.join(output_dir, f"{i:06d}.npz"),
                                    **{k: bundle_array(k, v) for k, v in micro.items()})
            n += 1
        print(f"[TRAIN] cached {n} preprocessed samples -> {output_dir}")
        return n

    @torch.no_grad()
    def resume(self, resume_from: str):
        """Weights-only resume from a checkpoint file or a directory with
        ``latest.json``: the LoRA and the adapter groups the file holds are
        copied into the trainable surface in its dtypes, the optimizer state
        starts afresh, and the loop restarts at the saved position (the
        exact ``sample_index``, rolled to the next epoch at the epoch's end;
        a legacy sidecar through ``checkpoint.resume_position``)."""
        path, meta = ckpt.resolve_resume(resume_from)
        lora_sd, pipe_sd = split_finetuned_checkpoint(load_state_dict(path))
        if lora_sd:
            lora = import_dit_lora({k.replace("pipe.dit.", ""): v for k, v in lora_sd.items()},
                                   self.pipe.dit.cfg, torch.float32, "cpu")
            self.trainable.lora.load_state_dict(lora.state_dict())
        for name, loaded in physic_adapters_from_state_dict(pipe_sd, torch.float32,
                                                            "cpu").items():
            target = getattr(self.trainable.adapters, name)
            if isinstance(target, torch.Tensor):
                target.copy_(loaded)
            else:
                target.load_state_dict(loaded.state_dict())
        self.opt_state = self.optimizer.init(self.trainable)
        if "sample_index" in meta:
            self.global_step = int(meta.get("global_step", 0))
            self.start_epoch = int(meta.get("epoch", 0))
            self.skip_batches = int(meta["sample_index"])
            if self.skip_batches >= len(self.dataset):
                self.start_epoch += 1
                self.skip_batches = 0
        else:
            # a legacy sidecar counts optimizer steps of batch_size items
            self.global_step, self.start_epoch, skip_steps = ckpt.resume_position(
                meta, num_processes=1,
                batches_per_epoch=max(len(self.dataset) // self.cfg.batch_size, 1))
            self.skip_batches = skip_steps * self.cfg.batch_size
        print(f"[RESUME] step={self.global_step} epoch={self.start_epoch} "
              f"skip={self.skip_batches} samples")

    @torch.no_grad()
    def evaluate(self, sample_idx: int = 0, seed: int = 42, num_inference_steps: int = 40):
        """A fixed-seed edit of dataset item ``sample_idx`` through the
        pipeline with the trainable LoRA hot-loaded (``pipe.dit_lora``) and
        the trainable adapters in ``pipe.adapters`` (the dual one as
        ``pipe.adapter``), all restored afterwards; saves and returns the
        ``[edit | GT | output]`` strip as ``eval-step-{N}.jpg``.  The step's
        gradients are freed first.  Skipped (None) with cached inputs, whose
        items carry no prompt or image."""
        from PIL import Image

        if self.cfg.cached_inputs:
            print("[EVAL] skipped: cached_inputs datasets carry no prompt/image samples to "
                  "generate from")
            return None
        sample = self.dataset[sample_idx]
        if sample is None:
            return None
        for p in self.trainable.parameters():
            p.grad = None
        pipe = self.pipe
        saved = pipe.adapters, pipe.adapter, pipe.dit_lora
        trained = dict(self.trainable.adapters.named_children())
        trained.update(self.trainable.adapters.named_parameters(recurse=False))
        pipe.adapters = dict(pipe.adapters, **trained)
        pipe.adapter = trained["visual_thinking_adapter"]
        pipe.dit_lora = self.trainable.lora
        try:
            out = pipe(sample["prompt"], edit_image=sample["edit_image"], seed=seed,
                       num_inference_steps=num_inference_steps, height=self.cfg.height,
                       width=self.cfg.width, have_text_reasoning=False,
                       edit_image_auto_resize=False)
        finally:
            pipe.adapters, pipe.adapter, pipe.dit_lora = saved
        size = (self.cfg.width, self.cfg.height)
        strip = Image.new("RGB", (size[0] * 3, size[1]))
        strip.paste(sample["edit_image"].resize(size), (0, 0))
        strip.paste(sample["image"].resize(size), (size[0], 0))
        strip.paste(out.resize(size), (size[0] * 2, 0))
        if self.logger is not None:
            self.logger.log_eval_image(self.global_step, strip, caption=sample["prompt"])
        path = os.path.join(self.cfg.output_path, f"eval-step-{self.global_step}.jpg")
        if self.is_main:
            os.makedirs(self.cfg.output_path, exist_ok=True)
            strip.save(path)
            print(f"[EVAL] step={self.global_step} -> {path}")
        return strip

    # ------------------------------------------------------------------

    def step(self, batch: dict) -> dict:
        """One optimizer step on ``batch`` (the global batch; on a mesh this
        process takes its rows); returns its metrics as floats with the
        step's wall time (ended by a device synchronise)."""
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        metrics = train_step(self.trainable, self.pipe.dit, self.optimizer, self.opt_state,
                             local_rows(batch, self.mesh), self.t_min, self.t_max,
                             use_remat=self.cfg.use_remat, attn_impl=self.pipe.attn_impl,
                             grad_group=data_group(self.mesh))
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
        for epoch in range(self.start_epoch, cfg.num_epochs):
            usable = 0
            start = self.skip_batches if epoch == self.start_epoch else 0
            for i, sample in prefetch_samples(self.dataset, range(start, len(self.dataset)),
                                              num_workers=cfg.loader_workers):
                self._epoch_pos = i + 1     # the exact resume position (save)
                if sample is None:
                    continue
                micro = (self._refresh_noise(sample) if cfg.cached_inputs
                         else self.preprocess(sample))
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
                    self.logger.log_step(self.global_step, epoch,
                                         {k: v for k, v in metrics.items() if k != "seconds"},
                                         metrics["seconds"])
                if cfg.save_every_n_steps and self.global_step % cfg.save_every_n_steps == 0:
                    self.save(epoch)
                if cfg.eval_every_n_steps and self.global_step % cfg.eval_every_n_steps == 0:
                    self.evaluate((i + 1) % len(self.dataset))
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
                               f"{len(pending)} usable samples over "
                               f"{cfg.num_epochs - self.start_epoch} epoch(s)")
        if pending:
            print(f"[TRAIN] {len(pending)} usable samples left in a partial batch were not "
                  f"trained on")

    def save(self, epoch: int) -> str:
        """Write a checkpoint (the first process only, on a mesh); returns
        its path."""
        if not self.is_main:
            return os.path.join(self.cfg.output_path, f"step-{self.global_step}.safetensors")
        path = ckpt.save_checkpoint(self.cfg.output_path, self.trainable, self.global_step,
                                    epoch, batches_per_epoch=len(self.dataset),
                                    sample_index=getattr(self, "_epoch_pos", 0))
        print(f"[ckpt] saved {path}")
        return path


def data_group(mesh):
    """The mesh's ``data`` group when that axis spans more than one process,
    else None."""
    if mesh is None or mesh.size(mesh.mesh_dim_names.index(shd.DATA_AXIS)) == 1:
        return None
    return mesh.get_group(shd.DATA_AXIS)


def local_rows(batch: dict, mesh) -> dict:
    """This process's rows of a global batch on a mesh whose ``data`` axis
    spans processes (the fields whose leading dim is the batch, the RoPE
    tables excepted: the JAX trainer's ``_place_batch``); else the batch."""
    if data_group(mesh) is None:
        return batch
    b = int(batch["input_latents"].shape[0])
    start, per = host_local_batch_slice(b, mesh)
    return {k: v[start:start + per]
            if v.dim() >= 1 and v.shape[0] == b
            and k not in ("img_cos", "img_sin", "txt_cos", "txt_sin") else v
            for k, v in batch.items()}


def bundle_array(key: str, value: torch.Tensor) -> np.ndarray:
    """One field of a preprocessed batch as ``cache_preprocessed`` writes
    it: fp32 for floats (the prompt embedding's values in the pipeline's
    dtype, widened), int32 special indices, bool masks."""
    value = value.detach().cpu()
    if value.is_floating_point():
        return value.float().numpy()
    return value.to(torch.int32).numpy() if key == "special_idx" else value.numpy()

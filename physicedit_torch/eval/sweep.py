"""Benchmark sweep drivers, PICABench and KRIS-Bench
(``physicedit_tpu/eval/sweep.py``, the reference's
``scripts/inference/inference_pica.py`` / ``inference_kris.py``):

- PICA: the HF dataset ``Andrew613/PICABench``, prompt_type in
  {superficial, intermediate, explicit}, edits at the input's native size
  (quantised to /32), index-range sharding across workers, outputs
  ``{idx:05d}.jpg``;
- KRIS: ``Liang0223/KRIS_Bench``, one output folder per category, inputs
  resized to about 1024², existing outputs skipped (restartable).

:class:`BucketBatcher` groups the items into batches for
``PhysicEditPipeline.edit_batch`` (one resolution bucket) or, in mixed mode,
``edit_batch_mixed`` (arrival order across resolutions).
"""

from __future__ import annotations

import os

from physicedit_torch.cli.validate import resize_image

PICA_PROMPT_COLUMNS = {
    "superficial": "superficial_prompt",
    "intermediate": "intermediate_prompt",
    "explicit": "explicit_prompt",
}


def _load_hf_dataset(name: str, split: str = "train", local_path: str | None = None):
    from datasets import load_dataset, load_from_disk

    if local_path is not None:
        return load_from_disk(local_path)
    return load_dataset(name, split=split)


class BucketBatcher:
    """Group sweep items into batches for the pipeline's serving calls.

    Items gather per /32-quantised (w, h) bucket; a bucket flushes through
    ``pipe.edit_batch`` when it holds ``batch_size`` items, and
    :meth:`flush_all` drains the rest at whatever partial size is left.  A
    batch of one (or ``batch_size`` 1) runs ``pipe.__call__``, the
    reference's one image per invocation.

    ``mixed=True`` (native-resolution serving): items gather in arrival
    order in one queue and flush every ``batch_size`` items through
    ``pipe.edit_batch_mixed``, whose conditioning batches across
    resolutions and whose denoise runs per same-shape group; batches are
    full even on a fragmented mix of sizes.
    """

    def __init__(self, pipe, batch_size: int, seed: int, num_inference_steps: int,
                 pipe_kwargs: dict | None = None, mixed: bool = False):
        self.pipe = pipe
        self.batch_size = batch_size
        self.seed = seed
        self.steps = num_inference_steps
        # extra kwargs for every pipe call (e.g. cfg_truncate_step)
        self.pipe_kwargs = dict(pipe_kwargs or {})
        self.mixed = mixed and batch_size > 1
        self.buckets: dict = {}

    def add(self, prompt, image, out_path, on_done):
        key = "mixed" if self.mixed else image.size
        self.buckets.setdefault(key, []).append((prompt, image, out_path, on_done))
        if len(self.buckets[key]) >= self.batch_size:
            self._flush(key)

    def _flush(self, key):
        items = self.buckets.pop(key, [])
        if not items:
            return
        prompts = [p for p, _, _, _ in items]
        images = [im for _, im, _, _ in items]
        if key == "mixed":
            outs = self.pipe.edit_batch_mixed(
                prompts, images, heights=[im.size[1] for im in images],
                widths=[im.size[0] for im in images], seeds=[self.seed] * len(items),
                num_inference_steps=self.steps, **self.pipe_kwargs)
        elif self.batch_size == 1 or len(items) == 1:
            w, h = key
            outs = [self.pipe(prompts[0], edit_image=images[0], seed=self.seed,
                              num_inference_steps=self.steps, height=h, width=w,
                              edit_image_auto_resize=False, **self.pipe_kwargs)]
        else:
            w, h = key
            outs = self.pipe.edit_batch(prompts, images, height=h, width=w,
                                        seeds=[self.seed] * len(items),
                                        num_inference_steps=self.steps, **self.pipe_kwargs)
        for out, (_, _, out_path, on_done) in zip(outs, items):
            on_done(out, out_path)

    def flush_all(self):
        for key in list(self.buckets):
            self._flush(key)


def run_pica_sweep(pipe, output_dir: str, prompt_type: str = "intermediate",
                   start_idx: int = 0, end_idx: int | None = None, seed: int = 42,
                   num_inference_steps: int = 40, local_dataset_path: str | None = None,
                   native_resolution: bool = True, skip_existing: bool = True,
                   prompt_rewriter=None, batch_size: int = 1,
                   cfg_truncate_step: int | None = None,
                   mixed_resolution_batching: bool = True):
    """PICABench over ``[start_idx, end_idx)``.  ``prompt_rewriter``: an
    optional callable prompt -> prompt (the reference's external rewriter
    is kept out of the package).  ``batch_size`` > 1 batches edits; with
    ``mixed_resolution_batching`` (the default) native-size items batch in
    arrival order through ``edit_batch_mixed``, else per /32 bucket through
    ``edit_batch``."""
    ds = _load_hf_dataset("Andrew613/PICABench", local_path=local_dataset_path)
    os.makedirs(output_dir, exist_ok=True)
    end_idx = len(ds) if end_idx is None else min(end_idx, len(ds))
    col = PICA_PROMPT_COLUMNS.get(prompt_type, prompt_type)

    def on_done(out, out_path):
        out.save(out_path)
        print(f"[PICA] -> {out_path}", flush=True)

    batcher = BucketBatcher(pipe, batch_size, seed, num_inference_steps,
                            pipe_kwargs={"cfg_truncate_step": cfg_truncate_step},
                            mixed=mixed_resolution_batching and native_resolution)
    for idx in range(start_idx, end_idx):
        out_path = os.path.join(output_dir, f"{idx:05d}.jpg")
        if skip_existing and os.path.exists(out_path):
            continue
        rec = ds[idx]
        image = rec["image"].convert("RGB")
        if not native_resolution:
            image = resize_image(image)
        else:
            # quantise to /32: a small set of shapes across the sweep
            w = max(32, (image.size[0] // 32) * 32)
            h = max(32, (image.size[1] // 32) * 32)
            if (w, h) != image.size:
                image = image.resize((w, h))
        prompt = rec[col]
        if prompt_rewriter is not None:
            prompt = prompt_rewriter(prompt)
        batcher.add(prompt, image, out_path, on_done)
    batcher.flush_all()


def run_kris_sweep(pipe, output_dir: str, start_idx: int = 0, end_idx: int | None = None,
                   seed: int = 42, num_inference_steps: int = 40,
                   local_dataset_path: str | None = None, skip_existing: bool = True,
                   batch_size: int = 1, cfg_truncate_step: int | None = None):
    """KRIS-Bench over ``[start_idx, end_idx)``, one folder per category."""
    ds = _load_hf_dataset("Liang0223/KRIS_Bench", local_path=local_dataset_path)
    os.makedirs(output_dir, exist_ok=True)
    end_idx = len(ds) if end_idx is None else min(end_idx, len(ds))

    def on_done(out, out_path):
        out.save(out_path)
        print(f"[KRIS] -> {out_path}", flush=True)

    batcher = BucketBatcher(pipe, batch_size, seed, num_inference_steps,
                            pipe_kwargs={"cfg_truncate_step": cfg_truncate_step})
    for idx in range(start_idx, end_idx):
        rec = ds[idx]
        category = rec.get("category", "default")
        cat_dir = os.path.join(output_dir, str(category))
        os.makedirs(cat_dir, exist_ok=True)
        name = rec.get("image_id", f"{idx:05d}")
        out_path = os.path.join(cat_dir, f"{name}.jpg")
        if skip_existing and os.path.exists(out_path):
            continue
        image = resize_image(rec["image"].convert("RGB"))
        prompt = rec.get("instruction", rec.get("prompt", ""))
        batcher.add(prompt, image, out_path, on_done)
    batcher.flush_all()
